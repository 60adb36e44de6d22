"""The row set's apply and the TopN flush functions through both packages
on the CPU, on random states carried across with ``interop``: ``topn_order``,
``topn_in_set`` (groups, ties, offsets), the refill and the candidate flush
over NaN, ±inf, NULLs, INT64 extremes and VARCHAR keys. Tolerance: exact —
membership masks, orders and row-set state slot for slot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.ops.row_set as JR
import risingwave_tpu.ops.topn as JT
import risingwave_tpu_torch.ops.row_set as TR
import risingwave_tpu_torch.ops.topn as TT
from risingwave_tpu_torch.interop import chunk_from_jax, row_set_state_from_jax
from test_torch_recovery import JAX, TORCH, np_of
from test_torch_topn import D, I, KV, both, order_spec



def test_row_set_delete_then_insert_in_one_chunk():
    """A Delete then an Insert of one pk in a chunk leaves the row (the last
    writer wins); the state equals the reference's slot for slot."""
    rows = [(1, 10), (2, 20), (1, 10), (1, 11), (3, 30), (3, 30)]
    ops = [I, I, D, I, I, D]

    def run(pkg):
        c = pkg.common
        schema = pkg.schema(*KV)
        mod = JR if pkg is JAX else TR
        st = mod.rs_new([c.INT64], [c.INT64, c.INT64], 16, **pkg.kw())
        ch = pkg.chunk(schema, rows, ops, 8)
        with pkg.eager():
            st, slots, applied = mod.rs_apply_chunk(st, ch, [0])
        return ([np_of(slots).tolist(), np_of(applied).tolist(),
                 np_of(st.live).tolist(), np_of(st.ckpt_dirty).tolist(),
                 bool(st.saw_delete)]
                + [np_of(x).tolist() for col in st.cols
                   for x in (col.data, col.mask)])

    got = both(run)
    applied = got[1]
    assert applied[:6] == [False, True, False, True, False, True]


def _random_rows(rng, n, strings):
    """Rows (k, f, s, i): float keys with NaN, ±inf, -0.0 and NULLs,
    VARCHAR keys, int64 keys with INT64 extremes and NULLs."""
    specials = [float("nan"), float("inf"), float("-inf"), -0.0, 0.0]
    out = []
    for k in range(n):
        f = (None if rng.random() < 0.15 else
             rng.choice(specials) if rng.random() < 0.25 else
             float(rng.integers(-5, 5)))
        s = None if rng.random() < 0.1 else str(rng.choice(strings))
        i = (None if rng.random() < 0.1 else
             int(rng.choice([np.iinfo(np.int64).min, np.iinfo(np.int64).max]))
             if rng.random() < 0.2 else int(rng.integers(-3, 3)))
        out.append((k, f, s, i))
    return out


RS_COLS = (("k", "INT64"), ("f", "FLOAT64"), ("s", "VARCHAR"),
           ("i", "INT64"))
ORDERS = {
    "float_asc": [(1,)],
    "float_desc_nulls_first": [(1, True, False)],
    "string_desc": [(2, True)],
    "string_then_float": [(2, False, True), (1, True)],
    "int_desc": [(3, True)],
    "int_nulls_first_then_string": [(3, False, False), (2, True, False)],
}


def _states(seed: int):
    """A random row set built in both packages (the port's from the
    reference's through interop), with a random group id per slot."""
    rng = np.random.default_rng(seed)
    strings = [f"w{rng.integers(0, 40):02d}" for _ in range(12)] + ["", "Z"]
    rows = _random_rows(rng, 48, strings)
    dels = [r for r in rows if rng.random() < 0.2]
    schema = JAX.schema(*RS_COLS)
    c = JAX.common
    with jax.disable_jit():
        st = JR.rs_new([c.INT64], list(schema.types), 64)
        st, _, _ = JR.rs_apply_chunk(st, JAX.chunk(schema, rows,
                                                   capacity=64), [0])
        st, _, _ = JR.rs_apply_chunk(st, JAX.chunk(schema, dels,
                                                   [D] * len(dels), 64), [0])
    gid = jnp.asarray(rng.integers(0, 3, 64), jnp.int32)
    tst = row_set_state_from_jax(jax.tree_util.tree_map(np.asarray, st),
                                 "cpu")
    # the reference's VARCHAR ids as the port dictionary's (trap: ids
    # differ by package, the strings do not)
    jd = JAX.common.GLOBAL_STRING_DICT
    td = TORCH.common.GLOBAL_STRING_DICT
    for cols in (tst.cols, tst.emitted_cols):
        data = cols[2].data
        data.copy_(torch.tensor([td.intern(jd.lookup(i))
                                 for i in data.tolist()], dtype=data.dtype))
    # a rank is a string's place among all of its dictionary's strings, and
    # a threshold key (t1) on a VARCHAR leading key is a rank: give both
    # dictionaries the same strings (earlier tests intern into one package
    # only), so that equal ranks mean equal strings
    for a, b in ((jd, td), (td, jd)):
        for s in [a.lookup(i) for i in range(len(a))]:
            b.intern(s)
    return st, tst, gid, rng


def _specs(pkg, order):
    return [order_spec(pkg, o[0], *o[1:3], is_string=o[0] == 2)
            for o in order] + [order_spec(pkg, 0)]


def _ranks(pkg):
    d = JAX.common.GLOBAL_STRING_DICT if pkg is JAX else \
        TORCH.common.GLOBAL_STRING_DICT
    return d.device_ranks() if pkg is JAX else d.device_ranks("cpu")


@pytest.mark.parametrize("order", sorted(ORDERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_topn_order_and_windows_on_random_states(order, seed):
    """``topn_order`` and ``topn_in_set`` (groups, ties, offsets) equal the
    reference's on random states with NaN, ±inf, NULLs, INT64 extremes and
    VARCHAR keys (dictionary ids differ by package: the keys are ranks)."""
    jst, tst, gid, _ = _states(seed)
    tgid = torch.from_numpy(np.array(gid)).long()
    js, ts = _specs(JAX, ORDERS[order]), _specs(TORCH, ORDERS[order])
    jr, tr = _ranks(JAX), _ranks(TORCH)
    perm_j = np.asarray(JT.topn_order(jst, gid, js, jr))
    perm_t = TT.topn_order(tst, tgid, ts, tr).numpy()
    assert perm_t.tolist() == perm_j.tolist()
    for off, lim, ties in ((0, 3, False), (1, 2, False), (0, 2, True),
                           (0, 1, True)):
        want = np.asarray(JT.topn_in_set(jst, gid, js, off, lim, ties,
                                         n_tie_keys=len(js) - 1,
                                         str_ranks=jr))
        got = TT.topn_in_set(tst, tgid, ts, off, lim, ties,
                             n_tie_keys=len(ts) - 1, str_ranks=tr)
        assert got.numpy().tolist() == want.tolist()


@pytest.mark.parametrize("order", sorted(ORDERS))
def test_topn_candidate_flush_and_refill_on_random_states(order):
    jst, tst, gid, rng = _states(5)
    zeros_j = jnp.zeros(64, jnp.int32)
    zeros_t = torch.zeros(64, dtype=torch.int64)
    js, ts = _specs(JAX, ORDERS[order]), _specs(TORCH, ORDERS[order])
    jr, tr = _ranks(JAX), _ranks(TORCH)
    for off, lim, keep in ((0, 4, 8), (2, 3, 6)):
        ji, jc, jt1 = JT.topn_refill(jst, zeros_j, js, off, lim, keep, jr)
        ti, tc, tt1 = TT.topn_refill(tst, zeros_t, ts, off, lim, keep, tr)
        assert ti.numpy().tolist() == np.asarray(ji).tolist()
        assert tc.numpy().tolist() == np.asarray(jc).tolist()
        assert np.array_equal(tt1.numpy(), np.asarray(jt1), equal_nan=True)
        cand = rng.random(64) < 0.5
        for t1 in (jt1, jnp.zeros_like(jt1)):
            want = JT.topn_candidate_flush(
                jst, js, off, lim, jnp.asarray(cand), 16, keep, t1, jr)
            got = TT.topn_candidate_flush(
                tst, ts, off, lim, torch.from_numpy(cand), 16, keep,
                torch.from_numpy(np.array(t1)), tr)
            for g, w in zip(got, want):
                assert np.array_equal(g.numpy(), np.asarray(w),
                                      equal_nan=True)


def test_chunk_carries_across():
    schema = JAX.schema(*KV)
    ch = JAX.chunk(schema, [(1, 2), (3, 4)], [I, D], 4)
    got = chunk_from_jax(jax.tree_util.tree_map(np.asarray, ch), "cpu")
    assert TORCH.common.chunk_to_rows(got, TORCH.schema(*KV),
                                      with_ops=True) == [(I, (1, 2)),
                                                         (D, (3, 4))]
