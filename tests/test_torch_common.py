"""Parity of the PyTorch port's building blocks with the JAX package, on the
CPU: hashing and vnodes, chunks and emission units, expressions (incl.
tumble_start), the device hash table, scatter reductions, the agg flush
gather, and the NEXmark generator. Inputs are made with numpy from a seed
and handed to both packages; every comparison is exact."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
import risingwave_tpu.ops as JO
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
import risingwave_tpu_torch.ops as TO
from risingwave_tpu.common.chunk import (
    count_units as j_count_units, gather_units_window as j_gather,
)
from risingwave_tpu.common.hashing import (
    hash_columns as j_hash_columns, vnode_of as j_vnode_of,
)
from risingwave_tpu.common.types import GLOBAL_STRING_DICT
from risingwave_tpu.connector.nexmark import (
    NexmarkConfig as JConfig, NexmarkGenerator as JGen,
)
from risingwave_tpu.ops.grouped_agg import AggCore as JAggCore
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.interop import agg_state_from_jax, chunk_from_jax
from risingwave_tpu_torch.ops.grouped_agg import AggCore as TAggCore

CPU = "cpu"


def jcols(arrays):
    return [J.Column(jnp.asarray(d), jnp.asarray(m)) for d, m in arrays]


def tcols(arrays):
    return [T.Column(torch.as_tensor(d), torch.as_tensor(m))
            for d, m in arrays]


def _column(kind, n, rng):
    mask = rng.random(n) < 0.8
    if kind == "int64":
        data = rng.integers(-2**62, 2**62, n)
    elif kind == "int32_neg":
        data = rng.integers(-50, 50, n).astype(np.int32)
    elif kind == "float64_zero":
        data = rng.standard_normal(n)
        data[::3] = -0.0
        data[1::3] = 0.0
    elif kind == "bool":
        data = rng.random(n) < 0.5
    else:  # all NULL
        data = rng.integers(0, 9, n)
        mask = np.zeros(n, bool)
    return data, mask


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kinds", [
    ("int64",), ("int32_neg",), ("float64_zero",), ("bool",), ("null",),
    ("int64", "float64_zero", "int32_neg"), ("null", "bool", "int64")])
def test_hash_columns_and_vnode_bit_for_bit(kinds):
    rng = np.random.default_rng(len(kinds))
    arrays = [_column(k, 500, rng) for k in kinds]
    hj = np.asarray(j_hash_columns(jcols(arrays))).view(np.int64)
    ht = T.hash_columns(tcols(arrays)).numpy()
    np.testing.assert_array_equal(hj, ht)
    np.testing.assert_array_equal(np.asarray(j_vnode_of(jcols(arrays))),
                                  T.vnode_of(tcols(arrays)).numpy())


def test_negative_zero_and_null_hash_to_their_tags():
    data = np.array([0.0, -0.0, 1.5, 7.0])
    mask = np.array([True, True, True, False])
    h = T.hash_columns(tcols([(data, mask)])).numpy()
    assert h[0] == h[1] != h[2]
    null_only = T.hash_columns(tcols([(np.array([3.0]), np.array([False]))]))
    assert null_only.item() == h[3]


# ---------------------------------------------------------------------------
# chunks and emission units
# ---------------------------------------------------------------------------

SCHEMA_J = J.Schema.of(("a", J.INT64), ("b", J.FLOAT64), ("c", J.BOOL))
SCHEMA_T = T.Schema.of(("a", T.INT64), ("b", T.FLOAT64), ("c", T.BOOL))


def _update_rows(n, rng):
    rows, ops = [], []
    while len(rows) < n - 1:
        a = int(rng.integers(-5, 5))
        b = None if rng.random() < 0.2 else float(rng.integers(0, 4))
        c = bool(rng.random() < 0.5)
        if rng.random() < 0.3:
            rows += [(a, b, c), (a, b, not c)]
            ops += [J.OP_UPDATE_DELETE, J.OP_UPDATE_INSERT]
        else:
            rows.append((a, b, c))
            ops.append(int(rng.choice([J.OP_INSERT, J.OP_DELETE])))
    return rows, ops


@pytest.mark.parametrize("seed", [0, 1])
def test_units_and_gather_window(seed):
    rng = np.random.default_rng(seed)
    rows, ops = _update_rows(40, rng)
    jc = J.make_chunk(SCHEMA_J, rows, ops=ops, capacity=48)
    tc = T.make_chunk(SCHEMA_T, rows, ops=ops, capacity=48, device=CPU)
    # hide a few rows, incl. halves of update pairs
    hide = rng.random(48) < 0.15
    jc = jc.replace(vis=jc.vis & jnp.asarray(~hide))
    tc = tc.replace(vis=tc.vis & torch.as_tensor(~hide))
    assert T.chunk_to_rows(tc, SCHEMA_T, with_ops=True) == \
        J.chunk_to_rows(jc, SCHEMA_J, with_ops=True)
    n_units = int(j_count_units(jc))
    assert int(T.count_units(tc)) == n_units
    for lo in (0, 1, 7, 8, n_units - 1, n_units):
        want = J.chunk_to_rows(j_gather(jc, jnp.int64(lo), 16), SCHEMA_J,
                               with_ops=True)
        got = T.chunk_to_rows(T.gather_units_window(tc, lo, 16), SCHEMA_T,
                              with_ops=True)
        assert got == want, lo


def test_chunk_from_jax_round_trip():
    rows, ops = _update_rows(10, np.random.default_rng(3))
    jc = J.make_chunk(SCHEMA_J, rows, ops=ops, capacity=16)
    tc = chunk_from_jax(jc, device=CPU)
    assert T.chunk_to_rows(tc, SCHEMA_T, with_ops=True) == \
        J.chunk_to_rows(jc, SCHEMA_J, with_ops=True)


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

X_J = J.Schema.of(("x", J.INT64), ("y", J.INT64), ("f", J.FLOAT64),
                  ("p", J.BOOL), ("q", J.BOOL), ("ts", J.TIMESTAMP),
                  ("i", J.INT32))
X_T = T.Schema.of(("x", T.INT64), ("y", T.INT64), ("f", T.FLOAT64),
                  ("p", T.BOOL), ("q", T.BOOL), ("ts", T.TIMESTAMP),
                  ("i", T.INT32))


def _expr_rows(n, rng):
    def maybe(v):
        return None if rng.random() < 0.2 else v
    return [(maybe(int(rng.integers(-20, 20))), maybe(int(rng.integers(-4, 4))),
             maybe(float(rng.integers(-8, 8)) / 4), maybe(bool(rng.random() < .5)),
             maybe(bool(rng.random() < .5)),
             maybe(int(rng.integers(-30_000, 30_000))),
             maybe(int(rng.integers(-9, 9))))
            for _ in range(n)]


def _build(E, types, spec):
    """One expression per spec entry, built the same way in both packages."""
    c = [E.col(i, t) for i, t in enumerate(types)]
    x, y, f, p, q, ts, i = c
    lit = E.Literal
    return {
        "add": E.call("add", x, y), "sub_float": E.call("subtract", f, x),
        "mul_i32": E.call("multiply", i, x), "neg": E.call("neg", x),
        "abs": E.call("abs", y), "div_int": E.call("divide", x, y),
        "div_float": E.call("divide", f, y), "mod": E.call("modulus", x, y),
        "eq": E.call("equal", x, y), "ne": E.call("not_equal", f, x),
        "lt": E.call("less_than", x, y),
        "le": E.call("less_than_or_equal", i, y),
        "gt": E.call("greater_than", f, y),
        "ge": E.call("greater_than_or_equal", x, i),
        "and": E.call("and", p, q), "or": E.call("or", p, q),
        "not": E.call("not", p), "is_null": E.call("is_null", x),
        "is_not_null": E.call("is_not_null", f),
        "coalesce": E.call("coalesce", x, y),
        "cast_f": E.cast(x, types[2]), "cast_i32": E.cast(x, types[6]),
        "tumble": E.call("tumble_start", ts, lit(7_000, types[0])),
        "tumble_col": E.call("tumble_start", ts, y),
        "tumble_zero": E.call("tumble_start", ts, lit(0, types[0])),
        "null_lit": E.call("add", x, lit(None, types[0])),
    }[spec]


@pytest.mark.parametrize("spec", [
    "add", "sub_float", "mul_i32", "neg", "abs", "div_int", "div_float",
    "mod", "eq", "ne", "lt", "le", "gt", "ge", "and", "or", "not", "is_null",
    "is_not_null", "coalesce", "cast_f", "cast_i32", "tumble", "tumble_col",
    "tumble_zero", "null_lit"])
def test_expression_parity(spec):
    rows = _expr_rows(64, np.random.default_rng(7))
    jc = J.make_chunk(X_J, rows, capacity=64)
    tc = T.make_chunk(X_T, rows, capacity=64, device=CPU)
    je = _build(JE, [f.type for f in X_J], spec)
    te = _build(TE, [f.type for f in X_T], spec)
    jr, tr = je.eval(jc), te.eval(tc)
    assert je.type.kind.name == te.type.kind.name
    jm, tm = np.asarray(jr.mask), tr.mask.numpy()
    np.testing.assert_array_equal(jm, tm)
    np.testing.assert_array_equal(np.asarray(jr.data)[jm], tr.data.numpy()[tm])


def test_tumble_start_floors_negative_timestamps():
    ts = T.Column(torch.tensor([-1, -5000, -5001, 4999, 5000]),
                  torch.ones(5, dtype=torch.bool))
    chunk = T.StreamChunk(torch.zeros(5, dtype=torch.int8),
                          torch.ones(5, dtype=torch.bool), (ts,))
    e = TE.call("tumble_start", TE.col(0, T.TIMESTAMP),
                TE.Literal(5000, T.INT64))
    assert e.eval(chunk).data.tolist() == [-5000, -5000, -10000, 0, 5000]


# ---------------------------------------------------------------------------
# hash table and scatter reductions
# ---------------------------------------------------------------------------

def _key_batches(rng, kind, n_batches, n, n_keys):
    """(key type names, [(key arrays, valid), ...]) of one kind of batch."""
    out = []
    for _ in range(n_batches):
        valid = rng.random(n) < 0.85
        m1 = rng.random(n) < 0.9
        if kind == "mixed":
            types = ("INT64", "FLOAT64")
            arrays = [(rng.integers(0, n_keys, n), m1),
                      (rng.integers(0, 3, n).astype(np.float64),
                       rng.random(n) < 0.9)]
        elif kind == "float_nan_zero":
            # NaN never equals itself; -0.0 and 0.0 are one key
            types = ("FLOAT64",)
            arrays = [(rng.choice([0.0, -0.0, np.nan, 1.5, -2.5, 3.0], n),
                       m1)]
        elif kind == "int32_bool":
            types = ("INT32", "BOOL")
            arrays = [(rng.integers(-n_keys, n_keys, n).astype(np.int32),
                       m1), (rng.random(n) < 0.5, rng.random(n) < 0.9)]
        elif kind == "all_null":
            types = ("INT64", "INT64")
            arrays = [(rng.integers(0, n_keys, n), np.zeros(n, bool)),
                      (rng.integers(0, n_keys, n), np.zeros(n, bool))]
        elif kind == "one_key":
            types = ("INT64",)
            arrays = [(np.full(n, 11), np.ones(n, bool))]
            valid = np.ones(n, bool)
        elif kind == "nan_chain":
            # every row a NaN of one hash: one insert per two rounds, so
            # the batch cannot settle within MAX_PROBE_ROUNDS
            types = ("FLOAT64",)
            arrays = [(np.full(n, np.nan), np.ones(n, bool))]
            valid = np.ones(n, bool)
        else:
            raise ValueError(kind)
        out.append((arrays, valid))
    return types, out


@pytest.mark.parametrize("cap,n_keys,kind,n", [
    pytest.param(64, 20, "mixed", 32, id="64-20"),
    pytest.param(16, 12, "mixed", 32, id="16-12"),
    pytest.param(8, 40, "mixed", 32, id="8-40"),
    pytest.param(64, 0, "float_nan_zero", 32, id="float_nan_zero"),
    pytest.param(64, 20, "int32_bool", 32, id="int32_bool"),
    pytest.param(16, 20, "all_null", 32, id="all_null"),
    pytest.param(16, 0, "one_key", 32, id="one_key"),
    pytest.param(256, 0, "nan_chain", 200, id="nan_chain_unsettled")])
def test_hash_table_slot_for_slot(cap, n_keys, kind, n):
    rng = np.random.default_rng(cap + n_keys + len(kind))
    types, batches = _key_batches(rng, kind, 3, n, n_keys)
    jt = JO.ht_new([getattr(J, t) for t in types], cap)
    tt = TO.ht_new([getattr(T, t) for t in types], cap, device=CPU)
    for arrays, valid in batches:
        jt, js, jn, jo = JO.ht_lookup_or_insert(jt, jcols(arrays),
                                                jnp.asarray(valid))
        tt, ts, tn, to = TO.ht_lookup_or_insert(tt, tcols(arrays),
                                                torch.as_tensor(valid))
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
        assert bool(jo) == bool(to)
        jl, jf = JO.ht_lookup(jt, jcols(arrays), jnp.asarray(valid))
        tl, tf = TO.ht_lookup(tt, tcols(arrays), torch.as_tensor(valid))
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    np.testing.assert_array_equal(np.asarray(jt.occupied),
                                  tt.occupied.numpy())
    for a, b in zip(jt.key_data + jt.key_mask, tt.key_data + tt.key_mask):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    if (kind == "mixed" and n_keys * 3 > cap) or kind == "nan_chain":
        assert bool(to), "the table was meant to overflow"
    if kind == "nan_chain":     # unsettled with free slots left
        assert not tt.occupied.all()
    if kind in ("all_null", "one_key"):
        assert int(tt.occupied.sum()) == 1


@pytest.mark.parametrize("op", ["add", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_scatter_reduce_drops_the_sentinel(op, dtype):
    rng = np.random.default_rng(11)
    cap = 16
    target = rng.integers(-50, 50, cap).astype(dtype)
    slots = rng.integers(0, cap + 1, 100)            # cap = dropped row
    contrib = rng.integers(-100, 100, 100).astype(dtype)
    want = np.asarray(JO.scatter_reduce(jnp.asarray(target),
                                        jnp.asarray(slots.astype(np.int32)),
                                        jnp.asarray(contrib), op))
    got = TO.scatter_reduce(torch.as_tensor(target.copy()),
                            torch.as_tensor(slots), torch.as_tensor(contrib),
                            op)
    # integer-valued float64 addends sum exactly in any order
    np.testing.assert_array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# agg flush: searchsorted boundaries of the flush windows
# ---------------------------------------------------------------------------

def test_gather_flush_chunk_at_window_boundaries():
    schema_j = J.Schema.of(("k", J.INT64), ("v", J.INT64))
    schema_t = T.Schema.of(("k", T.INT64), ("v", T.INT64))
    calls_j = [JE.count_star(), JE.agg("sum", 1, J.INT64),
               JE.agg("max", 1, J.INT64)]
    calls_t = [TE.count_star(), TE.agg("sum", 1, T.INT64),
               TE.agg("max", 1, T.INT64)]
    jcore = JAggCore([J.INT64], [0], calls_j, 64, 8)
    tcore = TAggCore([T.INT64], [0], calls_t, 64, 8, device=CPU)
    rng = np.random.default_rng(5)
    rows = [(int(k), int(v)) for k, v in zip(rng.integers(0, 30, 40),
                                             rng.integers(0, 100, 40))]
    jstate = jcore.apply_chunk(jcore.init_state(),
                               J.make_chunk(schema_j, rows, capacity=64))
    tstate = agg_state_from_jax(jcore.init_state(), device=CPU)
    tcore.apply_chunk(tstate, T.make_chunk(schema_t, rows, capacity=64,
                                           device=CPU))
    jrank, trank = jcore.flush_rank(jstate), tcore.flush_rank(tstate)
    np.testing.assert_array_equal(np.asarray(jrank), trank.numpy())
    n_dirty = int(trank[-1])
    out_j = J.Schema.of(("k", J.INT64), ("c", J.INT64), ("s", J.INT64),
                        ("m", J.INT64))
    out_t = T.Schema.of(("k", T.INT64), ("c", T.INT64), ("s", T.INT64),
                        ("m", T.INT64))
    for lo in (0, 1, 3, 4, n_dirty - 4, n_dirty - 1, n_dirty):
        want = J.chunk_to_rows(
            jcore.gather_flush_chunk(jstate, jrank, jnp.int64(lo)), out_j,
            with_ops=True)
        got = T.chunk_to_rows(tcore.gather_flush_chunk(tstate, trank, lo),
                              out_t, with_ops=True)
        assert got == want, lo


# ---------------------------------------------------------------------------
# NEXmark generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stream", ["bid", "auction", "person"])
def test_nexmark_generator_same_rows_from_same_seed(stream):
    jg = JGen(JConfig(chunk_capacity=64), seed=9)
    tg = NexmarkGenerator(NexmarkConfig(chunk_capacity=64), seed=9,
                          device=CPU)
    for _ in range(2):
        for n in (64, 40):
            jc = getattr(jg, f"next_{stream}_chunk")(n)
            tc = getattr(tg, f"next_{stream}_chunk")(n)
            assert len(jc.columns) == len(tc.columns)
            np.testing.assert_array_equal(np.asarray(jc.vis), tc.vis.numpy())
            for jcol, tcol in zip(jc.columns, tc.columns):
                jd, td = np.asarray(jcol.data), tcol.data.numpy()
                if jd.dtype == np.int32:      # VARCHAR ids: compare strings
                    jd = np.array([GLOBAL_STRING_DICT.lookup(int(v))
                                   for v in jd])
                    td = np.array([tg.vocab[int(v)] for v in td])
                np.testing.assert_array_equal(jd, td)
                np.testing.assert_array_equal(np.asarray(jcol.mask),
                                              tcol.mask.numpy())


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, risingwave_tpu_torch\n"
        "for m in pkgutil.walk_packages(risingwave_tpu_torch.__path__,\n"
        "                               'risingwave_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'risingwave_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(__import__("pathlib").Path(__file__)
                                 .resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
