"""Cold-tier eviction through both packages, on the CPU: the scenarios of
tests/test_eviction.py restated at the executor level (those go through the
SQL session, which the port does not have): MockSource scripts with the same
keys, budgets and checkpoint frequency drive each package's executors over
a StateTable on a MemoryStateStore. Output rows in order, committed bytes,
the evicted key sets and the device state must equal the reference's, and
the net output must equal an unbudgeted run's. Tolerance: exact."""

import copy

import pytest

import risingwave_tpu.common as J
from risingwave_tpu.storage import MemoryStateStore as JStore
from risingwave_tpu_torch.storage import MemoryStateStore as TStore
from test_torch_recovery import (
    BOTH, D, I, JAX, TORCH, agg_executor, assert_agg_states_equal,
    assert_join_sides_equal, join_executor,
)

# ---------------------------------------------------------------------------
# eviction to the cold tier (tests/test_eviction.py, at the executor level)
# ---------------------------------------------------------------------------

T_SCHEMA = (("k", "INT64"), ("g", "INT64"), ("v", "INT64"))
TF_SCHEMA = (("k", "INT64"), ("g", "FLOAT64"), ("v", "INT64"))


def _mv_spec(n_batches=8, groups=256, revisit_every=3, freq=2):
    """Batches of rows over ``groups`` keys, revisiting the earliest
    (coldest) keys now and then; every ``freq``-th barrier checkpoints."""
    spec, k = [("b", 1, False)], 0
    per = groups // n_batches
    for b in range(n_batches):
        rows = []
        for i in range(per):
            g = b * per + i
            rows.append((k, g, g * 10 + 1))
            k += 1
        if b % revisit_every == 2:
            for g in range(4):
                rows.append((k, g, g * 10 + 7))
                k += 1
        spec += [("c", rows, None), ("b", b + 2, (b + 2) % freq == 0)]
    return spec


def _mv_calls(c, e):
    return [e.count_star(), e.agg("sum", 2, c.INT64),
            e.agg("min", 2, c.INT64)]


def _budget_run(pkg, spec, budget, schema=T_SCHEMA, calls=_mv_calls,
                store=None, capacity=512):
    store = store if store is not None else pkg.store_cls()
    ex = agg_executor(pkg, spec, store, schema=schema, keys=(1,),
                      calls=calls, table_capacity=capacity, out_capacity=64,
                      hbm_group_budget=budget)
    return pkg.drain(ex, store), ex, store


def _net(rows):
    """The changelog reduced to its final multiset of rows."""
    acc = {}
    for op, row in rows:
        acc[row] = acc.get(row, 0) + (1 if op in (I, J.OP_UPDATE_INSERT)
                                      else -1)
    return sorted(r for r, n in acc.items() for _ in range(n))


@pytest.mark.parametrize("budget,shape", [
    (30, dict(groups=128)),
    (15, dict(n_batches=6, groups=60, revisit_every=2))],
    ids=["4x_budget_equals_unbudgeted", "evicted_key_faults_back_in"])
def test_agg_eviction_matches_reference(budget, shape):
    spec = _mv_spec(**shape)
    want, jex, jstore = _budget_run(JAX, spec, budget)
    got, tex, tstore = _budget_run(TORCH, spec, budget)
    base, _, _ = _budget_run(TORCH, spec, None)
    assert got == want
    assert tstore.snapshot() == jstore.snapshot()
    assert tex._evicted == jex._evicted and tex._evicted
    assert _net(got) == _net(base)
    assert_agg_states_equal(jex.state, tex.state)


def test_agg_float_group_keys_survive_eviction():
    spec, k = [("b", 1, False)], 0
    for b in range(4):
        spec += [("c", [(k + i, b * 25 + i + 0.5, i) for i in range(25)],
                  None), ("b", b + 2, (b + 2) % 2 == 0)]
        k += 25
    spec += [("c", [(9001, 0.5, 100), (9002, 1.5, 200)], None),
             ("b", 6, True)]

    def calls(c, e):
        return [e.count_star(), e.agg("sum", 2, c.INT64)]

    want, _, _ = _budget_run(JAX, spec, 20, TF_SCHEMA, calls, capacity=128)
    got, tex, _ = _budget_run(TORCH, spec, 20, TF_SCHEMA, calls,
                              capacity=128)
    base, _, _ = _budget_run(TORCH, spec, None, TF_SCHEMA, calls,
                             capacity=128)
    assert got == want
    assert _net(got) == _net(base)


def test_agg_recovery_with_more_groups_than_budget():
    spec, k = [("b", 1, False)], 0
    for b in range(4):
        # every second barrier checkpoints, and the last one (a clean
        # shutdown)
        spec += [("c", [(k + i, b * 50 + i % 50, i) for i in range(50)],
                  None), ("b", b + 2, b % 2 == 0 or b == 3)]
        k += 50
    after = [("b", 6, False), ("c", [(9001, 0, 5), (9002, 199, 5)], None),
             ("b", 7, True)]

    def calls(c, e):
        return [e.count_star(), e.agg("sum", 2, c.INT64)]

    res = {}
    for pkg in BOTH:
        out, _, store = _budget_run(pkg, spec, 40, calls=calls)
        ex = agg_executor(pkg, after, store, schema=T_SCHEMA, keys=(1,),
                          calls=calls, table_capacity=512, out_capacity=64,
                          hbm_group_budget=40)
        res[pkg.device] = (out, ex._evicted.copy(), copy.deepcopy(ex.state),
                           pkg.drain(ex, store), store.snapshot())
    jw, tw = res[None], res["cpu"]
    assert tw[1] == jw[1] and len(tw[1]) == 160
    assert_agg_states_equal(jw[2], tw[2])
    assert (tw[0], tw[3], tw[4]) == (jw[0], jw[3], jw[4])
    assert (J.OP_UPDATE_INSERT, (199, 2, 54)) in tw[3]


L_COLS, R_COLS = ("k", "j", "a"), ("k", "j", "b")


def _join_mv_specs(n_keys=120, revisit=True, freq=2):
    left, right = [("b", 1, False)], [("b", 1, False)]
    per = 20
    for b in range(n_keys // per):
        ckpt = (b + 2) % freq == 0
        left += [("c", [(b * per + i, b * per + i, i) for i in range(per)],
                  None), ("b", b + 2, ckpt)]
        right += [("c", [(b * per + i, b * per + i, i * 2)
                         for i in range(0, per, 2)], None),
                  ("b", b + 2, ckpt)]
    if revisit:
        e = n_keys // per + 2
        left += [("c", [(9002, 4, 55)], None), ("b", e, e % freq == 0)]
        right += [("c", [(9001, 1, 77)], None), ("c", [(2, 2, 4)], [D]),
                  ("b", e, e % freq == 0)]
    return left, right


def _join_budget_run(pkg, left, right, store, **kw):
    ex = join_executor(pkg, left, right, store, schemas=(L_COLS, R_COLS),
                       keys=([1], [1]), pks=([1, 0], [1, 0]), **kw)
    return pkg.drain(ex, store), ex


def test_join_key_space_larger_than_arena():
    """60 join keys through a 64-slot arena with a 16-key budget: the
    arena keeps its size and the output equals the reference's and the
    unbudgeted run's, deletes and inserts on faulted-back keys included."""
    left, right = _join_mv_specs(n_keys=60)
    kw = dict(key_capacity=64, hbm_key_budget=16)
    want, jex = _join_budget_run(JAX, left, right, JStore(), **kw)
    got, tex = _join_budget_run(TORCH, left, right, TStore(), **kw)
    base, _ = _join_budget_run(TORCH, left, right, TStore(),
                               key_capacity=128)
    assert got == want
    assert _net(got) == _net(base) and base
    assert tex.core.capacity == 64
    assert_join_sides_equal(jex.state, tex.state)


def test_join_recovery_with_more_keys_than_budget():
    left, right = [("b", 1, False)], [("b", 1, False)]
    for b in range(3):
        rows = [(b * 20 + i, b * 20 + i, i) for i in range(20)]
        left += [("c", rows, None), ("b", b + 2, True)]
        right += [("c", rows, None), ("b", b + 2, True)]
    left2 = [("b", 8, False), ("c", [(9001, 0, 42)], None), ("b", 9, True)]
    right2 = [("b", 8, False), ("c", [(1, 1, 1)], [D]), ("b", 9, True)]
    kw = dict(key_capacity=64, hbm_key_budget=16)
    res = {}
    for pkg in BOTH:
        store = pkg.store_cls()
        out, _ = _join_budget_run(pkg, left, right, store, **kw)
        ex = join_executor(pkg, left2, right2, store,
                           schemas=(L_COLS, R_COLS), keys=([1], [1]),
                           pks=([1, 0], [1, 0]), **kw)
        res[pkg.device] = (out, ex._evicted.copy(), copy.deepcopy(ex.state),
                           pkg.drain(ex, store), store.snapshot())
    jw, tw = res[None], res["cpu"]
    assert tw[1] == jw[1] and len(tw[1]) == 60 - 16
    assert_join_sides_equal(jw[2], tw[2])
    assert (tw[0], tw[3], tw[4]) == (jw[0], jw[3], jw[4])
    assert (I, (9001, 0, 42, 0, 0, 0)) in tw[3]
