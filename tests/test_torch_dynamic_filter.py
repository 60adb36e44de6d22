"""DynamicFilter and MaterializedAgg through both packages on the CPU.

The DynamicFilter scenarios of tests/test_executors2.py, a VARCHAR key, the
``price > (SELECT max(price) FROM bid)`` shape of tests/test_frontend.py
(a SimpleAgg(max) RHS), MaterializedAgg's call kinds under retraction
(tests/test_materialized_agg.py), and checkpoint and recovery of both, run
through the reference's executors (op by op, under ``jax.disable_jit``) and
the port's (``device="cpu"``). Tolerance: exact — output rows in order
(VARCHAR decoded) and committed store bytes.
"""

import numpy as np
import pytest

import risingwave_tpu.stream.materialized_agg as JM
import risingwave_tpu_torch.stream.materialized_agg as TM
from test_torch_recovery import JAX
from test_torch_topn import both, fold, source

I, D, UD, UI = 0, 1, 2, 3
KV = (("k", "INT64"), ("v", "INT64"))
RHS = (("bound", "INT64"),)


def _df(pkg, left, right, cmp, cols=KV, rhs_cols=RHS, key_col=1, **kw):
    return pkg.stream.DynamicFilterExecutor(
        source(pkg, pkg.schema(*cols), left),
        source(pkg, pkg.schema(*rhs_cols), right),
        key_col=key_col, cmp=cmp, pk_indices=[0], table_capacity=1 << 10,
        **kw, **pkg.kw())


DF_CASES = {
    "retroactive": dict(
        left=[("b", 1, False), ("c", [(1, 10), (2, 20), (3, 30)], None),
              ("b", 2, False), ("b", 3, False)],
        right=[("b", 1, False), ("c", [(15,)], None), ("b", 2, False),
               ("c", [(15,), (25,)], [UD, UI]), ("b", 3, False)],
        cmp="greater_than", want=[(3, 30)]),
    "no_bound": dict(
        left=[("b", 1, False), ("c", [(1, 10)], None), ("b", 2, False)],
        right=[("b", 1, False), ("b", 2, False)],
        cmp="less_than", want=[]),
    "lhs_delete": dict(
        left=[("b", 1, False), ("c", [(1, 10), (2, 20)], None),
              ("b", 2, False), ("c", [(2, 20)], [D]), ("b", 3, False)],
        right=[("b", 1, False), ("c", [(5,)], None), ("b", 2, False),
               ("b", 3, False)],
        cmp="greater_than", want=[(1, 10)]),
    "bound_deleted_then_le": dict(
        left=[("b", 1, False), ("c", [(1, 10), (2, 20), (3, 5)], None),
              ("b", 2, False), ("c", [(4, 7), (1, 10), (1, 1)],
                                [I, UD, UI]), ("b", 3, False),
              ("b", 4, False)],
        right=[("b", 1, False), ("c", [(10,)], None), ("b", 2, False),
               ("c", [(10,)], [D]), ("b", 3, False), ("c", [(7,)], None),
               ("b", 4, False)],
        cmp="less_than_or_equal", want=[(1, 1), (3, 5), (4, 7)]),
}


@pytest.mark.parametrize("name", sorted(DF_CASES))
def test_dynamic_filter_scenarios(name):
    case = dict(DF_CASES[name])
    want = case.pop("want")
    assert fold(both(lambda pkg: pkg.drain(_df(pkg, **case)))) == want


def test_dynamic_filter_varchar_key():
    """A VARCHAR key compares by the dictionary's ranks; the bound moves
    to a string interned after the rows."""
    cols = (("k", "INT64"), ("s", "VARCHAR"))
    words = ["pear", "apple", "Zebra", "mango", "", "kiwi"]
    left = [("b", 1, False),
            ("c", [(i, w) for i, w in enumerate(words)], None),
            ("b", 2, False), ("b", 3, False)]
    right = [("b", 1, False), ("c", [("kiwi",)], None), ("b", 2, False),
             ("c", [("kiwi",), ("banana",)], [UD, UI]), ("b", 3, False)]
    rows = both(lambda pkg: pkg.drain(_df(
        pkg, left, right, "greater_than_or_equal", cols=cols,
        rhs_cols=(("b", "VARCHAR"),))))
    assert fold(rows) == sorted((i, w) for i, w in enumerate(words)
                                if w >= "banana")


def test_dynamic_filter_fed_by_simple_agg_max():
    """``price > (SELECT max(price) FROM bid)``: each epoch's rows pass
    only until a later epoch raises the max past them."""
    rng = np.random.default_rng(4)
    bids = [[(int(k), int(p)) for k, p in
             zip(range(e * 20, e * 20 + 20), rng.integers(0, 100, 20))]
            for e in range(3)]

    def run(pkg):
        c, e = pkg.common, pkg.expr
        schema = pkg.schema(*KV)
        spec = [("b", 1, False)]
        for n, rows in enumerate(bids):
            spec += [("c", rows, None), ("b", 2 + n, False)]
        rhs = pkg.stream.SimpleAggExecutor(
            source(pkg, schema, spec), [e.agg("max", 1, c.INT64)],
            **pkg.kw())
        ex = pkg.stream.DynamicFilterExecutor(
            source(pkg, schema, spec), rhs, key_col=1,
            cmp="greater_than_or_equal", pk_indices=[0],
            table_capacity=1 << 10, **pkg.kw())
        return pkg.drain(ex)

    every = [r for rows in bids for r in rows]
    top = max(p for _, p in every)
    assert fold(both(run)) == sorted(r for r in every if r[1] >= top)


def test_dynamic_filter_checkpoint_recovery():
    def run(pkg):
        store = pkg.store_cls()
        schema = pkg.schema(*KV)
        bschema = pkg.schema(("id", "INT64"), ("value", "INT64"))

        def ex(left, right):
            with pkg.eager():
                return _df(pkg, left, right, "greater_than",
                           state_table=pkg.table_cls(store, 3, schema, [0]),
                           bound_table=pkg.table_cls(store, 4, bschema, [0]))

        first = pkg.drain(ex(
            [("b", 1, False), ("c", [(1, 10), (2, 20), (3, 30)], None),
             ("b", 2, True)],
            [("b", 1, False), ("c", [(15,)], None), ("b", 2, True)]), store)
        second = pkg.drain(ex(
            [("b", 3, False), ("c", [(4, 40), (3, 30)], [I, D]),
             ("b", 4, True)],
            [("b", 3, False), ("c", [(15,), (25,)], [UD, UI]),
             ("b", 4, True)]), store)
        return first, second, store.snapshot()

    first, second, _ = both(run)
    assert fold(first + second) == [(4, 40)]
    assert (D, (2, 20)) in second


# ---------------------------------------------------------------------------
# MaterializedAgg
# ---------------------------------------------------------------------------

GKV = (("g", "INT64"), ("v", "INT64"), ("s", "VARCHAR"))


def _mat_calls(pkg):
    c, e = pkg.common, pkg.expr
    A = e.AggCall
    return [A("count", -1), A("count", 1, c.INT64, distinct=True),
            A("sum", 1, c.INT64, distinct=True), A("min", 1, c.INT64),
            A("max", 2, c.VARCHAR), A("min", 2, c.VARCHAR),
            A("avg", 1, c.INT64, distinct=True), A("mode", 1, c.INT64),
            A("percentile_cont", 1, c.INT64, extra=0.25),
            A("string_agg", 2, c.VARCHAR, extra=",")]


MAT_SPEC = [
    ("b", 1, False),
    ("c", [(1, 10, "b"), (1, 10, "a"), (1, 20, "c"), (2, 5, "z"),
           (2, None, None)], None),
    ("b", 2, True),
    ("c", [(1, 10, "a"), (1, 20, "c"), (2, 7, "y")], [D, D, I]),
    ("b", 3, True),
    ("c", [(2, 5, "z"), (2, None, None), (2, 7, "y")], [D, D, D]),
    ("b", 4, True),
]


def test_materialized_agg_kinds_and_recovery():
    """Every call kind under retraction, a group that empties, and a
    recovery after epoch 2 that continues with the same rows."""
    def run(pkg):
        store = pkg.store_cls()
        calls = _mat_calls(pkg)
        schema = pkg.schema(*GKV)
        mod = JM if pkg is JAX else TM
        sch = mod.materialized_agg_state_schema((schema[0],))

        def ex(spec, st):
            with pkg.eager():
                return mod.MaterializedAggExecutor(
                    source(pkg, schema, spec), [0], calls,
                    state_table=pkg.table_cls(st, 9, sch, list(range(6))),
                    **pkg.kw())

        other = pkg.store_cls()
        whole = pkg.drain(ex(MAT_SPEC, other), other)
        first = pkg.drain(ex(MAT_SPEC[:3], store), store)
        second = pkg.drain(ex([("b", 2, False)] + MAT_SPEC[3:], store),
                           store)
        return whole, first + second, store.snapshot()

    whole, resumed, _ = both(run)
    assert resumed == whole
    assert fold(whole) == [(1, 1, 1, 10, 10, "b", "b", 10.0, 10, 10.0, "b")]


def test_global_materialized_agg_q102_rhs():
    """q102's right side: count(*) and count(DISTINCT auction) over bids,
    one global group that shows (0, 0) before any input."""
    def run(pkg):
        c, e = pkg.common, pkg.expr
        schema = pkg.schema(("auction", "INT64"))
        spec = [("b", 1, False), ("b", 2, False),
                ("c", [(1,), (1,), (2,), (3,), (3,), (3,)], None),
                ("b", 3, False), ("c", [(3,)], [D]), ("b", 4, False)]
        mod = JM if pkg is JAX else TM
        return pkg.drain(mod.MaterializedAggExecutor(
            source(pkg, schema, spec), [],
            [e.count_star(), e.agg("count", 0, c.INT64, distinct=True)],
            **pkg.kw()))

    rows = both(run)
    assert rows[0] == (I, (0, 0)) and fold(rows) == [(5, 3)]


def test_materialized_routing():
    from risingwave_tpu_torch.expr import AggCall
    from risingwave_tpu_torch.common import INT64, VARCHAR
    assert TM.call_needs_materialized(AggCall("count", 0, INT64, True), True)
    assert TM.call_needs_materialized(AggCall("max", 0, VARCHAR), False)
    assert not TM.call_needs_materialized(AggCall("max", 0, VARCHAR), True)
    assert not TM.call_needs_materialized(AggCall("sum", 0, INT64), False)
