"""TopN, GroupTopN and SimpleAgg executors through both packages on the
CPU.

The executor scenarios of tests/test_executors2.py (SimpleAgg,
StatelessSimpleAgg, TopN) and the TopN batch case of
tests/test_batched_ingest.py run through the reference's executors (op by
op, under ``jax.disable_jit``) and the port's (``device="cpu"``); the TopN
state after churn is carried across with ``interop``. The incremental TopN
cases are in tests/test_torch_topn_incremental.py, the row set and the
flush functions on random states in tests/test_torch_row_set.py.
Tolerance: exact everywhere — output rows in order, committed store bytes
and state slot for slot.
"""

import random

import jax
import numpy as np
import pytest
import torch

import risingwave_tpu.ops.topn as JT
import risingwave_tpu_torch.ops.topn as TT
from risingwave_tpu.stream.simple_agg import (
    simple_agg_state_schema as j_simple_schema,
)
from risingwave_tpu_torch.interop import (
    simple_agg_state_from_jax, topn_state_from_jax,
)
from risingwave_tpu_torch.stream.simple_agg import (
    simple_agg_state_schema as t_simple_schema,
)
from test_torch_recovery import BOTH, JAX, np_of

I, D, UD, UI = 0, 1, 2, 3


def both(fn):
    """``fn(pkg)`` for each package; the two results must be equal."""
    got = [fn(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    return got[0]


def order_spec(pkg, *args, **kw):
    mod = JT if pkg is JAX else TT
    return mod.OrderSpec(*args, **kw)


def source(pkg, schema, spec):
    return pkg.stream.MockSource(schema, pkg.messages(schema, spec))


def fold(rows):
    acc: dict = {}
    for op, row in rows:
        acc[row] = acc.get(row, 0) + (1 if op in (I, UI) else -1)
    assert all(n >= 0 for n in acc.values()), acc
    return sorted(r for r, n in acc.items() if n > 0)

# ---------------------------------------------------------------------------
# SimpleAgg / StatelessSimpleAgg (tests/test_executors2.py)
# ---------------------------------------------------------------------------

KV = (("k", "INT64"), ("v", "INT64"))


def _calls(pkg, *spec):
    e, c = pkg.expr, pkg.common
    return [e.count_star() if k == "count*" else e.agg(k, 1, c.INT64)
            for k in spec]


def test_simple_agg_initial_row_then_updates():
    def run(pkg):
        schema = pkg.schema(*KV)
        src = source(pkg, schema, [
            ("b", 1, False), ("b", 2, False),
            ("c", [(1, 10), (2, 20)], None), ("b", 3, False),
            ("c", [(1, 10)], [D]), ("b", 4, False)])
        ex = pkg.stream.SimpleAggExecutor(
            src, _calls(pkg, "count*", "sum", "min"), **pkg.kw())
        return pkg.drain(ex)

    rows = both(run)
    assert rows[0] == (I, (0, None, None))
    assert (UI, (2, 30, 10)) in rows


def test_simple_agg_checkpoint_recovery():
    def run(pkg):
        store = pkg.store_cls()
        calls = _calls(pkg, "count*", "sum")
        sch = (j_simple_schema if pkg is JAX else t_simple_schema)(calls)
        schema = pkg.schema(*KV)

        def table():
            return pkg.table_cls(store, 7, sch, [0])

        with pkg.eager():
            ex = pkg.stream.SimpleAggExecutor(
                source(pkg, schema, [("b", 1, False),
                                     ("c", [(1, 10), (2, 32)], None),
                                     ("b", 2, True)]),
                calls, state_table=table(), **pkg.kw())
        first = pkg.drain(ex, store)
        with pkg.eager():
            ex2 = pkg.stream.SimpleAggExecutor(
                source(pkg, schema, [("b", 3, False),
                                     ("c", [(3, 8)], None),
                                     ("b", 4, True)]),
                calls, state_table=table(), **pkg.kw())
        lanes = [int(np_of(x)) for x in ex2.state.lanes]
        return first, pkg.drain(ex2, store), lanes, store.snapshot()

    first, second, lanes, _ = both(run)
    assert lanes == [2, 2, 42]
    assert second == [(UD, (2, 42)), (UI, (3, 50))]


def test_stateless_simple_agg_partials():
    def run(pkg):
        schema = pkg.schema(*KV)
        src = source(pkg, schema, [
            ("b", 1, False), ("c", [(1, 10), (2, 20)], None),
            ("c", [(1, 5)], [D]), ("b", 2, False)])
        return pkg.drain(pkg.stream.StatelessSimpleAggExecutor(
            src, _calls(pkg, "count*", "sum")))

    assert both(run) == [(I, (2, 30)), (I, (-1, -5))]


def test_simple_agg_state_carries_across():
    """The reference's SimpleAggState after an epoch, carried into the
    port, gives the port's own state."""
    schema_spec = [("b", 1, False), ("c", [(1, 10), (2, 20), (3, 5)], None),
                   ("c", [(2, 20)], [D]), ("b", 2, False)]
    exs = []
    for pkg in BOTH:
        ex = pkg.stream.SimpleAggExecutor(
            source(pkg, pkg.schema(*KV), schema_spec),
            _calls(pkg, "count*", "sum", "max", "avg"), **pkg.kw())
        pkg.drain(ex)
        exs.append(ex)
    carried = simple_agg_state_from_jax(
        jax.tree_util.tree_map(np.asarray, exs[0].state), "cpu")
    for a, b in zip(carried.lanes + carried.prev_lanes,
                    exs[1].state.lanes + exs[1].state.prev_lanes):
        assert torch.equal(a, b)
    assert bool(carried.ever_emitted) and not bool(carried.dirty)

# ---------------------------------------------------------------------------
# TopN / GroupTopN (tests/test_executors2.py)
# ---------------------------------------------------------------------------


def _topn(pkg, spec, limit, offset=0, order=None, schema_cols=KV,
          pk=(0,), group_by=(), **kw):
    schema = pkg.schema(*schema_cols)
    order = order or [(1,)]
    return pkg.stream.TopNExecutor(
        source(pkg, schema, spec),
        [order_spec(pkg, *o) if isinstance(o, tuple)
         else order_spec(pkg, **o) for o in order],
        offset, limit, pk_indices=list(pk), group_by=list(group_by),
        table_capacity=1 << 10, **kw, **pkg.kw())


TOPN_CASES = {
    "insert_evict": dict(spec=[
        ("b", 1, False), ("c", [(1, 50), (2, 30), (3, 40)], None),
        ("b", 2, False), ("c", [(4, 10)], None), ("b", 3, False)],
        limit=2, want=[(2, 30), (4, 10)]),
    "delete_backfills": dict(spec=[
        ("b", 1, False), ("c", [(1, 10), (2, 20), (3, 30), (4, 40)], None),
        ("b", 2, False), ("c", [(1, 10)], [D]), ("b", 3, False)],
        limit=2, want=[(2, 20), (3, 30)]),
    "offset_update": dict(spec=[
        ("b", 1, False), ("c", [(1, 10), (2, 20), (3, 30), (4, 40)], None),
        ("b", 2, False), ("c", [(1, 10), (1, 99)], [UD, UI]),
        ("b", 3, False)],
        limit=2, offset=1, want=[(3, 30), (4, 40)]),
    "desc_with_ties": dict(spec=[
        ("b", 1, False),
        ("c", [(1, 50), (2, 50), (3, 40), (4, 50), (5, 60)], None),
        ("b", 2, False)],
        limit=2, order=[dict(col=1, desc=True)], with_ties=True,
        want=[(1, 50), (2, 50), (4, 50), (5, 60)]),
}


@pytest.mark.parametrize("name", sorted(TOPN_CASES))
def test_topn_scenarios(name):
    case = dict(TOPN_CASES[name])
    want = case.pop("want")
    rows = both(lambda pkg: pkg.drain(_topn(pkg, **case)))
    assert fold(rows) == want


@pytest.mark.parametrize("with_ties", [False, True])
def test_group_topn(with_ties):
    spec = [("b", 1, False),
            ("c", [(1, 1, 30), (1, 2, 10), (1, 3, 20), (2, 4, 5),
                   (2, 5, 50), (2, 7, 5)], None),
            ("b", 2, False), ("c", [(2, 6, 1), (1, 3, 20)], [I, D]),
            ("b", 3, False)]
    cols = (("g", "INT64"), ("k", "INT64"), ("v", "INT64"))
    rows = both(lambda pkg: pkg.drain(_topn(
        pkg, spec, 1, order=[(2,)], schema_cols=cols, pk=(1,),
        group_by=(0,), with_ties=with_ties)))
    assert fold(rows) == [(1, 2, 10), (2, 6, 1)]


@pytest.mark.parametrize("group", [False, True])
def test_topn_append_only(group):
    """Declared append-only: inserts flow as without the flag; a delete is
    an error at the next barrier, in both packages."""
    cols = (("g", "INT64"), ("k", "INT64"), ("v", "INT64"))
    ins = [("b", 1, False), ("c", [(1, 1, 5), (1, 2, 3), (2, 3, 9)], None),
           ("b", 2, False)]

    def run(pkg, spec):
        return pkg.drain(_topn(pkg, spec, 1, order=[(2,)], schema_cols=cols,
                               pk=(1,), group_by=(0,) if group else (),
                               append_only=True))

    rows = both(lambda pkg: run(pkg, ins))
    assert fold(rows) == ([(1, 2, 3), (2, 3, 9)] if group else [(1, 2, 3)])
    bad = ins + [("c", [(1, 2, 3)], [D]), ("b", 3, False)]
    for pkg in BOTH:
        with pytest.raises(RuntimeError, match="append-only"):
            run(pkg, bad)


def lazy_source(pkg, schema, spec):
    """A source that makes each chunk (interning its strings) only when
    the executors reach it, so the dictionary grows mid-run."""
    class Lazy(pkg.stream.MockSource):
        async def execute(self):
            for item in spec:
                for m in pkg.messages(schema, [item]):
                    yield m

    return Lazy(schema, [])


def test_topn_refill_forced_by_dictionary_growth():
    """Ordered by a VARCHAR column: a flush after the dictionary grew is a
    full refill (the new strings re-rank the keys); a flush with no new
    string takes the fast path. The same rows and counts in both."""
    cols = (("k", "INT64"), ("s", "VARCHAR"))
    tag = "topn-growth-"
    spec = [("b", 1, False),
            ("c", [(1, tag + "m"), (2, tag + "c"), (3, tag + "x"),
                   (4, tag + "f")], None), ("b", 2, False),
            ("c", [(5, tag + "a")], None), ("b", 3, False),       # grows
            ("c", [(6, tag + "c")], None), ("b", 4, False),       # no growth
            ("c", [(2, tag + "c")], [D]), ("b", 5, False),
            ("c", [(7, tag + "b")], None), ("b", 6, False)]       # grows

    def run(pkg):
        ex = pkg.stream.TopNExecutor(
            lazy_source(pkg, pkg.schema(*cols), spec),
            [order_spec(pkg, 1, is_string=True)], 0, 3, pk_indices=[0],
            table_capacity=1 << 10, **pkg.kw())
        return pkg.drain(ex), ex.n_fast_flushes, ex.n_refills

    rows, fast, refills = both(run)
    assert fold(rows) == [(5, tag + "a"), (6, tag + "c"), (7, tag + "b")]
    assert (fast, refills) == (2, 3)


def test_topn_checkpoint_recovery():
    def run(pkg):
        store = pkg.store_cls()
        schema = pkg.schema(*KV)

        def ex(spec):
            with pkg.eager():
                return _topn(pkg, spec, 2, state_table=pkg.table_cls(
                    store, 11, schema, [0]))

        first = pkg.drain(ex([("b", 1, False),
                              ("c", [(1, 10), (2, 20), (3, 30)], None),
                              ("b", 2, True)]), store)
        e2 = ex([("b", 3, False), ("c", [(1, 10), (5, 1)], [D, I]),
                 ("b", 4, True)])
        emitted = np_of(e2.state.rows.emitted).tolist()
        return first, pkg.drain(e2, store), emitted, store.snapshot()

    first, second, _, _ = both(run)
    assert fold(first + second) == [(2, 20), (5, 1)]


# ---------------------------------------------------------------------------
# TopN state carried across, batched ingest
# ---------------------------------------------------------------------------

def _churn(seed: int, ticks: int):
    rng = random.Random(seed)
    live: dict = {}
    spec = [("b", 1, False)]
    for epoch in range(2, ticks + 2):
        rows, ops = [], []
        for _ in range(rng.randint(1, 12)):
            if live and rng.random() < 0.45:
                k = rng.choice(sorted(live))
                rows.append((k, live.pop(k)))
                ops.append(D)
            else:
                k, v = rng.randint(0, 10_000), rng.randint(0, 500)
                if k in live:
                    continue
                live[k] = v
                rows.append((k, v))
                ops.append(I)
        if rows:
            spec.append(("c", rows, ops))
        spec.append(("b", epoch, False))
    return spec, live


def test_topn_batch_matches_per_chunk():
    """A ChunkBatch (K applies, no host sync) gives the per-chunk rows."""
    cols = (("v", "INT64"), ("pk", "INT64"))
    chunks = [([(5, 1), (3, 2), (8, 3)], None), ([(1, 4), (9, 5)], None),
              ([(3, 2)], [D]), ([(0, 6), (7, 7)], None)]
    per_chunk = [("b", 1, False)] + [("c", r, o) for r, o in chunks] + [
        ("b", 2, False)]
    batched = [("b", 1, False), ("k", chunks), ("b", 2, False)]

    def run(pkg, spec):
        return pkg.drain(_topn(pkg, spec, 3, order=[(0,)], schema_cols=cols,
                               pk=(1,), out_capacity=32))

    base = both(lambda pkg: run(pkg, per_chunk))
    assert both(lambda pkg: run(pkg, batched)) == base

def test_topn_state_carries_across():
    """The reference's TopNState after two epochs of churn, carried into
    the port, equals the port's own state slot for slot."""
    spec, _ = _churn(3, 6)
    exs = []
    for pkg in BOTH:
        ex = _topn(pkg, spec, 4)
        pkg.drain(ex)
        exs.append(ex)
    carried = topn_state_from_jax(
        jax.tree_util.tree_map(np.asarray, exs[0].state), "cpu")
    mine = exs[1].state
    for a, b in ((carried.cand, mine.cand), (carried.t1, mine.t1),
                 (carried.rows.live, mine.rows.live),
                 (carried.rows.emitted, mine.rows.emitted),
                 (carried.rows.table.occupied, mine.rows.table.occupied)):
        assert torch.equal(a, b)
    for a, b in zip(carried.rows.cols, mine.rows.cols):
        assert torch.equal(a.data, b.data) and torch.equal(a.mask, b.mask)
