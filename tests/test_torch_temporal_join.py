"""TemporalJoin (``FOR SYSTEM_TIME AS OF PROCTIME()``) and NEXmark q13
through both packages on the CPU.

The cases of tests/test_temporal_join.py as executors: the table side is a
StateTable in each package's store, written and committed between epochs,
and the probe stream is scripted. Inner and left joins, a point get by the
table's pk and an index over a non-pk key with a condition, and no
retraction when the table changes. The ``q13`` tree
(``stream/nexmark_plans.py``) joins the port's generated bids with a
10,000-row side table, loaded through Values → Materialize, and is held to
a numpy lookup of ``auction % 10000``. Tolerance: exact.
"""

import asyncio

import numpy as np
import pytest

import risingwave_tpu.stream.temporal_join as JTJ
import risingwave_tpu_torch.stream.nexmark_plans as plans
import risingwave_tpu_torch.stream.temporal_join as TTJ
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.connector.nexmark import BID_SCHEMA
from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
from risingwave_tpu_torch.stream import (
    Barrier, MaterializeExecutor, MockSource, ValuesExecutor,
)
from test_torch_eowc import events
from test_torch_recovery import BOTH, JAX

I, D = 0, 1
ORDERS = (("oid", "INT64"), ("item", "INT64"), ("qty", "INT64"))
PRICE = (("item", "INT64"), ("p", "INT64"))


class Probe:
    """A scripted probe stream whose barriers run table writes first, as
    the Session runs the table's job before the probe's in an epoch."""

    def __init__(self, pkg, schema, spec, writes):
        self.pkg, self.schema = pkg, schema
        self.msgs = pkg.messages(schema, spec)
        self.writes = writes

    async def execute(self):
        for m in self.msgs:
            if isinstance(m, self.pkg.stream.Barrier):
                for w in self.writes.get(m.epoch.curr, ()):
                    w()
            yield m


def temporal(pkg, spec, table_rows, left_keys=(1,), right_keys=(0,),
             **kw):
    """``table_rows``: epoch -> rows upserted into the price table just
    before that epoch's barrier reaches the join."""
    store = pkg.store_cls()
    table = pkg.table_cls(store, 9, pkg.schema(*PRICE), [0])

    def write(rows, epoch):
        def go():
            for r in rows:
                table.insert(r)
            table.commit(epoch)
            store.commit(epoch)
        return go

    writes = {e: [write(rows, e)] for e, rows in table_rows.items()}
    probe = Probe(pkg, pkg.schema(*ORDERS), spec, writes)
    with pkg.eager():
        mod = JTJ if pkg is JAX else TTJ
        return mod.TemporalJoinExecutor(
            probe, table, list(left_keys), list(right_keys),
            **pkg.kw(out_capacity=4, **kw))


def probe_rows(pkg, ex):
    return [r for r in events(pkg, ex) if r[0] not in ("wm", "barrier")]


def test_enrichment_without_retraction_as_reference():
    """test_enrichment_no_retraction: a price change retracts nothing; a
    later order sees the new price."""
    spec = [("b", 1, False), ("c", [(10, 1, 3)], None), ("b", 2, False),
            ("b", 3, False), ("c", [(11, 1, 1), (12, 2, 4)], None),
            ("b", 4, False)]
    tables = {1: [(1, 100), (2, 200)], 3: [(1, 999)]}
    got = [probe_rows(pkg, temporal(pkg, spec, tables)) for pkg in BOTH]
    assert got[1] == got[0]
    assert got[0] == [(I, (10, 1, 3, 1, 100)), (I, (11, 1, 1, 1, 999)),
                      (I, (12, 2, 4, 2, 200))]


def test_left_temporal_join_pads_nulls_as_reference():
    spec = [("b", 1, False), ("c", [(10, 7, 1), (11, 2, 1), (12, None, 1)],
                                   None), ("b", 2, False)]
    got = [probe_rows(pkg, temporal(pkg, spec, {1: [(2, 200)]}, outer=True))
           for pkg in BOTH]
    assert got[1] == got[0]
    assert got[0] == [(I, (10, 7, 1, None, None)), (I, (11, 2, 1, 2, 200)),
                      (I, (12, None, 1, None, None))]


def test_non_pk_key_index_and_condition_as_reference():
    """Probing by the table's non-pk column builds an index per chunk
    (several matches per key); the condition filters the joined rows."""
    def cond(pkg):
        c, e = pkg.common, pkg.expr
        return e.call("greater_than", e.col(4, c.INT64), e.col(2, c.INT64))

    spec = [("b", 1, False), ("c", [(10, 1, 150), (11, 5, 0)], None),
            ("b", 2, False)]
    tables = {1: [(1, 100), (2, 200), (3, 100), (4, 300)]}
    got = [probe_rows(pkg, temporal(pkg, spec, tables, left_keys=(1,),
                                    right_keys=(1,), condition=cond(pkg)))
           for pkg in BOTH]
    assert got[1] == got[0]
    assert got[0] == []
    spec = [("b", 1, False), ("c", [(10, 100, 50)], None), ("b", 2, False)]
    got = [probe_rows(pkg, temporal(pkg, spec, tables, left_keys=(1,),
                                    right_keys=(1,), condition=cond(pkg)))
           for pkg in BOTH]
    assert got[1] == got[0]
    assert sorted(got[0]) == [(I, (10, 100, 50, 1, 100)),
                              (I, (10, 100, 50, 3, 100))]


def test_retracting_probe_rejected():
    spec = [("b", 1, False), ("c", [(10, 1, 3)], [D]), ("b", 2, False)]
    for pkg in BOTH:
        with pytest.raises(AssertionError, match="append-only"):
            probe_rows(pkg, temporal(pkg, spec, {1: [(1, 100)]}))


def side_rows(n=10_000, seed=42):
    """The side table: key 0..n-1, a value drawn from the seed."""
    rng = np.random.default_rng(seed)
    return [(k, f"side-{int(v)}") for k, v in
            enumerate(rng.integers(0, 1 << 30, n))]


def load_side_input(store, rows):
    """Values → Materialize into the side table, one epoch, committed."""
    table = StateTable(store, 2, plans.side_input_schema(), [0])
    barriers = MockSource(plans.side_input_schema(),
                          [Barrier.new(1), Barrier.new(2, checkpoint=True)])
    mv = MaterializeExecutor(ValuesExecutor(
        plans.side_input_schema(), rows, barriers, capacity=1024,
        device="cpu"), table)
    events_into(mv, store)
    return table


def events_into(ex, store):
    async def run():
        async for m in ex.execute():
            if isinstance(m, Barrier) and m.checkpoint:
                store.commit(m.epoch.curr)

    asyncio.run(run())


def test_q13_equals_numpy_lookup():
    store = MemoryStateStore()
    side = side_rows()
    table = load_side_input(store, side)
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=64), seed=42,
                           device="cpu")
    chunks = [gen.next_bid_chunk() for _ in range(4)]
    msgs = [Barrier.new(3)]
    for i, c in enumerate(chunks):
        msgs += [c, Barrier.new(4 + i, checkpoint=True)]
    plan = plans.q13(MockSource(BID_SCHEMA, msgs), table,
                     StateTable(store, 1, plans.q13_schema(), [5]),
                     out_capacity=64, device="cpu")
    events_into(plan.mv, store)
    want = sorted(
        (int(a), int(b), int(p), int(t), side[int(a) % 10_000][1])
        for c in chunks for a, b, p, t, v in zip(
            c.columns[0].data, c.columns[1].data, c.columns[2].data,
            c.columns[5].data, c.vis) if v)
    got = sorted(r[:5] for r in plan.mv.rows())
    assert got == want and len(got) == 4 * 64
