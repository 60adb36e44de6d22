"""HopWindow and NEXmark q5 over HOP windows through both packages on the
CPU.

HopWindow runs the same scripted chunks in the reference's executor (op by
op, under ``jax.disable_jit``) and the port's (``device="cpu"``): negative
timestamps (floor division), size = slide, and rows on a window's edges. The
ChunkBatch path is held to the per-chunk path, and the port's ``q5_hop`` tree
(``stream/nexmark_plans.py``) to the reference Session's q5 MV for the SQL
of tests/test_nexmark_queries.py and to a numpy evaluation of q5 over bids
spread across many windows. Tolerance: exact (integer data).
"""

import asyncio
import collections

import pytest

import risingwave_tpu_torch.stream.nexmark_plans as plans
from risingwave_tpu.frontend.build import BuildConfig
from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.common import ChunkBatch, stack_chunks
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.connector.nexmark import BID_SCHEMA
from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
from risingwave_tpu_torch.stream import (
    Barrier, HopWindowExecutor, MockSource,
)
from test_nexmark_queries import CAP, DDL
from test_torch_nexmark_mv import SESSION_CONFIG
from test_torch_recovery import BOTH, TORCH

SEC = 1_000_000
TS = (("k", "INT64"), ("ts", "TIMESTAMP"))
Q5_SQL = """CREATE MATERIALIZED VIEW q5 AS
    SELECT AuctionBids.auction, AuctionBids.num FROM (
        SELECT bid.auction, count(*) AS num, window_start AS starttime
        FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
        GROUP BY window_start, bid.auction
    ) AS AuctionBids
    JOIN (
        SELECT max(CountBids.num) AS maxn, CountBids.starttime_c
        FROM (
            SELECT count(*) AS num, window_start AS starttime_c
            FROM HOP(bid, date_time, INTERVAL '2' SECOND,
                     INTERVAL '10' SECOND)
            GROUP BY bid.auction, window_start
        ) AS CountBids
        GROUP BY CountBids.starttime_c
    ) AS MaxBids
    ON AuctionBids.starttime = MaxBids.starttime_c
       AND AuctionBids.num = MaxBids.maxn"""


def drain(pkg, ex) -> list:
    """Every output row (op, row) in order, a ChunkBatch chunk by chunk."""
    async def run():
        out = []
        async for m in ex.execute():
            if isinstance(m, ChunkBatch):
                chunks = [m.at(i) for i in range(m.num_chunks)]
            elif isinstance(m, (pkg.stream.Barrier, pkg.stream.Watermark)):
                continue
            else:
                chunks = [m]
            for c in chunks:
                out.extend(pkg.common.chunk_to_rows(c, ex.schema,
                                                    with_ops=True))
        return out

    with pkg.eager():
        return asyncio.run(run())


def hop_rows(pkg, spec, slide, size, capacity=8):
    schema = pkg.schema(*TS)
    src = pkg.stream.MockSource(schema, pkg.messages(schema, spec,
                                                     capacity))
    with pkg.eager():
        ex = pkg.stream.HopWindowExecutor(src, 1, slide, size)
    return drain(pkg, ex)


EDGE_ROWS = [(1, 0), (2, -1), (3, -7), (4, 5), (5, 6), (6, -6), (7, None),
             (8, 11), (9, -12)]


@pytest.mark.parametrize("slide,size", [(3, 6), (2, 10), (4, 4), (5, 15)])
def test_hop_window_equals_reference(slide, size):
    """Negative timestamps round down; a row at a window's start is in it,
    one at its end is not; a NULL time is in no window."""
    spec = [("b", 1, False), ("c", EDGE_ROWS[:5], None),
            ("c", EDGE_ROWS[5:], None), ("b", 2, False)]
    got = [hop_rows(pkg, spec, slide, size) for pkg in BOTH]
    assert got[1] == got[0]
    n = size // slide
    assert len(got[0]) == n * (len(EDGE_ROWS) - 1)
    for _, (k, ts, ws, we) in got[0]:
        assert ws <= ts < we and we - ws == size and ws % slide == 0


def test_hop_window_rejects_size_not_a_multiple_of_slide():
    schema = TORCH.schema(*TS)
    with pytest.raises(ValueError):
        HopWindowExecutor(MockSource(schema, []), 1, 3, 7)


def test_hop_window_batch_equals_chunk_path():
    """K chunks in one ChunkBatch give n·K chunks in the per-chunk path's
    order (the hop offset inside each chunk)."""
    rows = [[(i * 10 + j, (i * 7 + j * 3) % 40 - 20) for j in range(5)]
            for i in range(4)]
    per_chunk = [("b", 1, False)] + [("c", r, None) for r in rows] + [
        ("b", 2, False)]
    batched = [("b", 1, False), ("k", [(r, None) for r in rows]),
               ("b", 2, False)]
    assert hop_rows(TORCH, batched, 2, 6) == hop_rows(TORCH, per_chunk, 2, 6)


def bid_source(ticks, chunk=CAP, cfg=None, batch=False, device="cpu"):
    """The port's host generator (seed 42): a chunk (or a one-chunk batch),
    then a checkpoint barrier, per tick, as the Session ticks a source."""
    gen = NexmarkGenerator(cfg or NexmarkConfig(chunk_capacity=chunk),
                           seed=42, device=device)
    msgs = [Barrier.new(1)]
    for t in range(ticks):
        c = gen.next_bid_chunk()
        msgs += [stack_chunks([c]) if batch else c,
                 Barrier.new(t + 2, checkpoint=True)]
    return MockSource(BID_SCHEMA, msgs)


def run_q5_hop(ticks, cfg=None, batch=False, device="cpu"):
    store = MemoryStateStore()
    plan = plans.q5_hop(bid_source(ticks, cfg=cfg, batch=batch,
                                   device=device),
                        bid_source(ticks, cfg=cfg, batch=batch,
                                   device=device),
                        StateTable(store, 1, plans.q5_hop_schema(),
                                   [2, 0, 3]),
                        agg_capacity=1 << 10, key_capacity=1 << 8,
                        bucket_width=64, out_capacity=64, device=device)

    async def run():
        async for m in plan.mv.execute():
            if isinstance(m, Barrier) and m.checkpoint:
                store.commit(m.epoch.curr)

    asyncio.run(run())
    return plan


def test_q5_hop_equals_reference_session():
    """The port's tree against the reference planner's, through the
    reference Session, on the same bids (4 ticks of 64)."""
    s = Session(source_chunk_capacity=CAP, chunks_per_tick=1,
                config=BuildConfig(**SESSION_CONFIG))
    s.run_sql(DDL)
    s.run_sql(Q5_SQL)
    for _ in range(4):
        s.tick()
    want = sorted(s.mv_rows("q5"))
    s.close()
    got = sorted(r[:2] for r in run_q5_hop(4).mv.rows())
    assert got == want and len(got) > 0


def q5_numpy(bids, slide=2 * SEC, size=10 * SEC):
    """tests/test_nexmark_queries.py's q5 evaluation."""
    counts = collections.defaultdict(int)
    for auction, ts in bids:
        base = (ts // slide) * slide
        for i in range(size // slide):
            ws = base - i * slide
            if ws <= ts < ws + size:
                counts[(ws, auction)] += 1
    maxn = collections.defaultdict(int)
    for (ws, _), c in counts.items():
        maxn[ws] = max(maxn[ws], c)
    return sorted((a, c, ws) for (ws, a), c in counts.items()
                  if c == maxn[ws])


@pytest.mark.parametrize("batch", [False, True])
def test_q5_hop_across_windows_equals_numpy(batch):
    """Bids 20 ms apart (events_per_second 50): 12 ticks of 64 bids cross
    ~8 slides, so windows open and close, counts retract, and the max per
    window moves."""
    cfg = NexmarkConfig(chunk_capacity=CAP, events_per_second=50)
    plan = run_q5_hop(12, cfg=cfg, batch=batch)
    gen = NexmarkGenerator(cfg, seed=42, device="cpu")
    bids = []
    for _ in range(12):
        c = gen.next_bid_chunk()
        bids += [(int(a), int(t)) for a, t, v in zip(
            c.columns[0].data, c.columns[5].data, c.vis) if v]
    want = q5_numpy(bids)
    got = sorted((r[0], r[1], r[2]) for r in plan.mv.rows())
    assert got == want
    assert len({w for _, _, w in want}) > 5
