"""NEXmark q105 and q18 as the port's executor trees on the CPU, against
the reference's ``Session`` running the same SQL and against the
recomputation of tests/test_nexmark_extended.py (q102 is in
tests/test_torch_nexmark_q102.py, so that each file runs one Session join).

The trees (``stream/nexmark_plans.py``) are the reference planner's,
executor for executor, fed by the port's host generator (seed 42, one chunk
of 64 rows per source per tick, as the Session ticks its sources). The MV
rows must equal the Session's exactly (VARCHAR decoded).
"""

import asyncio
import collections

import pytest

import risingwave_tpu_torch.stream.nexmark_plans as plans
from risingwave_tpu.frontend.build import BuildConfig
from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.connector.nexmark import AUCTION_SCHEMA, BID_SCHEMA
from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
from risingwave_tpu_torch.stream import Barrier, MockSource
from test_nexmark_queries import CAP, DDL, TICKS, replay

SQL = {
    "q105": """CREATE MATERIALIZED VIEW q105 AS
        SELECT a.id AS auction_id, a.item_name, COUNT(b.auction)
          AS bid_count
        FROM auction a JOIN bid b ON a.id = b.auction
        GROUP BY a.id, a.item_name
        ORDER BY bid_count DESC LIMIT 1000""",
    "q102": """CREATE MATERIALIZED VIEW q102 AS
        SELECT a.id AS auction_id, a.item_name, COUNT(b.auction)
          AS bid_count
        FROM auction a JOIN bid b ON a.id = b.auction
        GROUP BY a.id, a.item_name
        HAVING COUNT(b.auction) >= (
          SELECT COUNT(*) / COUNT(DISTINCT auction) FROM bid)""",
    "q18": """CREATE MATERIALIZED VIEW q18 AS
        SELECT auction, bidder, price, date_time
        FROM (SELECT *, RANK() OVER (PARTITION BY bidder, auction
                  ORDER BY date_time DESC) AS rank_number
              FROM bid) WHERE rank_number <= 1""",
}
SMALL = dict(device="cpu", out_capacity=64)


def nexmark_source(table: str, ticks: int) -> MockSource:
    """One generator per source leaf, as the Session has: a chunk, then a
    barrier, per tick."""
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=CAP), seed=42,
                           device="cpu")
    fn = {"bid": gen.next_bid_chunk, "auction": gen.next_auction_chunk}[table]
    schema = {"bid": BID_SCHEMA, "auction": AUCTION_SCHEMA}[table]
    msgs = [Barrier.new(1)]
    for t in range(ticks):
        msgs += [fn(), Barrier.new(t + 2, checkpoint=True)]
    return MockSource(schema, msgs)


def drive(plan, store) -> list:
    async def run():
        async for m in plan.mv.execute():
            if isinstance(m, Barrier) and m.checkpoint:
                store.commit(m.epoch.curr)

    asyncio.run(run())
    # the hidden pk column (q18's _pk0) is not part of the MV's rows
    width = len(plan.mv.schema) - (plan.mv.schema[-1].name == "_pk0")
    return sorted(r[:width] for r in plan.mv.rows())


def mv_table(store, schema, pk):
    return StateTable(store, 1, schema, pk)


# The reference Session's executors, sized for this data so that none
# grows mid-run: at the planner's defaults (bucket width 16) the q105 and
# q102 joins widen their buckets as the hottest auction's bids arrive, and
# every growth recompiles the join's steps (about two thirds of the
# Session's time on the CPU).
SESSION_CONFIG = dict(chunk_capacity=CAP, agg_table_capacity=1 << 10,
                      join_key_capacity=1 << 7, join_bucket_width=1 << 10,
                      topn_table_capacity=1 << 10)


def session_rows(name: str, ticks: int) -> list:
    """The MV rows of ``SQL[name]`` in the reference's Session, its sources
    ticked as tests/test_nexmark_queries.py's ``make_session`` ticks them."""
    s = Session(source_chunk_capacity=CAP, chunks_per_tick=1,
                config=BuildConfig(**SESSION_CONFIG))
    s.run_sql(DDL)
    s.run_sql(SQL[name])
    for _ in range(ticks):
        s.tick()
    rows = sorted(s.mv_rows(name))
    s.close()
    return rows


def bid_counts(ticks):
    auctions = replay("auction", ticks)
    n_bid = collections.Counter(b[0] for b in replay("bid", ticks))
    return auctions, n_bid


def test_q105_top_auctions():
    store = MemoryStateStore()
    plan = plans.q105(nexmark_source("auction", 6), nexmark_source("bid", 6),
                      mv_table(store, plans.q105_schema(), [0, 1]),
                      key_capacity=64, agg_capacity=256, topn_capacity=256,
                      **SMALL)
    got = drive(plan, store)
    auctions, n_bid = bid_counts(6)
    want = sorted((a[0], a[1], n_bid[a[0]]) for a in auctions
                  if n_bid[a[0]] > 0)
    assert got == want and len(got) > 0
    assert got == session_rows("q105", 6)


@pytest.mark.parametrize("limit", [5, 12])
def test_q105_limit_below_the_groups(limit):
    """A window smaller than the group count: ties on bid_count are broken
    by (auction_id, item_name) ascending, item_name by string."""
    store = MemoryStateStore()
    plan = plans.q105(nexmark_source("auction", 6), nexmark_source("bid", 6),
                      mv_table(store, plans.q105_schema(), [0, 1]),
                      limit=limit, key_capacity=64, agg_capacity=256,
                      topn_capacity=256, **SMALL)
    got = drive(plan, store)
    auctions, n_bid = bid_counts(6)
    rows = [(a[0], a[1], n_bid[a[0]]) for a in auctions if n_bid[a[0]] > 0]
    rows = sorted(set(rows), key=lambda r: (-r[2], r[0], r[1]))
    assert got == sorted(rows[:limit])


def test_q18_last_bid():
    store = MemoryStateStore()
    plan = plans.q18(nexmark_source("bid", TICKS),
                     mv_table(store, plans.q18_schema(), [4]),
                     table_capacity=512, **SMALL)
    got = drive(plan, store)
    last: dict = {}
    for b in replay("bid", TICKS):
        k = (b[1], b[0])
        if k not in last or b[5] > last[k][5]:
            last[k] = b
    want = sorted((b[0], b[1], b[2], b[5]) for b in last.values())
    assert got == want and len(got) > 0
    assert got == session_rows("q18", TICKS)


def test_q18_ties_and_recovery():
    """Ties at a group's latest date_time all stay; a GroupTopN recovered
    from its state table mid-stream ends on the uninterrupted MV."""
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=CAP), seed=42,
                           device="cpu")
    chunks = [gen.next_bid_chunk() for _ in range(4)]
    # every second bid repeats the previous bid's (auction, bidder,
    # date_time) at another price: ties at the top of their group
    for c in chunks:
        for i in (0, 1, 5):
            c.columns[i].data[1::2] = c.columns[i].data[0::2]
    schema = BID_SCHEMA

    def source(part):
        msgs = [Barrier.new(part[0] + 1)]
        for t in part:
            msgs += [chunks[t], Barrier.new(t + 2, checkpoint=True)]
        return MockSource(schema, msgs)

    def build(store, src, seq=0):
        st = StateTable(store, 2, plans.q18_schema(), [4])
        return plans.q18(src, mv_table(store, plans.q18_schema(), [4]),
                         table_capacity=512, state_table=st,
                         row_id_start=seq, **SMALL)

    whole_store = MemoryStateStore()
    whole = drive(build(whole_store, source([0, 1, 2, 3])), whole_store)
    store = MemoryStateStore()
    drive(build(store, source([0, 1])), store)
    resumed = drive(build(store, source([2, 3]), seq=2 * CAP), store)
    assert resumed == whole
    seen: dict = {}
    for c in chunks:
        for row in zip(*(c.columns[i].data.tolist() for i in (0, 1, 2, 5))):
            k = (row[1], row[0])
            seen.setdefault(k, []).append(row)
    want = []
    for rows in seen.values():
        top = max(r[3] for r in rows)
        want += [r for r in rows if r[3] == top]
    assert whole == sorted(want)
    assert len(want) > len(seen)        # ties kept
