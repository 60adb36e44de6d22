"""The NEXmark SQL set (tests/test_nexmark_queries.py's q1, q2, q3, q4,
q7 and q8) as the port's executor trees on the CPU, against the
reference's ``Session`` running the same SQL.

The trees (``stream/nexmark_plans.py``) are the reference planner's,
executor for executor, fed by the port's host generator (seed 42, one
chunk of 64 rows per source leaf per tick, a generator per leaf, as the
Session ticks its sources). One Session holds the five MVs of the fast
tests and ticks them together; q4 (marked slow, as the reference marks
its own) runs a Session of its own. The MV rows must equal the Session's
exactly (VARCHAR decoded; q4's averages are of integers, exact in float64).
"""

import asyncio

import pytest

import risingwave_tpu_torch.stream.nexmark_plans as plans
from risingwave_tpu.frontend.build import BuildConfig
from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.connector.nexmark import (
    AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA,
)
from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
from risingwave_tpu_torch.stream import Barrier, MockSource
from test_nexmark_queries import CAP, DDL

TICKS = 6
SQL = {
    "q1": """CREATE MATERIALIZED VIEW q1 AS
        SELECT auction, bidder, price * 89 / 100 AS price, date_time
        FROM bid""",
    "q2": """CREATE MATERIALIZED VIEW q2 AS
        SELECT auction, price FROM bid
        WHERE auction % 123 = 0 OR auction % 125 = 0""",
    "q3": """CREATE MATERIALIZED VIEW q3 AS
        SELECT P.name, P.city, P.state, A.id
        FROM auction AS A INNER JOIN person AS P on A.seller = P.id
        WHERE A.category = 10
          AND (P.state = 'OR' OR P.state = 'ID' OR P.state = 'CA')""",
    "q4": """CREATE MATERIALIZED VIEW q4 AS
        SELECT Q.category, AVG(Q.final) as avg
        FROM (
            SELECT MAX(B.price) AS final, A.category
            FROM auction A, bid B
            WHERE A.id = B.auction
              AND B.date_time BETWEEN A.date_time AND A.expires
            GROUP BY A.id, A.category
        ) Q
        GROUP BY Q.category""",
    "q7": """CREATE MATERIALIZED VIEW q7 AS
        SELECT B.auction, B.price, B.bidder, B.date_time
        FROM bid B
        JOIN (
            SELECT MAX(price) AS maxprice, window_end as date_time
            FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)
            GROUP BY window_end
        ) B1 ON B.price = B1.maxprice
        WHERE B.date_time BETWEEN B1.date_time - INTERVAL '10' SECOND
              AND B1.date_time""",
    "q8": """CREATE MATERIALIZED VIEW q8 AS
        SELECT P.id, P.name, P.starttime
        FROM (
            SELECT id, name, window_start AS starttime,
                   window_end AS endtime
            FROM TUMBLE(person, date_time, INTERVAL '10' SECOND)
            GROUP BY id, name, window_start, window_end
        ) P
        JOIN (
            SELECT seller, window_start AS starttime,
                   window_end AS endtime
            FROM TUMBLE(auction, date_time, INTERVAL '10' SECOND)
            GROUP BY seller, window_start, window_end
        ) A ON P.id = A.seller AND P.starttime = A.starttime
               AND P.endtime = A.endtime""",
}
FAST = ("q1", "q2", "q3", "q7", "q8")
# sized so that no join grows mid-run (each growth recompiles)
SESSION_CONFIG = dict(chunk_capacity=CAP, agg_table_capacity=1 << 10,
                      join_key_capacity=1 << 9, join_bucket_width=1 << 6)
SMALL = dict(device="cpu", out_capacity=64)
JOIN = dict(key_capacity=1 << 9, bucket_width=1 << 6)


def session_rows(names) -> dict:
    s = Session(source_chunk_capacity=CAP, chunks_per_tick=1,
                config=BuildConfig(**SESSION_CONFIG))
    s.run_sql(DDL)
    for name in names:
        s.run_sql(SQL[name])
    for _ in range(TICKS):
        s.tick()
    rows = {name: sorted(s.mv_rows(name)) for name in names}
    s.close()
    return rows


@pytest.fixture(scope="module")
def session():
    return session_rows(FAST)


def source(table: str) -> MockSource:
    """One generator per source leaf: a chunk, then a barrier, per tick."""
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=CAP), seed=42,
                           device="cpu")
    fn = {"bid": gen.next_bid_chunk, "auction": gen.next_auction_chunk,
          "person": gen.next_person_chunk}[table]
    schema = {"bid": BID_SCHEMA, "auction": AUCTION_SCHEMA,
              "person": PERSON_SCHEMA}[table]
    msgs = [Barrier.new(1)]
    for t in range(TICKS):
        msgs += [fn(), Barrier.new(t + 2, checkpoint=True)]
    return MockSource(schema, msgs)


def drive(build, schema, pk) -> list:
    """The MV rows of the tree ``build(mv_table)``, its hidden pk columns
    (``_pk*``) left out, as the Session's ``mv_rows`` leaves them out."""
    store = MemoryStateStore()
    plan = build(StateTable(store, 1, schema, pk))

    async def run():
        async for m in plan.mv.execute():
            if isinstance(m, Barrier) and m.checkpoint:
                store.commit(m.epoch.curr)

    asyncio.run(run())
    width = sum(not f.name.startswith("_pk") for f in schema)
    return sorted(r[:width] for r in plan.mv.rows())


def test_q1_currency_conversion(session):
    got = drive(lambda t: plans.q1(source("bid"), t, device="cpu"),
                plans.q1_schema(), [4])
    assert got == session["q1"] and len(got) == TICKS * CAP


def test_q2_filter(session):
    got = drive(lambda t: plans.q2(source("bid"), t, device="cpu"),
                plans.q2_schema(), [2])
    assert got == session["q2"] and len(got) > 0


def test_q3_join_filter(session):
    got = drive(lambda t: plans.q3(source("auction"), source("person"), t,
                                   **JOIN, **SMALL),
                plans.q3_schema(), [4, 5])
    assert got == session["q3"] and len(got) > 0


def test_q7_highest_bid(session):
    got = drive(lambda t: plans.q7(source("bid"), source("bid"), t,
                                   agg_capacity=1 << 10, **JOIN, **SMALL),
                plans.q7_schema(), [4, 5])
    assert got == session["q7"] and len(got) > 0


def test_q8_new_users(session):
    got = drive(lambda t: plans.q8(source("person"), source("auction"), t,
                                   agg_capacity=1 << 10, **JOIN, **SMALL),
                plans.q8_schema(), list(range(7)))
    assert got == session["q8"] and len(got) > 0


@pytest.mark.slow
def test_q4_avg_final_price():
    got = drive(lambda t: plans.q4(source("auction"), source("bid"), t,
                                   agg_capacity=1 << 10, **JOIN, **SMALL),
                plans.q4_schema(), [0])
    assert got == session_rows(["q4"])["q4"] and len(got) > 0
