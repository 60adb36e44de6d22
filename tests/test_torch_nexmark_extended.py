"""The rest of the NEXmark suite (tests/test_nexmark_extended.py's q0, q9,
q10, q14-q17, q20-q22, q101, q103, q104 and q106) as the port's executor
trees on the CPU, against the reference's ``Session`` running the same SQL.

The trees (``stream/nexmark_plans.py``) are the reference planner's,
executor for executor, fed by the port's host generator (seed 42, one
chunk of 64 rows per source leaf per tick, a generator per leaf, as the
Session ticks its sources). One Session holds the MVs without a join and
ticks them together (six ticks); each join query runs a Session of its
own over four ticks, op by op (``jax.disable_jit``: its join would
compile per instance), with the joins sized so that none grows. q9
(marked slow, as the reference marks its own) runs six ticks. The MV rows
must equal the Session's exactly (VARCHAR decoded; q17's averages are of
integers, exact in float64).
"""

import contextlib

import jax
import pytest

import risingwave_tpu_torch.stream.nexmark_plans as plans
from risingwave_tpu.frontend.build import BuildConfig
from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.connector.nexmark import (
    AUCTION_SCHEMA, BID_SCHEMA,
)
from risingwave_tpu_torch.stream import Barrier, MockSource
from test_nexmark_queries import CAP, DDL
from test_torch_nexmark_sql import SMALL, drive

SQL = {
    "q0": """CREATE MATERIALIZED VIEW q0 AS SELECT auction, bidder,
        price, date_time FROM bid""",
    "q9": """CREATE MATERIALIZED VIEW q9 AS
        SELECT id, item_name, auction, bidder, price, bid_date_time FROM (
          SELECT A.id, A.item_name, B.auction, B.bidder, B.price,
                 B.date_time AS bid_date_time,
            ROW_NUMBER() OVER (PARTITION BY A.id
                ORDER BY B.price DESC, B.date_time ASC) AS rownum
          FROM auction A, bid B
          WHERE A.id = B.auction
            AND B.date_time BETWEEN A.date_time AND A.expires
        ) WHERE rownum <= 1""",
    "q10": """CREATE MATERIALIZED VIEW q10 AS
        SELECT auction, bidder, price, date_time,
               TO_CHAR(date_time, 'YYYY-MM-DD') as date,
               TO_CHAR(date_time, 'HH:MI') as time FROM bid""",
    "q14": """CREATE MATERIALIZED VIEW q14 AS
        SELECT auction, bidder, 908 * price / 1000 as price,
          CASE WHEN extract(hour from date_time) >= 8
                AND extract(hour from date_time) <= 18 THEN 'dayTime'
               WHEN extract(hour from date_time) <= 6
                 OR extract(hour from date_time) >= 20 THEN 'nightTime'
          ELSE 'otherTime' END AS bidtimetype, date_time
        FROM bid WHERE 908 * price / 1000 > 1000""",
    "q15": """CREATE MATERIALIZED VIEW q15 AS
        SELECT TO_CHAR(date_time, 'yyyy-MM-dd') as day,
          count(*) AS total_bids,
          count(*) filter (where price < 10000) AS rank1_bids,
          count(*) filter (where price >= 10000 and price < 1000000)
            AS rank2_bids,
          count(*) filter (where price >= 1000000) AS rank3_bids,
          count(distinct bidder) AS total_bidders,
          count(distinct bidder) filter (where price < 10000)
            AS rank1_bidders,
          count(distinct auction) AS total_auctions,
          count(distinct auction) filter (where price >= 1000000)
            AS rank3_auctions
        FROM bid GROUP BY to_char(date_time, 'yyyy-MM-dd')""",
    "q16": """CREATE MATERIALIZED VIEW q16 AS
        SELECT channel, to_char(date_time, 'YYYY-MM-DD') as day,
          max(to_char(date_time, 'HH:MI')) as minute,
          count(*) AS total_bids,
          count(*) filter (where price < 10000) AS rank1_bids,
          count(distinct bidder) AS total_bidders,
          count(distinct auction) AS total_auctions
        FROM bid GROUP BY channel, to_char(date_time, 'YYYY-MM-DD')""",
    "q17": """CREATE MATERIALIZED VIEW q17 AS
        SELECT auction, to_char(date_time, 'YYYY-MM-DD') AS day,
          count(*) AS total_bids,
          count(*) filter (where price < 10000) AS rank1_bids,
          min(price) AS min_price, max(price) AS max_price,
          avg(price) AS avg_price, sum(price) AS sum_price
        FROM bid GROUP BY auction, to_char(date_time, 'YYYY-MM-DD')""",
    "q20": """CREATE MATERIALIZED VIEW q20 AS
        SELECT auction, bidder, price, channel, item_name, seller, category
        FROM bid AS B INNER JOIN auction AS A on B.auction = A.id
        WHERE A.category = 10""",
    "q21": """CREATE MATERIALIZED VIEW q21 AS
        SELECT auction, bidder, price, channel,
          CASE WHEN LOWER(channel) = 'apple' THEN '0'
               WHEN LOWER(channel) = 'google' THEN '1'
               WHEN LOWER(channel) = 'facebook' THEN '2'
               WHEN LOWER(channel) = 'baidu' THEN '3'
          ELSE (regexp_match(url, '(&|^)channel_id=([^&]*)'))[2] END
            AS channel_id
        FROM bid
        WHERE (regexp_match(url, '(&|^)channel_id=([^&]*)'))[2]
                is not null
           or LOWER(channel) in ('apple', 'google', 'facebook', 'baidu')""",
    "q22": """CREATE MATERIALIZED VIEW q22 AS
        SELECT auction, bidder, price, channel,
          split_part(url, '/', 4) as dir1,
          split_part(url, '/', 5) as dir2,
          split_part(url, '/', 6) as dir3 FROM bid""",
    "q101": """CREATE MATERIALIZED VIEW q101 AS
        SELECT a.id AS auction_id, a.item_name, b.max_price
        FROM auction a LEFT OUTER JOIN (
          SELECT b1.auction, MAX(b1.price) max_price
          FROM bid b1 GROUP BY b1.auction
        ) b ON a.id = b.auction""",
    "q103": """CREATE MATERIALIZED VIEW q103 AS
        SELECT a.id AS auction_id, a.item_name FROM auction a
        WHERE a.id IN (
          SELECT b.auction FROM bid b GROUP BY b.auction
          HAVING COUNT(*) >= 2)""",
    "q104": """CREATE MATERIALIZED VIEW q104 AS
        SELECT a.id AS auction_id, a.item_name FROM auction a
        WHERE a.id NOT IN (
          SELECT b.auction FROM bid b GROUP BY b.auction
          HAVING COUNT(*) < 2)""",
    "q106": """CREATE MATERIALIZED VIEW q106 AS
        SELECT MIN(final) AS min_final FROM (
          SELECT auction.id, MAX(price) AS final FROM auction, bid
          WHERE bid.auction = auction.id
            AND bid.date_time BETWEEN auction.date_time AND auction.expires
          GROUP BY auction.id)""",
}
NO_JOIN = ("q0", "q10", "q14", "q15", "q16", "q17", "q21", "q22")
TICKS = 6
JOIN_TICKS = 4
# no join grows in the reference (a growth widens and recompiles)
SESSION_CONFIG = dict(chunk_capacity=CAP, agg_table_capacity=1 << 10,
                      join_key_capacity=1 << 10, join_bucket_width=1 << 8)
JOIN = dict(key_capacity=1 << 10, bucket_width=1 << 8)
AGG = dict(agg_capacity=1 << 10)


def session_rows(names, ticks: int = TICKS, eager: bool = False) -> dict:
    with jax.disable_jit() if eager else contextlib.nullcontext():
        s = Session(source_chunk_capacity=CAP, chunks_per_tick=1,
                    config=BuildConfig(**SESSION_CONFIG))
        s.run_sql(DDL)
        for name in names:
            s.run_sql(SQL[name])
        for _ in range(ticks):
            s.tick()
        rows = {name: sorted(s.mv_rows(name)) for name in names}
        s.close()
    return rows


def source(table: str, ticks: int = TICKS) -> MockSource:
    """One generator per source leaf: a chunk, then a barrier, per tick."""
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=CAP), seed=42,
                           device="cpu")
    fn = {"bid": gen.next_bid_chunk, "auction": gen.next_auction_chunk}
    schema = {"bid": BID_SCHEMA, "auction": AUCTION_SCHEMA}[table]
    msgs = [Barrier.new(1)]
    for t in range(ticks):
        msgs += [fn[table](), Barrier.new(t + 2, checkpoint=True)]
    return MockSource(schema, msgs)


@pytest.fixture(scope="module")
def session():
    return session_rows(NO_JOIN)


def check(session, name, build, pk):
    got = drive(build, getattr(plans, f"{name}_schema")(), pk)
    assert got == session[name] and len(got) > 0


def check_join(name, build, pk):
    """A join query over JOIN_TICKS ticks against its own Session."""
    want = session_rows([name], JOIN_TICKS, eager=True)[name]
    got = drive(lambda t: build(lambda table: source(table, JOIN_TICKS), t),
                getattr(plans, f"{name}_schema")(), pk)
    assert got == want and len(got) > 0
    return got


def test_q0_passthrough(session):
    check(session, "q0", lambda t: plans.q0(source("bid"), t, device="cpu"),
          [4])
    assert len(session["q0"]) == TICKS * CAP


def test_q10_log_format(session):
    check(session, "q10",
          lambda t: plans.q10(source("bid"), t, device="cpu"), [6])


def test_q14_calculated_fields(session):
    check(session, "q14",
          lambda t: plans.q14(source("bid"), t, device="cpu"), [5])


def test_q15_bidding_statistics(session):
    check(session, "q15", lambda t: plans.q15(source("bid"), t, **SMALL),
          [0])


def test_q16_channel_statistics(session):
    check(session, "q16", lambda t: plans.q16(source("bid"), t, **SMALL),
          [0, 1])


def test_q17_auction_statistics(session):
    check(session, "q17",
          lambda t: plans.q17(source("bid"), t, **AGG, **SMALL), [0, 1])


def test_q20_expand_bid():
    check_join("q20", lambda src, t: plans.q20(
        src("bid"), src("auction"), t, **JOIN, **SMALL), [7, 8])


def test_q21_channel_id(session):
    check(session, "q21",
          lambda t: plans.q21(source("bid"), t, device="cpu"), [5])


def test_q22_url_directories(session):
    check(session, "q22",
          lambda t: plans.q22(source("bid"), t, device="cpu"), [7])


def test_q101_highest_bid_outer():
    got = check_join("q101", lambda src, t: plans.q101(
        src("auction"), src("bid"), t, **JOIN, **AGG, **SMALL), [3, 4])
    assert any(r[2] is None for r in got)


def test_q103_semi_join():
    check_join("q103", lambda src, t: plans.q103(
        src("auction"), src("bid"), t, **JOIN, **AGG, **SMALL), [2])


def test_q104_anti_join():
    check_join("q104", lambda src, t: plans.q104(
        src("auction"), src("bid"), t, **JOIN, **AGG, **SMALL), [2])


def test_q106_min_final_price():
    check_join("q106", lambda src, t: plans.q106(
        src("auction"), src("bid"), t, **JOIN, **AGG, **SMALL), [])


@pytest.mark.slow
def test_q9_winning_bids():
    got = drive(lambda t: plans.q9(source("auction"), source("bid"), t,
                                   topn_capacity=1 << 10, **JOIN, **SMALL),
                plans.q9_schema(), [6, 7])
    assert got == session_rows(["q9"], eager=True)["q9"] and len(got) > 0
