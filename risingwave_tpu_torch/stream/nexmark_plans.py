"""The executor trees of the NEXmark SQL set (q1, q2, q3, q4, q7, q8 as
tests/test_nexmark_queries.py writes them), the suite of
tests/test_nexmark_extended.py (q0, q9, q10, q14-q18, q20-q22, q101-q106),
q5 over HOP windows, an EOWC running window, q13 and a dedup stream,
built from this package's executors.

Each tree is the one the reference's planner builds for the query (its
``EXPLAIN``), executor for executor:

  * q1 — ``SELECT auction, bidder, price * 89 / 100 AS price, date_time
    FROM bid``: bids → RowIdGen → Project → Materialize;
  * q2 — ``WHERE auction % 123 = 0 OR auction % 125 = 0``: bids → RowIdGen
    → Project(auction, price, _row_id) → Filter → Project → Materialize;
  * q3 — auction ⋈ person on seller = id, ``category = 10`` and the
    person's state in (OR, ID, CA): each side RowIdGen → Project → Filter,
    then HashJoin → Project → Materialize;
  * q4 — the average final price per category: auction ⋈ bid on id =
    auction → Filter(bid time BETWEEN the auction's date_time and expires)
    → Project → HashAgg(max(price) per auction and category) → Project →
    HashAgg(avg per category; its input retracts) → Project →
    Materialize;
  * q7 — bids ⋈ (bids → Project(tumble end, price) → HashAgg(max)) on
    price = max → Filter(date_time within the window) → Project →
    Materialize, each branch on its own source of the same bids;
  * q8 — persons and auctions grouped by (id, name, window) and (seller,
    window) over 10 s TUMBLE windows (HashAggs without calls), joined on
    the id and both window bounds → Project → Materialize;

  * q105 — ``SELECT a.id, a.item_name, COUNT(b.auction) AS bid_count FROM
    auction a JOIN bid b ON a.id = b.auction GROUP BY a.id, a.item_name
    ORDER BY bid_count DESC LIMIT 1000``: both sources → RowIdGen →
    Project → HashJoin → Project → HashAgg(count) → Project → TopN →
    Materialize;
  * q102 — the same join and agg ``HAVING COUNT(b.auction) >= (SELECT
    COUNT(*) / COUNT(DISTINCT auction) FROM bid)``: DynamicFilter(>=) whose
    right side is bids → MaterializedAgg(count(*), count(DISTINCT)) →
    Project(divide);
  * q18 — the last bid of each (bidder, auction), ``RANK() OVER (PARTITION
    BY bidder, auction ORDER BY date_time DESC) <= 1``: bids → RowIdGen →
    Project → GroupTopN(limit 1, WITH TIES) → Project → Materialize;
  * q5_hop — NEXmark q5 as its SQL reads (HOP(bid, date_time, 2 s, 10 s)):
    each branch on its own source of the same bids. Left: RowIdGen →
    HopWindow → Project(window_start, auction) → HashAgg(count(*)) →
    Project(auction, num, starttime); right: RowIdGen → HopWindow →
    Project(auction, window_start) → HashAgg(count(*)) → Project →
    MaterializedAgg(max) (its input retracts) → Project(maxn,
    starttime_c); root: HashJoin(starttime, num = starttime_c, maxn) →
    Project → Materialize;
  * eowc_running — ``SELECT auction, price, date_time, sum(price) OVER w,
    row_number() OVER w FROM bid EMIT ON WINDOW CLOSE`` (w: PARTITION BY
    auction ORDER BY date_time) over a source with ``WATERMARK FOR
    date_time AS date_time - INTERVAL '4' SECOND``: RowIdGen →
    WatermarkFilter → Sort → EowcOverWindow → Project → Materialize;
  * q13 — ``SELECT B.auction, B.bidder, B.price, B.date_time, S.value FROM
    bid B JOIN side_input FOR SYSTEM_TIME AS OF PROCTIME() S ON
    mod(B.auction, 10000) = S.key``: RowIdGen → Project (the key
    ``auction % 10000``) → TemporalJoin on the side table's StateTable →
    Project → Materialize (built by hand: the reference planner takes only
    a column = column condition for a temporal join);
  * dedup — bids → AppendOnlyDedup(auction, bidder) → Materialize: the
    first bid of each (auction, bidder) (by hand: no rule of the reference
    planner builds AppendOnlyDedup).

The rest of the suite, each tree read off the reference's ``EXPLAIN``
the same way (a FILTER clause becomes a CASE-wrapped argument, as the
reference binder writes it; ``count(DISTINCT)`` puts every call of its
agg on the host tier, the MaterializedAgg): q0 a pass-through; q10 and
q22 Projects with ``to_char`` and ``split_part``; q14 Filter → Project
with a CASE of the hour; q21 Filter and Project over ``lower`` and
``(regexp_match(url, ...))[2]``; q15 and q16 MaterializedAggs per day (and
channel); q17 a HashAgg per (auction, day); q9 the auction ⋈ bid join in
its window → GroupTopN(id; price desc, date_time asc; limit 1) for
``ROW_NUMBER() <= 1``; q20 bids ⋈ auctions of category 10; q101 auctions
LEFT JOIN a HashAgg(max); q103 and q104 a semi and a null-aware anti join
of the auctions with a HAVING HashAgg(count(*)); q106 the windowed join →
HashAgg(max) → MaterializedAgg(min) (its input retracts).

Sources are executors that yield the connector's chunks (or ChunkBatches);
``with_row_id`` appends the hidden ``_row_id`` pk column and numbers it,
from ``row_id_start`` (one start per source; a plan recovered mid-stream
passes starts above the ids its state holds). Capacities are arguments:
the defaults are the reference planner's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import ChunkBatch, Column, StreamChunk
from ..common.types import (
    INT32, INT64, SERIAL, TIMESTAMP, VARCHAR, Field, Schema,
)
from ..expr.agg import AggCall, agg, count_star
from ..expr.expr import Literal, call, col
from ..ops.join_state import JoinType
from ..ops.topn import OrderSpec
from ..storage.state_table import StateTable
from .dedup import AppendOnlyDedupExecutor
from .dynamic_filter import DynamicFilterExecutor
from .eowc import SortExecutor, WatermarkFilterExecutor
from .executor import Executor, SingleInputExecutor
from .hash_agg import HashAggExecutor
from .hash_join import HashJoinExecutor
from .hop_window import HopWindowExecutor
from .materialize import MaterializeExecutor
from .materialized_agg import MaterializedAggExecutor
from .over_window import EowcOverWindowExecutor, WindowCall, eowc_acc_schema
from .project import FilterExecutor, ProjectExecutor
from .row_id_gen import RowIdGenExecutor
from .temporal_join import TemporalJoinExecutor
from .top_n import TopNExecutor

SECOND = 1_000_000
#: q5's HOP(date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
HOP_SLIDE = 2 * SECOND
HOP_SIZE = 10 * SECOND
#: WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
EOWC_DELAY = 4 * SECOND
#: q13's side table: keys 0..SIDE_INPUT_KEYS-1, joined on auction % it
SIDE_INPUT_KEYS = 10_000
#: q7's and q8's TUMBLE(date_time, INTERVAL '10' SECOND)
TUMBLE_SIZE = 10 * SECOND


class RowIdAppend(SingleInputExecutor):
    """Appends the hidden ``_row_id`` SERIAL column (zeros, for RowIdGen
    to fill) to every chunk or ChunkBatch of a source."""

    identity = "RowIdAppend"

    def __init__(self, input: Executor):
        super().__init__(input)
        self.schema = input.schema.concat(
            Schema((Field("_row_id", SERIAL),)))

    @staticmethod
    def _append(chunk: StreamChunk) -> StreamChunk:
        rid = Column(torch.zeros_like(chunk.vis, dtype=torch.int64),
                     torch.ones_like(chunk.vis))
        return chunk.with_columns(chunk.columns + (rid,))

    async def map_chunk(self, chunk: StreamChunk):
        yield self._append(chunk)

    async def map_chunk_batch(self, batch: ChunkBatch):
        yield ChunkBatch(self._append(batch.chunk))


def with_row_id(source: Executor, start: int = 0,
                device=DEFAULT_DEVICE) -> RowIdGenExecutor:
    """``source`` with its ``_row_id`` column appended and numbered from
    ``start``."""
    appended = RowIdAppend(source)
    return RowIdGenExecutor(appended, len(appended.schema) - 1,
                            start_seq=start, device=device)


def _project(input: Executor, cols, names) -> ProjectExecutor:
    return ProjectExecutor(
        input, [col(i, input.schema[i].type) for i in cols], names)


@dataclasses.dataclass
class Plan:
    """A built tree: ``mv`` is its root, the rest are handles on the
    executors a caller reads counters or state from."""

    mv: MaterializeExecutor
    join: Optional[HashJoinExecutor] = None
    top_n: Optional[TopNExecutor] = None
    dynamic_filter: Optional[DynamicFilterExecutor] = None
    #: q5_hop: (left count, right count, max) aggs
    aggs: tuple = ()
    watermark_filter: Optional[WatermarkFilterExecutor] = None
    sort: Optional[SortExecutor] = None
    dedup: Optional[AppendOnlyDedupExecutor] = None


def _join_agg(auction: Executor, bid: Executor, key_capacity: int,
              bucket_width: int, agg_capacity: int, out_capacity: int,
              row_id_start, device):
    """auction ⋈ bid on id = auction, grouped by (id, item_name),
    count(b.auction); ``row_id_start``: (auction's, bid's)."""
    a = _project(with_row_id(auction, row_id_start[0], device), (0, 1, 10),
                 ("id", "item_name", "_row_id"))
    b = _project(with_row_id(bid, row_id_start[1], device), (0, 7),
                 ("auction", "_row_id"))
    join = HashJoinExecutor(a, b, [0], [0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    keyed = _project(join, (0, 1, 3), ("k0", "k1", "a0"))
    agg = HashAggExecutor(keyed, [0, 1], [AggCall("count", 2, INT64)],
                          table_capacity=agg_capacity,
                          out_capacity=out_capacity, device=device)
    return join, agg


def q105(auction: Executor, bid: Executor, mv_table: StateTable, *,
         limit: int = 1000, key_capacity: int = 1 << 13,
         bucket_width: int = 16, agg_capacity: int = 1 << 16,
         topn_capacity: int = 1 << 16, out_capacity: int = 1024,
         row_id_start: tuple = (0, 0), device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``q105_schema()``, pk (0, 1).
    ``row_id_start``: the first row ids of (auction, bid)."""
    join, agg = _join_agg(auction, bid, key_capacity, bucket_width,
                          agg_capacity, out_capacity, row_id_start, device)
    named = _project(agg, (0, 1, 2), ("auction_id", "item_name", "bid_count"))
    top = TopNExecutor(named, [OrderSpec(2, desc=True, nulls_last=False)],
                       0, limit, pk_indices=[0, 1],
                       table_capacity=topn_capacity,
                       out_capacity=out_capacity, device=device)
    return Plan(MaterializeExecutor(top, mv_table), join=join, top_n=top)


def q102(auction: Executor, bid: Executor, bid_rhs: Executor,
         mv_table: StateTable, *, key_capacity: int = 1 << 13,
         bucket_width: int = 16, agg_capacity: int = 1 << 16,
         filter_capacity: int = 1 << 16, out_capacity: int = 1024,
         row_id_start: tuple = (0, 0, 0), device=DEFAULT_DEVICE) -> Plan:
    """``bid_rhs``: a second source of the same bids (the subquery's).
    ``mv_table``: schema ``q105_schema()``, pk (0, 1).
    ``row_id_start``: the first row ids of (auction, bid, bid_rhs)."""
    join, agg = _join_agg(auction, bid, key_capacity, bucket_width,
                          agg_capacity, out_capacity, row_id_start[:2],
                          device)
    auctions = _project(with_row_id(bid_rhs, row_id_start[2], device), (0,),
                        ("a0",))
    counts = MaterializedAggExecutor(
        auctions, [], [count_star(), AggCall("count", 0, INT64, True)],
        out_capacity=out_capacity, device=device)
    avg = ProjectExecutor(counts, [call("divide", col(0, INT64),
                                        col(1, INT64))], ("avg",))
    dyn = DynamicFilterExecutor(agg, avg, key_col=2,
                                cmp="greater_than_or_equal",
                                pk_indices=[0, 1],
                                table_capacity=filter_capacity,
                                out_capacity=out_capacity, device=device)
    named = _project(dyn, (0, 1, 2), ("auction_id", "item_name", "bid_count"))
    return Plan(MaterializeExecutor(named, mv_table), join=join,
                dynamic_filter=dyn)


def q18(bid: Executor, mv_table: StateTable, *,
        table_capacity: int = 1 << 16, out_capacity: int = 1024,
        state_table: Optional[StateTable] = None, row_id_start: int = 0,
        device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``q18_schema()``, pk (4,) (the hidden row id).
    ``state_table``: the GroupTopN's (schema ``q18_schema()``, pk (4,)).
    ``row_id_start``: the bids' first row id."""
    rows = _project(with_row_id(bid, row_id_start, device), (0, 1, 2, 5, 7),
                    ("auction", "bidder", "price", "date_time", "_row_id"))
    top = TopNExecutor(rows, [OrderSpec(3, desc=True, nulls_last=False)],
                       0, 1, pk_indices=[4], group_by=[1, 0],
                       with_ties=True, state_table=state_table,
                       table_capacity=table_capacity,
                       out_capacity=out_capacity, device=device)
    named = _project(top, (0, 1, 2, 3, 4),
                     ("auction", "bidder", "price", "date_time", "_pk0"))
    return Plan(MaterializeExecutor(named, mv_table), top_n=top)


def _hop(bid: Executor, device) -> HopWindowExecutor:
    """bids, with row ids, over HOP(date_time, HOP_SLIDE, HOP_SIZE)."""
    return HopWindowExecutor(with_row_id(bid, 0, device), 5, HOP_SLIDE,
                             HOP_SIZE)


def q5_hop(bid: Executor, bid_right: Executor, mv_table: StateTable, *,
           agg_capacity: int = 1 << 16, key_capacity: int = 1 << 13,
           bucket_width: int = 16, out_capacity: int = 1024,
           device=DEFAULT_DEVICE) -> Plan:
    """``bid_right``: a second source of the same bids (the right branch's
    scan). ``mv_table``: schema ``q5_hop_schema()``, pk (2, 0, 3)."""
    left_win = _project(_hop(bid, device), (8, 0),
                        ("window_start", "auction"))
    left_count = HashAggExecutor(left_win, [0, 1], [count_star()],
                                 table_capacity=agg_capacity,
                                 out_capacity=out_capacity, device=device)
    left = _project(left_count, (1, 2, 0), ("auction", "num", "starttime"))
    right_win = _project(_hop(bid_right, device), (0, 8),
                         ("auction", "window_start"))
    right_count = HashAggExecutor(right_win, [0, 1], [count_star()],
                                  table_capacity=agg_capacity,
                                  out_capacity=out_capacity, device=device)
    counts = _project(right_count, (1, 2), ("starttime_c", "num"))
    max_num = MaterializedAggExecutor(counts, [0], [agg("max", 1, INT64)],
                                      out_capacity=out_capacity,
                                      device=device)
    right = _project(max_num, (1, 0), ("maxn", "starttime_c"))
    join = HashJoinExecutor(left, right, [2, 1], [1, 0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    named = _project(join, (0, 1, 2, 4),
                     ("auction", "num", "_pk0", "_pk1"))
    return Plan(MaterializeExecutor(named, mv_table), join=join,
                aggs=(left_count, right_count, max_num))


def eowc_running(bid: Executor, mv_table: StateTable, *,
                 sort_capacity: int = 1 << 16,
                 out_capacity: int = 1024, state_tables=None,
                 row_id_start: int = 0, device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``eowc_running_schema()``, pk (5,).
    ``state_tables``: ``eowc_running_state_tables(store)`` (the watermark,
    Sort, accumulator and buffer tables) or None. ``row_id_start``: the
    bids' first row id."""
    wm_st, sort_st, acc_st, buf_st = state_tables or (None,) * 4
    rows = with_row_id(bid, row_id_start, device)
    filtered = WatermarkFilterExecutor(rows, 5, EOWC_DELAY,
                                       state_table=wm_st, device=device)
    sort = SortExecutor(filtered, time_col=5, pk_indices=[7],
                        state_table=sort_st, table_capacity=sort_capacity,
                        out_capacity=out_capacity, device=device)
    win = EowcOverWindowExecutor(sort, running_calls(), pk_indices=[7],
                                 acc_table=acc_st, buffer_table=buf_st,
                                 out_capacity=out_capacity, device=device)
    named = _project(win, (0, 2, 5, 8, 9, 7),
                     ("auction", "price", "date_time", "rs", "rn", "_pk0"))
    return Plan(MaterializeExecutor(named, mv_table),
                watermark_filter=filtered, sort=sort)


def running_calls() -> tuple:
    """sum(price) and row_number() OVER (PARTITION BY auction ORDER BY
    date_time), as the reference binder types them."""
    order = (OrderSpec(5),)
    return (WindowCall("sum", INT64, arg=2, partition_by=(0,),
                       order_by=order),
            WindowCall("row_number", INT64, partition_by=(0,),
                       order_by=order))


def eowc_running_state_tables(store, first_id: int = 2) -> tuple:
    """The watermark, Sort, accumulator and buffer tables of
    ``eowc_running`` (ids from ``first_id``), in the reference's layouts."""
    from ..connector.nexmark import BID_SCHEMA
    rows = BID_SCHEMA.concat(Schema((Field("_row_id", SERIAL),)))
    wm = Schema((Field("id", INT64), Field("watermark", TIMESTAMP)))
    return (StateTable(store, first_id, wm, [0]),
            StateTable(store, first_id + 1, rows, [7]),
            StateTable(store, first_id + 2,
                       eowc_acc_schema(rows, running_calls()), [0]),
            StateTable(store, first_id + 3, rows, [7]))


def side_input_schema() -> Schema:
    return Schema((Field("key", INT64), Field("value", VARCHAR)))


def q13(bid: Executor, side_table: StateTable, mv_table: StateTable, *,
        out_capacity: int = 1024, device=DEFAULT_DEVICE) -> Plan:
    """``side_table``: schema ``side_input_schema()``, pk (0,), loaded
    before the first probe. ``mv_table``: schema ``q13_schema()``, pk
    (5,)."""
    rows = with_row_id(bid, 0, device)
    keyed = ProjectExecutor(
        rows, [col(i, rows.schema[i].type) for i in (0, 1, 2, 5, 7)]
        + [call("modulus", col(0, INT64), Literal(SIDE_INPUT_KEYS, INT64))],
        ("auction", "bidder", "price", "date_time", "_row_id", "key"))
    join = TemporalJoinExecutor(keyed, side_table, [5], [0],
                                out_capacity=out_capacity, device=device)
    named = _project(join, (0, 1, 2, 3, 7, 4),
                     ("auction", "bidder", "price", "date_time", "value",
                      "_pk0"))
    return Plan(MaterializeExecutor(named, mv_table))


def dedup(bid: Executor, mv_table: StateTable, *,
          table_capacity: int = 1 << 16, state_table=None,
          device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: the bid schema, pk (0, 1). ``state_table``: the
    dedup's (schema ``dedup_state_schema()``, pk (0, 1)) or None."""
    first = AppendOnlyDedupExecutor(bid, [0, 1], state_table=state_table,
                                    table_capacity=table_capacity,
                                    device=device)
    return Plan(MaterializeExecutor(first, mv_table), dedup=first)


def dedup_state_schema() -> Schema:
    from ..connector.nexmark import BID_SCHEMA
    return Schema((BID_SCHEMA[0], BID_SCHEMA[1]))


def q5_hop_schema() -> Schema:
    return Schema((Field("auction", INT64), Field("num", INT64),
                   Field("_pk0", TIMESTAMP), Field("_pk1", TIMESTAMP)))


def eowc_running_schema() -> Schema:
    return Schema((Field("auction", INT64), Field("price", INT64),
                   Field("date_time", TIMESTAMP), Field("rs", INT64),
                   Field("rn", INT64), Field("_pk0", SERIAL)))


def q13_schema() -> Schema:
    from ..connector.nexmark import BID_SCHEMA
    return Schema(tuple(BID_SCHEMA[i] for i in (0, 1, 2, 5))
                  + (Field("value", VARCHAR), Field("_pk0", SERIAL)))


def q105_schema() -> Schema:
    from ..connector.nexmark import AUCTION_SCHEMA
    return Schema((Field("auction_id", INT64), AUCTION_SCHEMA[1],
                   Field("bid_count", INT64)))


def q18_schema() -> Schema:
    from ..connector.nexmark import BID_SCHEMA
    return Schema(tuple(BID_SCHEMA[i] for i in (0, 1, 2, 5))
                  + (Field("_pk0", SERIAL),))


# ---------------------------------------------------------------------------
# the NEXmark SQL set (tests/test_nexmark_queries.py)
# ---------------------------------------------------------------------------

def _i64(index: int):
    return col(index, INT64)


def _lit(v, t=INT32) -> Literal:
    return Literal(v, t)


def _tumble(ts_col: int):
    """(window_start, window_end) of TUMBLE(date_time, TUMBLE_SIZE)."""
    start = call("tumble_start", col(ts_col, TIMESTAMP),
                 _lit(TUMBLE_SIZE, INT64))
    return start, call("add", start, _lit(TUMBLE_SIZE, INT64))


def _mv(root: Executor, cols, names, mv_table: StateTable) -> Plan:
    s = root.schema
    return Plan(MaterializeExecutor(ProjectExecutor(
        root, [col(i, s[i].type) for i in cols], names), mv_table))


def q1(bid: Executor, mv_table: StateTable, *,
       device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``q1_schema()``, pk (4,)."""
    rows = with_row_id(bid, 0, device)
    price = call("divide", call("multiply", _i64(2), _lit(89)), _lit(100))
    return Plan(MaterializeExecutor(ProjectExecutor(
        rows, [_i64(0), _i64(1), price, col(5, TIMESTAMP),
               col(7, SERIAL)],
        ("auction", "bidder", "price", "date_time", "_pk0")), mv_table))


def q2(bid: Executor, mv_table: StateTable, *,
       device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``q2_schema()``, pk (2,)."""
    rows = _project(with_row_id(bid, 0, device), (0, 2, 7),
                    ("auction", "price", "_row_id"))

    def divisible(n):
        return call("equal", call("modulus", _i64(0), _lit(n)), _lit(0))

    kept = FilterExecutor(rows, call("or", divisible(123), divisible(125)))
    return _mv(kept, (0, 1, 2), ("auction", "price", "_pk0"), mv_table)


def q3(auction: Executor, person: Executor, mv_table: StateTable, *,
       key_capacity: int = 1 << 13, bucket_width: int = 16,
       out_capacity: int = 1024, device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``q3_schema()``, pk (4, 5)."""
    a = FilterExecutor(
        _project(with_row_id(auction, 0, device), (0, 7, 8, 10),
                 ("id", "seller", "category", "_row_id")),
        call("equal", _i64(2), _lit(10)))
    p = _project(with_row_id(person, 0, device), (0, 1, 4, 5, 8),
                 ("id", "name", "city", "state", "_row_id"))

    def state_is(v):
        return call("equal", col(3, VARCHAR), Literal(v, VARCHAR))

    p = FilterExecutor(p, call("or", call("or", state_is("OR"),
                                          state_is("ID")), state_is("CA")))
    join = HashJoinExecutor(a, p, [1], [0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    plan = _mv(join, (5, 6, 7, 0, 3, 8),
               ("name", "city", "state", "id", "_pk0", "_pk1"), mv_table)
    plan.join = join
    return plan


def q4(auction: Executor, bid: Executor, mv_table: StateTable, *,
       key_capacity: int = 1 << 13, bucket_width: int = 16,
       agg_capacity: int = 1 << 16, out_capacity: int = 1024,
       device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``q4_schema()``, pk (0,)."""
    a = _project(with_row_id(auction, 0, device), (0, 5, 6, 8, 10),
                 ("id", "date_time", "expires", "category", "_row_id"))
    b = _project(with_row_id(bid, 0, device), (0, 2, 5, 7),
                 ("auction", "price", "date_time", "_row_id"))
    join = HashJoinExecutor(a, b, [0], [0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    ts = col(7, TIMESTAMP)
    within = FilterExecutor(join, call(
        "and", call("greater_than_or_equal", ts, col(1, TIMESTAMP)),
        call("less_than_or_equal", ts, col(2, TIMESTAMP))))
    final = HashAggExecutor(
        _project(within, (0, 3, 6), ("id", "category", "price")), [0, 1],
        [agg("max", 2, INT64)], table_capacity=agg_capacity,
        out_capacity=out_capacity, device=device)
    avg = HashAggExecutor(
        _project(final, (1, 2), ("category", "final")), [0],
        [agg("avg", 1, INT64)], table_capacity=agg_capacity,
        out_capacity=out_capacity, device=device)
    plan = _mv(avg, (0, 1), ("category", "avg"), mv_table)
    plan.join, plan.aggs = join, (final, avg)
    return plan


def q7(bid: Executor, bid_max: Executor, mv_table: StateTable, *,
       key_capacity: int = 1 << 13, bucket_width: int = 16,
       agg_capacity: int = 1 << 16, out_capacity: int = 1024,
       device=DEFAULT_DEVICE) -> Plan:
    """``bid_max``: a second source of the same bids (the subquery's).
    ``mv_table``: schema ``q7_schema()``, pk (4, 5)."""
    left = _project(with_row_id(bid, 0, device), (0, 1, 2, 5, 7),
                    ("auction", "bidder", "price", "date_time", "_row_id"))
    _, end = _tumble(5)
    windows = ProjectExecutor(with_row_id(bid_max, 0, device),
                              [end, _i64(2)], ("date_time", "price"))
    top = HashAggExecutor(windows, [0], [agg("max", 1, INT64)],
                          table_capacity=agg_capacity,
                          out_capacity=out_capacity, device=device)
    right = _project(top, (1, 0), ("maxprice", "date_time"))
    join = HashJoinExecutor(left, right, [2], [0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    ts, end_col = col(3, TIMESTAMP), col(6, TIMESTAMP)
    within = FilterExecutor(join, call(
        "and", call("greater_than_or_equal", ts,
                    call("subtract", end_col, _lit(TUMBLE_SIZE, INT64))),
        call("less_than_or_equal", ts, end_col)))
    plan = _mv(within, (0, 2, 1, 3, 4, 6),
               ("auction", "price", "bidder", "date_time", "_pk0", "_pk1"),
               mv_table)
    plan.join, plan.aggs = join, (top,)
    return plan


def q8(person: Executor, auction: Executor, mv_table: StateTable, *,
       key_capacity: int = 1 << 13, bucket_width: int = 16,
       agg_capacity: int = 1 << 16, out_capacity: int = 1024,
       device=DEFAULT_DEVICE) -> Plan:
    """``mv_table``: schema ``q8_schema()``, pk (0, 1, 2, 3, 4, 5, 6)."""
    p_start, p_end = _tumble(6)
    p = ProjectExecutor(with_row_id(person, 0, device),
                        [_i64(0), col(1, VARCHAR), p_start, p_end],
                        ("id", "name", "starttime", "endtime"))
    p_groups = HashAggExecutor(p, [0, 1, 2, 3], [],
                               table_capacity=agg_capacity,
                               out_capacity=out_capacity, device=device)
    a_start, a_end = _tumble(5)
    a = ProjectExecutor(with_row_id(auction, 0, device),
                        [_i64(7), a_start, a_end],
                        ("seller", "starttime", "endtime"))
    a_groups = HashAggExecutor(a, [0, 1, 2], [],
                               table_capacity=agg_capacity,
                               out_capacity=out_capacity, device=device)
    join = HashJoinExecutor(_project(p_groups, (0, 1, 2, 3),
                                     ("id", "name", "starttime", "endtime")),
                            _project(a_groups, (0, 1, 2),
                                     ("seller", "starttime", "endtime")),
                            [0, 2, 3],
                            [0, 1, 2], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    plan = _mv(join, range(7), ("id", "name", "starttime", "_pk3", "_pk4",
                                "_pk5", "_pk6"), mv_table)
    plan.join, plan.aggs = join, (p_groups, a_groups)
    return plan


def q1_schema() -> Schema:
    return Schema.of(("auction", INT64), ("bidder", INT64),
                     ("price", INT64), ("date_time", TIMESTAMP),
                     ("_pk0", SERIAL))


def q2_schema() -> Schema:
    return Schema.of(("auction", INT64), ("price", INT64), ("_pk0", SERIAL))


def q3_schema() -> Schema:
    return Schema.of(("name", VARCHAR), ("city", VARCHAR),
                     ("state", VARCHAR), ("id", INT64), ("_pk0", SERIAL),
                     ("_pk1", SERIAL))


def q4_schema() -> Schema:
    from ..common.types import FLOAT64
    return Schema.of(("category", INT64), ("avg", FLOAT64))


def q7_schema() -> Schema:
    return Schema.of(("auction", INT64), ("price", INT64),
                     ("bidder", INT64), ("date_time", TIMESTAMP),
                     ("_pk0", SERIAL), ("_pk1", TIMESTAMP))


def q8_schema() -> Schema:
    return Schema.of(("id", INT64), ("name", VARCHAR),
                     ("starttime", TIMESTAMP), ("_pk3", TIMESTAMP),
                     ("_pk4", INT64), ("_pk5", TIMESTAMP),
                     ("_pk6", TIMESTAMP))


# ---------------------------------------------------------------------------
# the rest of the NEXmark suite (tests/test_nexmark_extended.py): q0, q9,
# q10, q14-q17, q20-q22, q101, q103, q104, q106
# ---------------------------------------------------------------------------

#: q21's channel_id pattern and its known channels
CHANNEL_ID_PATTERN = "(&|^)channel_id=([^&]*)"
KNOWN_CHANNELS = (("apple", "0"), ("google", "1"), ("facebook", "2"),
                  ("baidu", "3"))


def _ts(index: int):
    return col(index, TIMESTAMP)


def _str(v) -> Literal:
    return Literal(v, VARCHAR)


def _to_char(ts_col: int, fmt: str):
    return call("to_char", _ts(ts_col), _str(fmt))


def _price_rank(price_col: int, lo: Optional[int], hi: Optional[int]):
    """``lo <= price < hi`` (either bound open), as the binder writes a
    FILTER clause's condition."""
    p = _i64(price_col)
    parts = []
    if lo is not None:
        parts.append(call("greater_than_or_equal", p, _lit(lo)))
    if hi is not None:
        parts.append(call("less_than", p, _lit(hi)))
    return parts[0] if len(parts) == 1 else call("and", *parts)


def _filtered(cond, value):
    """``agg(value) FILTER (WHERE cond)``: the CASE-wrapped argument."""
    return call("case", cond, value)


def q0(bid: Executor, mv_table: StateTable, *,
       device=DEFAULT_DEVICE) -> Plan:
    """``SELECT auction, bidder, price, date_time FROM bid``: bids →
    RowIdGen → Project → Materialize. ``mv_table``: schema ``q0_schema()``,
    pk (4,)."""
    return _mv(with_row_id(bid, 0, device), (0, 1, 2, 5, 7),
               ("auction", "bidder", "price", "date_time", "_pk0"), mv_table)


def q9(auction: Executor, bid: Executor, mv_table: StateTable, *,
       key_capacity: int = 1 << 13, bucket_width: int = 16,
       topn_capacity: int = 1 << 16, out_capacity: int = 1024,
       device=DEFAULT_DEVICE) -> Plan:
    """The winning bid of each auction id: auction ⋈ bid on id = auction →
    Filter(bid time BETWEEN the auction's date_time and expires) →
    GroupTopN(id; price desc, date_time asc; limit 1) → Project →
    Materialize (``ROW_NUMBER() ... <= 1``). ``mv_table``: schema
    ``q9_schema()``, pk (6, 7)."""
    a = _project(with_row_id(auction, 0, device), (0, 1, 5, 6, 10),
                 ("id", "item_name", "date_time", "expires", "_row_id"))
    b = _project(with_row_id(bid, 0, device), (0, 1, 2, 5, 7),
                 ("auction", "bidder", "price", "date_time", "_row_id"))
    join = HashJoinExecutor(a, b, [0], [0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    ts = _ts(8)
    within = FilterExecutor(join, call(
        "and", call("greater_than_or_equal", ts, _ts(2)),
        call("less_than_or_equal", ts, _ts(3))))
    top = TopNExecutor(within, [OrderSpec(7, desc=True, nulls_last=False),
                                OrderSpec(8)], 0, 1, pk_indices=[4, 9],
                       group_by=[0], table_capacity=topn_capacity,
                       out_capacity=out_capacity, device=device)
    plan = _mv(top, (0, 1, 5, 6, 7, 8, 4, 9),
               ("id", "item_name", "auction", "bidder", "price",
                "bid_date_time", "_pk0", "_pk1"), mv_table)
    plan.join, plan.top_n = join, top
    return plan


def q10(bid: Executor, mv_table: StateTable, *,
        device=DEFAULT_DEVICE) -> Plan:
    """Bids with ``TO_CHAR(date_time, 'YYYY-MM-DD')`` and ``'HH:MI'``:
    bids → RowIdGen → Project → Materialize. ``mv_table``: schema
    ``q10_schema()``, pk (6,)."""
    rows = with_row_id(bid, 0, device)
    return Plan(MaterializeExecutor(ProjectExecutor(
        rows, [_i64(0), _i64(1), _i64(2), _ts(5),
               _to_char(5, "YYYY-MM-DD"), _to_char(5, "HH:MI"),
               col(7, SERIAL)],
        ("auction", "bidder", "price", "date_time", "date", "time",
         "_pk0")), mv_table))


def q14(bid: Executor, mv_table: StateTable, *,
        device=DEFAULT_DEVICE) -> Plan:
    """``908 * price / 1000`` over 1000, with the bid's time of day: bids →
    RowIdGen → Project → Filter → Project(the CASE of the hour) →
    Materialize. ``mv_table``: schema ``q14_schema()``, pk (5,)."""
    from ..expr.expr import make_extract
    rows = _project(with_row_id(bid, 0, device), (0, 1, 2, 5, 7),
                    ("auction", "bidder", "price", "date_time", "_row_id"))

    def price():
        return call("divide", call("multiply", _lit(908), _i64(2)),
                    _lit(1000))

    kept = FilterExecutor(rows, call("greater_than", price(), _lit(1000)))

    def hour():
        return make_extract("hour", _ts(3))

    kind = call(
        "case",
        call("and", call("greater_than_or_equal", hour(), _lit(8)),
             call("less_than_or_equal", hour(), _lit(18))),
        _str("dayTime"),
        call("or", call("less_than_or_equal", hour(), _lit(6)),
             call("greater_than_or_equal", hour(), _lit(20))),
        _str("nightTime"), _str("otherTime"))
    return Plan(MaterializeExecutor(ProjectExecutor(
        kept, [_i64(0), _i64(1), price(), kind, _ts(3), col(4, SERIAL)],
        ("auction", "bidder", "price", "bidtimetype", "date_time", "_pk0")),
        mv_table))


def q15(bid: Executor, mv_table: StateTable, *,
        out_capacity: int = 1024, device=DEFAULT_DEVICE) -> Plan:
    """Bidding statistics per day: bids → RowIdGen → Project(day, the
    FILTER clauses' CASE-wrapped arguments) → MaterializedAgg (its
    ``count(DISTINCT)`` calls put every call on the host tier) → Project →
    Materialize. ``mv_table``: schema ``q15_schema()``, pk (0,)."""
    rows = with_row_id(bid, 0, device)
    one = _lit(1)
    keyed = ProjectExecutor(rows, [
        _to_char(5, "yyyy-MM-dd"),
        _filtered(_price_rank(2, None, 10_000), one),
        _filtered(_price_rank(2, 10_000, 1_000_000), one),
        _filtered(_price_rank(2, 1_000_000, None), one),
        _i64(1),
        _filtered(_price_rank(2, None, 10_000), _i64(1)),
        _i64(0),
        _filtered(_price_rank(2, 1_000_000, None), _i64(0))],
        ("k0", "a0", "a1", "a2", "a3", "a4", "a5", "a6"))
    calls = [count_star()] + [agg("count", i, INT32) for i in (1, 2, 3)] + [
        agg("count", i, INT64, distinct=True) for i in (4, 5, 6, 7)]
    stats = MaterializedAggExecutor(keyed, [0], calls,
                                    out_capacity=out_capacity, device=device)
    plan = _mv(stats, range(9), [f.name for f in q15_schema()], mv_table)
    plan.aggs = (stats,)
    return plan


def q16(bid: Executor, mv_table: StateTable, *,
        out_capacity: int = 1024, device=DEFAULT_DEVICE) -> Plan:
    """Channel statistics per day: bids → RowIdGen → Project(channel, day,
    minute, the FILTER argument, bidder, auction) → MaterializedAgg(max
    of the minute string, count(*), the filtered count, two
    ``count(DISTINCT)``) → Project → Materialize. ``mv_table``: schema
    ``q16_schema()``, pk (0, 1)."""
    rows = with_row_id(bid, 0, device)
    keyed = ProjectExecutor(rows, [
        col(3, VARCHAR), _to_char(5, "YYYY-MM-DD"), _to_char(5, "HH:MI"),
        _filtered(_price_rank(2, None, 10_000), _lit(1)), _i64(1), _i64(0)],
        ("k0", "k1", "a0", "a1", "a2", "a3"))
    calls = [agg("max", 2, VARCHAR), count_star(), agg("count", 3, INT32),
             agg("count", 4, INT64, distinct=True),
             agg("count", 5, INT64, distinct=True)]
    stats = MaterializedAggExecutor(keyed, [0, 1], calls,
                                    out_capacity=out_capacity, device=device)
    plan = _mv(stats, range(7), [f.name for f in q16_schema()], mv_table)
    plan.aggs = (stats,)
    return plan


def q17_input(bid: Executor, device=DEFAULT_DEVICE) -> ProjectExecutor:
    """q17's agg input: bids → RowIdGen → Project(auction, day, the FILTER
    argument, price four times)."""
    rows = with_row_id(bid, 0, device)
    return ProjectExecutor(rows, [
        _i64(0), _to_char(5, "YYYY-MM-DD"),
        _filtered(_price_rank(2, None, 10_000), _lit(1))]
        + [_i64(2)] * 4, ("k0", "k1", "a0", "a1", "a2", "a3", "a4"))


def q17_calls() -> list:
    """count(*), the filtered count, min, max, avg and sum of the price."""
    return [count_star(), agg("count", 2, INT32), agg("min", 3, INT64),
            agg("max", 4, INT64), agg("avg", 5, INT64), agg("sum", 6, INT64)]


def q17_output(agg_root: Executor) -> ProjectExecutor:
    s = agg_root.schema
    return ProjectExecutor(agg_root, [col(i, s[i].type) for i in range(8)],
                           [f.name for f in q17_schema()])


def q17(bid: Executor, mv_table: StateTable, *,
        agg_capacity: int = 1 << 16, out_capacity: int = 1024,
        device=DEFAULT_DEVICE) -> Plan:
    """Auction statistics per day: ``q17_input`` → HashAgg((auction, day);
    ``q17_calls``) → Project → Materialize. ``mv_table``: schema
    ``q17_schema()``, pk (0, 1)."""
    stats = HashAggExecutor(q17_input(bid, device), [0, 1], q17_calls(),
                            table_capacity=agg_capacity,
                            out_capacity=out_capacity, device=device)
    plan = Plan(MaterializeExecutor(q17_output(stats), mv_table))
    plan.aggs = (stats,)
    return plan


def q20(bid: Executor, auction: Executor, mv_table: StateTable, *,
        key_capacity: int = 1 << 13, bucket_width: int = 16,
        out_capacity: int = 1024, device=DEFAULT_DEVICE) -> Plan:
    """Bids joined with their auction of category 10: bids → RowIdGen →
    Project; auctions → RowIdGen → Project → Filter; HashJoin → Project →
    Materialize. ``mv_table``: schema ``q20_schema()``, pk (7, 8)."""
    b, a = q20_sides(bid, auction, device)
    join = HashJoinExecutor(b, a, [0], [0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    plan = Plan(MaterializeExecutor(q20_output(join), mv_table))
    plan.join = join
    return plan


def q20_sides(bid: Executor, auction: Executor, device=DEFAULT_DEVICE):
    """q20's two join inputs (bids, auctions of category 10)."""
    b = _project(with_row_id(bid, 0, device), (0, 1, 2, 3, 7),
                 ("auction", "bidder", "price", "channel", "_row_id"))
    a = FilterExecutor(
        _project(with_row_id(auction, 0, device), (0, 1, 7, 8, 10),
                 ("id", "item_name", "seller", "category", "_row_id")),
        call("equal", _i64(3), _lit(10)))
    return b, a


def q20_output(join: Executor) -> ProjectExecutor:
    s = join.schema
    return ProjectExecutor(
        join, [col(i, s[i].type) for i in (0, 1, 2, 3, 6, 7, 8, 4, 9)],
        [f.name for f in q20_schema()])


def q21(bid: Executor, mv_table: StateTable, *,
        device=DEFAULT_DEVICE) -> Plan:
    """The channel id of a bid, from its channel or its URL: bids →
    RowIdGen → Project → Filter → Project(CASE ... ELSE
    ``(regexp_match(url, ...))[2]``) → Materialize. ``mv_table``: schema
    ``q21_schema()``, pk (5,)."""
    rows = _project(with_row_id(bid, 0, device), (0, 1, 2, 3, 4, 7),
                    ("auction", "bidder", "price", "channel", "url",
                     "_row_id"))

    def from_url():
        return call("regexp_match_group", col(4, VARCHAR),
                    _str(CHANNEL_ID_PATTERN), _lit(2))

    def channel_is(name):
        return call("equal", call("lower", col(3, VARCHAR)), _str(name))

    known = channel_is(KNOWN_CHANNELS[0][0])
    for name, _ in KNOWN_CHANNELS[1:]:
        known = call("or", known, channel_is(name))
    kept = FilterExecutor(rows, call("or", call("is_not_null", from_url()),
                                     known))
    case = []
    for name, cid in KNOWN_CHANNELS:
        case += [channel_is(name), _str(cid)]
    return Plan(MaterializeExecutor(ProjectExecutor(
        kept, [_i64(0), _i64(1), _i64(2), col(3, VARCHAR),
               call("case", *case, from_url()), col(5, SERIAL)],
        ("auction", "bidder", "price", "channel", "channel_id", "_pk0")),
        mv_table))


def q22(bid: Executor, mv_table: StateTable, *,
        device=DEFAULT_DEVICE) -> Plan:
    """The URL's first three directories by ``split_part``: bids →
    RowIdGen → Project → Materialize. ``mv_table``: schema
    ``q22_schema()``, pk (7,)."""
    rows = with_row_id(bid, 0, device)
    dirs = [call("split_part", col(4, VARCHAR), _str("/"), _lit(n))
            for n in (4, 5, 6)]
    return Plan(MaterializeExecutor(ProjectExecutor(
        rows, [_i64(0), _i64(1), _i64(2), col(3, VARCHAR)] + dirs
        + [col(7, SERIAL)],
        ("auction", "bidder", "price", "channel", "dir1", "dir2", "dir3",
         "_pk0")), mv_table))


def _auction_items(auction: Executor, device) -> ProjectExecutor:
    return _project(with_row_id(auction, 0, device), (0, 1, 10),
                    ("id", "item_name", "_row_id"))


def _bid_counts(bid: Executor, agg_capacity: int, out_capacity: int,
                device) -> HashAggExecutor:
    """bids → RowIdGen → Project(auction) → HashAgg(count(*))."""
    auctions = _project(with_row_id(bid, 0, device), (0,), ("k0",))
    return HashAggExecutor(auctions, [0], [count_star()],
                           table_capacity=agg_capacity,
                           out_capacity=out_capacity, device=device)


def q101(auction: Executor, bid: Executor, mv_table: StateTable, *,
         key_capacity: int = 1 << 13, bucket_width: int = 16,
         agg_capacity: int = 1 << 16, out_capacity: int = 1024,
         device=DEFAULT_DEVICE) -> Plan:
    """Each auction with its highest bid: auctions LEFT JOIN (bids →
    HashAgg(max(price)) per auction) → Project → Materialize.
    ``mv_table``: schema ``q101_schema()``, pk (3, 4)."""
    prices = _project(with_row_id(bid, 0, device), (0, 2), ("k0", "a0"))
    best = HashAggExecutor(prices, [0], [agg("max", 1, INT64)],
                           table_capacity=agg_capacity,
                           out_capacity=out_capacity, device=device)
    right = _project(best, (0, 1), ("auction", "max_price"))
    join = HashJoinExecutor(_auction_items(auction, device), right, [0], [0],
                            JoinType.LEFT_OUTER, key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    plan = _mv(join, (0, 1, 4, 2, 3),
               ("auction_id", "item_name", "max_price", "_pk0", "_pk1"),
               mv_table)
    plan.join, plan.aggs = join, (best,)
    return plan


def _semi_anti(auction: Executor, bid: Executor, mv_table: StateTable,
               cmp: str, anti: bool, key_capacity: int, bucket_width: int,
               agg_capacity: int, out_capacity: int, device) -> Plan:
    counts = _bid_counts(bid, agg_capacity, out_capacity, device)
    having = FilterExecutor(counts, call(cmp, _i64(1), _lit(2)))
    right = _project(having, (0,), ("auction",))
    left = _auction_items(auction, device)
    if anti:
        left = FilterExecutor(left, call("is_not_null", _i64(0)))
    join = HashJoinExecutor(
        left, right, [0], [0],
        JoinType.LEFT_ANTI if anti else JoinType.LEFT_SEMI,
        key_capacity=key_capacity, bucket_width=bucket_width,
        out_capacity=out_capacity, null_aware_anti=anti, device=device)
    plan = _mv(join, (0, 1, 2), ("auction_id", "item_name", "_pk0"),
               mv_table)
    plan.join, plan.aggs = join, (counts,)
    return plan


def q103(auction: Executor, bid: Executor, mv_table: StateTable, *,
         key_capacity: int = 1 << 13, bucket_width: int = 16,
         agg_capacity: int = 1 << 16, out_capacity: int = 1024,
         device=DEFAULT_DEVICE) -> Plan:
    """Auctions with at least two bids (``IN`` a HAVING subquery): a semi
    join of the auctions with bids → HashAgg(count(*)) → Filter(>= 2) →
    Project. ``mv_table``: schema ``q103_schema()``, pk (2,)."""
    return _semi_anti(auction, bid, mv_table, "greater_than_or_equal",
                      False, key_capacity, bucket_width, agg_capacity,
                      out_capacity, device)


def q104(auction: Executor, bid: Executor, mv_table: StateTable, *,
         key_capacity: int = 1 << 13, bucket_width: int = 16,
         agg_capacity: int = 1 << 16, out_capacity: int = 1024,
         device=DEFAULT_DEVICE) -> Plan:
    """Auctions without exactly one bid (``NOT IN`` a HAVING subquery): a
    null-aware anti join of the auctions (Filter(id IS NOT NULL)) with
    bids → HashAgg(count(*)) → Filter(< 2) → Project. ``mv_table``: schema
    ``q103_schema()``, pk (2,)."""
    return _semi_anti(auction, bid, mv_table, "less_than", True,
                      key_capacity, bucket_width, agg_capacity,
                      out_capacity, device)


def q106(auction: Executor, bid: Executor, mv_table: StateTable, *,
         key_capacity: int = 1 << 13, bucket_width: int = 16,
         agg_capacity: int = 1 << 16, out_capacity: int = 1024,
         device=DEFAULT_DEVICE) -> Plan:
    """The lowest final price: auction ⋈ bid → Filter(bid time within the
    auction) → Project → HashAgg(max(price) per auction) → Project →
    MaterializedAgg(min; its input retracts) → Project → Materialize.
    ``mv_table``: schema ``q106_schema()``, no pk (one row)."""
    a = _project(with_row_id(auction, 0, device), (0, 5, 6, 10),
                 ("id", "date_time", "expires", "_row_id"))
    b = _project(with_row_id(bid, 0, device), (0, 2, 5, 7),
                 ("auction", "price", "date_time", "_row_id"))
    join = HashJoinExecutor(a, b, [0], [0], JoinType.INNER,
                            key_capacity=key_capacity,
                            bucket_width=bucket_width,
                            out_capacity=out_capacity, device=device)
    ts = _ts(6)
    within = FilterExecutor(join, call(
        "and", call("greater_than_or_equal", ts, _ts(1)),
        call("less_than_or_equal", ts, _ts(2))))
    final = HashAggExecutor(_project(within, (0, 5), ("k0", "a0")), [0],
                            [agg("max", 1, INT64)],
                            table_capacity=agg_capacity,
                            out_capacity=out_capacity, device=device)
    lowest = MaterializedAggExecutor(_project(final, (1,), ("a0",)), [],
                                     [agg("min", 0, INT64)],
                                     out_capacity=out_capacity,
                                     device=device)
    plan = _mv(lowest, (0,), ("min_final",), mv_table)
    plan.join, plan.aggs = join, (final, lowest)
    return plan


def q0_schema() -> Schema:
    return q1_schema()


def q9_schema() -> Schema:
    return Schema.of(("id", INT64), ("item_name", VARCHAR),
                     ("auction", INT64), ("bidder", INT64), ("price", INT64),
                     ("bid_date_time", TIMESTAMP), ("_pk0", SERIAL),
                     ("_pk1", SERIAL))


def q10_schema() -> Schema:
    return Schema.of(("auction", INT64), ("bidder", INT64), ("price", INT64),
                     ("date_time", TIMESTAMP), ("date", VARCHAR),
                     ("time", VARCHAR), ("_pk0", SERIAL))


def q14_schema() -> Schema:
    return Schema.of(("auction", INT64), ("bidder", INT64), ("price", INT64),
                     ("bidtimetype", VARCHAR), ("date_time", TIMESTAMP),
                     ("_pk0", SERIAL))


def q15_schema() -> Schema:
    return Schema.of(("day", VARCHAR), *((n, INT64) for n in (
        "total_bids", "rank1_bids", "rank2_bids", "rank3_bids",
        "total_bidders", "rank1_bidders", "total_auctions",
        "rank3_auctions")))


def q16_schema() -> Schema:
    return Schema.of(("channel", VARCHAR), ("day", VARCHAR),
                     ("minute", VARCHAR), ("total_bids", INT64),
                     ("rank1_bids", INT64), ("total_bidders", INT64),
                     ("total_auctions", INT64))


def q17_schema() -> Schema:
    from ..common.types import FLOAT64
    return Schema.of(("auction", INT64), ("day", VARCHAR),
                     ("total_bids", INT64), ("rank1_bids", INT64),
                     ("min_price", INT64), ("max_price", INT64),
                     ("avg_price", FLOAT64), ("sum_price", INT64))


def q20_schema() -> Schema:
    return Schema.of(("auction", INT64), ("bidder", INT64), ("price", INT64),
                     ("channel", VARCHAR), ("item_name", VARCHAR),
                     ("seller", INT64), ("category", INT64),
                     ("_pk0", SERIAL), ("_pk1", SERIAL))


def q21_schema() -> Schema:
    return Schema.of(("auction", INT64), ("bidder", INT64), ("price", INT64),
                     ("channel", VARCHAR), ("channel_id", VARCHAR),
                     ("_pk0", SERIAL))


def q22_schema() -> Schema:
    return Schema.of(("auction", INT64), ("bidder", INT64), ("price", INT64),
                     ("channel", VARCHAR), ("dir1", VARCHAR),
                     ("dir2", VARCHAR), ("dir3", VARCHAR), ("_pk0", SERIAL))


def q101_schema() -> Schema:
    return Schema.of(("auction_id", INT64), ("item_name", VARCHAR),
                     ("max_price", INT64), ("_pk0", SERIAL), ("_pk1", INT64))


def q103_schema() -> Schema:
    return Schema.of(("auction_id", INT64), ("item_name", VARCHAR),
                     ("_pk0", SERIAL))


def q104_schema() -> Schema:
    return q103_schema()


def q106_schema() -> Schema:
    return Schema.of(("min_final", INT64))
