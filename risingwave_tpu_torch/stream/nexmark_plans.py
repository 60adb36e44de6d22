"""The executor trees of NEXmark q105, q102 and q18, built from this
package's executors.

Each tree is the one the reference's planner builds for the query (its
``EXPLAIN``), executor for executor:

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
    Project → GroupTopN(limit 1, WITH TIES) → Project → Materialize.

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
from ..common.types import INT64, SERIAL, Field, Schema
from ..expr.agg import AggCall, count_star
from ..expr.expr import call, col
from ..ops.join_state import JoinType
from ..ops.topn import OrderSpec
from ..storage.state_table import StateTable
from .dynamic_filter import DynamicFilterExecutor
from .executor import Executor, SingleInputExecutor
from .hash_agg import HashAggExecutor
from .hash_join import HashJoinExecutor
from .materialize import MaterializeExecutor
from .materialized_agg import MaterializedAggExecutor
from .project import ProjectExecutor
from .row_id_gen import RowIdGenExecutor
from .top_n import TopNExecutor


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


def q105_schema() -> Schema:
    from ..connector.nexmark import AUCTION_SCHEMA
    return Schema((Field("auction_id", INT64), AUCTION_SCHEMA[1],
                   Field("bid_count", INT64)))


def q18_schema() -> Schema:
    from ..connector.nexmark import BID_SCHEMA
    return Schema(tuple(BID_SCHEMA[i] for i in (0, 1, 2, 5))
                  + (Field("_pk0", SERIAL),))
