"""TPC-H q3 and q10 as streaming MVs over tables: the table schemas and
the executor trees, created in a ``frontend.runtime.Cluster``.

Each table is a stream job of its own, DML queue → [RowIdGen] →
Materialize (the reference Session's ``_create_table``): DML chunks
staged in the ``DmlManager`` reach it inside one epoch, and what its
Materialize passes on is republished on the job's changelog bus. A
``TableScan`` leaf of an MV is a ``BackfillExecutor`` over the table's
StateTable, fed the table's live deltas by a ``QueueSource`` subscribed to
that bus, with a progress table of its own.

The trees are the reference planner's for ``tests/test_tpch.py``'s SQL
(its ``EXPLAIN``), executor for executor:

  * q3: customer ``Project($0, $6)`` → ``Filter(c_mktsegment =
    'BUILDING')``, orders ``Filter(o_orderdate < 1995-03-15)``, joined on
    c_custkey = o_custkey; that joined with lineitem ``Project($0..$4)`` →
    ``Filter(l_shipdate > 1995-03-15)`` on o_orderkey = l_orderkey →
    ``Project(o_orderkey, o_orderdate, o_shippriority, l_extendedprice *
    (1 - l_discount))`` → ``HashAgg(keys 0, 1, 2; sum(3))`` →
    ``Project($0, $3, $1, $2)`` → Materialize, pk (0, 2, 3);
  * q10: customer ``Project($0, $1, $3)`` ⋈ orders ``Project($0, $1, $2)``
    → ``Filter(1993-10-01 <= o_orderdate < 1994-01-01)`` on c_custkey =
    o_custkey; ⋈ lineitem ``Project($0, $1, $2, $3, $5)`` →
    ``Filter(l_returnflag = 'R')`` on o_orderkey; ⋈ nation on c_nationkey
    = n_nationkey → ``Project(c_custkey, c_name, n_name, revenue)`` →
    ``HashAgg(keys 0, 1, 2; sum(3))`` → ``Project($0, $1, $3, $2)`` →
    Materialize, pk (0, 1, 3).

DECIMAL columns have scale 2 (the binder's DECIMAL), so revenue is a
DECIMAL of scale 4 summed exactly in int64 lanes. Capacities are
arguments; the defaults are the reference planner's.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Sequence

from .. import DEFAULT_DEVICE
from ..common.chunk import DEFAULT_CHUNK_CAPACITY
from ..common.types import DATE, INT64, VARCHAR, Schema, decimal
from ..expr.agg import AggCall
from ..expr.expr import Literal, call, col
from ..frontend.runtime import Cluster
from ..ops.join_state import JoinType
from ..storage.state_table import StateTable
from .executor import Executor
from .hash_agg import HashAggExecutor
from .hash_join import HashJoinExecutor
from .materialize import MaterializeExecutor
from .project import FilterExecutor, ProjectExecutor

DEC = decimal(2)

CUSTOMER_SCHEMA = Schema.of(
    ("c_custkey", INT64), ("c_name", VARCHAR), ("c_address", VARCHAR),
    ("c_nationkey", INT64), ("c_phone", VARCHAR), ("c_acctbal", DEC),
    ("c_mktsegment", VARCHAR), ("c_comment", VARCHAR))
ORDERS_SCHEMA = Schema.of(
    ("o_orderkey", INT64), ("o_custkey", INT64), ("o_orderdate", DATE),
    ("o_shippriority", INT64))
LINEITEM_SCHEMA = Schema.of(
    ("l_orderkey", INT64), ("l_linenumber", INT64),
    ("l_extendedprice", DEC), ("l_discount", DEC), ("l_shipdate", DATE),
    ("l_returnflag", VARCHAR))
NATION_SCHEMA = Schema.of(("n_nationkey", INT64), ("n_name", VARCHAR))

#: table -> (schema, pk)
TABLES = {"customer": (CUSTOMER_SCHEMA, (0,)),
          "orders": (ORDERS_SCHEMA, (0,)),
          "lineitem": (LINEITEM_SCHEMA, (0, 1)),
          "nation": (NATION_SCHEMA, (0,))}


def day(iso: str) -> int:
    """A DATE literal: days since 1970-01-01."""
    return (datetime.date.fromisoformat(iso)
            - datetime.date(1970, 1, 1)).days


Q3_DATE = day("1995-03-15")
Q10_FROM, Q10_TO = day("1993-10-01"), day("1994-01-01")

Q3_SCHEMA = Schema.of(("o_orderkey", INT64), ("revenue", decimal(4)),
                      ("o_orderdate", DATE), ("o_shippriority", INT64))
Q3_PK = (0, 2, 3)
Q10_SCHEMA = Schema.of(("c_custkey", INT64), ("c_name", VARCHAR),
                       ("revenue", decimal(4)), ("n_name", VARCHAR))
Q10_PK = (0, 1, 3)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Capacities of the q3 and q10 trees: the key capacity and bucket
    width of each join (in tree order, innermost first) and the agg's
    group table. The defaults are the reference planner's."""

    joins: tuple = ((1 << 13, 16),) * 3
    agg_capacity: int = 1 << 16
    out_capacity: int = DEFAULT_CHUNK_CAPACITY


def _project(input: Executor, cols: Sequence[int]) -> ProjectExecutor:
    s = input.schema
    return ProjectExecutor(input, [col(i, s[i].type) for i in cols],
                           [s[i].name for i in cols])


def _revenue(price: int, disc: int):
    """l_extendedprice * (1 - l_discount): DECIMAL(2) * DECIMAL(2) →
    DECIMAL(4), the literal 1 cast up to the discount's scale."""
    return call("multiply", col(price, DEC),
                call("subtract", Literal(1, INT64), col(disc, DEC)))


def _join(left, right, lk, rk, sizes: Sizes, i: int, device):
    cap, width = sizes.joins[i]
    return HashJoinExecutor(left, right, [lk], [rk], JoinType.INNER,
                            key_capacity=cap, bucket_width=width,
                            out_capacity=sizes.out_capacity, device=device)


def _agg_root(joined: Executor, exprs, names, final: Sequence[int],
              sizes: Sizes, device) -> tuple:
    pre = ProjectExecutor(joined, exprs, names)
    agg = HashAggExecutor(pre, [0, 1, 2],
                          [AggCall("sum", 3, pre.schema[3].type)],
                          table_capacity=sizes.agg_capacity,
                          out_capacity=sizes.out_capacity, device=device)
    s = agg.schema
    out = ProjectExecutor(agg, [col(i, s[i].type) for i in final],
                          [names[i] for i in final])
    return out, agg


def q3(customer: Executor, orders: Executor, lineitem: Executor,
       mv_table: StateTable, sizes: Sizes = Sizes(),
       device=DEFAULT_DEVICE) -> "MvPlan":
    """The scans are the tables' Backfill leaves (``Cluster.scan``).
    ``mv_table``: schema ``Q3_SCHEMA``, pk ``Q3_PK``."""
    cust = FilterExecutor(_project(customer, (0, 6)),
                   call("equal", col(1, VARCHAR),
                        Literal("BUILDING", VARCHAR)))
    ords = FilterExecutor(orders, call("less_than", col(2, DATE),
                                Literal(Q3_DATE, DATE)))
    co = _join(cust, ords, 0, 1, sizes, 0, device)
    items = FilterExecutor(_project(lineitem, (0, 1, 2, 3, 4)),
                    call("greater_than", col(4, DATE),
                         Literal(Q3_DATE, DATE)))
    col_ = _join(co, items, 2, 0, sizes, 1, device)
    out, agg = _agg_root(
        col_, [col(2, INT64), col(4, DATE), col(5, INT64), _revenue(8, 9)],
        ["o_orderkey", "o_orderdate", "o_shippriority", "revenue"],
        (0, 3, 1, 2), sizes, device)
    return MvPlan(MaterializeExecutor(out, mv_table), (co, col_), agg)


def q10(customer: Executor, orders: Executor, lineitem: Executor,
        nation: Executor, mv_table: StateTable, sizes: Sizes = Sizes(),
        device=DEFAULT_DEVICE) -> "MvPlan":
    """The scans are the tables' Backfill leaves (``Cluster.scan``).
    ``mv_table``: schema ``Q10_SCHEMA``, pk ``Q10_PK``."""
    cust = _project(customer, (0, 1, 3))
    ords = FilterExecutor(_project(orders, (0, 1, 2)), call(
        "and",
        call("greater_than_or_equal", col(2, DATE), Literal(Q10_FROM, DATE)),
        call("less_than", col(2, DATE), Literal(Q10_TO, DATE))))
    co = _join(cust, ords, 0, 1, sizes, 0, device)
    items = FilterExecutor(_project(lineitem, (0, 1, 2, 3, 5)),
                    call("equal", col(4, VARCHAR), Literal("R", VARCHAR)))
    col_ = _join(co, items, 3, 0, sizes, 1, device)
    coln = _join(col_, nation, 2, 0, sizes, 2, device)
    out, agg = _agg_root(
        coln, [col(0, INT64), col(1, VARCHAR), col(12, VARCHAR),
               _revenue(8, 9)],
        ["c_custkey", "c_name", "n_name", "revenue"], (0, 1, 3, 2),
        sizes, device)
    return MvPlan(MaterializeExecutor(out, mv_table), (co, col_, coln), agg)


@dataclasses.dataclass
class MvPlan:
    """A built MV tree: ``mv`` its root; its joins (innermost first) and
    agg, for counters and state."""

    mv: MaterializeExecutor
    joins: tuple
    agg: HashAggExecutor


def create_tables(cluster: Cluster) -> None:
    for name, (schema, pk) in TABLES.items():
        cluster.create_table(name, schema, pk)


def create_q3(cluster: Cluster, sizes: Sizes = Sizes()) -> MvPlan:
    plan = q3(cluster.scan("customer"), cluster.scan("orders"),
              cluster.scan("lineitem"),
              StateTable(cluster.store, cluster.next_table_id(), Q3_SCHEMA,
                         Q3_PK), sizes, cluster.device)
    cluster.create_mv("q3", plan.mv)
    return plan


def create_q10(cluster: Cluster, sizes: Sizes = Sizes()) -> MvPlan:
    plan = q10(cluster.scan("customer"), cluster.scan("orders"),
               cluster.scan("lineitem"), cluster.scan("nation"),
               StateTable(cluster.store, cluster.next_table_id(), Q10_SCHEMA,
                          Q10_PK), sizes, cluster.device)
    cluster.create_mv("q10", plan.mv)
    return plan
