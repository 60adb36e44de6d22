"""Copy of ``risingwave_tpu/frontend/sqlast.py``: the reference's text,
its relative imports resolving to the port's modules.

SQL AST node definitions.

Counterpart of the reference's sqlparser AST (reference: src/sqlparser/src/
ast/mod.rs — trimmed to the streaming-SQL subset this frontend accepts:
CREATE SOURCE / TABLE / MATERIALIZED VIEW / INDEX, DROP, INSERT, SELECT with
joins, GROUP BY, HAVING, ORDER BY / LIMIT / OFFSET, window TVFs
(TUMBLE/HOP), scalar subqueries, UNION ALL, EMIT ON WINDOW CLOSE).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union


# -- expressions --------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ColumnRef:
    name: str
    table: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Lit:
    value: Any               # python value; None = NULL
    type_hint: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FuncCall:
    name: str
    args: tuple
    distinct: bool = False
    #: aggregate FILTER (WHERE <cond>) clause (reference:
    #: src/sqlparser/src/ast/mod.rs Function.filter)
    filter: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class BinaryOp:
    op: str                  # +,-,*,/,%,=,<>,<,<=,>,>=,AND,OR,||
    left: Any
    right: Any


@dataclasses.dataclass(frozen=True)
class UnaryOp:
    op: str                  # NOT, -
    operand: Any


@dataclasses.dataclass(frozen=True)
class Case:
    # [(cond, result), ...], else_result
    branches: tuple
    else_result: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class InList:
    expr: Any
    items: tuple
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Between:
    expr: Any
    low: Any
    high: Any
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class IsNull:
    expr: Any
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Cast:
    expr: Any
    type_name: str


@dataclasses.dataclass(frozen=True)
class ScalarSubquery:
    query: "Select"


@dataclasses.dataclass(frozen=True)
class InSubquery:
    """<expr> [NOT] IN (SELECT …) — planned as a left semi/anti join
    (reference: the ApplyJoin subquery-unnesting rules in
    src/frontend/src/optimizer/rule/apply_join_transpose_rule.rs)."""

    expr: Any
    query: "Select"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class ArrayLit:
    """ARRAY[e1, e2, …] constructor."""

    items: tuple


@dataclasses.dataclass(frozen=True)
class Subscript:
    """<expr>[<index>] — 1-based array element access (PG semantics)."""

    expr: Any
    index: Any


@dataclasses.dataclass(frozen=True)
class FieldAccess:
    """(<expr>).field — struct field access."""

    expr: Any
    field: str


@dataclasses.dataclass(frozen=True)
class WindowFunc:
    """fn(args) OVER (PARTITION BY … ORDER BY …)."""

    func: "FuncCall"
    partition_by: tuple = ()
    order_by: tuple = ()     # OrderItem...


@dataclasses.dataclass(frozen=True)
class Star:
    table: Optional[str] = None


Expr = Union[ColumnRef, Lit, FuncCall, BinaryOp, UnaryOp, Case, InList,
             Between, IsNull, Cast, ScalarSubquery, Star]


# -- relations ----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TableFuncRef:
    """FROM generate_series(1, 10) [AS g]."""

    name: str
    args: tuple
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class WindowTVF:
    """TUMBLE(t, time_col, interval) / HOP(t, time_col, slide, size)."""

    kind: str                # "tumble" | "hop"
    table: TableRef
    time_col: str
    args: tuple              # (size,) for tumble; (slide, size) for hop
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Join:
    kind: str                # inner/left/right/full/left_semi/left_anti
    left: Any
    right: Any
    on: Optional[Expr]
    #: FOR SYSTEM_TIME AS OF PROCTIME() — process-time temporal join:
    #: probe the right side's CURRENT materialized rows, no retractions
    temporal: bool = False


@dataclasses.dataclass(frozen=True)
class SubqueryRef:
    query: "Select"
    alias: str


Relation = Union[TableRef, TableFuncRef, WindowTVF, Join, SubqueryRef]


# -- statements ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class OrderItem:
    expr: Expr
    desc: bool = False
    nulls_last: Optional[bool] = None   # None = PG default by direction


@dataclasses.dataclass(frozen=True)
class Select:
    items: tuple             # SelectItem...
    from_: Optional[Relation]
    where: Optional[Expr] = None
    group_by: tuple = ()
    having: Optional[Expr] = None
    order_by: tuple = ()     # OrderItem...
    limit: Optional[int] = None
    offset: Optional[int] = None
    with_ties: bool = False
    distinct: bool = False
    union_all: Optional["Select"] = None   # SELECT ... UNION ALL SELECT ...
    emit_on_window_close: bool = False


@dataclasses.dataclass(frozen=True)
class ColumnDef:
    name: str
    type_name: str


@dataclasses.dataclass(frozen=True)
class CreateSource:
    name: str
    columns: tuple           # ColumnDef...
    with_options: dict
    watermark: Optional[tuple] = None    # (col, delay_expr)
    append_only: bool = True
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateTable:
    name: str
    columns: tuple
    pk: tuple = ()
    with_options: dict = dataclasses.field(default_factory=dict)
    append_only: bool = False
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateMaterializedView:
    name: str
    query: Select
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateSink:
    """CREATE SINK name FROM upstream | AS SELECT … WITH (connector=…)."""

    name: str
    from_name: Optional[str] = None
    query: Optional[Select] = None
    with_options: dict = dataclasses.field(default_factory=dict)
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class CreateIndex:
    name: str
    table: str
    columns: tuple
    if_not_exists: bool = False


@dataclasses.dataclass(frozen=True)
class DropStatement:
    kind: str                # source/table/materialized_view/index
    name: str
    if_exists: bool = False


@dataclasses.dataclass(frozen=True)
class Insert:
    table: str
    columns: tuple
    rows: tuple              # tuple of value-expr tuples


@dataclasses.dataclass(frozen=True)
class Delete:
    table: str
    where: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class Update:
    table: str
    assignments: tuple            # ((col, expr), ...)
    where: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class Query:
    """Top-level SELECT statement."""

    select: Select


@dataclasses.dataclass(frozen=True)
class ShowStatement:
    what: str                # tables/sources/materialized_views


@dataclasses.dataclass(frozen=True)
class FlushStatement:
    pass


@dataclasses.dataclass(frozen=True)
class SetStatement:
    """SET param = value (system params / session vars). ``system``
    marks the ALTER SYSTEM SET variant: the change propagates to every
    session attached to the same meta via a notification."""

    name: str
    value: Any
    system: bool = False


@dataclasses.dataclass(frozen=True)
class Explain:
    """EXPLAIN <statement>: show the optimized plan without executing
    (reference: handler/explain.rs — plan-only path)."""

    stmt: "Statement"


Statement = Union[CreateSink, CreateSource, CreateTable, CreateMaterializedView,
                  CreateIndex, DropStatement, Insert, Delete, Update, Query,
                  ShowStatement, FlushStatement, SetStatement, Explain]
