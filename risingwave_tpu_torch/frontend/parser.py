"""Copy of ``risingwave_tpu/frontend/parser.py``: the reference's text, its
relative imports resolving to the port's modules. One change:
``_type_name`` keeps a DECIMAL's arguments in the name it returns
(``decimal(p,s)``), which the reference drops (ROADMAP C3).

Recursive-descent SQL parser for the streaming subset.

Counterpart of the reference's hand-written parser
(reference: src/sqlparser/src/parser.rs — Postgres dialect plus streaming
extensions: CREATE SOURCE, CREATE MATERIALIZED VIEW, window TVFs, EMIT ON
WINDOW CLOSE). Precedence-climbing expression parsing; case-insensitive
keywords; '...' string literals; -- line comments.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

from . import sqlast as A

_TOKEN_RE = re.compile(r"""
    \s+
  | --[^\n]*
  | (?P<num>\d+\.\d+|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<name>[A-Za-z_][A-Za-z_0-9$]*)
  | (?P<op>->>|->|<>|!=|<=|>=|\|\||::|[-+*/%(),.<>=;\[\]])
""", re.VERBOSE)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "between", "is", "null",
    "case", "when", "then", "else", "end", "cast", "distinct", "join",
    "inner", "left", "right", "full", "outer", "on", "union", "all",
    "create", "drop", "insert", "into", "values", "table", "source",
    "materialized", "view", "index", "if", "exists", "with", "primary",
    "key", "watermark", "for", "interval", "asc", "desc", "nulls", "first",
    "last", "ties", "emit", "window", "close", "true", "false", "show",
    "tables", "sources", "flush", "tumble", "hop", "append", "only",
    "sink", "sinks", "over", "partition", "like", "extract", "set", "to",
    "parameters", "delete", "update", "explain", "alter", "system",
}


class Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: Any):
        self.kind = kind      # num / str / name / kw / op / eof
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise SqlParseError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup is None:
            continue
        text = m.group(m.lastgroup)
        if m.lastgroup == "num":
            v = float(text) if "." in text else int(text)
            out.append(Token("num", v))
        elif m.lastgroup == "str":
            out.append(Token("str", text[1:-1].replace("''", "'")))
        elif m.lastgroup == "name":
            low = text.lower()
            out.append(Token("kw" if low in KEYWORDS else "name", low))
        else:
            out.append(Token("op", text))
    out.append(Token("eof", None))
    return out


class SqlParseError(ValueError):
    pass


# interval unit -> microseconds (reference: INTERVAL literal binding)
_INTERVAL_UNITS = {
    "second": 1_000_000, "seconds": 1_000_000,
    "minute": 60_000_000, "minutes": 60_000_000,
    "hour": 3_600_000_000, "hours": 3_600_000_000,
    "day": 86_400_000_000, "days": 86_400_000_000,
}

_CMP_OPS = {"=", "<>", "!=", "<", "<=", ">", ">="}


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers --------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise SqlParseError(f"expected {kw.upper()}, got {self.peek()}")

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def eat_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.eat_op(op):
            raise SqlParseError(f"expected {op!r}, got {self.peek()}")

    def ident(self) -> str:
        t = self.next()
        if t.kind not in ("name", "kw"):
            raise SqlParseError(f"expected identifier, got {t}")
        return t.value

    # -- statements -----------------------------------------------------------

    def parse_statements(self) -> list[A.Statement]:
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.parse_statement())
            while self.eat_op(";"):
                pass
        return stmts

    def parse_statement(self) -> A.Statement:
        if self.eat_kw("explain"):
            return A.Explain(self.parse_statement())
        if self.at_kw("create"):
            return self._create()
        if self.at_kw("drop"):
            return self._drop()
        if self.at_kw("insert"):
            return self._insert()
        if self.at_kw("select"):
            return A.Query(self._select())
        if self.eat_kw("delete"):
            self.expect_kw("from")
            table = self.ident()
            where = self.parse_expr() if self.eat_kw("where") else None
            return A.Delete(table, where)
        if self.eat_kw("update"):
            table = self.ident()
            self.expect_kw("set")
            assigns = []
            while True:
                col = self.ident()
                self.expect_op("=")
                assigns.append((col, self.parse_expr()))
                if not self.eat_op(","):
                    break
            where = self.parse_expr() if self.eat_kw("where") else None
            return A.Update(table, tuple(assigns), where)
        if self.eat_kw("show"):
            what = self.ident()
            return A.ShowStatement(what)
        if self.eat_kw("flush"):
            return A.FlushStatement()
        if self.eat_kw("set"):
            name = self.ident()
            if not self.eat_op("="):
                self.expect_kw("to")
            t = self.next()
            return A.SetStatement(name, t.value)
        if self.eat_kw("alter"):
            # ALTER SYSTEM SET <param> = <value> | TO <value>: the
            # cluster-wide variant of SET (reference:
            # src/common/src/system_param/mod.rs hot propagation)
            self.expect_kw("system")
            self.expect_kw("set")
            name = self.ident()
            if not self.eat_op("="):
                self.expect_kw("to")
            t = self.next()
            return A.SetStatement(name, t.value, system=True)
        raise SqlParseError(f"unsupported statement at {self.peek()}")

    def _if_not_exists(self) -> bool:
        if self.eat_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            return True
        return False

    def _create(self) -> A.Statement:
        self.expect_kw("create")
        if self.eat_kw("source"):
            ine = self._if_not_exists()
            name = self.ident()
            columns, pk, watermark = self._column_defs()
            opts = self._with_options()
            return A.CreateSource(name, tuple(columns), opts,
                                  watermark=watermark, if_not_exists=ine)
        if self.eat_kw("table"):
            ine = self._if_not_exists()
            name = self.ident()
            columns, pk, _ = self._column_defs()
            opts = self._with_options()
            append_only = opts.pop("appendonly", "false") == "true"
            return A.CreateTable(name, tuple(columns), pk=tuple(pk),
                                 with_options=opts, append_only=append_only,
                                 if_not_exists=ine)
        if self.eat_kw("materialized"):
            self.expect_kw("view")
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_kw("as")
            q = self._select()
            return A.CreateMaterializedView(name, q, if_not_exists=ine)
        if self.eat_kw("sink"):
            ine = self._if_not_exists()
            name = self.ident()
            from_name, q = None, None
            if self.eat_kw("from"):
                from_name = self.ident()
            else:
                self.expect_kw("as")
                q = self._select()
            opts = self._with_options()
            return A.CreateSink(name, from_name=from_name, query=q,
                                with_options=opts, if_not_exists=ine)
        if self.eat_kw("index"):
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_kw("on")
            table = self.ident()
            self.expect_op("(")
            cols = [self.ident()]
            while self.eat_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            return A.CreateIndex(name, table, tuple(cols), if_not_exists=ine)
        raise SqlParseError(f"unsupported CREATE at {self.peek()}")

    def _column_defs(self):
        columns, pk, watermark = [], [], None
        if not self.eat_op("("):
            return columns, pk, watermark
        while True:
            if self.eat_kw("primary"):
                self.expect_kw("key")
                self.expect_op("(")
                pk.append(self.ident())
                while self.eat_op(","):
                    pk.append(self.ident())
                self.expect_op(")")
            elif self.eat_kw("watermark"):
                self.expect_kw("for")
                col = self.ident()
                self.expect_kw("as")
                expr = self.parse_expr()
                watermark = (col, expr)
            else:
                cname = self.ident()
                tname = self._type_name()
                columns.append(A.ColumnDef(cname, tname))
                if self.eat_kw("primary"):
                    self.expect_kw("key")
                    pk.append(cname)
            if not self.eat_op(","):
                break
        self.expect_op(")")
        return columns, pk, watermark

    def _type_name(self) -> str:
        name = self.ident()
        # two-word types: double precision, timestamp with(out) time zone
        if name == "double" and self.peek().value == "precision":
            self.next()
            return "double"
        if name == "struct" and self.at_op("<"):
            # STRUCT<a BIGINT, b VARCHAR> — composite column type
            # (reference: struct_array.rs); flattened back to a string the
            # catalog's type_from_name re-parses
            self.next()
            fields = []
            while True:
                fname = self.ident()
                ftype = self._type_name()
                fields.append(f"{fname} {ftype}")
                if not self.eat_op(","):
                    break
            self.expect_op(">")
            return f"struct<{', '.join(fields)}>"
        if self.eat_op("("):
            # varchar(n) / decimal(p,s): a DECIMAL keeps its arguments in
            # the name (``decimal(p,s)``), whose scale the catalog reads;
            # other size arguments are unused
            args = [self.next().value]
            while self.eat_op(","):
                args.append(self.next().value)
            self.expect_op(")")
            if name in ("decimal", "numeric"):
                return f"{name}({','.join(str(a) for a in args)})"
        return name

    def _with_options(self) -> dict:
        opts = {}
        if self.eat_kw("with"):
            self.expect_op("(")
            while True:
                # option keys may be quoted ('datagen.split.num' = 2)
                k = (self.next().value if self.peek().kind == "str"
                     else self.ident())
                self.expect_op("=")
                t = self.next()
                opts[k] = t.value
                if not self.eat_op(","):
                    break
            self.expect_op(")")
        return opts

    def _drop(self) -> A.DropStatement:
        self.expect_kw("drop")
        if self.eat_kw("materialized"):
            self.expect_kw("view")
            kind = "materialized_view"
        elif self.eat_kw("source"):
            kind = "source"
        elif self.eat_kw("sink"):
            kind = "sink"
        elif self.eat_kw("table"):
            kind = "table"
        elif self.eat_kw("index"):
            kind = "index"
        else:
            raise SqlParseError(f"unsupported DROP at {self.peek()}")
        if_exists = False
        if self.eat_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return A.DropStatement(kind, self.ident(), if_exists)

    def _insert(self) -> A.Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        table = self.ident()
        cols = []
        if self.eat_op("("):
            cols.append(self.ident())
            while self.eat_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.parse_expr()]
            while self.eat_op(","):
                row.append(self.parse_expr())
            self.expect_op(")")
            rows.append(tuple(row))
            if not self.eat_op(","):
                break
        return A.Insert(table, tuple(cols), tuple(rows))

    # -- SELECT ---------------------------------------------------------------

    def _select(self) -> A.Select:
        self.expect_kw("select")
        distinct = self.eat_kw("distinct")
        items = [self._select_item()]
        while self.eat_op(","):
            items.append(self._select_item())
        from_ = None
        if self.eat_kw("from"):
            from_ = self._relation()
            while self.eat_op(","):
                right = self._relation()
                from_ = A.Join("inner", from_, right, None)
        where = self.parse_expr() if self.eat_kw("where") else None
        group_by = []
        if self.eat_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.eat_op(","):
                group_by.append(self.parse_expr())
        having = self.parse_expr() if self.eat_kw("having") else None
        order_by = []
        if self.eat_kw("order"):
            self.expect_kw("by")
            order_by.append(self._order_item())
            while self.eat_op(","):
                order_by.append(self._order_item())
        limit = offset = None
        with_ties = False
        if self.eat_kw("limit"):
            limit = int(self.next().value)
            if self.eat_kw("with"):
                self.expect_kw("ties")
                with_ties = True
        if self.eat_kw("offset"):
            offset = int(self.next().value)
        eowc = False
        if self.eat_kw("emit"):
            self.expect_kw("on")
            self.expect_kw("window")
            self.expect_kw("close")
            eowc = True
        union_all = None
        if self.eat_kw("union"):
            self.expect_kw("all")
            union_all = self._select()
        return A.Select(
            items=tuple(items), from_=from_, where=where,
            group_by=tuple(group_by), having=having, order_by=tuple(order_by),
            limit=limit, offset=offset, with_ties=with_ties,
            distinct=distinct, union_all=union_all,
            emit_on_window_close=eowc)

    def _select_item(self) -> A.SelectItem:
        if self.at_op("*"):
            self.next()
            return A.SelectItem(A.Star())
        e = self.parse_expr()
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "name":
            alias = self.next().value
        return A.SelectItem(e, alias)

    def _over_clause(self, fc: A.FuncCall) -> A.WindowFunc:
        """OVER (PARTITION BY e, … ORDER BY e [ASC|DESC], …)"""
        self.expect_op("(")
        partition_by: list = []
        order_by: list = []
        if self.eat_kw("partition"):
            self.expect_kw("by")
            partition_by.append(self.parse_expr())
            while self.eat_op(","):
                partition_by.append(self.parse_expr())
        if self.eat_kw("order"):
            self.expect_kw("by")
            order_by.append(self._order_item())
            while self.eat_op(","):
                order_by.append(self._order_item())
        self.expect_op(")")
        return A.WindowFunc(fc, tuple(partition_by), tuple(order_by))

    def _order_item(self) -> A.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.eat_kw("desc"):
            desc = True
        else:
            self.eat_kw("asc")
        nulls_last = None
        if self.eat_kw("nulls"):
            if self.eat_kw("first"):
                nulls_last = False
            else:
                self.expect_kw("last")
                nulls_last = True
        return A.OrderItem(e, desc, nulls_last)

    def _relation(self) -> A.Relation:
        rel = self._relation_primary()
        while True:
            kind = None
            if self.eat_kw("join") or self.eat_kw("inner"):
                self.eat_kw("join")
                kind = "inner"
            elif self.at_kw("left", "right", "full"):
                kind = self.next().value
                self.eat_kw("outer")
                self.expect_kw("join")
            else:
                break
            right = self._relation_primary()
            temporal = False
            if self.eat_kw("for"):
                # FOR SYSTEM_TIME AS OF PROCTIME()
                if self.ident() != "system_time":
                    raise SqlParseError("expected SYSTEM_TIME after FOR")
                self.expect_kw("as")
                if self.ident() != "of":
                    raise SqlParseError("expected OF")
                if self.ident() != "proctime":
                    raise SqlParseError("only PROCTIME() temporal joins "
                                        "are supported")
                self.expect_op("(")
                self.expect_op(")")
                temporal = True
            on = None
            if self.eat_kw("on"):
                on = self.parse_expr()
            rel = A.Join(kind, rel, right, on, temporal=temporal)
        return rel

    def _relation_primary(self) -> A.Relation:
        if self.at_kw("tumble", "hop"):
            kind = self.next().value
            self.expect_op("(")
            table = A.TableRef(self.ident())
            self.expect_op(",")
            time_col = self.ident()
            args = []
            while self.eat_op(","):
                args.append(self._interval_or_expr())
            self.expect_op(")")
            alias = None
            if self.eat_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "name":
                alias = self.next().value
            return A.WindowTVF(kind, table, time_col, tuple(args), alias)
        if self.eat_op("("):
            q = self._select()
            self.expect_op(")")
            alias = "subquery"
            if self.eat_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "name":
                alias = self.next().value
            return A.SubqueryRef(q, alias)
        name = self.ident()
        # qualified relation names (pg_catalog.pg_tables,
        # information_schema.columns, …)
        while self.at_op("."):
            self.next()
            name += "." + self.ident()
        if self.at_op("("):
            # FROM table_function(args), e.g. generate_series(1, 10)
            self.next()
            args = []
            if not self.at_op(")"):
                args.append(self.parse_expr())
                while self.eat_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            alias = None
            if self.eat_kw("as"):
                alias = self.ident()
            elif self.peek().kind == "name":
                alias = self.next().value
            return A.TableFuncRef(name, tuple(args), alias)
        alias = None
        if self.eat_kw("as"):
            alias = self.ident()
        elif self.peek().kind == "name":
            alias = self.next().value
        return A.TableRef(name, alias)

    def _interval_or_expr(self):
        if self.at_kw("interval"):
            return self.parse_expr()
        return self.parse_expr()

    # -- expressions (precedence climbing) ------------------------------------

    def parse_expr(self):
        return self._or_expr()

    def _or_expr(self):
        e = self._and_expr()
        while self.eat_kw("or"):
            e = A.BinaryOp("OR", e, self._and_expr())
        return e

    def _and_expr(self):
        e = self._not_expr()
        while self.eat_kw("and"):
            e = A.BinaryOp("AND", e, self._not_expr())
        return e

    def _not_expr(self):
        if self.eat_kw("not"):
            return A.UnaryOp("NOT", self._not_expr())
        return self._cmp_expr()

    def _cmp_expr(self):
        e = self._add_expr()
        while True:
            if self.peek().kind == "op" and self.peek().value in _CMP_OPS:
                op = self.next().value
                if op == "!=":
                    op = "<>"
                e = A.BinaryOp(op, e, self._add_expr())
                continue
            negated = False
            save = self.i
            if self.eat_kw("not"):
                negated = True
            if self.eat_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    q = self._select()
                    self.expect_op(")")
                    e = A.InSubquery(e, q, negated)
                    continue
                items = [self.parse_expr()]
                while self.eat_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                e = A.InList(e, tuple(items), negated)
                continue
            if self.eat_kw("between"):
                low = self._add_expr()
                self.expect_kw("and")
                high = self._add_expr()
                e = A.Between(e, low, high, negated)
                continue
            if self.eat_kw("like"):
                e = A.BinaryOp("NOT LIKE" if negated else "LIKE",
                               e, self._add_expr())
                continue
            if negated:
                self.i = save
            if self.eat_kw("is"):
                neg = self.eat_kw("not")
                self.expect_kw("null")
                e = A.IsNull(e, neg)
                continue
            return e

    def _add_expr(self):
        e = self._mul_expr()
        while self.at_op("+", "-", "||"):
            op = self.next().value
            e = A.BinaryOp(op, e, self._mul_expr())
        return e

    def _mul_expr(self):
        e = self._unary_expr()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            e = A.BinaryOp(op, e, self._unary_expr())
        return e

    def _unary_expr(self):
        if self.eat_op("-"):
            return A.UnaryOp("-", self._unary_expr())
        return self._postfix_expr()

    def _postfix_expr(self):
        e = self._primary_expr()
        while True:
            if self.eat_op("::"):
                e = A.Cast(e, self._type_name())
            elif self.eat_op("["):
                idx = self.parse_expr()
                self.expect_op("]")
                e = A.Subscript(e, idx)
            elif self.at_op("->", "->>"):
                op = self.next().value
                e = A.BinaryOp(op, e, self._primary_expr())
            elif (self.at_op(".")
                    and self.peek(1).kind in ("name", "kw")):
                # (expr).field — struct access; qualified column names
                # never reach here (consumed inside _primary_expr)
                self.next()
                e = A.FieldAccess(e, self.ident())
            else:
                return e

    def _primary_expr(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            return A.Lit(t.value)
        if t.kind == "str":
            self.next()
            return A.Lit(t.value, "varchar")
        if self.eat_kw("null"):
            return A.Lit(None)
        if self.eat_kw("true"):
            return A.Lit(True)
        if self.eat_kw("false"):
            return A.Lit(False)
        if self.at_kw("interval"):
            self.next()
            amount_tok = self.next()
            unit = None
            if amount_tok.kind == "str":
                # INTERVAL '5 seconds' / INTERVAL '5' SECOND
                parts = amount_tok.value.split()
                amount = float(parts[0])
                if len(parts) > 1:
                    unit = parts[1].lower()
            else:
                amount = amount_tok.value
            if unit is None and self.peek().kind == "name":
                unit = self.next().value
            unit = unit or "second"
            us = _INTERVAL_UNITS.get(unit)
            if us is None:
                raise SqlParseError(f"unsupported interval unit {unit!r}")
            return A.Lit(int(amount * us), "interval")
        if (t.kind in ("name", "kw") and str(t.value).lower() == "array"
                and self.peek(1).kind == "op" and self.peek(1).value == "["):
            self.next()
            self.expect_op("[")
            items: list = []
            if not self.at_op("]"):
                items.append(self.parse_expr())
                while self.eat_op(","):
                    items.append(self.parse_expr())
            self.expect_op("]")
            return A.ArrayLit(tuple(items))
        if self.eat_kw("case"):
            branches = []
            while self.eat_kw("when"):
                cond = self.parse_expr()
                self.expect_kw("then")
                branches.append((cond, self.parse_expr()))
            else_r = self.parse_expr() if self.eat_kw("else") else None
            self.expect_kw("end")
            return A.Case(tuple(branches), else_r)
        if self.eat_kw("cast"):
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            tn = self._type_name()
            self.expect_op(")")
            return A.Cast(e, tn)
        if self.eat_kw("extract"):
            # EXTRACT(field FROM expr)
            self.expect_op("(")
            field = self.ident()
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_op(")")
            return A.FuncCall("extract", (A.Lit(field, "varchar"), e))
        if (t.kind == "name" and t.value in ("date", "timestamp", "timestamptz")
                and self.peek(1).kind == "str"):
            # typed literal: DATE '1995-03-15' / TIMESTAMP '… 00:00:00'
            kind = self.next().value
            return A.Lit(self.next().value,
                         "date" if kind == "date" else "timestamp")
        if self.eat_op("("):
            if self.at_kw("select"):
                q = self._select()
                self.expect_op(")")
                return A.ScalarSubquery(q)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind in ("name", "kw"):
            name = self.ident()
            if self.eat_op("("):
                distinct = self.eat_kw("distinct")
                args: list = []
                if self.at_op("*"):
                    self.next()
                    args = [A.Star()]
                elif not self.at_op(")"):
                    args.append(self.parse_expr())
                    while self.eat_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                fc = A.FuncCall(name, tuple(args), distinct)
                if (self.peek().kind in ("name", "kw")
                        and str(self.peek().value).lower() == "within"):
                    # ordered-set agg: fn(frac…) WITHIN GROUP (ORDER BY v)
                    # rewrites to fn(v [, frac]) — percentile_cont / mode
                    self.next()
                    if self.ident() != "group":
                        raise SqlParseError("expected GROUP after WITHIN")
                    self.expect_op("(")
                    self.expect_kw("order")
                    self.expect_kw("by")
                    v = self.parse_expr()
                    self.expect_op(")")
                    fc = A.FuncCall(name, (v,) + fc.args, distinct)
                if (self.peek().kind in ("name", "kw")
                        and str(self.peek().value).lower() == "filter"
                        and self.peek(1).kind == "op"
                        and self.peek(1).value == "("):
                    self.next()
                    self.expect_op("(")
                    self.expect_kw("where")
                    cond = self.parse_expr()
                    self.expect_op(")")
                    fc = dataclasses.replace(fc, filter=cond)
                if self.eat_kw("over"):
                    return self._over_clause(fc)
                return fc
            if self.eat_op("."):
                if self.at_op("*"):
                    self.next()
                    return A.Star(table=name)
                col = self.ident()
                return A.ColumnRef(col, table=name)
            return A.ColumnRef(name)
        raise SqlParseError(f"unexpected token {t} in expression")


def parse_sql(sql: str) -> list[A.Statement]:
    return Parser(sql).parse_statements()


def parse_one(sql: str) -> A.Statement:
    stmts = parse_sql(sql)
    if len(stmts) != 1:
        raise SqlParseError(f"expected one statement, got {len(stmts)}")
    return stmts[0]
