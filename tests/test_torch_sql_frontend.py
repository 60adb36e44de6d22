"""The port's SQL front end (parser, binder, planner, optimizer) against
the reference's: the same statement gives the same EXPLAIN text.

The statements are every MV of tests/test_nexmark_queries.py,
tests/test_nexmark_extended.py and tests/test_tpch.py, read from those
files' string literals, and the planner shapes of tests/test_frontend.py.
Each package plans over its own catalog, made by the same DDL in its own
Session; only the planner runs (nothing is built or ticked). Also: the
type names of the DDL (DECIMAL(p, s) keeps its scale in the port), and the
statements of later slices raise ``SqlError`` naming their ROADMAP item.
"""

import ast
import pathlib
import re

import pytest

from risingwave_tpu.frontend.parser import parse_one as ref_parse
from risingwave_tpu.frontend.session import Session as RefSession
from risingwave_tpu_torch.common.types import decimal
from risingwave_tpu_torch.frontend import BuildConfig, Session, SqlError
from risingwave_tpu_torch.frontend.catalog import type_from_name
from risingwave_tpu_torch.frontend.parser import parse_one
from test_nexmark_queries import DDL as NEXMARK_DDL

TESTS = pathlib.Path(__file__).parent


def sql_literals(filename: str, prefix: str) -> dict:
    """The string literals of a test file that start with ``prefix``
    (``CREATE MATERIALIZED VIEW`` or ``CREATE TABLE``), by the name that
    follows; the first of a name wins."""
    out: dict = {}
    tree = ast.parse((TESTS / filename).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value.strip()
            m = re.match(re.escape(prefix) + r"\s+(\w+)", text, re.I)
            if m:
                out.setdefault(m.group(1), text)
    return out


MV_FILES = ("test_nexmark_queries.py", "test_nexmark_extended.py",
            "test_tpch.py")
MVS = [(f"{f[5:-3]}::{name}", sql) for f in MV_FILES
       for name, sql in sql_literals(f, "CREATE MATERIALIZED VIEW").items()]
# the planner shapes of tests/test_frontend.py
SELECTS = [
    ("select::projection", "SELECT auction, price * 100 AS p FROM bid"),
    ("select::agg", "SELECT auction, count(*) FROM bid GROUP BY auction"),
    ("select::topn", "SELECT auction, price FROM bid ORDER BY price DESC "
     "LIMIT 3"),
    ("select::dynamic_filter", "SELECT auction FROM bid WHERE price > "
     "(SELECT max(price) FROM bid)"),
    ("select::hop", "SELECT auction, window_start FROM HOP(bid, date_time, "
     "INTERVAL '2 seconds', INTERVAL '10 seconds')"),
]


@pytest.fixture(scope="module")
def sessions():
    ddl = [NEXMARK_DDL] + list(
        sql_literals("test_tpch.py", "CREATE TABLE").values())
    ref, port = RefSession(), Session(device="cpu")
    for s in (ref, port):
        for stmt in ddl:
            s.run_sql(stmt)
    yield ref, port
    ref.close()
    port.close()


def _query(sql: str, parse):
    stmt = parse(sql)
    return stmt.query if hasattr(stmt, "query") else stmt.select


@pytest.mark.parametrize("name,sql", MVS + SELECTS,
                         ids=[n for n, _ in MVS + SELECTS])
def test_explain_equals_reference(sessions, name, sql):
    ref, port = sessions
    want = ref._plan(_query(sql, ref_parse)).explain()
    got = port._plan(_query(sql, parse_one)).explain()
    assert got == want


@pytest.mark.parametrize("text", [
    "price > 10", "upper(channel) = 'X'", "channel < 'b'",
    "length(url) + auction", "CAST(price AS VARCHAR)", "auction % 3",
    "url LIKE '%a%' AND price < 5", "coalesce(extra, channel)"])
def test_host_callback_split_equals_reference(text):
    """The planner moves a residual join condition that uses a host
    function above the join: both packages must name the same ones."""
    from risingwave_tpu.connector.nexmark import BID_SCHEMA as REF_BID
    from risingwave_tpu.expr.expr import uses_host_callback as ref_uses
    from risingwave_tpu.frontend.binder import ExprBinder as RefBinder
    from risingwave_tpu.frontend.binder import Scope as RefScope
    from risingwave_tpu_torch.common.chunk import make_chunk
    from risingwave_tpu_torch.connector.nexmark import BID_SCHEMA
    from risingwave_tpu_torch.expr import uses_host_callback
    from risingwave_tpu_torch.frontend.binder import ExprBinder, Scope
    ast_ = parse_one(f"SELECT {text} FROM bid").select.items[0].expr
    ref_ast = ref_parse(f"SELECT {text} FROM bid").select.items[0].expr
    e = ExprBinder(Scope.of_schema(BID_SCHEMA)).bind(ast_)
    ref_e = RefBinder(RefScope.of_schema(REF_BID)).bind(ref_ast)
    assert uses_host_callback(e) == ref_uses(ref_e)
    assert repr(e.type) == repr(ref_e.type)
    row = (7, 8, 9, "ch", "http://a/b", 1_000_000, None)
    chunk = make_chunk(BID_SCHEMA, [row], capacity=2, device="cpu")
    assert e.eval(chunk).data.shape == (2,)


def test_statement_list_is_complete():
    # 7 + 17 + 2 MVs: a statement that stops matching the extraction
    # would silently leave the parity test
    assert len(MVS) == 26


def test_explain_statement(sessions):
    _, port = sessions
    rows = port.run_sql("EXPLAIN SELECT auction, count(*) FROM bid "
                        "GROUP BY auction")
    assert rows[0][0].startswith("Project")
    assert any("HashAgg" in r[0] for r in rows)


@pytest.mark.parametrize("name,scale", [
    ("decimal", 2), ("numeric", 2), ("decimal(10,4)", 4),
    ("numeric(6,1)", 1), ("decimal(12)", 0), ("NUMERIC(15, 2)", 2)])
def test_decimal_type_names(name, scale):
    assert type_from_name(name) == decimal(scale)


def test_parser_keeps_decimal_arguments():
    stmt = parse_one("CREATE TABLE t (k BIGINT PRIMARY KEY, "
                     "d DECIMAL(10,4), v VARCHAR(20))")
    assert [c.type_name for c in stmt.columns] == [
        "bigint", "decimal(10,4)", "varchar"]


@pytest.mark.parametrize("sql,item", [
    ("CREATE SINK s FROM bid WITH (connector = 'blackhole')", "A6 part 2"),
    ("CREATE INDEX i ON t (k)", "A6 part 2"),
    ("SET checkpoint_frequency = 5", "A6 part 2"),
])
def test_later_statements_name_their_roadmap_item(sql, item):
    s = Session(device="cpu")
    with pytest.raises(SqlError, match=item):
        s.run_sql(sql)
    s.close()


@pytest.mark.parametrize("cfg,item", [
    (BuildConfig(coschedule=True), "A4"),
    (BuildConfig(tick_compiler=True), "A4"),
    (BuildConfig(mesh=object()), "A5"),
])
def test_later_paths_name_their_roadmap_item(cfg, item):
    s = Session(device="cpu", config=cfg)
    s.run_sql(NEXMARK_DDL)
    with pytest.raises(SqlError, match=item):
        s.run_sql("CREATE MATERIALIZED VIEW m AS SELECT auction FROM bid")
    assert "m" not in s.catalog.mvs
    s.close()


@pytest.mark.parametrize("connector", ["datagen", "file", "kafka"])
def test_later_connectors_name_their_roadmap_item(connector):
    s = Session(device="cpu")
    s.run_sql(NEXMARK_DDL)
    s.run_sql(f"CREATE SOURCE src (a BIGINT) WITH (connector = "
              f"'{connector}')")
    with pytest.raises(SqlError, match="A6 part 2"):
        # the bid leaf is built first: its feed goes with the failure
        s.run_sql("CREATE MATERIALIZED VIEW m AS SELECT a FROM bid "
                  "JOIN src ON auction = a")
    assert "m" not in s.catalog.mvs and not s.feeds
    s.close()


def test_session_defaults_to_cuda():
    # no card here: the default device is named, never replaced by the CPU
    s = Session()
    assert s.device == "cuda"
    s.close()
