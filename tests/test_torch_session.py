"""The port's ``Session`` against the reference's, statement for statement.

Each scenario runs the same SQL in both packages (the port on the CPU) and
gathers what a user sees: MV rows (``mv_rows``) and SELECT rows, after each
step. They must be equal: exact on integers, DECIMAL (read back as the
same float from the same scaled int64), DATE, timestamps and decoded
VARCHAR. Covered: DDL, INSERT, UPDATE (same pk and pk-moving), DELETE and
the DML errors of tests/test_dml.py, MV on MV, DROP, VALUES and UNION ALL,
DISTINCT, TopN, EXPLAIN and SHOW, ``BuildConfig(sanity_checks=True)``,
the HBM budgets (eviction and fault-in, fragmented and not), the settings
of epoch and row flow, and a source's ``rows_per_chunk``.
The one recorded divergence: DECIMAL(p, s) keeps its scale in the port
(ROADMAP C3).
"""

import pytest

from risingwave_tpu.frontend.build import BuildConfig as RefConfig
from risingwave_tpu.frontend.session import Session as RefSession
from risingwave_tpu_torch.frontend import BuildConfig, Session
from test_nexmark_queries import CAP, DDL as NEXMARK_DDL

SMALL = dict(chunk_capacity=64, agg_table_capacity=1 << 8,
             join_key_capacity=1 << 8, join_bucket_width=16,
             topn_table_capacity=1 << 8)


def sessions(**cfg):
    """A reference Session and a port Session on the CPU, configured
    alike."""
    kw = dict(SMALL, **cfg)
    return (RefSession(source_chunk_capacity=CAP, config=RefConfig(**kw)),
            Session(source_chunk_capacity=CAP, config=BuildConfig(**kw),
                    device="cpu"))


def both(scenario, **cfg):
    """``scenario(session)``'s observations, equal between the packages."""
    ref, port = sessions(**cfg)
    try:
        want, got = scenario(ref), scenario(port)
    finally:
        ref.close()
        port.close()
    assert got == want
    return got


def table_t(s):
    s.run_sql("CREATE TABLE t (k BIGINT PRIMARY KEY, g BIGINT, v BIGINT, "
              "name VARCHAR)")
    s.run_sql("INSERT INTO t VALUES (1, 0, 10, 'a'), (2, 1, 20, 'b'), "
              "(3, 0, 30, 'c'), (4, 2, 40, 'd')")


def test_dml_through_mvs():
    def scenario(s):
        out = []
        table_t(s)
        s.run_sql("CREATE MATERIALIZED VIEW m AS SELECT g, count(*) AS n, "
                  "sum(v) AS total, max(name) AS top FROM t GROUP BY g")
        s.flush()
        out.append(sorted(s.mv_rows("m")))
        out.append(s.run_sql("DELETE FROM t WHERE v > 35"))
        s.flush()
        out.append(sorted(s.mv_rows("m")))
        out.append(s.run_sql("UPDATE t SET v = v + 100, name = 'z' "
                             "WHERE g = 0"))
        s.flush()
        out.append(sorted(s.mv_rows("m")))
        # a pk-moving update: every delete before every insert
        out.append(s.run_sql("UPDATE t SET k = k + 1"))
        s.flush()
        out.append(sorted(s.run_sql("SELECT k, g, v, name FROM t")))
        out.append(sorted(s.mv_rows("m")))
        s.run_sql("INSERT INTO t VALUES (9, 5, 1, NULL)")
        s.flush()
        out.append(sorted(s.mv_rows("m"), key=repr))
        out.append(s.run_sql("SELECT g, n FROM m ORDER BY n DESC, g"))
        return out

    got = both(scenario)
    assert got[-1][0] == (0, 2)


@pytest.mark.parametrize("setup,stmt,match", [
    ("CREATE TABLE noz (a BIGINT)", "DELETE FROM noz", "PRIMARY KEY"),
    ("CREATE TABLE ao (a BIGINT PRIMARY KEY) WITH (appendonly = 'true')",
     "DELETE FROM ao", "APPEND ONLY"),
    ("CREATE TABLE t (k BIGINT PRIMARY KEY, v BIGINT); "
     "INSERT INTO t VALUES (1, 10), (2, 20)",
     "UPDATE t SET k = 2 WHERE k = 1", "collides"),
    ("CREATE TABLE t (k BIGINT PRIMARY KEY, v BIGINT); "
     "INSERT INTO t VALUES (1, 10), (2, 20)",
     "UPDATE t SET k = 7", "duplicate key"),
    ("CREATE TABLE t (k BIGINT PRIMARY KEY, v BIGINT)",
     "INSERT INTO t VALUES (1)", "arity"),
    ("", "INSERT INTO nowhere VALUES (1)", "not found"),
])
def test_dml_errors(setup, stmt, match):
    def scenario(s):
        if setup:
            s.run_sql(setup)
            s.flush()
        with pytest.raises(Exception, match=match):
            s.run_sql(stmt)
        return [sorted(s.run_sql(f"SELECT * FROM {t}"))
                for t in sorted(s.catalog.tables)]

    both(scenario)


def test_mv_on_mv_and_drop():
    def scenario(s):
        out = []
        table_t(s)
        s.run_sql("CREATE MATERIALIZED VIEW a AS SELECT k, g, v * 2 AS w "
                  "FROM t WHERE v >= 20")
        s.run_sql("CREATE MATERIALIZED VIEW b AS SELECT g, sum(w) AS s "
                  "FROM a GROUP BY g")
        s.flush()
        out.append(sorted(s.mv_rows("b")))
        s.run_sql("INSERT INTO t VALUES (5, 1, 50, 'e')")
        s.run_sql("DELETE FROM t WHERE k = 3")
        s.flush()
        out.append(sorted(s.mv_rows("a")))
        out.append(sorted(s.mv_rows("b")))
        out.append(sorted(s.run_sql("SELECT g, s FROM b WHERE s > 50")))
        s.run_sql("DROP MATERIALIZED VIEW b")
        s.run_sql("DROP MATERIALIZED VIEW IF EXISTS b")
        out.append(s.run_sql("SHOW MATERIALIZED_VIEWS"))
        s.run_sql("INSERT INTO t VALUES (6, 2, 60, 'f')")
        s.flush()
        out.append(sorted(s.mv_rows("a")))
        s.run_sql("DROP MATERIALIZED VIEW a")
        s.run_sql("DROP TABLE t")
        out.append((s.run_sql("SHOW TABLES"),
                    s.run_sql("SHOW MATERIALIZED_VIEWS")))
        return out

    got = both(scenario)
    assert got[-1] == ([], [])


def test_union_distinct_and_topn():
    def scenario(s):
        out = []
        table_t(s)
        s.run_sql("CREATE TABLE u (k BIGINT PRIMARY KEY, g BIGINT, "
                  "v BIGINT, name VARCHAR)")
        s.run_sql("INSERT INTO u VALUES (10, 0, 5, 'x'), (11, 3, 70, 'y')")
        s.run_sql("CREATE MATERIALIZED VIEW un AS SELECT k, v FROM t "
                  "UNION ALL SELECT k, v FROM u")
        s.run_sql("CREATE MATERIALIZED VIEW d AS SELECT DISTINCT g FROM t")
        s.run_sql("CREATE MATERIALIZED VIEW cd AS SELECT count(DISTINCT g) "
                  "AS n FROM t")
        s.run_sql("CREATE MATERIALIZED VIEW top2 AS SELECT k, v FROM t "
                  "ORDER BY v DESC LIMIT 2")
        s.flush()
        for name in ("un", "d", "cd", "top2"):
            out.append(sorted(s.mv_rows(name)))
        s.run_sql("INSERT INTO t VALUES (7, 4, 99, 'q')")
        s.run_sql("DELETE FROM t WHERE k = 4")
        s.flush()
        for name in ("un", "d", "cd", "top2"):
            out.append(sorted(s.mv_rows(name)))
        # VALUES (a FROM-less UNION) and a table function, as SELECTs
        out.append(sorted(s.run_sql("SELECT 1 AS n, 'one' AS w UNION ALL "
                                    "SELECT 1 + 2, upper('three')")))
        out.append(sorted(s.run_sql("SELECT * FROM generate_series(1, 4)")))
        return out

    both(scenario)


def test_values_mv_keeps_ticking_where_reference_hangs():
    """An MV over VALUES: the reference gives its leaf only the init
    barrier, so the next tick waits on that job forever (not run here).
    The port feeds the leaf every barrier."""
    _, s = sessions()
    s.run_sql("CREATE MATERIALIZED VIEW vals AS SELECT 1 AS n, 'one' AS w "
              "UNION ALL SELECT 2, 'two' UNION ALL SELECT 1 + 2, "
              "upper('three')")
    for _ in range(3):
        s.tick()
    s.flush()
    assert sorted(s.mv_rows("vals")) == [(1, "one"), (2, "two"),
                                         (3, "THREE")]
    s.close()


def stored(s) -> list:
    """(table id, rows) of the store's committed tables: the same ids,
    allocated in the same order, in both packages."""
    return sorted((t, len(rows)) for t, rows in
                  s.store.snapshot()["tables"].items() if rows)


def test_source_mv_with_sanity_checks():
    # every executor wrapped in the schema, update-pair and epoch checks
    def scenario(s):
        s.run_sql(NEXMARK_DDL)
        s.run_sql("CREATE MATERIALIZED VIEW m AS SELECT auction % 8 AS b, "
                  "count(*) AS n, max(price) AS top FROM bid "
                  "GROUP BY auction % 8")
        s.run_sql("CREATE MATERIALIZED VIEW top3 AS SELECT b, n FROM m "
                  "ORDER BY n DESC LIMIT 3")
        for _ in range(3):
            s.tick()
        s.flush()
        out = [sorted(s.mv_rows("m")), sorted(s.mv_rows("top3")),
               s.run_sql("SELECT b, top FROM m ORDER BY b LIMIT 4"),
               s.run_sql("SHOW SOURCES"), stored(s)]
        # dropping the source-fed jobs frees their feeds; ticks go on
        s.run_sql("DROP MATERIALIZED VIEW top3")
        s.run_sql("DROP MATERIALIZED VIEW m")
        s.tick()
        s.flush()
        return out + [s.run_sql("SHOW MATERIALIZED_VIEWS")], stored(s)

    ref, port = sessions(sanity_checks=True)
    try:
        (want, ref_left), (got, left) = scenario(ref), scenario(port)
    finally:
        ref.close()
        port.close()
    assert got == want
    assert sum(r[1] for r in got[0]) == 3 * CAP and len(got[4]) > 3
    # the drops free every table of both jobs; the reference keeps top3's
    # Backfill progress row
    assert left == [] and ref_left == [(4, 1)]


def test_fragment_parallelism_builds_fragment_graphs():
    """``fragment_parallelism=2``: the port builds the grouped agg and the
    equi-join (with its residual condition) as fragment graphs of two
    actors; the rows equal the reference Session's at its default."""
    from risingwave_tpu_torch.frontend.fragments import FragmentGraph
    from risingwave_tpu_torch.frontend.session import Session as Port

    def scenario(s):
        table_t(s)
        s.run_sql("CREATE TABLE u (id BIGINT PRIMARY KEY, k BIGINT, "
                  "w BIGINT)")
        s.run_sql("INSERT INTO u VALUES (1, 1, 5), (2, 1, 50), (3, 3, 7)")
        s.run_sql("CREATE MATERIALIZED VIEW j AS SELECT t.k, u.id, w FROM t "
                  "JOIN u ON t.k = u.k AND w < v")
        s.run_sql("CREATE MATERIALIZED VIEW a AS SELECT g, count(*) AS n, "
                  "sum(v) AS total FROM t GROUP BY g")
        s.flush()
        s.run_sql("UPDATE t SET v = 60 WHERE k = 1")
        s.flush()
        if isinstance(s, Port):
            for name in ("j", "a"):
                kinds = {type(e) for e in executors(s.jobs[name].pipeline)}
                assert FragmentGraph in kinds
        return [sorted(s.mv_rows("j")), sorted(s.mv_rows("a"))]

    ref = RefSession(source_chunk_capacity=CAP, config=RefConfig(**SMALL))
    port = Session(source_chunk_capacity=CAP, device="cpu",
                   config=BuildConfig(fragment_parallelism=2, **SMALL))
    try:
        want, got = scenario(ref), scenario(port)
    finally:
        ref.close()
        port.close()
    assert got == want and got[0] == [(1, 1, 5), (1, 2, 50), (3, 3, 7)]


def executors(root) -> list:
    out, todo = [], [root]
    while todo:
        ex = todo.pop()
        out.append(ex)
        todo += [getattr(ex, f) for f in ("input", "left", "right", "merge")
                 if getattr(ex, f, None) is not None]
        todo += list(getattr(ex, "actors", ()))
    return out


BUDGETS = dict(agg_hbm_budget=4, join_hbm_budget=4)


def budget_scenario(s, evicted=None):
    """DML over a grouped agg and an equi-join with a residual condition,
    24 groups and 24 join keys; ``evicted`` (the port's) gathers, after
    each checkpoint, how many keys each stateful executor holds evicted."""
    s.run_sql("CREATE TABLE t (k BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
    s.run_sql("CREATE TABLE u (id BIGINT PRIMARY KEY, g BIGINT, w BIGINT)")
    s.run_sql("INSERT INTO t VALUES " + ", ".join(
        f"({k}, {k % 24}, {k})" for k in range(96)))
    s.run_sql("INSERT INTO u VALUES " + ", ".join(
        f"({i}, {i % 24}, {10 * i})" for i in range(48)))
    s.run_sql("CREATE MATERIALIZED VIEW a AS SELECT g, count(*) AS n, "
              "sum(v) AS total FROM t GROUP BY g")
    s.run_sql("CREATE MATERIALIZED VIEW j AS SELECT t.k, u.id, w FROM t "
              "JOIN u ON t.g = u.g AND w > v")
    s.flush()
    out = [sorted(s.mv_rows("a")), sorted(s.mv_rows("j"))]
    for step in range(3):
        s.run_sql(f"UPDATE t SET v = v + 100 WHERE g % 3 = {step}")
        s.run_sql(f"DELETE FROM u WHERE id % 8 = {step}")
        s.run_sql(f"INSERT INTO u VALUES ({100 + step}, {5 * step}, 5000)")
        s.flush()
        out += [sorted(s.mv_rows("a")), sorted(s.mv_rows("j"))]
        if evicted is not None:
            exs = [e for name in ("a", "j")
                   for e in executors(s.jobs[name].pipeline)]
            evicted.append((
                {type(e).__name__ for e in exs},
                {type(e).__name__ for e in exs
                 if getattr(e, "_evicted", None)}))
    return out


@pytest.fixture(scope="module")
def budget_reference():
    ref = RefSession(source_chunk_capacity=CAP,
                     config=RefConfig(**SMALL, **BUDGETS))
    try:
        return budget_scenario(ref)
    finally:
        ref.close()


@pytest.mark.parametrize("parallelism", [1, 2])
def test_hbm_budgets_evict_and_fault_back(parallelism, budget_reference):
    """``agg_hbm_budget`` and ``join_hbm_budget`` below the live group and
    key counts: every checkpoint evicts the coldest groups and join keys
    to the state tables (at parallelism 2, each actor its own shard's into
    the shared tables), and DML that touches them faults them back in. The
    rows equal the reference Session's under the same budgets (at its
    parallelism 1)."""
    evicted = []
    port = Session(source_chunk_capacity=CAP, device="cpu",
                   config=BuildConfig(fragment_parallelism=parallelism,
                                      **SMALL, **BUDGETS))
    try:
        got = budget_scenario(port, evicted)
    finally:
        port.close()
    assert got == budget_reference and len(got[1]) > 100
    assert len(evicted) == 3
    for kinds, holding in evicted:
        assert ("FragmentGraph" in kinds) == (parallelism > 1)
        # groups and keys of both kinds stayed evicted at each checkpoint
        assert holding == {"HashAggExecutor", "HashJoinExecutor"}


@pytest.mark.parametrize("knob,session_kw,cfg", [
    ("in_flight_barriers", {"in_flight_barriers": 2}, {}),
    ("backfill_batch_rows", {}, {"backfill_batch_rows": 2}),
    ("exchange_permits", {}, {"fragment_parallelism": 2,
                              "exchange_permits": 1}),
])
def test_flow_settings_keep_results(knob, session_kw, cfg):
    """Settings that change how epochs and rows flow, not what an MV holds:
    two barriers in flight (one while a backfill is live), a Backfill of 2
    rows per barrier, one permit per exchange channel at parallelism 2.
    The rows equal the reference Session's under the same setting (its
    parallelism stays 1)."""
    def scenario(s):
        s.run_sql(NEXMARK_DDL)
        table_t(s)
        s.run_sql("CREATE MATERIALIZED VIEW m AS SELECT auction % 8 AS b, "
                  "count(*) AS n FROM bid GROUP BY auction % 8")
        s.run_sql("CREATE MATERIALIZED VIEW a AS SELECT g, count(*) AS n, "
                  "sum(v) AS total FROM t GROUP BY g")
        for _ in range(3):
            s.tick()
        s.run_sql("INSERT INTO t VALUES (5, 1, 50, 'e')")
        s.flush()
        return [sorted(s.mv_rows("m")), sorted(s.mv_rows("a"))]

    ref_cfg = {k: v for k, v in cfg.items()
               if k not in ("fragment_parallelism", "exchange_permits")}
    ref = RefSession(source_chunk_capacity=CAP, **session_kw,
                     config=RefConfig(**SMALL, **ref_cfg))
    port = Session(source_chunk_capacity=CAP, device="cpu", **session_kw,
                   config=BuildConfig(**SMALL, **cfg))
    try:
        want, got = scenario(ref), scenario(port)
        assert port.backfill_done("a")
    finally:
        ref.close()
        port.close()
    assert got == want
    assert sum(n for _, n in got[0]) == 3 * CAP


def test_source_rows_per_chunk_option():
    """The nexmark source's ``rows_per_chunk`` WITH option sets its chunk
    size over the Session's ``source_chunk_capacity``."""
    def scenario(s):
        s.run_sql(NEXMARK_DDL.replace(
            "nexmark_table = 'bid')",
            "nexmark_table = 'bid', rows_per_chunk = 5)"))
        s.run_sql("CREATE MATERIALIZED VIEW n AS SELECT count(*) AS n, "
                  "max(auction) AS top FROM bid")
        for _ in range(3):
            s.tick()
        s.flush()
        return sorted(s.mv_rows("n"))

    assert both(scenario)[0][0] == 15


def test_explain_and_show():
    def scenario(s):
        table_t(s)
        return [s.run_sql("EXPLAIN SELECT g, sum(v) FROM t GROUP BY g"),
                s.run_sql("SHOW TABLES")]

    both(scenario)


def test_decimal_scale_follows_ddl_where_reference_gives_two():
    """ROADMAP C3: the reference drops DECIMAL(p, s)'s arguments and gives
    every DECIMAL scale 2. The port keeps the declared scale and rounds an
    inserted literal half away from zero there, as PostgreSQL does."""
    ddl = ("CREATE TABLE t (k BIGINT PRIMARY KEY, d DECIMAL(10,4), "
           "n NUMERIC(6,1))")
    dml = "INSERT INTO t VALUES (1, 1.23456, 2.25)"
    ref, port = sessions()
    try:
        for s in (ref, port):
            s.run_sql(ddl)
            s.run_sql(dml)
            s.flush()
        assert [f.type.scale for f in port.catalog.tables["t"].schema][1:] \
            == [4, 1]
        assert port.run_sql("SELECT k, d, n FROM t") == [(1, 1.2346, 2.3)]
        assert [f.type.scale for f in ref.catalog.tables["t"].schema][1:] \
            == [2, 2]
        assert ref.run_sql("SELECT k, d, n FROM t") == [(1, 1.23, 2.25)]
    finally:
        ref.close()
        port.close()
