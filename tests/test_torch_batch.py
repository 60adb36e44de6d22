"""The port's batch engine (``batch/lower.py``, ``batch/executors.py``)
against the reference Session's SELECTs.

Each SELECT runs in both packages over the same tables; the rows must be
equal (ORDER BY results in order, the rest as multisets; exact on integers
and decoded VARCHAR). Each case also states which path the port took:
``lower_plan``'s batch chain (grouped and global agg, the six join kinds
with and without a residual condition, sort and limit, filters and
projections) or the stream fold (a window function, DISTINCT agg, a
grouped TopN, and a join whose build side has more rows per key than the
bucket budget, which raises ``BatchFallback`` at run time).
"""

import pytest

from risingwave_tpu.frontend.session import Session as RefSession
from risingwave_tpu_torch.batch import executors as X
from risingwave_tpu_torch.batch.lower import lower_plan
from risingwave_tpu_torch.frontend import Session
from risingwave_tpu_torch.frontend.parser import parse_one

HOT = 600      # rows of one key: past the join's bucket budget (512)

SETUP = [
    "CREATE TABLE a (k BIGINT PRIMARY KEY, g BIGINT, v BIGINT, s VARCHAR)",
    "CREATE TABLE b (id BIGINT PRIMARY KEY, k BIGINT, w BIGINT)",
    "CREATE TABLE hot (id BIGINT PRIMARY KEY, k BIGINT)",
    "INSERT INTO a VALUES (1, 0, 10, 'x'), (2, 1, 20, 'y'), (3, 0, 30, NULL),"
    " (4, 2, 40, 'z'), (5, NULL, 50, 'x'), (6, 1, NULL, 'w')",
    "INSERT INTO b VALUES (10, 1, 100), (11, 1, 110), (12, 3, 120), "
    "(13, 7, 130), (14, NULL, 140), (15, 4, 150), (16, 4, 160)",
    "INSERT INTO hot VALUES " + ", ".join(
        f"({i}, {1 if i < HOT else 2})" for i in range(HOT + 3)),
]

CASES = [
    # (id, SQL, batch executor the port's plan lowers to, or None = fold)
    ("agg", "SELECT g, count(*), sum(v), min(s), max(v) FROM a GROUP BY g",
     X.BatchHashAgg),
    ("global_agg", "SELECT count(*), sum(v), avg(v) FROM a", X.BatchHashAgg),
    ("empty_global_agg", "SELECT count(*), max(v) FROM a WHERE v > 1000",
     X.BatchHashAgg),
    ("filter_project", "SELECT k, v * 2 + 1, upper(s) FROM a "
     "WHERE v >= 20 AND s <> 'z'", X.BatchProject),
    ("inner", "SELECT a.k, s, w FROM a JOIN b ON a.k = b.k",
     X.BatchHashJoin),
    ("inner_condition", "SELECT a.k, w FROM a JOIN b ON a.k = b.k "
     "AND w > v + 95", X.BatchHashJoin),
    ("left", "SELECT a.k, w FROM a LEFT JOIN b ON a.k = b.k",
     X.BatchHashJoin),
    ("right", "SELECT a.k, b.id, w FROM a RIGHT JOIN b ON a.k = b.k",
     X.BatchHashJoin),
    ("full", "SELECT a.k, b.id FROM a FULL JOIN b ON a.k = b.k",
     X.BatchHashJoin),
    ("semi", "SELECT k, v FROM a WHERE k IN (SELECT k FROM b)",
     X.BatchHashJoin),
    ("anti", "SELECT k, v FROM a WHERE k NOT IN "
     "(SELECT k FROM b WHERE k > 2)", X.BatchHashJoin),
    ("join_agg", "SELECT a.g, count(*), sum(w) FROM a JOIN b "
     "ON a.k = b.k GROUP BY a.g", X.BatchHashAgg),
    ("sort_limit", "SELECT k, v FROM a ORDER BY v DESC LIMIT 3",
     X.BatchLimit),
    ("sort_offset", "SELECT k, s FROM a ORDER BY s, k LIMIT 2 OFFSET 1",
     X.BatchLimit),
    ("window_fold", "SELECT k, row_number() OVER (PARTITION BY g "
     "ORDER BY v) FROM a", None),
    ("distinct_agg_fold", "SELECT count(DISTINCT g) FROM a", None),
    ("hot_join_fallback", "SELECT hot.id, b.w FROM b JOIN hot "
     "ON b.k = hot.k", X.BatchHashJoin),
]


@pytest.fixture(scope="module")
def sessions():
    ref, port = RefSession(), Session(device="cpu")
    for s in (ref, port):
        for stmt in SETUP:
            s.run_sql(stmt)
        s.flush()
    yield ref, port
    ref.close()
    port.close()


def _executors(chain):
    """The executor classes of a batch chain, root first."""
    out, todo = [], [chain]
    while todo:
        ex = todo.pop()
        out.append(type(ex))
        todo += [getattr(ex, f) for f in ("input", "left", "right")
                 if hasattr(ex, f)]
    return out


def _rows(rows, sql):
    return rows if "ORDER BY" in sql else sorted(rows, key=repr)


@pytest.mark.parametrize("name,sql,lowered", CASES,
                         ids=[c[0] for c in CASES])
def test_select_equals_reference(sessions, monkeypatch, name, sql, lowered):
    ref, port = sessions
    folds = []
    real = Session._query_stream_fold
    monkeypatch.setattr(Session, "_query_stream_fold",
                        lambda self, *a: folds.append(1) or real(self, *a))
    got = port.run_sql(sql)
    assert _rows(got, sql) == _rows(ref.run_sql(sql), sql)
    assert got or name == "empty_global_agg"
    chain = lower_plan(port._plan(parse_one(sql).select), port.store,
                       catalog=port.catalog, device="cpu")
    if lowered is None:
        assert chain is None and folds
    else:
        assert lowered in _executors(chain)
        # the one batch join past its bucket budget falls back at run time
        assert bool(folds) == (name == "hot_join_fallback")


def test_bucketed_build_escalates_width(sessions):
    """Duplicate build keys: W grows 1 → 8, and each key's rows all join."""
    _, port = sessions
    plan = port._plan(parse_one(
        "SELECT a.k, b.id FROM a JOIN b ON a.k = b.k").select)
    chain = lower_plan(plan, port.store, catalog=port.catalog, device="cpu")
    rows = X.run_batch(chain)
    assert sorted((r[0], r[1]) for r in rows) == [
        (1, 10), (1, 11), (3, 12), (4, 15), (4, 16)]


def test_occurrence_within_chunk():
    import torch
    slots = torch.tensor([5, 2, 5, 9, 2, 5])
    keyed = torch.tensor([True, True, True, False, True, True])
    assert X._occurrence(slots, keyed, 16).tolist()[:3] == [0, 0, 1]
    assert X._occurrence(slots, keyed, 16).tolist()[4:] == [1, 2]


def test_batch_rows_into_hash_agg():
    """Rows from a provider (``BatchRows``, in chunks of 4) through the
    batch agg: the grouped sums and counts."""
    from risingwave_tpu_torch.common.types import INT64, Field, Schema
    from risingwave_tpu_torch.expr import agg, count_star
    schema = Schema((Field("k", INT64), Field("v", INT64)))
    rows = [(i % 3, i) for i in range(10)]
    chain = X.BatchHashAgg(
        X.BatchRows(schema, lambda: rows, batch_size=4, device="cpu"), [0],
        [count_star(), agg("sum", 1, INT64)], device="cpu")
    assert sorted(X.run_batch(chain)) == [(0, 4, 18), (1, 3, 12), (2, 3, 15)]
