"""NEXmark through SQL: the port's Session against the reference's.

The MVs q1, q2, q3, q5, q7, q8, q17 and q105 (the SQL of
tests/test_nexmark_queries.py and tests/test_nexmark_extended.py) are
created by ``CREATE MATERIALIZED VIEW`` in one Session of each package
(64-row chunks, one chunk per source leaf per tick, four ticks) and their
rows must be equal: exact on integers, timestamps and decoded VARCHAR;
q17's averages are of integers, exact in float64. The reference Session's
joins are sized so that none grows (each growth recompiles). q4, q9 and
q20 are marked slow, as the reference marks its own.
"""

import pytest

from risingwave_tpu.frontend.build import BuildConfig as RefConfig
from risingwave_tpu.frontend.session import Session as RefSession
from risingwave_tpu_torch.frontend import BuildConfig, Session
from test_nexmark_queries import CAP, DDL
from test_torch_sql_frontend import sql_literals

SQL = {**sql_literals("test_nexmark_queries.py", "CREATE MATERIALIZED VIEW"),
       **sql_literals("test_nexmark_extended.py",
                      "CREATE MATERIALIZED VIEW")}
FAST = ("q1", "q2", "q3", "q5", "q7", "q8", "q17", "q105")
SLOW = ("q4", "q9", "q20")
TICKS = 4
CONFIG = dict(chunk_capacity=CAP, agg_table_capacity=1 << 10,
              join_key_capacity=1 << 9, join_bucket_width=1 << 8,
              topn_table_capacity=1 << 12)


def mv_rows(session, names) -> dict:
    session.run_sql(DDL)
    for name in names:
        session.run_sql(SQL[name])
    for _ in range(TICKS):
        session.tick()
    rows = {name: sorted(session.mv_rows(name)) for name in names}
    session.close()
    return rows


def both(names):
    ref = mv_rows(RefSession(source_chunk_capacity=CAP, chunks_per_tick=1,
                             config=RefConfig(**CONFIG)), names)
    port = mv_rows(Session(source_chunk_capacity=CAP, chunks_per_tick=1,
                           config=BuildConfig(**CONFIG), device="cpu"),
                   names)
    return ref, port


@pytest.fixture(scope="module")
def fast():
    return both(FAST)


@pytest.mark.parametrize("name", FAST)
def test_mv_equals_reference_session(fast, name):
    ref, port = fast
    assert port[name] == ref[name]
    assert port[name]


def test_one_chunk_per_leaf_per_tick(fast):
    _, port = fast
    assert len(port["q1"]) == TICKS * CAP


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_slow_mv_equals_reference_session(name):
    ref, port = both((name,))
    assert port[name] == ref[name]


def test_smoke_sql_phase_at_small_scale(monkeypatch):
    """chip_smoke.py's phase 24 (a) on the CPU at a small size (chunks of
    256 rows, 4 per leaf per tick): q105, q105 without its TopN, q17, q18
    and q7 by SQL, each MV equal to numpy over phase 13's chunks, and the
    SELECTs over q17 on the paths they name (``run_sql_nexmark`` raises otherwise); the CUDA-only
    calls stubbed."""
    import torch

    import chip_smoke as cs
    for name, stub in (("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 0),
                       ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, stub)
    for name, value in (("CHUNK", 256), ("NEX_CHUNKS_PER_EPOCH", 4),
                        ("Q105_KEY_CAPACITY", 1 << 10),
                        ("Q105_BUCKET_WIDTH", 2048),
                        ("Q105_AGG_CAPACITY", 1 << 14),
                        ("Q105_TOPN_CAPACITY", 1 << 14)):
        monkeypatch.setattr(cs, name, value)
    n = cs.NEX_EPOCHS * cs.NEX_CHUNKS_PER_EPOCH
    auctions, _ = cs.nexmark_chunks("auction", n, "cpu")
    bids, _ = cs.nexmark_chunks("bid", n, "cpu")
    out = cs.run_sql_nexmark("cpu", auctions, bids,
                             cs.ExtData(auctions, bids))
    assert list(out) == ["q105", "q105_join", "q17", "q18", "q7"]
    assert out["q105"]["rows_out"] == 1000
    assert out["q105_join"]["rows_out"] > 1000
    assert out["q17"]["selects"]["grouped_agg"]["rows"] > 100
    assert [r["path"] for r in out["q17"]["selects"].values()] == [
        "BatchHashAgg", "BatchHashJoin", "BatchLimit", "stream fold"]
