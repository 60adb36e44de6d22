"""TPC-H q3 and q10 through SQL: the port's Session against the reference's.

Both Sessions load tests/test_tpch.py's rows by INSERT, create q3 and q10
(the SQL of tests/test_tpch.py) as MVs over the tables (Backfill, then the
joins and aggs on the live deltas) and take the same refreshes: an
INSERT, a DELETE of one order's lineitems and an UPDATE of a customer's
segment. The MV rows and the SELECT rows must be equal after each step:
revenue is DECIMAL, compared as the same value read from the same scaled
int64; dates exact; VARCHAR decoded.
"""

from risingwave_tpu.frontend.session import Session as RefSession
from risingwave_tpu_torch.frontend import Session
from test_torch_sql_frontend import sql_literals
from test_tpch import CUSTOMERS, LINEITEM, NATION, ORDERS

TABLES = sql_literals("test_tpch.py", "CREATE TABLE")
MVS = sql_literals("test_tpch.py", "CREATE MATERIALIZED VIEW")


def load(s) -> None:
    for name in ("customer", "orders", "lineitem", "nation"):
        s.run_sql(TABLES[name])
    s.run_sql("INSERT INTO customer VALUES " + ", ".join(
        f"({c[0]}, '{c[1]}', '{c[2]}', {c[3]}, '{c[4]}', {c[5]}, "
        f"'{c[6]}', '{c[7]}')" for c in CUSTOMERS))
    s.run_sql("INSERT INTO orders VALUES " + ", ".join(
        f"({o[0]}, {o[1]}, DATE '{o[2]}', {o[3]})" for o in ORDERS))
    s.run_sql("INSERT INTO lineitem VALUES " + ", ".join(
        f"({l[0]}, {l[1]}, {l[2]}, {l[3]}, DATE '{l[4]}', '{l[5]}')"
        for l in LINEITEM))
    s.run_sql("INSERT INTO nation VALUES " + ", ".join(
        f"({n[0]}, '{n[1]}')" for n in NATION))
    s.flush()


def scenario(s) -> list:
    out = []
    load(s)
    s.run_sql(MVS["q3"])
    s.run_sql(MVS["q10"])
    s.flush()

    def observe():
        out.append((sorted(s.mv_rows("q3")), sorted(s.mv_rows("q10"))))

    observe()
    s.run_sql("INSERT INTO lineitem VALUES "
              "(100, 3, 200.00, 0.00, DATE '1995-03-18', 'N'), "
              "(104, 2, 50.00, 0.50, DATE '1994-01-09', 'R')")
    s.flush()
    observe()
    s.run_sql("DELETE FROM lineitem WHERE l_orderkey = 103")
    s.flush()
    observe()
    s.run_sql("UPDATE customer SET c_mktsegment = 'BUILDING' "
              "WHERE c_custkey = 2")
    s.run_sql("INSERT INTO orders VALUES (105, 2, DATE '1995-03-01', 6)")
    s.run_sql("INSERT INTO lineitem VALUES "
              "(105, 1, 300.00, 0.10, DATE '1995-03-30', 'N')")
    s.flush()
    observe()
    out.append(sorted(s.run_sql(
        "SELECT c_name, o_orderkey, o_orderdate FROM customer "
        "JOIN orders ON c_custkey = o_custkey WHERE o_shippriority > 1")))
    out.append(s.run_sql(
        "SELECT o_orderkey, revenue FROM q3 ORDER BY revenue DESC LIMIT 2"))
    return out


def test_q3_q10_by_sql_equal_reference_through_refreshes():
    ref, port = RefSession(), Session(device="cpu")
    try:
        want, got = scenario(ref), scenario(port)
    finally:
        ref.close()
        port.close()
    assert got == want
    q3, q10 = got[-3]
    # the update moved customer 2 into q3 with its new order
    assert any(r[0] == 105 for r in q3) and q10


def test_smoke_sql_phase_at_small_scale(monkeypatch):
    """chip_smoke.py's phase 24 (b) on the CPU at SF 0.002 (chunks of 256
    rows): the INSERT load, q3 and q10 by SQL, an RF1, an RF2 and an
    UPDATE, each MV equal to numpy after each (``run_sql_tpch`` raises
    otherwise); the CUDA-only calls stubbed."""
    import torch

    import chip_smoke as cs
    for name, stub in (("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 0),
                       ("empty_cache", lambda *a: None)):
        monkeypatch.setattr(torch.cuda, name, stub)
    monkeypatch.setattr(cs, "CHUNK", 256)
    out = cs.run_sql_tpch("cpu", sf=0.002)
    assert [r["kind"] for r in out["refresh"]] == ["RF1", "RF2", "UPDATE"]
    assert out["gate_backfill"]["q3"] > 0 and out["gate_RF2"]["q10"] > 0
    # the UPDATE moved a customer's orders into q3
    assert out["gate_UPDATE"]["q3"] > out["gate_RF2"]["q3"]
