"""TPC-H q3 and q10 as streaming MVs over tables through the port, on the
CPU, against the reference's ``Session`` running tests/test_tpch.py's SQL
on the same rows, and a small run of ``chip_smoke.py``'s TPC-H phase (its
generator at a tiny scale factor, one RF1 and one RF2) against its numpy
evaluation.

The port's tables are stream jobs fed by DML, its TableScan leaves are
Backfills (``stream/tpch_plans.py``). DECIMAL results compare as scaled
integers: the Session's float revenue times 10**4, rounded, against the
port's int64 lanes; VARCHAR by string.
"""

import pytest

import chip_smoke as cs
import risingwave_tpu_torch.stream.tpch_plans as tp
from risingwave_tpu_torch.frontend.runtime import Cluster
from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.common import make_chunk
from test_tpch import CUSTOMERS, LINEITEM, NATION, ORDERS, _setup, d

SQL = {"q3": """SELECT o_orderkey, sum(l_extendedprice * (1 - l_discount))
                   AS revenue, o_orderdate, o_shippriority
               FROM customer, orders, lineitem
               WHERE c_mktsegment = 'BUILDING'
                 AND c_custkey = o_custkey
                 AND l_orderkey = o_orderkey
                 AND o_orderdate < DATE '1995-03-15'
                 AND l_shipdate > DATE '1995-03-15'
               GROUP BY o_orderkey, o_orderdate, o_shippriority""",
       "q10": """SELECT c_custkey, c_name,
                   sum(l_extendedprice * (1 - l_discount)) AS revenue,
                   n_name
               FROM customer, orders, lineitem, nation
               WHERE c_custkey = o_custkey
                 AND l_orderkey = o_orderkey
                 AND o_orderdate >= DATE '1993-10-01'
                 AND o_orderdate < DATE '1994-01-01'
                 AND l_returnflag = 'R'
                 AND c_nationkey = n_nationkey
               GROUP BY c_custkey, c_name, n_name"""}
REVENUE = {"q3": 1, "q10": 2}
NEW_ITEM = (100, 3, 200.00, 0.00, "1995-03-18", "N")


def scaled(rows, name):
    """MV rows with the revenue as an int64 at scale 4."""
    i = REVENUE[name]
    return sorted(tuple(round(v * 10**4) if j == i else v
                        for j, v in enumerate(r)) for r in rows)


@pytest.fixture(scope="module")
def session():
    """The reference's MVs: before and after the incremental insert."""
    s = _setup()
    for name, q in SQL.items():
        s.run_sql(f"CREATE MATERIALIZED VIEW {name} AS {q}")
    s.flush()
    before = {n: scaled(s.mv_rows(n), n) for n in SQL}
    s.run_sql("INSERT INTO lineitem VALUES (100, 3, 200.00, 0.00, "
              "DATE '1995-03-18', 'N')")
    s.flush()
    after = {n: scaled(s.mv_rows(n), n) for n in SQL}
    s.close()
    return before, after


def port_cluster():
    cl = Cluster(device="cpu", chunk_capacity=4, batch_rows=2)
    tp.create_tables(cl)
    rows = {"customer": CUSTOMERS,
            "orders": [(o[0], o[1], d(o[2]), o[3]) for o in ORDERS],
            "lineitem": [l[:4] + (d(l[4]), l[5]) for l in LINEITEM],
            "nation": NATION}
    for name, table_rows in rows.items():
        schema = tp.TABLES[name][0]
        for i in range(0, len(table_rows), 4):
            cl.write(name, make_chunk(schema, table_rows[i:i + 4],
                                      capacity=4, device="cpu"))
        cl.tick()
    return cl


def mv(cl, name):
    """The port's MV rows, DECIMAL as its scaled integer."""
    schema = cl.jobs[name].pipeline.schema
    return sorted(tuple(v if j == REVENUE[name] or not schema[j].type
                        .is_string else schema[j].type.to_python(v)
                        for j, v in enumerate(r))
                  for r in cl.jobs[name].table.scan_all())


def test_q3_q10_equal_session_before_and_after_insert(session):
    before, after = session
    cl = port_cluster()
    tp.create_q3(cl)
    tp.create_q10(cl)
    while not (cl.backfill_done("q3") and cl.backfill_done("q10")):
        cl.tick()
    cl.tick()
    assert mv(cl, "q3") == before["q3"] and len(before["q3"]) > 0
    assert mv(cl, "q10") == before["q10"] and len(before["q10"]) > 0
    item = NEW_ITEM[:4] + (d(NEW_ITEM[4]), NEW_ITEM[5])
    cl.write("lineitem", make_chunk(tp.LINEITEM_SCHEMA, [item], capacity=4,
                                    device="cpu"))
    cl.tick()
    assert mv(cl, "q3") == after["q3"]
    assert mv(cl, "q10") == after["q10"]
    cl.close()


def test_smoke_phase_at_small_scale(monkeypatch):
    """chip_smoke.py's TPC-H phase on the CPU at SF 0.002 (chunks of 256
    rows): the DML load, both backfills, one RF1 and one RF2, each MV
    equal to the numpy evaluation after each (``run_tpch`` raises
    otherwise); the CUDA-only calls stubbed."""
    import contextlib
    import torch
    for name, stub in (("synchronize", lambda *a: None),
                       ("reset_peak_memory_stats", lambda *a: None),
                       ("max_memory_allocated", lambda *a: 0)):
        monkeypatch.setattr(torch.cuda, name, stub)
    monkeypatch.setattr(cs, "profiled", contextlib.nullcontext)
    monkeypatch.setattr(cs, "CHUNK", 256)
    out = cs.run_tpch("cpu", sf=0.002, refresh_pairs=1)
    assert [r["kind"] for r in out["refresh"]] == ["RF1", "RF2"]
    assert all(r["rows"] > 0 for r in out["refresh"])
    assert out["gate_backfill"]["q3"] > 0 and out["gate_RF2"]["q10"] > 0
    assert all(b["rows"] == sum(out["rows"][t] for t in tables)
               for b, tables in (
                   (out["backfill"]["q3"], ("customer", "orders",
                                            "lineitem")),
                   (out["backfill"]["q10"], ("customer", "orders",
                                             "lineitem", "nation"))))
