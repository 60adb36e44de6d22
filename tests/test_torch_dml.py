"""DML through the port's ``DmlManager`` into a table job, with an MV over
the table retracting, against the reference's ``Session`` running
tests/test_dml.py's statements on the same rows (CPU).

The port has no SQL frontend: each statement is staged as the chunk the
Session's DML executor hands its table (inserts; deletes of the rows the
WHERE picks; an UPDATE as U-/U+ pairs, or a delete and an insert when it
moves the pk). Each write lands inside one epoch; after each, the table's
rows and the MV's (``SELECT g, sum(v) FROM t GROUP BY g``) must equal the
Session's.
"""

import pytest

from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.common import INT64, Schema, make_chunk
from risingwave_tpu_torch.expr import AggCall, col
from risingwave_tpu_torch.frontend.runtime import Cluster
from risingwave_tpu_torch.storage import StateTable
from risingwave_tpu_torch.stream import (
    HashAggExecutor, MaterializeExecutor, ProjectExecutor,
)

I, D, UD, UI = 0, 1, 2, 3
SCHEMA = Schema.of(("k", INT64), ("g", INT64), ("v", INT64))
ROWS = [(1, 0, 10), (2, 1, 20), (3, 0, 30), (4, 1, 40)]
# (SQL statements of one epoch, the chunks the port stages for them)
STEPS = [
    (["UPDATE t SET v = v + 100 WHERE g = 0"],
     [[(UD, (1, 0, 10)), (UI, (1, 0, 110)), (UD, (3, 0, 30)),
       (UI, (3, 0, 130))]]),
    (["UPDATE t SET k = k + 100 WHERE k = 2"],
     [[(D, (2, 1, 20)), (I, (102, 1, 20))]]),
    (["INSERT INTO t VALUES (5, 0, 50)",
      "UPDATE t SET g = 9, v = 0 WHERE k = 5"],
     [[(I, (5, 0, 50))], [(UD, (5, 0, 50)), (UI, (5, 9, 0))]]),
    (["DELETE FROM t WHERE v > 25"],
     [[(D, (1, 0, 110)), (D, (3, 0, 130)), (D, (4, 1, 40))]]),
    (["DELETE FROM t WHERE g = 9"], [[(D, (5, 9, 0))]]),
    (["DELETE FROM t"], [[(D, (102, 1, 20))]]),
]
MV = "SELECT g, sum(v) AS sv FROM t GROUP BY g"


@pytest.fixture(scope="module")
def session():
    """(table rows, MV rows) after the load and after each step."""
    s = Session()
    s.run_sql("CREATE TABLE t (k BIGINT PRIMARY KEY, g BIGINT, v BIGINT)")
    s.run_sql("INSERT INTO t VALUES " + ", ".join(map(str, ROWS)))
    s.flush()
    s.run_sql(f"CREATE MATERIALIZED VIEW m AS {MV}")
    s.flush()
    out = [(sorted(s.run_sql("SELECT k, g, v FROM t")),
            sorted(s.mv_rows("m")))]
    for sqls, _ in STEPS:
        for q in sqls:
            s.run_sql(q)
        s.flush()
        out.append((sorted(s.run_sql("SELECT k, g, v FROM t")),
                    sorted(s.mv_rows("m"))))
    s.close()
    return out


def stage(cl, changes):
    cl.write("t", make_chunk(SCHEMA, [r for _, r in changes],
                             ops=[op for op, _ in changes], capacity=8,
                             device="cpu"))


def test_dml_into_table_job_and_mv_retracts(session):
    cl = Cluster(device="cpu", chunk_capacity=8, batch_rows=2)
    cl.create_table("t", SCHEMA, (0,))
    stage(cl, [(I, r) for r in ROWS])
    cl.tick()
    scan = cl.scan("t")
    sums = HashAggExecutor(
        ProjectExecutor(scan, [col(1, INT64), col(2, INT64)], ("g", "v")),
        [0], [AggCall("sum", 1, INT64)], table_capacity=64, out_capacity=8,
        device="cpu")
    mv = MaterializeExecutor(sums, StateTable(
        cl.store, cl.next_table_id(), sums.schema, [0]))
    cl.create_mv("m", mv)
    while not cl.backfill_done("m"):
        cl.tick()
    cl.tick()

    def now():
        return (sorted(cl.jobs["t"].table.scan_all()),
                sorted(cl.mv_rows("m")))

    assert now() == session[0]
    for i, (_, chunks) in enumerate(STEPS):
        for changes in chunks:
            stage(cl, changes)
        assert now()[0] == session[i][0]      # staged, not yet applied
        cl.tick()
        assert now() == session[i + 1], STEPS[i][0]
    assert session[-1] == ([], [])
    cl.close()


def test_stage_needs_a_registered_table():
    from risingwave_tpu_torch.stream.dml import DmlManager
    with pytest.raises(KeyError):
        DmlManager().stage(7, None)


@pytest.mark.parametrize("stop_after", [None, 3])
def test_scheduled_source_equals_reference(stop_after):
    """ScheduledSource: an initial barrier, a barrier every 2 chunks, every
    second one a checkpoint, a STOP barrier when the generator runs out
    (7 chunks) or after ``stop_after`` barriers; the same messages as the
    reference's."""
    import asyncio

    from risingwave_tpu.common import make_chunk as j_make_chunk
    from risingwave_tpu.common import INT64 as J_INT64, Schema as JSchema
    from risingwave_tpu.stream.source import ScheduledSource as JSource
    from risingwave_tpu_torch.stream.source import ScheduledSource

    def run(src_cls, make, schema, **kw):
        left = iter(range(7))

        def gen():
            i = next(left, None)
            return None if i is None else make(schema, [(i,)], capacity=2,
                                               **kw)

        src = src_cls(schema, gen, chunks_per_epoch=2,
                      checkpoint_frequency=2, first_epoch=5,
                      stop_after_epochs=stop_after)

        async def drain():
            out = []
            async for m in src.execute():
                if hasattr(m, "epoch"):
                    out.append(("b", m.epoch.curr, m.epoch.prev,
                                m.checkpoint, m.is_stop()))
                else:
                    out.append(("c", int(m.columns[0].data[0])))
            return out

        return asyncio.run(drain())

    got = run(ScheduledSource, make_chunk, SCHEMA.select([0]),
              device="cpu")
    want = run(JSource, j_make_chunk, JSchema.of(("k", J_INT64)))
    assert got == want and got[-1][-1] is True
