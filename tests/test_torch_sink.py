"""The SinkExecutor and its log store through both packages on the CPU:
the four scenarios of tests/test_sink_decouple.py (a backend down for
several epochs degrades the sink and ``resume()`` drains the backlog
exactly once; a degraded backlog survives a crash and is delivered once;
the log cap fails loudly; a once-off fault is absorbed by the retry), and
a recovery with no progress row rolling back phantom output.

Each scenario drives the reference's ``SinkExecutor`` and the port's over
the same messages, with the same failpoint armed at the same barriers and
the same retry policy (``FaultConfig`` of the test_sink_decouple scenarios).
After every barrier the committed store snapshots (the log and progress
tables, byte for byte: VARCHAR values are encoded by content) and the sink
files' bytes must be equal. Tolerance: exact.
"""

import asyncio
import json

import pytest

import risingwave_tpu.common.config as JC
import risingwave_tpu.common.failpoint as JF
import risingwave_tpu.connector.sinks as JK
import risingwave_tpu.stream.sink as JSink
import risingwave_tpu_torch.common.config as TC
import risingwave_tpu_torch.common.failpoint as TF
import risingwave_tpu_torch.connector.sinks as TK
import risingwave_tpu_torch.stream.sink as TSink
from risingwave_tpu.common.retry import GLOBAL_RETRY_METRICS as J_RETRY
from risingwave_tpu_torch.common.retry import GLOBAL_RETRY_METRICS as T_RETRY
from test_torch_recovery import JAX, TORCH

#: per package: (sink module, sinks connector, failpoints, config, retry
#: counters)
MODS = {id(JAX): (JSink, JK, JF, JC, J_RETRY),
        id(TORCH): (TSink, TK, TF, TC, T_RETRY)}
FAULT = dict(sink_retry_attempts=2, sink_retry_base_ms=0.5,
             sink_retry_deadline_ms=50.0, sink_degrade_after=2)
COLS = (("k", "INT64"), ("v", "INT64"), ("s", "VARCHAR"))


def ins(*kvs):
    return ("c", [(k, v, f"s{k % 3}") for k, v in kvs], None)


def ckpt(epoch):
    return ("b", epoch, True)


class Job:
    """One package's sink over a scripted input: ``agg`` puts a SimpleAgg
    (sum of v) in front, so the sink gets its U-/U+ changelog."""

    def __init__(self, pkg, path, store=None, recovering=False, agg=False,
                 sink=None, **kw):
        self.pkg = pkg
        sink_mod, conn, self.fp, cfg, self.retry = MODS[id(pkg)]
        self.store = store if store is not None else pkg.store_cls()
        self.src = pkg.stream.MockSource(pkg.schema(*COLS), [])
        inp = self.src
        if agg:
            with pkg.eager():
                inp = pkg.stream.SimpleAggExecutor(
                    inp, [pkg.expr.agg("sum", 1, pkg.common.INT64)],
                    **pkg.kw())
        self.path = path
        self.sink = sink if sink is not None else conn.FileSink(
            path, inp.schema)
        policy = cfg.FaultConfig(**FAULT).sink_retry_policy()
        self.ex = sink_mod.SinkExecutor(
            inp, self.sink,
            pkg.table_cls(self.store, 1,
                          sink_mod.log_table_schema(inp.schema), [0, 1]),
            pkg.table_cls(self.store, 2, sink_mod.PROGRESS_SCHEMA, [0]),
            recovering=recovering, retry_policy=policy,
            degrade_after=kw.get("degrade_after", FAULT[
                "sink_degrade_after"]),
            log_cap_rows=kw.get("log_cap_rows", 1_000_000))

    def run(self, spec, actions=None, commit=True) -> list:
        """Drive ``spec``; after each barrier commit the store (unless not
        ``commit``), run ``actions[epoch](job)`` and record (snapshot,
        file bytes, health)."""
        self.src.reset(self.pkg.messages(self.src.schema, spec))
        seen = []

        async def go():
            async for m in self.ex.execute():
                if isinstance(m, self.pkg.stream.Barrier):
                    e = m.epoch.curr
                    if commit:
                        self.store.commit(e)
                    if actions and e in actions:
                        actions[e](self)
                    seen.append((self.store.snapshot(), self.bytes(),
                                 self.ex.sink_health()))

        with self.pkg.eager():
            asyncio.run(go())
        return seen

    def bytes(self) -> bytes:
        if not isinstance(self.sink, (JK.FileSink, TK.FileSink)):
            return b""
        self.sink._f.flush()
        with open(self.path, "rb") as f:
            return f.read()

    def arm(self, **kw):
        self.fp.arm("sink.deliver", OSError, **kw)

    def disarm(self):
        self.fp.disarm()


def both(tmp_path, scenario):
    """``scenario(pkg, dir)`` for each package; the results must be
    equal."""
    got = []
    for pkg in (JAX, TORCH):
        d = tmp_path / ("jax" if pkg is JAX else "torch")
        d.mkdir()
        try:
            got.append(scenario(pkg, d))
        finally:
            MODS[id(pkg)][2].disarm()
    assert got[1] == got[0]
    return got[0]


def rows_of(data: bytes) -> list:
    return [json.loads(line) for line in data.decode().splitlines()]


def test_down_backend_degrades_not_stalls(tmp_path):
    def scenario(pkg, d):
        job = Job(pkg, str(d / "out.jsonl"), agg=True)
        spec = [ckpt(1), ins((1, 10)), ckpt(2)]
        for i in range(2, 7):
            spec += [ins((i, 10 * i)), ckpt(i + 1)]
        spec += [ckpt(8)]
        seen = job.run(spec, actions={2: Job.arm,
                                      7: lambda j: (j.disarm(),
                                                    j.ex.resume())})
        down = seen[5][2]
        assert down["degraded"] and down["pending_rows"] > 0
        assert down["delivery_failures"] >= FAULT["sink_degrade_after"]
        assert down["last_error"]
        end = seen[-1][2]
        assert not end["degraded"] and end["pending_rows"] == 0
        return seen

    seen = both(tmp_path, scenario)
    ups = [r["agg0"] for r in rows_of(seen[-1][1])
           if r["__op"] == "update_insert"]
    assert ups == [10, 30, 60, 100, 150, 210]


def test_degraded_backlog_survives_crash_and_delivers_once(tmp_path):
    def scenario(pkg, d):
        path = str(d / "out.jsonl")
        job = Job(pkg, path)
        spec = [ckpt(1), ins((1, 10)), ckpt(2)]
        for i in range(2, 5):
            spec += [ins((i, 10 * i)), ckpt(i + 1)]
        # the crash: the stream stops after epoch 5's checkpoint, and
        # epoch 6's rows never reach a barrier
        seen = job.run(spec + [ins((9, 90))], actions={2: Job.arm})
        assert seen[-1][2]["degraded"]
        job.disarm()
        again = Job(pkg, path, store=job.store, recovering=True)
        seen += again.run([ckpt(6)])
        keys = sorted(r["k"] for r in rows_of(seen[-1][1]))
        assert keys == [1, 2, 3, 4]
        assert seen[-1][2]["pending_rows"] == 0
        assert again.ex.rows_delivered == 3
        return seen

    both(tmp_path, scenario)


def test_recovery_without_progress_row_rolls_back_phantom_output(tmp_path):
    """Delivered, but the epoch never committed: the recovered sink finds
    no progress row and truncates the phantom rows."""
    def scenario(pkg, d):
        path = str(d / "out.jsonl")
        job = Job(pkg, path)
        seen = job.run([ckpt(1), ins((1, 10), (2, 20)), ckpt(2)],
                       commit=False)
        assert len(rows_of(seen[-1][1])) == 2
        store = pkg.store_cls()
        again = Job(pkg, path, store=store, recovering=True)
        seen += again.run([ckpt(3), ins((3, 30)), ckpt(4)])
        assert [r["k"] for r in rows_of(seen[-1][1])] == [3]
        return seen

    both(tmp_path, scenario)


def test_log_cap_backpressure_fails_loudly(tmp_path):
    def scenario(pkg, d):
        conn = MODS[id(pkg)][1]
        job = Job(pkg, None, sink=conn.BlackHoleSink(), degrade_after=1,
                  log_cap_rows=3)
        job.arm()
        with pytest.raises(RuntimeError, match="log_cap_rows") as ei:
            job.run([ckpt(1), ins((1, 1), (2, 2)), ckpt(2),
                     ins((3, 3), (4, 4)), ckpt(3)])
        health = job.ex.sink_health()
        assert health["degraded"] and health["pending_rows"] == 4
        return str(ei.value), job.store.snapshot()

    both(tmp_path, scenario)


def test_transient_hiccup_absorbed_by_retry(tmp_path):
    def scenario(pkg, d):
        job = Job(pkg, str(d / "out.jsonl"))
        job.retry.reset()
        job.arm(once=True)
        seen = job.run([ckpt(1), ins((1, 10)), ckpt(2)])
        health = seen[-1][2]
        assert not health["degraded"] and health["pending_rows"] == 0
        assert [r["k"] for r in rows_of(seen[-1][1])] == [1]
        assert job.retry.snapshot()["sink.deliver"]["retries"] >= 1
        return seen

    both(tmp_path, scenario)


def test_build_sink_registry(tmp_path):
    schema = TORCH.schema(*COLS)
    assert isinstance(TK.build_sink("blackhole", {}, schema),
                      TK.BlackHoleSink)
    f = TK.build_sink("file", {"path": str(tmp_path / "o.csv"),
                               "format": "csv"}, schema)
    f.write_rows([(0, (1, None, "a,b"))])
    f.flush()
    j = JK.build_sink("file", {"path": str(tmp_path / "j.csv"),
                               "format": "csv"}, JAX.schema(*COLS))
    j.write_rows([(0, (1, None, "a,b"))])
    j.flush()
    assert (tmp_path / "o.csv").read_bytes() == \
        (tmp_path / "j.csv").read_bytes()
    with pytest.raises(NotImplementedError, match="BrokerSink"):
        TK.build_sink("kafka", {}, schema)
    with pytest.raises(ValueError):
        TK.build_sink("file", {}, schema)


def test_sink_knobs_default_to_fault_config():
    """A SinkExecutor given no knobs takes FaultConfig's, which equal the
    reference's defaults."""
    fields = ("sink_retry_attempts", "sink_retry_base_ms",
              "sink_retry_deadline_ms", "sink_degrade_after",
              "sink_log_cap_rows")
    port, ref = TC.FaultConfig(), JC.FaultConfig()
    assert [getattr(port, f) for f in fields] == \
        [getattr(ref, f) for f in fields]
    schema = TORCH.schema(*COLS)
    store = TORCH.store_cls()
    ex = TSink.SinkExecutor(
        TORCH.stream.MockSource(schema, []), TK.BlackHoleSink(),
        TORCH.table_cls(store, 1, TSink.log_table_schema(schema), [0, 1]),
        TORCH.table_cls(store, 2, TSink.PROGRESS_SCHEMA, [0]))
    assert (ex.degrade_after, ex.log_cap_rows) == (
        port.sink_degrade_after, port.sink_log_cap_rows)
    assert ex._policy.max_attempts == port.sink_retry_attempts
