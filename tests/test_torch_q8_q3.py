"""The q8 session-window and TPC-H q3 slices of the PyTorch port against the
JAX package, on the CPU: the q3 event generator bit for bit; the session
core's chunk step, watermark flush and closed-session gather, field for
field, from a state carried across from the JAX package (rows out of order
inside a chunk, a per-key rewind across chunks, a delete, a full closed
buffer); the q3 core's chunk steps and top-10 churn over two epochs; both
fused epochs against the reference's; and the export/import round trips.
All state is integer, so every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
from risingwave_tpu.connector import NexmarkConfig as JConfig
from risingwave_tpu.connector.nexmark import DeviceBidGenerator as JGen
from risingwave_tpu.connector.tpch import (
    DeviceQ3Generator as JQ3Gen, TpchQ3Config as JQ3Config,
)
from risingwave_tpu.ops.fused_epoch import (
    fused_source_q3_epoch as j_q3_epoch,
    fused_source_session_epoch as j_session_epoch,
)
from risingwave_tpu.ops.session_window import (
    SessionWindowCore as JSessionCore,
)
from risingwave_tpu.ops.stream_q3 import Q3Core as JQ3Core
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
from risingwave_tpu_torch.connector import (
    Q3_CUTOFF_DAYS, DeviceBidGenerator, DeviceQ3Generator, NexmarkConfig,
    TpchQ3Config, threefry,
)
from risingwave_tpu_torch.interop import (
    chunk_from_jax, q3_state_from_jax, session_state_from_jax,
)
from risingwave_tpu_torch.ops import session_window, stream_q3
from risingwave_tpu_torch.ops.fused_epoch import EPOCH_BUILDERS
from risingwave_tpu_torch.ops.session_window import SessionWindowCore
from risingwave_tpu_torch.ops.stream_q3 import Q3Core

CPU = "cpu"
CAP = 256                  # rows per chunk
GAP = 5_000                # session gap, us
K = 4                      # chunks per epoch
T0 = 1_600_000_000_000_000


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_table_equal(j, t, what):
    np.testing.assert_array_equal(_np(j.occupied), _np(t.occupied),
                                  err_msg=f"{what}.occupied")
    for i, (a, b) in enumerate(zip(j.key_data + j.key_mask,
                                   t.key_data + t.key_mask)):
        np.testing.assert_array_equal(_np(a), _np(b),
                                      err_msg=f"{what} key array {i}")


def _assert_session_equal(j, t):
    _assert_table_equal(j.table, t.table, "table")
    for f in session_window.FIELDS:
        np.testing.assert_array_equal(_np(getattr(j, f)), _np(getattr(t, f)),
                                      err_msg=f)


def _assert_q3_equal(j, t):
    _assert_table_equal(j.orders, t.orders, "orders")
    for f in stream_q3.FIELDS:
        np.testing.assert_array_equal(_np(getattr(j, f)), _np(getattr(t, f)),
                                      err_msg=f)
    _assert_table_equal(j.agg.table, t.agg.table, "agg.table")
    for name in ("lanes", "prev_lanes"):
        for a, b in zip(getattr(j.agg, name), getattr(t.agg, name)):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    for name in ("dirty", "overflow"):
        np.testing.assert_array_equal(_np(getattr(j.agg, name)),
                                      _np(getattr(t.agg, name)),
                                      err_msg=f"agg.{name}")


def _assert_chunk_equal(j, t):
    for a, b in zip((j.ops, j.vis), (t.ops, t.vis)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(j.columns, t.columns):
        np.testing.assert_array_equal(_np(a.data), _np(b.data))
        np.testing.assert_array_equal(_np(a.mask), _np(b.mask))


def _host(state):
    return jax.tree_util.tree_map(np.asarray, state)


# ---------------------------------------------------------------------------
# the q3 event source
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start", [0, 4096 * 3, 10**9 + 7])
def test_q3_generator_bit_equal(start):
    jfn = JQ3Gen(JQ3Config(chunk_capacity=CAP)).chunk_fn()
    tfn = DeviceQ3Generator(TpchQ3Config(chunk_capacity=CAP),
                            device=CPU).chunk_fn()
    _assert_chunk_equal(jfn(jnp.int64(start)), tfn(start))
    # the batched form: chunk i of [k, cap] equals the single chunk there
    batch = tfn(torch.tensor([start, start + CAP]))
    _assert_chunk_equal(jfn(jnp.int64(start + CAP)),
                        T.map_tensors(batch, lambda a: a[1]))


# ---------------------------------------------------------------------------
# q8: the session-window core
# ---------------------------------------------------------------------------

def _session_cores(closed_capacity):
    def schema(c):
        return c.Schema((c.Field("bidder", c.INT64),
                         c.Field("ts", c.TIMESTAMP)))
    j = JSessionCore(schema(J), 0, 1, GAP, capacity=1 << 10,
                     closed_capacity=closed_capacity)
    t = SessionWindowCore(schema(T), 0, 1, GAP, capacity=1 << 10,
                          closed_capacity=closed_capacity, device=CPU)
    return j, t


def _session_rows(rng, n, base):
    """``n`` events over 12 bidders in random order: gaps below and above
    GAP, so sessions extend, split and close inside one chunk."""
    keys = rng.integers(0, 12, n)
    ts = base + np.sort(rng.integers(0, 8 * GAP, n))
    order = rng.permutation(n)
    return [(int(k), int(t)) for k, t in zip(keys[order], ts[order])]


def _session_chunks(scenario, rng):
    """(rows, ops) of the chunks a scenario applies after the first."""
    def ins(rows):
        return rows, None

    base = T0 + 10 * GAP
    if scenario == "out_of_order_in_chunk":
        return [ins(_session_rows(rng, 200, base)),
                ins(_session_rows(rng, 200, base + 9 * GAP))]
    if scenario == "rewind_across_chunks":
        first = _session_rows(rng, 100, base)
        late = [(k, t - 3 * GAP) for k, t in first[:5]]
        return [ins(first), ins(late + _session_rows(rng, 50, base + GAP))]
    if scenario == "delete":
        rows = _session_rows(rng, 100, base)
        return [(rows, [T.OP_DELETE if i == 7 else T.OP_INSERT
                        for i in range(len(rows))])]
    if scenario == "closed_overflow":
        return [ins(_session_rows(rng, 250, base + i * 9 * GAP))
                for i in range(3)]
    raise ValueError(scenario)


@pytest.mark.parametrize("scenario", [
    "out_of_order_in_chunk", "rewind_across_chunks", "delete",
    "closed_overflow"])
def test_session_core_steps_equal_reference(scenario):
    rng = np.random.default_rng(sum(map(ord, scenario)))
    ccap = 16 if scenario == "closed_overflow" else 1 << 12
    jcore, tcore = _session_cores(ccap)
    japply = jax.jit(jcore.apply_chunk)

    def chunks(rows, ops):
        jc = J.make_chunk(jcore.in_schema, rows, ops=ops, capacity=CAP)
        return jc, chunk_from_jax(_host(jc), device=CPU)

    # a state built by the reference, carried across
    js = japply(jcore.init_state(),
                chunks(_session_rows(rng, 150, T0), None)[0])
    ts = session_state_from_jax(_host(js), device=CPU)
    _assert_session_equal(js, ts)
    for rows, ops in _session_chunks(scenario, rng):
        jc, tc = chunks(rows, ops)
        js = japply(js, jc)
        ts = tcore.apply_chunk(ts, tc)
        _assert_session_equal(js, ts)
    wm = T0 + 20 * GAP
    js, jpacked = jax.jit(jcore.flush_plan)(js, jnp.int64(wm))
    ts, tpacked = tcore.flush_plan(ts, wm)
    np.testing.assert_array_equal(_np(jpacked), _np(tpacked))
    _assert_session_equal(js, ts)
    flags = dict(zip(("n", "ovf", "covf", "del", "ooo"),
                     _np(tpacked).tolist()))
    assert flags["n"] > 0 and not flags["ovf"]
    assert bool(flags["covf"]) == (scenario == "closed_overflow")
    assert bool(flags["del"]) == (scenario == "delete")
    assert bool(flags["ooo"]) == (scenario == "rewind_across_chunks")
    jsnap, tsnap = jcore.snapshot_closed(js), tcore.snapshot_closed(ts)
    for lo in range(0, flags["n"], 64):
        _assert_chunk_equal(
            jcore.gather_closed(jsnap, jnp.int64(flags["n"]), jnp.int64(lo),
                                out_capacity=64),
            tcore.gather_closed(tsnap, flags["n"], lo, 64))
    _assert_session_equal(jcore.finish_flush(js), tcore.finish_flush(ts))


# ---------------------------------------------------------------------------
# q3: the join + agg + top-n core
# ---------------------------------------------------------------------------

def _q3_cores():
    j = JQ3Core(Q3_CUTOFF_DAYS, orders_capacity=1 << 11,
                agg_capacity=1 << 11)
    t = Q3Core(Q3_CUTOFF_DAYS, orders_capacity=1 << 11,
               agg_capacity=1 << 11, device=CPU)
    return j, t


def test_q3_core_steps_and_churn_equal_reference():
    jcore, tcore = _q3_cores()
    jfn = JQ3Gen(JQ3Config(chunk_capacity=CAP)).chunk_fn()
    tfn = DeviceQ3Generator(TpchQ3Config(chunk_capacity=CAP),
                            device=CPU).chunk_fn()
    japply, jflush = jax.jit(jcore.apply_chunk), jax.jit(jcore.flush)
    js = japply(jcore.init_state(), jfn(jnp.int64(0)))
    ts = q3_state_from_jax(jcore.export_host(js), device=CPU)
    _assert_q3_equal(js, ts)
    ops_seen = []
    start = CAP
    for _ in range(2):               # two epochs of K chunks and a flush
        for _ in range(K):
            js = japply(js, jfn(jnp.int64(start)))
            ts = tcore.apply_chunk(ts, tfn(start))
            start += CAP
            _assert_q3_equal(js, ts)
        js, jout, jpacked = jflush(js)
        ts, tout, tpacked = tcore.flush(ts)
        np.testing.assert_array_equal(_np(jpacked), _np(tpacked))
        _assert_chunk_equal(jout, tout)
        _assert_q3_equal(js, ts)
        assert not _np(tpacked)[1:].any()
        ops_seen.append(set(_np(tout.ops)[_np(tout.vis)].tolist()))
    assert ops_seen[0] == {T.OP_INSERT}
    assert ops_seen[1] == {T.OP_DELETE, T.OP_INSERT}   # departures, arrivals


# ---------------------------------------------------------------------------
# the fused epochs
# ---------------------------------------------------------------------------

def _keys(seed, b):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), b),
            threefry.fold_in(threefry.prng_key(seed, CPU), b))


def _q8_parts():
    jcore, tcore = _session_cores(1 << 12)
    jep = j_session_epoch(JGen(JConfig(chunk_capacity=CAP)).chunk_fn(),
                          [JE.col(1, J.INT64), JE.col(5, J.TIMESTAMP)],
                          jcore, CAP)
    tep = EPOCH_BUILDERS["source_session"](
        DeviceBidGenerator(NexmarkConfig(chunk_capacity=CAP),
                           device=CPU).chunk_fn(),
        [TE.col(1, T.INT64), TE.col(5, T.TIMESTAMP)], tcore, CAP)
    return jcore, tcore, jep, tep


def test_fused_session_epochs_equal_reference():
    jcore, tcore, jep, tep = _q8_parts()
    js, ts = jcore.init_state(), tcore.init_state()
    cfg = NexmarkConfig(chunk_capacity=CAP)
    us_per_event = max(1_000_000 // max(cfg.events_per_second, 1), 1)
    closed = 0
    for b in range(2):
        jk, tk = _keys(31, b)
        start = b * K * CAP
        wm = cfg.start_time_us + (start + K * CAP) * us_per_event - GAP
        js, jsnap, jpacked = jep(js, jnp.int64(start), jk, K, jnp.int64(wm))
        ts, tsnap, tpacked = tep(ts, start, tk, K, wm)
        np.testing.assert_array_equal(_np(jpacked), _np(tpacked))
        for a, b_ in zip(jsnap, tsnap):
            np.testing.assert_array_equal(_np(a), _np(b_))
        _assert_session_equal(js, ts)
        assert not _np(tpacked)[1:].any()
        closed += int(_np(tpacked)[0])
    assert closed > 0


def test_fused_q3_epochs_equal_reference():
    jcore, tcore = _q3_cores()
    jep = j_q3_epoch(JQ3Gen(JQ3Config(chunk_capacity=CAP)).chunk_fn(),
                     jcore, CAP)
    tep = EPOCH_BUILDERS["source_q3"](
        DeviceQ3Generator(TpchQ3Config(chunk_capacity=CAP),
                          device=CPU).chunk_fn(), tcore, CAP)
    js, ts = jcore.init_state(), tcore.init_state()
    for b in range(2):
        jk, tk = _keys(37, b)
        js, jout, jpacked = jep(js, jnp.int64(b * K * CAP), jk, K)
        ts, tout, tpacked = tep(ts, b * K * CAP, tk, K)
        np.testing.assert_array_equal(_np(jpacked), _np(tpacked))
        _assert_chunk_equal(jout, tout)
        _assert_q3_equal(js, ts)
        assert int(_np(tpacked)[0]) > 0 and not _np(tpacked)[1:].any()


# ---------------------------------------------------------------------------
# checkpoint round trips
# ---------------------------------------------------------------------------

def test_session_export_import_round_trip():
    jcore, tcore, jep, tep = _q8_parts()
    jk, tk = _keys(5, 0)
    js, _, _ = jep(jcore.init_state(), jnp.int64(0), jk, K, jnp.int64(0))
    ts, _, _ = tep(tcore.init_state(), 0, tk, K, 0)
    # the reference's payload, and the port's own, restore the same state
    _assert_session_equal(js, tcore.import_host(jcore.export_host(js)))
    restored = tcore.import_host(tcore.export_host(ts))
    _assert_session_equal(js, restored)
    # and the restored state runs on as the original does
    jk, tk = _keys(5, 1)
    a = tep(ts, K * CAP, tk, K, T0 + 10**9)
    b = tep(restored, K * CAP, tk, K, T0 + 10**9)
    np.testing.assert_array_equal(_np(a[2]), _np(b[2]))
    _assert_session_equal(a[0], b[0])


def test_q3_export_import_round_trip():
    jcore, tcore = _q3_cores()
    jfn = JQ3Gen(JQ3Config(chunk_capacity=CAP)).chunk_fn()
    tfn = DeviceQ3Generator(TpchQ3Config(chunk_capacity=CAP),
                            device=CPU).chunk_fn()
    js, ts = jcore.init_state(), tcore.init_state()
    japply = jax.jit(jcore.apply_chunk)
    for i in range(2):
        js = japply(js, jfn(jnp.int64(i * CAP)))
        ts = tcore.apply_chunk(ts, tfn(i * CAP))
    _assert_q3_equal(js, tcore.import_host(jcore.export_host(js)))
    _assert_q3_equal(js, q3_state_from_jax(_host(js), device=CPU))
    restored = tcore.import_host(tcore.export_host(ts))
    _assert_q3_equal(js, restored)
    a = tcore.flush(tcore.apply_chunk(ts, tfn(2 * CAP)))
    b = tcore.flush(tcore.apply_chunk(restored, tfn(2 * CAP)))
    _assert_chunk_equal(a[1], b[1])
    _assert_q3_equal(a[0], b[0])
