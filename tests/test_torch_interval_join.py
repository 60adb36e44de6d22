"""The bucketed interval-join core and kernel B2 (the flush match grids) in
the PyTorch port against the JAX package, on the CPU: the plain match
version equals the Pallas kernel in interpret mode and its jnp formulation;
the EPOCHS scenario of tests/test_interval_join.py gives the same (op, row)
lists in order, across an export/import cycle too; ring turnover and
clobber, the probe-delete flag, lane overflow and the band filter leave
equal state and output. The CUDA kernel itself is compared with the plain
version in tests/test_torch_gpu.py and chip_smoke.py, on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.common as J
from risingwave_tpu.ops.interval_join import (
    IntervalJoinCore as JCore, interval_match_jnp, interval_match_pallas,
)
import risingwave_tpu_torch.common as T
from risingwave_tpu_torch.interop import interval_join_state_from_jax
from risingwave_tpu_torch.ops import interval_join as ij
from risingwave_tpu_torch.ops.interval_join import (
    VECTOR_FIELDS, IntervalJoinCore, interval_match, interval_match_plain,
)

CAP = 64
WINDOW = 100
I, D = J.OP_INSERT, J.OP_DELETE


def _match_inputs(nb, w, seed, high_words=True):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 5, (nb, w)).astype(np.int64)
    old_max = rng.integers(0, 5, nb).astype(np.int64)
    new_max = rng.integers(0, 5, nb).astype(np.int64)
    if high_words:     # values that differ only in the high 32-bit word
        vals += rng.integers(0, 2, (nb, w)).astype(np.int64) << 33
        old_max += rng.integers(0, 2, nb).astype(np.int64) << 33
    return (vals, rng.random((nb, w)) < 0.7, old_max, rng.random(nb) < 0.8,
            new_max, rng.random(nb) < 0.8)


@pytest.mark.parametrize("nb,w,ref", [(512, 128, "pallas"), (512, 128, "jnp"),
                                      (300, 24, "jnp"), (37, 5, "jnp")])
def test_interval_match_plain_equals_reference(nb, w, ref):
    args = _match_inputs(nb, w, nb + w)
    jargs = [jnp.asarray(a) for a in args]
    if ref == "pallas":
        want = interval_match_pallas(*jargs, interpret=True)
    else:
        want = interval_match_jnp(*jargs)
    got = interval_match_plain(*[torch.as_tensor(a) for a in args])
    for a, b in zip(want, got):
        assert b.dtype == torch.bool
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    args = [torch.as_tensor(a) for a in _match_inputs(40, 8, 1)]
    before = interval_match.launches
    got = interval_match(*args)
    want = interval_match_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert interval_match.launches == before


@pytest.mark.parametrize("bad", ["vals_dtype", "occ_dtype", "shape",
                                 "contiguous", "rank"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = [torch.as_tensor(a) for a in _match_inputs(8, 4, 2)]
    if bad == "vals_dtype":
        args[0] = args[0].int()
    elif bad == "occ_dtype":
        args[1] = args[1].to(torch.uint8)
    elif bad == "shape":
        args[2] = args[2][:7]
    elif bad == "contiguous":
        args[0] = torch.as_tensor(_match_inputs(4, 8, 2)[0]).t()
    else:
        args[3] = args[3][:, None]
    with pytest.raises((TypeError, ValueError)):
        interval_match(*args)


# ---------------------------------------------------------------------------
# the core, driven through both packages
# ---------------------------------------------------------------------------

def _schema(pkg):
    return pkg.Schema.of(("ws", pkg.INT64), ("auction", pkg.INT64),
                         ("price", pkg.INT64))


def _cores(**kw):
    kw.setdefault("n_buckets", 256)
    kw.setdefault("lane_width", 16)
    return (JCore(_schema(J), ts_col=0, val_col=2, window_us=WINDOW, **kw),
            IntervalJoinCore(_schema(T), ts_col=0, val_col=2,
                             window_us=WINDOW, device="cpu", **kw))


class Stepper:
    """One package's core, stepped chunk by chunk and flush by flush."""

    def __init__(self, core, torch_side: bool):
        self.core, self.torch_side = core, torch_side
        self.state = core.init_state()
        self.pkg = T if torch_side else J

    def rows(self, chunk):
        return self.pkg.chunk_to_rows(chunk, self.core.out_schema,
                                      with_ops=True)

    def chunk(self, rows, ops=None):
        kw = {"device": "cpu"} if self.torch_side else {}
        ch = self.pkg.make_chunk(_schema(self.pkg), rows, ops=ops,
                                 capacity=CAP, **kw)
        self.state, out = self.core.apply_chunk(self.state, ch)
        return self.rows(out)

    def flush(self):
        old = self.state.emitted_max
        del_m, ins_m, packed = self.core.flush_plan(self.state)
        packed = [int(x) for x in np.asarray(packed)]
        out, lo = [], 0
        while lo < packed[0]:
            out += self.rows(self.core.gather_flush(
                self.state, del_m, ins_m, old, lo, out_capacity=CAP))
            lo += CAP
        self.state = self.core.finish_flush(self.state)
        return out, packed[1:]

    def checkpoint_cycle(self):
        self.state = self.core.import_host(self.core.export_host(self.state))

    def leaves(self):
        s = self.state
        out = {f: np.asarray(getattr(s, f)) if not self.torch_side
               else getattr(s, f).numpy() for f in VECTOR_FIELDS}
        for name in ("row_data", "row_mask"):
            for i, a in enumerate(getattr(s, name)):
                out[f"{name}{i}"] = np.asarray(a) if not self.torch_side \
                    else a.numpy()
        return out


def _run(script, **kw):
    """Run ``script`` (steps ("chunk", rows[, ops]), ("flush",),
    ("cycle",)) through both cores; returns each package's outputs and its
    final state leaves."""
    jcore, tcore = _cores(**kw)
    results = []
    with jax.disable_jit():    # op by op: no compile per core
        for d in (Stepper(jcore, False), Stepper(tcore, True)):
            outs = []
            for step in script:
                if step[0] == "chunk":
                    outs.append(d.chunk(*step[1:]))
                elif step[0] == "flush":
                    outs.append(d.flush())
                else:
                    d.checkpoint_cycle()
            results.append((outs, d.leaves()))
    return results


EPOCHS = [
    # epoch 1: two windows born; window 0 max=9, window 100 max=7
    [(0, 1, 5), (0, 2, 9), (100, 3, 7)],
    # epoch 2: window 0 churns at the same max + a late row equal to it
    [(0, 4, 9), (100, 4, 3)],
    # epoch 3: window 0 max RISES → retraction; window 200 born
    [(0, 5, 12), (200, 6, 4)],
    # epoch 4: quiet window 100 churns; window 200 tied rows
    [(100, 7, 2), (200, 8, 4), (200, 9, 4)],
]


def _epochs_script(cycle_after=None):
    script = []
    for ei, rows in enumerate(EPOCHS):
        script += [("chunk", rows), ("flush",)]
        if ei == cycle_after:
            script.append(("cycle",))
    return script


def _assert_same(want, got):
    (w_out, w_leaves), (g_out, g_leaves) = want, got
    assert g_out == w_out
    assert w_leaves.keys() == g_leaves.keys()
    for name in w_leaves:
        np.testing.assert_array_equal(w_leaves[name], g_leaves[name],
                                      err_msg=name)


@pytest.mark.parametrize("cycle_after", [None, 1],
                         ids=["straight", "export_import_after_epoch_2"])
def test_epochs_scenario_equals_reference(cycle_after):
    want, got = _run(_epochs_script(cycle_after))
    _assert_same(want, got)
    outs = want[0]
    # every epoch emitted, and epoch 3's max change retracted
    assert all(outs[i] or outs[i + 1][0] for i in range(0, len(outs), 2))
    assert any(op == D for op, _ in outs[5][0])


SCENARIOS = {
    # windows 0 and 4*WINDOW share ring slot 0: the slot is reclaimed
    "ring_turnover": (dict(n_buckets=4, lane_width=4), [
        ("chunk", [(0, 1, 5)]), ("flush",),
        ("chunk", [(4 * WINDOW, 2, 7)]), ("flush",)]),
    # window 0 still has an unflushed delta when window 4 steals its slot
    "ring_clobber": (dict(n_buckets=4, lane_width=4), [
        ("chunk", [(0, 1, 5)]), ("chunk", [(4 * WINDOW, 2, 7)]),
        ("flush",)]),
    # the ring wraps within one chunk: the older row is stale
    "ring_clobber_within_chunk": (dict(n_buckets=4, lane_width=4), [
        ("chunk", [(4 * WINDOW, 2, 7), (0, 1, 5)]), ("flush",)]),
    "probe_delete": ({}, [
        ("chunk", [(0, 1, 5), (0, 2, 6)], [I, D]), ("flush",)]),
    "lane_overflow": (dict(lane_width=2), [
        ("chunk", [(0, i, i) for i in range(3)]), ("flush",)]),
    # a probe-time match against the flushed max, then a tie flushes
    "probe_match": ({}, [
        ("chunk", [(0, 1, 9)]), ("flush",), ("chunk", [(0, 2, 9)]),
        ("flush",)]),
    "null_rows": ({}, [
        ("chunk", [(0, 1, 5), (None, 2, 7), (100, 3, None), (0, 4, 5)]),
        ("flush",)]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_equals_reference(name):
    kw, script = SCENARIOS[name]
    want, got = _run(script, **kw)
    _assert_same(want, got)
    flags = dict(zip(("lane_overflow", "ring_clobber", "saw_delete"),
                     want[0][-1][1]))
    expect = {"ring_clobber": "ring_clobber",
              "ring_clobber_within_chunk": "ring_clobber",
              "probe_delete": "saw_delete",
              "lane_overflow": "lane_overflow"}.get(name)
    assert flags == {f: int(f == expect) for f in flags}
    if name == "ring_turnover":
        assert got[1]["win_id"][0] == 4 and got[1]["cur_max"][0] == 7
    if name == "probe_match":
        assert want[0][2] == [(I, (0, 2, 9, 0, 9))]


def test_band_filter_equals_reference():
    """Only rows with ts in [win_start, win_start + 50) match."""
    kw = dict(n_buckets=64, lane_width=8, band_col=0, band_us=50)
    want, got = _run([("chunk", [(10, 1, 9), (60, 2, 9)]), ("flush",),
                      ("chunk", [(20, 3, 9), (70, 4, 9)]), ("flush",)], **kw)
    _assert_same(want, got)
    assert want[0][1][0] == [(I, (10, 1, 9, 0, 9))]
    assert want[0][2] == [(I, (20, 3, 9, 0, 9))]


def test_state_carried_from_jax_continues_equal():
    jcore, tcore = _cores()
    jd, td = Stepper(jcore, False), Stepper(tcore, True)
    with jax.disable_jit():
        for rows in EPOCHS[:2]:
            jd.chunk(rows)
            jd.flush()
        td.state = interval_join_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jd.state), device="cpu")
        for rows in EPOCHS[2:]:
            assert td.chunk(rows) == jd.chunk(rows)
            assert td.flush() == jd.flush()


def test_dropped_rows_land_in_spare_cells():
    """Rows that are not stored write past the arena, each in a cell of
    its own, and leave the arena as it was."""
    _, core = _cores(n_buckets=4, lane_width=2)
    state = core.init_state()
    rows = [(0, i, i) for i in range(5)]          # 3 rows overflow lane 2
    ch = T.make_chunk(_schema(T), rows, capacity=8, device="cpu")
    state, _ = core.apply_chunk(state, ch)
    assert ij._spare_cells(state) == 8
    store = state.row_store[1]
    assert store[:8].tolist() == [0, 1, 0, 0, 0, 0, 0, 0]
    assert store[8 + 2:8 + 5].tolist() == [2, 3, 4]
    assert state.row_data[1].data_ptr() == store.data_ptr()
