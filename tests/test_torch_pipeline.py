"""Executor pipelines through both packages, on the CPU: the q5 core
(Project → HashAgg), the q7 core (Project → HashAgg(max) → HashJoin(price =
max)) including max changes that retract and a run that grows its join
state, the HashJoin scenarios of tests/test_hash_join.py for every join type,
and carrying the reference's state after epoch k into the port. The same
scripted inputs go to both packages; outputs must be equal exactly, in
order."""

import asyncio
import dataclasses
import functools

import jax
import numpy as np
import pytest

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
import risingwave_tpu.ops as JO
import risingwave_tpu.stream as JS
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
import risingwave_tpu_torch.ops as TO
import risingwave_tpu_torch.stream as TS
from risingwave_tpu.connector.nexmark import (
    NexmarkConfig as JConfig, NexmarkGenerator as JGen,
)
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.interop import (
    agg_state_from_jax, join_state_from_jax,
)

CAP = 64


@dataclasses.dataclass
class Pkg:
    """One package's entry points, so a driver runs either."""

    common: object
    expr: object
    stream: object
    ops: object
    device: object = None     # None: the JAX package (no device argument)

    def kw(self, **kw):
        if self.device is not None:
            kw["device"] = self.device
        return kw

    def schema(self, *cols):
        return self.common.Schema.of(*((n, self.common.INT64) for n in cols))

    def chunk(self, schema, rows, ops=None, capacity=CAP):
        return self.common.make_chunk(schema, rows, ops=ops,
                                      capacity=capacity, **self.kw())

    def rows(self, msg, schema):
        return self.common.chunk_to_rows(msg, schema, with_ops=True)


JAX = Pkg(J, JE, JS, JO)
TORCH = Pkg(T, TE, TS, TO, device="cpu")


# ---------------------------------------------------------------------------
# the q7 core, pinned to the probe-then-flush schedule of
# tests/test_interval_join.py::run_executor_q7
# ---------------------------------------------------------------------------

class ProbeSource:
    """Releases one gate per epoch, just before yielding its barrier."""

    def __init__(self, schema, messages, gates, barrier_cls):
        self.schema, self._messages, self._gates = schema, messages, gates
        self._barrier_cls = barrier_cls

    async def execute(self):
        epoch_i = 0
        for m in self._messages:
            if isinstance(m, self._barrier_cls):
                self._gates[epoch_i].set()
                epoch_i += 1
            yield m
            await asyncio.sleep(0)


class GatedSource:
    """Holds each epoch's messages until the probe side's gate opens."""

    def __init__(self, schema, messages, gates, barrier_cls):
        self.schema, self._messages, self._gates = schema, messages, gates
        self._barrier_cls = barrier_cls

    async def execute(self):
        epoch_i, waited = 0, False
        for m in self._messages:
            if not waited:
                await self._gates[epoch_i].wait()
                waited = True
            yield m
            await asyncio.sleep(0)
            if isinstance(m, self._barrier_cls):
                epoch_i += 1
                waited = False


EPOCHS = [
    # two windows born; window 0 max=9, window 100 max=7
    [(0, 1, 5), (0, 2, 9), (100, 3, 7)],
    # window 0 max unchanged (churn) + a late row equal to the emitted max
    [(0, 4, 9), (100, 4, 3)],
    # window 0 max RISES → every price-9 match retracts; window 200 born
    [(0, 5, 12), (200, 6, 4)],
    # quiet window 100 churns; window 200 gets tied rows
    [(100, 7, 2), (200, 8, 4), (200, 9, 4)],
    # window 200 max rises over three tied rows; window 300 born twice
    [(200, 10, 5), (300, 11, 1), (300, 12, 1), (0, 13, 12)],
]


class Q7:
    """The q7 executor pipeline of one package, driven in phases."""

    def __init__(self, pkg: Pkg, key_capacity=1 << 10, bucket_width=16):
        self.pkg = pkg
        self.probe_schema = pkg.schema("ws", "auction", "price")
        self.pre_schema = pkg.schema("ws", "price")
        self.agg = pkg.stream.HashAggExecutor(
            GatedSource(self.pre_schema, [], [], None), [0],
            [pkg.expr.agg("max", 1, pkg.common.INT64)],
            table_capacity=1 << 10, out_capacity=CAP, **pkg.kw())
        cond = pkg.expr.call("equal", pkg.expr.col(2, pkg.common.INT64),
                             pkg.expr.col(4, pkg.common.INT64))
        self.join = pkg.stream.HashJoinExecutor(
            ProbeSource(self.probe_schema, [], [], None), self.agg, [0], [0],
            condition=cond, key_capacity=key_capacity,
            bucket_width=bucket_width, out_capacity=CAP, **pkg.kw())

    def run(self, epochs_rows, first_epoch=1, leading_barrier=True):
        """Run scripted epochs; returns per-epoch [(op, row), ...]."""
        pkg, barrier = self.pkg, self.pkg.stream.Barrier
        gates = [asyncio.Event() for _ in range(len(epochs_rows) + 2)]
        probe_msgs = [barrier.new(first_epoch)] if leading_barrier else []
        build_msgs = list(probe_msgs)
        e = first_epoch
        for rows in epochs_rows:
            probe_msgs.append(pkg.chunk(self.probe_schema, rows))
            build_msgs.append(pkg.chunk(self.pre_schema,
                                        [(ws, p) for ws, _, p in rows]))
            e += 1
            probe_msgs.append(barrier.new(e))
            build_msgs.append(barrier.new(e))

        async def drive():
            # asyncio.Event binds to the running loop: build sources here
            self.join.left = ProbeSource(self.probe_schema, probe_msgs,
                                         gates, barrier)
            self.agg.input = GatedSource(self.pre_schema, build_msgs, gates,
                                         barrier)
            per_epoch, cur = [], []
            async for m in self.join.execute():
                if isinstance(m, barrier):
                    per_epoch.append(cur)
                    cur = []
                elif not isinstance(m, pkg.stream.Watermark):
                    cur.extend(pkg.rows(m, self.join.schema))
            return per_epoch[1:] if leading_barrier else per_epoch

        return asyncio.run(drive())


def run_q7(pkg, epochs_rows, device=None, **kw):
    if device is not None:
        pkg = dataclasses.replace(pkg, device=device)
    return Q7(pkg, **kw).run(epochs_rows)


@functools.lru_cache(maxsize=None)
def _q7_reference_run():
    """The reference's q7 run over EPOCHS, once per process: its output
    and its final join state as numpy arrays."""
    ref = Q7(JAX)
    out = ref.run(EPOCHS)
    return out, jax.tree_util.tree_map(np.asarray, ref.join.state), ref


def _q7_reference():
    return _q7_reference_run()[0]


def test_q7_executor_pipeline_parity():
    want = _q7_reference()
    assert run_q7(TORCH, EPOCHS) == want
    # max changes retracted earlier matches
    assert any(op == J.OP_DELETE for op, _ in want[2])
    assert any(op == J.OP_DELETE for op, _ in want[4])


def test_q7_parity_when_join_state_grows():
    """Bucket width 1 and two key slots overflow on both axes: the port
    rewinds and grows (W 1→…, capacity 2→…) and must still give the
    reference's output, epoch by epoch and in order."""
    q7 = Q7(TORCH, key_capacity=2, bucket_width=1)
    assert q7.run(EPOCHS) == _q7_reference()
    assert q7.join.core.W > 1 and q7.join.core.capacity > 2


def test_import_state_matches_reference_slot_for_slot():
    """Growth re-layout (ops/join_state.py::import_state) on the same state:
    wider buckets and a rehash into a bigger key table."""
    _, old, ref = _q7_reference_run()
    core_j = JO.JoinCore(ref.probe_schema, ref.agg.schema, [0], [0],
                         JO.JoinType.INNER, key_capacity=2048,
                         bucket_width=32)
    want = JO.join_state.import_state(core_j, old)
    port = Q7(TORCH)
    core_t = TO.JoinCore(port.probe_schema, port.agg.schema, [0], [0],
                         TO.JoinType.INNER, key_capacity=2048,
                         bucket_width=32, device="cpu")
    got = TO.import_state(core_t, join_state_from_jax(old, device="cpu"))
    for side in ("left", "right"):
        w, g = getattr(want, side), getattr(got, side)
        pairs = list(zip(w.ht.key_data + w.ht.key_mask + w.row_data
                         + w.row_mask, g.ht.key_data + g.ht.key_mask
                         + g.row_data + g.row_mask))
        pairs += [(w.ht.occupied, g.ht.occupied), (w.occupied, g.occupied),
                  (w.tomb, g.tomb), (w.degree, g.degree)]
        for a, b in pairs:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_carry_state_across_from_jax_after_epoch_k():
    k = 2
    ref = Q7(JAX)
    first = ref.run(EPOCHS[:k])
    host = jax.tree_util.tree_map(np.asarray, (ref.agg.state, ref.join.state))
    port = Q7(TORCH)
    port.agg.state = agg_state_from_jax(host[0], device="cpu")
    # the join state goes across as plain nested mappings
    port.join.state = join_state_from_jax(dataclasses.asdict(host[1]),
                                          device="cpu")
    rest = EPOCHS[k:]
    want = ref.run(rest, first_epoch=k + 1, leading_barrier=False)
    got = port.run(rest, first_epoch=k + 1, leading_barrier=False)
    assert got == want
    assert first + want == _q7_reference()


# ---------------------------------------------------------------------------
# the q5 core from NEXmark bids
# ---------------------------------------------------------------------------

def _q5(pkg, calls, gen):
    c, e = pkg.common, pkg.expr
    from risingwave_tpu.connector.nexmark import BID_SCHEMA as JB
    from risingwave_tpu_torch.connector import BID_SCHEMA as TB
    bid_schema = JB if pkg is JAX else TB
    msgs = [pkg.stream.Barrier.new(1)]
    for epoch in range(3):
        msgs += [gen.next_bid_chunk() for _ in range(2)]
        msgs.append(pkg.stream.Barrier.new(epoch + 2))
    proj = pkg.stream.ProjectExecutor(
        pkg.stream.MockSource(bid_schema, msgs),
        [e.call("tumble_start", e.col(5, c.TIMESTAMP),
                e.Literal(20_000, c.INT64)),
         e.col(0, c.INT64), e.col(2, c.INT64)],
        names=("window_start", "auction", "price"))
    aggs = [e.count_star()] + [
        e.agg(kind, 2, c.INT64) for kind in calls]
    agg = pkg.stream.HashAggExecutor(proj, [0, 1], aggs, table_capacity=1024,
                                     out_capacity=32, **pkg.kw())

    async def drive():
        barriers, cur = [], []
        async for m in agg.execute():
            if isinstance(m, pkg.stream.Barrier):
                barriers.append(cur)
                cur = []
            else:
                cur.append(pkg.rows(m, agg.schema))
        return barriers

    return asyncio.run(drive()), agg


@pytest.mark.parametrize("calls", [(), ("count", "sum", "min", "max", "avg")],
                         ids=["q5_count_star", "all_lanes"])
def test_q5_flush_chunks_and_lanes(calls):
    want, jagg = _q5(JAX, calls, JGen(JConfig(chunk_capacity=128), seed=3))
    got, tagg = _q5(TORCH, calls, NexmarkGenerator(
        NexmarkConfig(chunk_capacity=128), seed=3, device="cpu"))
    # every barrier's flush chunks, in order (avg is float64; its lanes sum
    # integer prices, so they are exact in any order)
    assert got == want
    assert sum(len(ch) for ch in want[1]) > 0 and len(want[1]) > 1
    js, ts = jagg.state, tagg.state
    for a, b in zip(js.lanes + js.prev_lanes, ts.lanes + ts.prev_lanes):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(js.table.key_data + js.table.key_mask,
                    ts.table.key_data + ts.table.key_mask):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# HashJoin scenarios (tests/test_hash_join.py) through both packages
# ---------------------------------------------------------------------------

I, D, UD, UI = J.OP_INSERT, J.OP_DELETE, J.OP_UPDATE_DELETE, \
    J.OP_UPDATE_INSERT


def L(*rows, ops=None):
    return ("L", list(rows), ops)


def R(*rows, ops=None):
    return ("R", list(rows), ops)


SCENARIOS = {
    "inner_insert_then_match": ("INNER", False, [
        [L((1, 100), (2, 200))], [R((1, 10), (3, 30))]]),
    "inner_multi_match_and_delete": ("INNER", False, [
        [L((1, 100), (1, 101))], [R((1, 10))], [R((1, 10), ops=[D])]]),
    "left_outer_null_pad_then_retract": ("LEFT_OUTER", False, [
        [L((1, 100))], [R((1, 10))], [R((1, 10), ops=[D])]]),
    "left_outer_duplicate_key_degree_transitions": ("LEFT_OUTER", False, [
        [L((1, 100))], [R((1, 10), (1, 11))]]),
    "right_outer_mirrors_left": ("RIGHT_OUTER", False, [
        [R((7, 70))], [L((7, 700))]]),
    "full_outer_both_sides_pad": ("FULL_OUTER", False, [
        [L((1, 100)), R((2, 20))], [R((1, 10))]]),
    "left_semi": ("LEFT_SEMI", False, [
        [L((1, 100), (2, 200))], [R((1, 10))], [R((1, 11))],
        [R((1, 10), ops=[D])], [R((1, 11), ops=[D])]]),
    "left_semi_insert_on_matched_side": ("LEFT_SEMI", False, [
        [R((1, 10))], [L((1, 100))], [L((1, 100), ops=[D])]]),
    "left_anti": ("LEFT_ANTI", False, [
        [L((1, 100), (2, 200))], [R((1, 10))], [R((1, 10), ops=[D])]]),
    "right_semi_and_anti_churn": ("RIGHT_SEMI", False, [
        [R((1, 10), (2, 20), (1, 11))], [L((1, 100), (1, 101))],
        [L((1, 100), ops=[D])], [L((1, 101), (2, 5), ops=[D, I])]]),
    "right_anti_churn": ("RIGHT_ANTI", False, [
        [R((1, 10), (2, 20), (1, 11))], [L((1, 100), (1, 101))],
        [L((1, 100), ops=[D])], [L((1, 101), (2, 5), ops=[D, I])]]),
    "update_pair_flows_through": ("INNER", False, [
        [L((1, 100)), R((1, 10))], [L((1, 100), (1, 150), ops=[UD, UI])]]),
    "non_equi_condition": ("INNER", True, [
        [L((1, 5), (1, 50))], [R((1, 10))]]),
    "condition_affects_outer_degrees": ("LEFT_OUTER", True, [
        [L((1, 50))], [R((1, 10))], [R((1, 99))]]),
    "null_keys_never_match_inner": ("INNER", False, [
        [L((None, 100)), R((None, 10))]]),
    "null_keys_left_outer_pads": ("LEFT_OUTER", False, [
        [L((None, 100)), R((None, 10))]]),
    "full_outer_same_chunk_duplicates_and_deletes": ("FULL_OUTER", True, [
        [L((1, 5), (1, 5), (2, 7)), R((1, 9), (1, 3))],
        [R((1, 9), (1, 20), ops=[D, I]), L((1, 5), (3, 1), ops=[D, I])],
        [L((1, 5), (2, 7), ops=[D, D])]]),
}


def run_join(pkg, join_type, with_condition, epochs, checkpoint=False):
    """Drive one join over scripted epochs; returns (rows, executor)."""
    ls, rs = pkg.schema("k", "a"), pkg.schema("k", "b")
    left, right = [], []
    barrier = pkg.stream.Barrier
    left.append(barrier.new(1))
    right.append(barrier.new(1))
    for e, chunks in enumerate(epochs):
        for side, rows, ops in chunks:
            (left if side == "L" else right).append(
                pkg.chunk(ls if side == "L" else rs, rows, ops=ops))
        left.append(barrier.new(e + 2, checkpoint=checkpoint))
        right.append(barrier.new(e + 2, checkpoint=checkpoint))
    cond = None
    if with_condition:   # ON l.k = r.k AND l.a < r.b
        cond = pkg.expr.call("less_than", pkg.expr.col(1, pkg.common.INT64),
                             pkg.expr.col(3, pkg.common.INT64))
    ex = pkg.stream.HashJoinExecutor(
        pkg.stream.MockSource(ls, left), pkg.stream.MockSource(rs, right),
        [0], [0], getattr(pkg.ops.JoinType, join_type), condition=cond,
        key_capacity=64, bucket_width=4, out_capacity=32, **pkg.kw())

    async def drain():
        out = []
        async for m in ex.execute():
            if not isinstance(m, (pkg.stream.Barrier, pkg.stream.Watermark)):
                out.extend(pkg.rows(m, ex.schema))
        return out

    return asyncio.run(drain()), ex


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_hash_join_scenario_parity(name):
    join_type, with_condition, epochs = SCENARIOS[name]
    # the reference runs op by op: its jitted steps would compile anew for
    # every executor, which costs seconds per scenario on the CPU
    with jax.disable_jit():
        want, _ = run_join(JAX, join_type, with_condition, epochs)
    got, _ = run_join(TORCH, join_type, with_condition, epochs)
    assert got == want


def test_checkpoint_barriers_retire_tombstones_alike():
    """Checkpoint barriers free deleted lanes for reuse; the arenas must
    come out equal lane for lane, and the output equal."""
    epochs = [[L((1, 1), (1, 2), (1, 3), (1, 4)), R((1, 9))],
              [L((1, 1), (1, 2), ops=[D, D])],
              [L((1, 5), (1, 6)), R((1, 8))]]
    with jax.disable_jit():
        want, jex = run_join(JAX, "INNER", False, epochs, checkpoint=True)
    got, tex = run_join(TORCH, "INNER", False, epochs, checkpoint=True)
    assert got == want
    for side in ("left", "right"):
        js, ts = getattr(jex.state, side), getattr(tex.state, side)
        for a, b in [(js.occupied, ts.occupied), (js.tomb, ts.tomb),
                     (js.degree, ts.degree)] + list(zip(js.row_data,
                                                        ts.row_data)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tex.core.W == 4      # the freed lanes were reused, no growth


def _filtered(pkg):
    """Project(tumble_start(ts, 10), k) → Filter(k > 0) over update pairs,
    with a watermark on ts; returns every message as comparable data."""
    c, e, st = pkg.common, pkg.expr, pkg.stream
    schema = pkg.schema("k", "ts")
    rows = [(1, 5), (-1, 7), (2, 12), (-2, 13), (3, -4), (4, 31)]
    ops = [UD, UI, UD, UI, I, D]
    src = st.MockSource(schema, [st.Barrier.new(1),
                                 pkg.chunk(schema, rows, ops=ops),
                                 st.Watermark(1, 25), st.Barrier.new(2)])
    proj = st.ProjectExecutor(src, [
        e.call("tumble_start", e.col(1, c.INT64), e.Literal(10, c.INT64)),
        e.col(0, c.INT64)], names=("w", "k"))
    filt = st.FilterExecutor(proj, e.call("greater_than", e.col(1, c.INT64),
                                          e.Literal(0, c.INT64)))

    async def drive():
        out = []
        async for m in filt.execute():
            if isinstance(m, st.Watermark):
                out.append(("wm", m.col_idx, m.value))
            elif isinstance(m, st.Barrier):
                out.append(("barrier", m.epoch.curr))
            else:
                out.append(pkg.rows(m, filt.schema))
        return out

    return asyncio.run(drive())


def test_filter_degrades_broken_update_pairs_and_watermarks_pass():
    got = _filtered(TORCH)
    assert got == _filtered(JAX)
    assert ("wm", 0, 20) in got


def test_unported_arguments_raise():
    """Both kinds the port once rejected now construct:
    approx_count_distinct as 16 HLL register lanes (INT64 output), and
    array_agg on the host tier (a LIST of its argument's type)."""
    hll = TE.agg("approx_count_distinct", 0, T.INT64)
    arr = TE.agg("array_agg", 0, T.VARCHAR)
    assert hll.output_type == T.INT64
    assert arr.output_type == T.list_of(T.VARCHAR)
    assert hll.num_lanes == 16 and not hll.lanes_unsupported
    assert hll.reduce_ops() == ["max"] * 16
    assert arr.lanes_unsupported
    from risingwave_tpu_torch.stream.materialized_agg import (
        call_needs_materialized,
    )
    assert call_needs_materialized(arr, True)
    assert not call_needs_materialized(hll, False)
