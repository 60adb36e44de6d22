"""Batched (ChunkBatch) ingest through both packages, on the CPU: the q5
core over [K, C] batches of device-generated bids (equal to the reference's
batched run and to the port's chunk-by-chunk run, state slot for slot), the
three join cases of tests/test_batched_ingest.py, and the checkpoint marks
of the fused q5 epoch. Tolerance: exact."""

import jax
import jax.numpy as jnp
import pytest

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
from risingwave_tpu.connector import NexmarkConfig as JConfig
from risingwave_tpu.connector.nexmark import DeviceBidGenerator as JBidGen
from risingwave_tpu.ops.fused_epoch import (
    fused_source_agg_epoch as j_agg_epoch,
)
from risingwave_tpu.ops.grouped_agg import AggCore as JAggCore
from risingwave_tpu_torch.connector import DeviceBidGenerator, NexmarkConfig
from risingwave_tpu_torch.interop import prng_key_from_jax
from risingwave_tpu_torch.ops.fused_epoch import fused_source_agg_epoch
from risingwave_tpu_torch.ops.grouped_agg import AggCore
from test_torch_recovery import (
    D, JAX, TORCH, assert_agg_states_equal, assert_equal,
    assert_join_sides_equal, join_executor,
)

# ---------------------------------------------------------------------------
# batched (ChunkBatch) ingest
# ---------------------------------------------------------------------------

def _q5_batches(pkg, gen, batched: bool, k=4, epochs=2):
    c, e, s = pkg.common, pkg.expr, pkg.stream
    msgs = [s.Barrier.new(1)]
    for ep in range(epochs):
        batch = gen.next_batch(k)
        msgs += [batch] if batched else [batch.at(i) for i in range(k)]
        msgs.append(s.Barrier.new(ep + 2))
    from risingwave_tpu.connector.nexmark import BID_SCHEMA as JB
    from risingwave_tpu_torch.connector import BID_SCHEMA as TB
    proj = s.ProjectExecutor(
        s.MockSource(JB if pkg is JAX else TB, msgs),
        [e.call("tumble_start", e.col(5, c.TIMESTAMP),
                e.Literal(2_000, c.INT64)), e.col(0, c.INT64)],
        names=("window_start", "auction"))
    with pkg.eager():
        agg = s.HashAggExecutor(proj, [0, 1], [e.count_star()],
                                table_capacity=1024, out_capacity=64,
                                **pkg.kw())
    return pkg.drain(agg), agg


def test_q5_chunk_batch_matches_reference_and_per_chunk():
    """Bids from the device generators as [K, C] ChunkBatches through
    Project → HashAgg(count(*)): state slot for slot and flush rows equal
    to the reference's batched run and to the port's chunk-by-chunk run."""
    cfg = dict(chunk_capacity=64)
    want, jagg = _q5_batches(JAX, JBidGen(JConfig(**cfg), seed=4), True)
    got, tagg = _q5_batches(TORCH, DeviceBidGenerator(
        NexmarkConfig(**cfg), seed=4, device="cpu"), True)
    one, tone = _q5_batches(TORCH, DeviceBidGenerator(
        NexmarkConfig(**cfg), seed=4, device="cpu"), False)
    assert got == want == one and len(got) > 10
    assert_agg_states_equal(jagg.state, tagg.state)
    assert_agg_states_equal(jagg.state, tone.state)


BL = [([(1, 100), (2, 200), (1, 101)], None), ([(3, 300)], None),
      ([(1, 100)], [D]), ([(4, 400), (2, 201)], None), ([(5, 500)], None)]


def _batched_join_specs(batched, left_chunks=BL):
    right = [("b", 1, False),
             ("c", [(1, 10), (2, 20), (3, 30), (4, 40), (5, 50)], None),
             ("b", 2, False), ("b", 3, False)]
    body = ([("k", left_chunks)] if batched
            else [("c", r, o) for r, o in left_chunks])
    left = [("b", 1, False), ("b", 2, False), *body, ("b", 3, False)]
    return left, right


@pytest.mark.parametrize("case", ["matches_per_chunk", "overflow_rewinds",
                                  "build_side"])
def test_join_batch_matches_reference(case):
    """tests/test_batched_ingest.py's three join cases, each through both
    packages and against the port's per-chunk run."""
    kw, sub = {}, 2
    if case == "overflow_rewinds":
        kw, sub = dict(key_capacity=4, bucket_width=2), 4
    if case == "build_side":
        rights = [([(1, 10)], None), ([(1, 11), (2, 20)], None),
                  ([(1, 10)], [D])]
        left = [("b", 1, False), ("c", [(1, 100), (2, 200)], None),
                ("b", 2, False), ("b", 3, False)]
        specs = {b: (left, [("b", 1, False), ("b", 2, False),
                            *([("k", rights)] if b else
                              [("c", r, o) for r, o in rights]),
                            ("b", 3, False)]) for b in (True, False)}
    else:
        specs = {b: _batched_join_specs(b) for b in (True, False)}
    jex = join_executor(JAX, *specs[True], **kw)
    jex.batch_chunks = sub
    want = JAX.drain(jex)
    tex = join_executor(TORCH, *specs[True], **kw)
    tex.emit_batch = sub
    got = TORCH.drain(tex)
    base = TORCH.drain(join_executor(TORCH, *specs[False], **kw))
    assert got == want == base and any(op == D for op, _ in got)
    assert_join_sides_equal(jex.state, tex.state)
    if case == "overflow_rewinds":
        assert tex.core.capacity > 4


def test_fused_q5_epoch_ckpt_marks_equal_reference():
    """The fused q5 epoch marks ckpt_dirty as the reference's does."""
    cap, k = 64, 8

    def core(cls, c, e, **kw):
        return cls((c.TIMESTAMP, c.INT64), (0, 1), [e.count_star()],
                   table_capacity=1 << 12, out_capacity=cap, **kw)

    jcore = core(JAggCore, J, JE)
    tcore = core(AggCore, T, TE, device="cpu")
    exprs = [[e.call("tumble_start", e.col(5, c.TIMESTAMP),
                     e.Literal(1_000_000, c.INT64)), e.col(0, c.INT64)]
             for c, e in ((J, JE), (T, TE))]
    jep = j_agg_epoch(JBidGen(JConfig(chunk_capacity=cap)).chunk_fn(),
                      exprs[0], jcore, cap)
    tep = fused_source_agg_epoch(
        DeviceBidGenerator(NexmarkConfig(chunk_capacity=cap),
                           device="cpu").chunk_fn(), exprs[1], tcore, cap)
    js, ts = jcore.init_state(), tcore.init_state()
    for b in range(2):
        jk = jax.random.fold_in(jax.random.PRNGKey(9), b)
        tk = prng_key_from_jax(jax.random.key_data(jk), device="cpu")
        js = jep(js, jnp.int64(b * k * cap), jk, k)
        ts = tep(ts, b * k * cap, tk, k)
    assert_agg_states_equal(js, ts)
    assert_equal([(js.last_used, ts.last_used)])
    assert int(ts.ckpt_dirty.sum()) > 10
