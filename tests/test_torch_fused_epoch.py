"""Fused epochs (ops/fused_epoch.py) in the PyTorch port against the JAX
package, on the CPU, from the same start event and key: the q7 join epoch
(on-device bids → Project → bucketed interval join → barrier flush) gives
equal state leaves, probe output, flush masks, old emitted max and packed
stats, and equal drained chunks, epoch after epoch; the q5 agg epoch gives
the same group table slot for slot; a run carried across from the JAX
package after epoch 2 (state and key) continues equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
from risingwave_tpu.common.chunk import (
    flatten_shards as j_flatten, gather_units_window as j_gather_units,
)
from risingwave_tpu.connector import NexmarkConfig as JConfig
from risingwave_tpu.connector.nexmark import DeviceBidGenerator as JGen
from risingwave_tpu.ops.fused_epoch import (
    fused_source_agg_epoch as j_agg_epoch,
    fused_source_join_epoch as j_join_epoch,
)
from risingwave_tpu.ops.grouped_agg import AggCore as JAggCore
from risingwave_tpu.ops.interval_join import IntervalJoinCore as JCore
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
from risingwave_tpu_torch.connector import (
    DeviceBidGenerator, NexmarkConfig, threefry,
)
from risingwave_tpu_torch.interop import (
    interval_join_state_from_jax, prng_key_from_jax,
)
from risingwave_tpu_torch.ops.fused_epoch import (
    EPOCH_BUILDERS, fused_source_agg_epoch, fused_source_join_epoch,
    fused_source_q3_epoch, fused_source_session_epoch,
)
from risingwave_tpu_torch.ops.grouped_agg import AggCore
from risingwave_tpu_torch.ops.interval_join import (
    VECTOR_FIELDS, IntervalJoinCore,
)

CAP = 64
K = 8
Q7_WINDOW = 5_000
SEED = 5


def _q7_exprs(c, e):
    return [e.call("tumble_start", e.col(5, c.TIMESTAMP),
                   e.Literal(Q7_WINDOW, c.INT64)),
            e.col(0, c.INT64), e.col(2, c.INT64)]


def _probe_schema(c):
    return c.Schema((c.Field("window_start", c.TIMESTAMP),
                     c.Field("auction", c.INT64), c.Field("price", c.INT64)))


def _tied(fn, ops):
    """A source with prices in 1..4, so windows tie, maxima churn and late
    rows match at probe time."""
    def tied(start, key):
        ch = fn(start, key)
        cols = list(ch.columns)
        price = cols[2]
        cols[2] = type(price)(ops.remainder(price.data, 4) + 1, price.mask)
        return ch.with_columns(cols)
    return tied


class Q7:
    """One package's fused q7 epoch and its drains."""

    def __init__(self, torch_side: bool, prices: str):
        self.torch_side = torch_side
        if torch_side:
            c, e = T, TE
            self.core = IntervalJoinCore(_probe_schema(c), 0, 2, Q7_WINDOW,
                                         n_buckets=512, lane_width=64,
                                         device="cpu")
            fn = DeviceBidGenerator(NexmarkConfig(chunk_capacity=CAP),
                                    device="cpu").chunk_fn()
            ops = torch
        else:
            c, e = J, JE
            self.core = JCore(_probe_schema(c), 0, 2, Q7_WINDOW,
                              n_buckets=512, lane_width=64)
            fn = JGen(JConfig(chunk_capacity=CAP)).chunk_fn()
            ops = jnp
        if prices == "tied":
            fn = _tied(fn, ops)
        build = fused_source_join_epoch if torch_side else j_join_epoch
        self.epoch = build(fn, _q7_exprs(c, e), self.core, CAP)
        self.state = self.core.init_state()
        self.start = 0

    def run(self, key):
        """One epoch; returns every output as numpy, drains included."""
        core, c = self.core, (T if self.torch_side else J)
        start = self.start if self.torch_side else jnp.int64(self.start)
        (self.state, probe_out, del_m, ins_m, old,
         packed) = self.epoch(self.state, start, key, K)
        self.start += K * CAP
        out = {"packed": packed, "del": del_m, "ins": ins_m, "old": old,
               "probe_vis": probe_out.vis, "probe_ops": probe_out.ops}
        for j, col in enumerate(probe_out.columns):
            out[f"probe{j}"] = col.data
            out[f"probe_mask{j}"] = col.mask
        n_flush, _, _, _, n_probe = (int(x) for x in np.asarray(packed))
        flat = (T.flatten_shards if self.torch_side else j_flatten)(probe_out)
        gather = T.gather_units_window if self.torch_side else \
            j_gather_units
        drains = []
        for lo in range(0, n_probe, CAP // 2):
            drains.append(c.chunk_to_rows(gather(flat, lo, CAP),
                                          core.out_schema, with_ops=True))
        for lo in range(0, n_flush, CAP):
            drains.append(c.chunk_to_rows(core.gather_flush(
                self.state, del_m, ins_m, old, lo, out_capacity=CAP),
                core.out_schema, with_ops=True))
        out = {k: np.asarray(v) if not self.torch_side else v.numpy()
               for k, v in out.items()}
        out.update(self.leaves())
        return out, drains

    def leaves(self):
        s, conv = self.state, (
            (lambda a: a.numpy()) if self.torch_side else np.asarray)
        out = {f: conv(getattr(s, f)) for f in VECTOR_FIELDS}
        for i, (d, m) in enumerate(zip(s.row_data, s.row_mask)):
            out[f"row_data{i}"], out[f"row_mask{i}"] = conv(d), conv(m)
        return out


def _keys(b):
    return (jax.random.fold_in(jax.random.PRNGKey(SEED), b),
            threefry.fold_in(threefry.prng_key(SEED, "cpu"), b))


def _assert_epoch_equal(want, got):
    (w, w_drains), (g, g_drains) = want, got
    assert w.keys() == g.keys()
    for name in w:
        np.testing.assert_array_equal(w[name], g[name], err_msg=name)
    assert g_drains == w_drains


@pytest.mark.parametrize("prices", ["bids", "tied"])
def test_fused_join_epochs_equal_reference(prices):
    ref, port = Q7(False, prices), Q7(True, prices)
    units = [0, 0]
    for b in range(3):
        jk, tk = _keys(b)
        want = ref.run(jk)
        _assert_epoch_equal(want, port.run(tk))
        units = [u + int(x) for u, x in zip(units, want[0]["packed"][[0, 4]])]
        assert not want[0]["packed"][1:4].any()
    assert units[0] > 0                       # flush units every run
    if prices == "tied":
        assert units[1] > 0                   # and probe-time matches


def test_fused_join_state_and_key_carried_from_jax():
    ref, port = Q7(False, "tied"), Q7(True, "tied")
    base = jax.random.PRNGKey(SEED)
    for b in range(2):
        ref.run(jax.random.fold_in(base, b))
    port.state = interval_join_state_from_jax(
        jax.tree_util.tree_map(np.asarray, ref.state), device="cpu")
    port.start = ref.start
    key = prng_key_from_jax(np.asarray(jax.random.key_data(base)),
                            device="cpu")
    for b in range(2, 4):
        _assert_epoch_equal(ref.run(jax.random.fold_in(base, b)),
                            port.run(threefry.fold_in(key, b)))


def test_fused_agg_epoch_equals_reference_slot_for_slot():
    def core(c, e, cls, **kw):
        return cls((c.TIMESTAMP, c.INT64), (0, 1),
                   [e.count_star(), e.agg("max", 2, c.INT64)],
                   table_capacity=1 << 12, out_capacity=CAP, **kw)

    jcore, tcore = core(J, JE, JAggCore), core(T, TE, AggCore, device="cpu")
    exprs = [[e.call("tumble_start", e.col(5, c.TIMESTAMP),
                     e.Literal(1_000_000, c.INT64)),
              e.col(0, c.INT64), e.col(2, c.INT64)]
             for c, e in ((J, JE), (T, TE))]
    jep = j_agg_epoch(JGen(JConfig(chunk_capacity=CAP)).chunk_fn(), exprs[0],
                      jcore, CAP)
    tep = EPOCH_BUILDERS["source_agg"](
        DeviceBidGenerator(NexmarkConfig(chunk_capacity=CAP),
                           device="cpu").chunk_fn(), exprs[1], tcore, CAP)
    assert EPOCH_BUILDERS == {
        "source_agg": fused_source_agg_epoch,
        "source_join": fused_source_join_epoch,
        "source_session": fused_source_session_epoch,
        "source_q3": fused_source_q3_epoch}
    js, ts = jcore.init_state(), tcore.init_state()
    for b in range(2):
        jk, tk = _keys(b)
        js = jep(js, jnp.int64(b * K * CAP), jk, K)
        ts = tep(ts, b * K * CAP, tk, K)
    pairs = [(js.table.occupied, ts.table.occupied), (js.dirty, ts.dirty),
             (js.overflow, ts.overflow)]
    pairs += list(zip(js.table.key_data + js.table.key_mask,
                      ts.table.key_data + ts.table.key_mask))
    pairs += list(zip(js.lanes + js.prev_lanes, ts.lanes + ts.prev_lanes))
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(np.asarray(js.table.occupied).sum()) > 10
    assert int(np.asarray(js.lanes[0]).sum()) == 2 * K * CAP
