"""Checkpoint, recovery, cold-tier eviction and sharded reload of the
slice-1 executors, through both packages on the CPU. The helpers here also
drive tests/test_torch_cleaning.py and tests/test_torch_batched.py.

The same scripted messages go to the reference's executors (run op by op
under ``jax.disable_jit``) and the port's (``device="cpu"``), each over its
own ``MemoryStateStore``. Tolerance: exact everywhere — output rows in
order, committed store bytes, and recovered or compacted state slot for
slot (the scenarios use integer lanes only)."""

import asyncio
import contextlib
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import risingwave_tpu.common as J
import risingwave_tpu.expr as JE
import risingwave_tpu.ops as JO
import risingwave_tpu.stream as JS
import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
import risingwave_tpu_torch.ops as TO
import risingwave_tpu_torch.stream as TS
from risingwave_tpu.storage import MemoryStateStore as JStore
from risingwave_tpu.storage import StateTable as JTable
from risingwave_tpu.stream.hash_agg import agg_state_schema as j_agg_schema
from risingwave_tpu_torch.storage import MemoryStateStore as TStore
from risingwave_tpu_torch.storage import StateTable as TTable
from risingwave_tpu_torch.stream.hash_agg import (
    agg_state_schema as t_agg_schema,
)

CAP = 32


@dataclasses.dataclass
class Pkg:
    """One package's entry points, so a driver runs either."""

    common: object
    expr: object
    stream: object
    ops: object
    store_cls: object
    table_cls: object
    agg_schema: object
    device: object = None     # None: the JAX package (no device argument)

    def kw(self, **kw):
        if self.device is not None:
            kw["device"] = self.device
        return kw

    def eager(self):
        """The reference runs op by op: its executors jit their steps per
        instance, and compiling them costs seconds per executor on the
        CPU (a recovery runs in the constructor)."""
        return (jax.disable_jit() if self.device is None
                else contextlib.nullcontext())

    def schema(self, *cols):
        c = self.common
        return c.Schema.of(*((n, getattr(c, t)) for n, t in cols))

    def chunk(self, schema, rows, ops=None, capacity=CAP):
        return self.common.make_chunk(schema, rows, ops=ops,
                                      capacity=capacity, **self.kw())

    def messages(self, schema, spec, capacity=CAP):
        """``spec``: ("b", epoch, checkpoint) barriers, ("c", rows, ops)
        chunks, ("k", [(rows, ops), ...]) ChunkBatches, ("w", col, value)
        watermarks."""
        out = []
        for item in spec:
            if item[0] == "b":
                out.append(self.stream.Barrier.new(item[1],
                                                   checkpoint=item[2]))
            elif item[0] == "c":
                out.append(self.chunk(schema, item[1], item[2],
                                      max(capacity, len(item[1]))))
            elif item[0] == "k":
                out.append(self.common.chunk.stack_chunks(
                    [self.chunk(schema, r, o, capacity)
                     for r, o in item[1]]))
            else:
                out.append(self.stream.Watermark(item[1], item[2]))
        return out

    def drain(self, ex, store=None):
        """Every output row (op, row) in order; each checkpoint barrier
        commits ``store``."""
        async def run():
            out = []
            async for m in ex.execute():
                if isinstance(m, self.stream.Barrier):
                    if store is not None and m.checkpoint:
                        store.commit(m.epoch.curr)
                elif not isinstance(m, self.stream.Watermark):
                    out.extend(self.common.chunk_to_rows(m, ex.schema,
                                                         with_ops=True))
            return out

        with self.eager():
            return asyncio.run(run())


JAX = Pkg(J, JE, JS, JO, JStore, JTable, j_agg_schema)
TORCH = Pkg(T, TE, TS, TO, TStore, TTable, t_agg_schema, device="cpu")
BOTH = (JAX, TORCH)
I, D = J.OP_INSERT, J.OP_DELETE


def np_of(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_equal(pairs):
    for a, b in pairs:
        np.testing.assert_array_equal(np_of(a), np_of(b))


def assert_agg_states_equal(js, ts, marks=True):
    """Table, lanes and prev lanes slot for slot (and the checkpoint and
    dirty marks with ``marks``)."""
    pairs = [(js.table.occupied, ts.table.occupied)]
    pairs += list(zip(js.table.key_data + js.table.key_mask,
                      ts.table.key_data + ts.table.key_mask))
    pairs += list(zip(js.lanes + js.prev_lanes,
                      ts.lanes + ts.prev_lanes))
    if marks:
        pairs += [(js.dirty, ts.dirty), (js.ckpt_dirty, ts.ckpt_dirty)]
    assert_equal(pairs)


def assert_join_sides_equal(jst, tst):
    for side in ("left", "right"):
        a, b = getattr(jst, side), getattr(tst, side)
        assert_equal([(a.ht.occupied, b.ht.occupied), (a.occupied,
                                                       b.occupied),
                      (a.tomb, b.tomb), (a.degree, b.degree),
                      (a.ckpt_dirty, b.ckpt_dirty)]
                     + list(zip(a.ht.key_data + a.row_data + a.row_mask,
                                b.ht.key_data + b.row_data + b.row_mask)))


# ---------------------------------------------------------------------------
# HashAgg: checkpoint, recovery and the post-recovery update
# ---------------------------------------------------------------------------

AGG_IN = (("k", "INT64"), ("v", "INT64"))


def agg_executor(pkg, spec, store=None, table_id=101, schema=AGG_IN,
                 keys=(0,), calls=None, **kw):
    c, e = pkg.common, pkg.expr
    schema = pkg.schema(*schema)
    calls = calls(c, e) if calls else [e.count_star(),
                                       e.agg("sum", 1, c.INT64)]
    table = None
    if store is not None:
        st_schema = pkg.agg_schema([schema[i] for i in keys], calls)
        table = pkg.table_cls(store, table_id, st_schema,
                              list(range(len(keys))))
    kw.setdefault("table_capacity", 64)
    kw.setdefault("out_capacity", 16)
    src = pkg.stream.MockSource(schema, pkg.messages(schema, spec))
    with pkg.eager():
        return pkg.stream.HashAggExecutor(src, list(keys), calls,
                                          state_table=table, **pkg.kw(**kw))


def test_agg_checkpoint_and_recovery_matches_reference():
    """tests/test_hash_agg.py::test_checkpoint_and_recovery, with the
    committed bytes compared after every checkpoint."""
    first = [("b", 1, False), ("c", [(1, 10), (2, 20)], None),
             ("b", 2, True), ("c", [(1, 3), (3, 30)], None),
             ("c", [(2, 20)], [D]), ("b", 3, True)]
    second = [("b", 4, False), ("c", [(1, 5)], None), ("b", 5, True),
              ("c", [(1, 1), (4, 40)], None), ("b", 6, True)]
    stores = {}
    outs = {}
    for pkg in BOTH:
        store = stores[pkg.device] = pkg.store_cls()
        out1 = pkg.drain(agg_executor(pkg, first, store), store)
        snap1 = store.snapshot()
        out2 = pkg.drain(agg_executor(pkg, second, store), store)
        outs[pkg.device] = (out1, snap1, out2, store.snapshot())
    assert outs["cpu"] == outs[None]
    # the update after recovery retracts the stored value
    assert (J.OP_UPDATE_DELETE, (1, 2, 13)) in outs["cpu"][2]
    assert (J.OP_UPDATE_INSERT, (1, 3, 18)) in outs["cpu"][2]


def _many_groups(n=1500):
    rows = [(g * 7 % 5003, g) for g in range(n)]
    spec = [("b", 1, False)]
    spec += [("c", rows[i:i + 256], None) for i in range(0, n, 256)]
    spec.append(("b", 2, True))
    return spec


def test_agg_cross_recovery_slot_for_slot():
    """The port recovers from the reference's store: its table, lanes and
    prev lanes equal the reference's recovered state slot for slot (1024-row
    load batches, rows in encoded-key order); two later updates emit the
    same U-/U+ pairs, with the stored old values (prev lanes not aliased to
    the lanes)."""
    jstore = JStore()
    JAX.drain(agg_executor(JAX, _many_groups(), jstore, table_capacity=4096,
                           out_capacity=512), jstore)
    tstore = TStore()
    tstore.restore(jstore.snapshot())
    after = [("b", 3, False), ("c", [(7, 1), (14, 2), (999_999, 3)], None),
             ("b", 4, True), ("c", [(7, 10), (14, 20)], None),
             ("b", 5, True)]
    jex = agg_executor(JAX, after, jstore, table_capacity=4096,
                       out_capacity=512)
    tex = agg_executor(TORCH, after, tstore, table_capacity=4096,
                       out_capacity=512)
    assert_agg_states_equal(jex.state, tex.state)
    assert int(np.asarray(jex.state.table.occupied).sum()) == 1500
    got, want = TORCH.drain(tex, tstore), JAX.drain(jex, jstore)
    assert got == want
    assert got[got.index((J.OP_UPDATE_DELETE, (7, 1, 1))) + 1] == \
        (J.OP_UPDATE_INSERT, (7, 2, 2))
    assert tstore.snapshot() == jstore.snapshot()


def test_agg_varchar_keys_recover_by_string():
    """VARCHAR group keys recover through their string bytes: each epoch's
    decoded output rows equal, and the committed bytes equal. The ids may
    differ between the packages' dictionaries (they depend on what each
    interned earlier in the process), and a flush's row order follows the
    slots, which follow the ids, so each epoch's rows compare as a sorted
    list."""
    schema = (("s", "VARCHAR"), ("v", "INT64"))
    first = [("b", 1, False), ("c", [("x", 1), ("y\x00z", 2), ("", 3)],
                                None), ("b", 2, True)]
    second = [("b", 3, False), ("c", [("y\x00z", 5), ("w", 1)], None),
              ("b", 4, True)]
    outs = {}
    for pkg in BOTH:
        store = pkg.store_cls()
        out1 = pkg.drain(agg_executor(pkg, first, store, schema=schema),
                         store)
        out2 = pkg.drain(agg_executor(pkg, second, store, schema=schema),
                         store)
        outs[pkg.device] = (sorted(out1), sorted(out2), store.snapshot())
    assert outs["cpu"] == outs[None]


# ---------------------------------------------------------------------------
# HashJoin: checkpoint and recovery with degrees rebuilt
# ---------------------------------------------------------------------------

def join_executor(pkg, left_spec, right_spec, stores=None, join_type="INNER",
                  schemas=(("k", "a"), ("k", "b")), keys=([0], [0]),
                  pks=([0, 1], [0, 1]), **kw):
    ls = pkg.schema(*((n, "INT64") for n in schemas[0]))
    rs = pkg.schema(*((n, "INT64") for n in schemas[1]))
    tables = {}
    if stores is not None:
        tables = dict(
            left_state_table=pkg.table_cls(stores, 1, ls, pks[0]),
            right_state_table=pkg.table_cls(stores, 2, rs, pks[1]))
    kw.setdefault("key_capacity", 64)
    kw.setdefault("bucket_width", 4)
    kw.setdefault("out_capacity", 32)
    with pkg.eager():
        return pkg.stream.HashJoinExecutor(
            pkg.stream.MockSource(ls, pkg.messages(ls, left_spec)),
            pkg.stream.MockSource(rs, pkg.messages(rs, right_spec)),
            keys[0], keys[1], getattr(pkg.ops.JoinType, join_type),
            **tables, **pkg.kw(**kw))


def test_join_recovery_rebuilds_degrees_like_reference():
    """tests/test_hash_join.py::test_checkpoint_and_recovery_rebuild_degrees:
    the recovered arenas equal the reference's lane for lane, and deleting
    the right row then retracts to the NULL-padded row."""
    left = [("b", 1, False), ("c", [(1, 100), (2, 200), (1, 101)], None),
            ("b", 2, True), ("c", [(2, 200)], [D]), ("b", 3, True)]
    right = [("b", 1, False), ("c", [(1, 10), (3, 30)], None),
             ("b", 2, True), ("b", 3, True)]
    left2 = [("b", 4, False), ("c", [(3, 300)], None), ("b", 5, True)]
    right2 = [("b", 4, False), ("c", [(1, 10)], [D]), ("b", 5, True)]
    res = {}
    for pkg in BOTH:
        store = pkg.store_cls()
        out = pkg.drain(join_executor(pkg, left, right, store,
                                      "LEFT_OUTER"), store)
        rec = join_executor(pkg, left2, right2, store, "LEFT_OUTER")
        res[pkg.device] = (out, copy.deepcopy(rec.state),
                           pkg.drain(rec, store), store.snapshot())
    jw, tw = res[None], res["cpu"]
    assert_join_sides_equal(jw[1], tw[1])
    assert (tw[0], tw[2], tw[3]) == (jw[0], jw[2], jw[3])
    assert (J.OP_UPDATE_DELETE, (1, 100, 1, 10)) in tw[2]
    assert (J.OP_UPDATE_INSERT, (1, 100, None, None)) in tw[2]


# ---------------------------------------------------------------------------
# sharded reload
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_store():
    """The reference's store after 600 groups (shared: recovery reads it
    without writing)."""
    jstore = JStore()
    JAX.drain(agg_executor(JAX, _many_groups(600), jstore,
                           table_capacity=1024, out_capacity=256), jstore)
    return jstore


@pytest.mark.parametrize("shard", [dict(load_shard=(0, 2)),
                                   dict(load_shard=(1, 2)),
                                   dict(load_shard=(0, 3)),
                                   dict(load_shard=(2, 3)),
                                   dict(load_vnodes=(40, 170))],
                         ids=["2_shards_0", "2_shards_1", "3_shards_0",
                              "3_shards_2", "vnodes_40_170"])
def test_sharded_reload_keeps_the_reference_rows(shard, reference_store):
    jstore = reference_store
    tstore = TStore()
    tstore.restore(jstore.snapshot())
    jex = agg_executor(JAX, [], jstore, table_capacity=1024, **shard)
    tex = agg_executor(TORCH, [], tstore, table_capacity=1024, **shard)
    assert_agg_states_equal(jex.state, tex.state)
    n = int(tex.state.table.occupied.sum())
    assert 0 < n < 600


def test_join_sharded_reload_keeps_the_reference_rows():
    left = [("b", 1, False),
            ("c", [(k, k * 3) for k in range(30)], None), ("b", 2, True)]
    right = [("b", 1, False),
             ("c", [(k, -k) for k in range(0, 30, 2)], None),
             ("b", 2, True)]
    states = {}
    for pkg in BOTH:
        store = pkg.store_cls()
        pkg.drain(join_executor(pkg, left, right, store), store)
        states[pkg.device] = join_executor(pkg, [], [], store,
                                           load_shard=(1, 2)).state
    assert_join_sides_equal(states[None], states["cpu"])
    assert 0 < int(states["cpu"].left.occupied.sum()) < 30
