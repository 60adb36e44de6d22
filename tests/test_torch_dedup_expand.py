"""AppendOnlyDedup and Expand through both packages on the CPU.

Dedup keeps the first row of each pk: within a chunk the find-or-insert's
winner among one new key's rows is its lowest row, on the port's plain
version here (the card's two kernel paths are held to it in
tests/test_torch_gpu.py and chip_smoke.py). Checkpoint and recovery match
the reference slot for slot (integer keys) and byte for byte in the store;
a reference dedup's state carries across with ``interop``. Expand's column
subsets equal the reference's, and its ChunkBatch path its per-chunk path.
Reference executors run op by op under ``jax.disable_jit``. Tolerance:
exact.
"""

import copy
import random

import jax
import numpy as np
import pytest

from risingwave_tpu_torch.interop import dedup_state_from_jax
from test_torch_eowc import events
from test_torch_recovery import BOTH, JAX, TORCH, assert_equal

I, D = 0, 1
KV = (("k", "INT64"), ("v", "INT64"))
KKV = (("a", "INT64"), ("b", "INT32"), ("v", "INT64"))


def source(pkg, spec, schema=KV, capacity=8):
    s = pkg.schema(*schema)
    return pkg.stream.MockSource(s, pkg.messages(s, spec, capacity))


def dedup(pkg, spec, schema=KV, pk=(0,), store=None, table_id=5,
          capacity=8, **kw):
    src = source(pkg, spec, schema, capacity)
    if store is not None:
        kw["state_table"] = pkg.table_cls(
            store, table_id, pkg.schema(*(schema[i] for i in pk)),
            list(range(len(pk))))
    kw.setdefault("table_capacity", 64)
    with pkg.eager():
        return pkg.stream.AppendOnlyDedupExecutor(src, list(pk),
                                                  **pkg.kw(**kw))


def assert_dedup_states_equal(js, ts):
    assert_equal([(js.table.occupied, ts.table.occupied),
                  (js.ckpt_dirty, ts.ckpt_dirty)]
                 + list(zip(js.table.key_data + js.table.key_mask,
                            ts.table.key_data + ts.table.key_mask)))


def test_dedup_keeps_first_within_and_across_chunks():
    """tests/test_executors3.py::test_append_only_dedup."""
    spec = [("b", 1, False), ("c", [(1, 10), (2, 20), (1, 30)], None),
            ("b", 2, False), ("c", [(2, 40), (3, 50)], None),
            ("b", 3, False)]
    got = [events(pkg, dedup(pkg, spec)) for pkg in BOTH]
    assert got[1] == got[0]
    assert [r[1] for r in got[0] if r[0] == I] == [(1, 10), (2, 20), (3, 50)]


def dup_chunks(seed, n_chunks=4, n=256, keys=40):
    """Chunks with many rows per key (two key columns, NULLs among them);
    the value is the arrival number, so the first row of a key is the one
    with the lowest value."""
    rng = random.Random(seed)
    rows, t = [], 0
    for _ in range(n_chunks):
        chunk = []
        for _ in range(n):
            k = rng.randrange(keys)
            chunk.append((None if k == 0 else k % 13,
                          None if k == 1 else k // 13, t))
            t += 1
        rows.append(chunk)
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_dedup_first_row_of_each_key_slot_for_slot(seed):
    chunks = dup_chunks(seed)
    spec = [("b", 1, False)] + [("c", c, None) for c in chunks] + [
        ("b", 2, False)]
    exs = [dedup(pkg, spec, KKV, (0, 1), table_capacity=128)
           for pkg in BOTH]
    got = [events(pkg, ex) for pkg, ex in zip(BOTH, exs)]
    assert got[1] == got[0]
    first = {}
    for chunk in chunks:
        for a, b, t in chunk:
            first.setdefault((a, b), t)
    kept = [r[1] for r in got[0] if r[0] == I]
    assert sorted(r[2] for r in kept) == sorted(first.values())
    assert_dedup_states_equal(*exs)


def test_dedup_batch_equals_chunk_path():
    chunks = dup_chunks(2, n=64)
    per_chunk = [("b", 1, False)] + [("c", c, None) for c in chunks] + [
        ("b", 2, False)]
    batched = [("b", 1, False), ("k", [(c, None) for c in chunks]),
               ("b", 2, False)]
    a = dedup(TORCH, per_chunk, KKV, (0, 1), table_capacity=128)
    b = dedup(TORCH, batched, KKV, (0, 1), capacity=64, table_capacity=128)
    assert events(TORCH, a) == events(TORCH, b)
    assert_dedup_states_equal(a, b)


def test_dedup_checkpoint_and_recovery_slot_for_slot():
    """tests/test_executors3.py::test_dedup_checkpoint_recovery, larger:
    the committed store equal to the reference's, and the recovered table
    slot for slot."""
    chunks = dup_chunks(3, n_chunks=3, n=64, keys=200)
    first = ([("b", 1, False)] + [("c", [r[::2] for r in c], None)
                                  for c in chunks[:2]] + [("b", 2, True)])
    second = [("b", 3, False), ("c", [r[::2] for r in chunks[2]], None),
              ("b", 4, True)]
    outs, recovered = {}, {}
    for pkg in BOTH:
        store = pkg.store_cls()
        a = events(pkg, dedup(pkg, first, store=store), store)
        snap = store.snapshot()
        ex = dedup(pkg, second, store=store)
        recovered[pkg.device] = copy.deepcopy(ex)
        b = events(pkg, ex, store)
        outs[pkg.device] = (a, snap, b, store.snapshot())
    assert outs["cpu"] == outs[None]
    assert_dedup_states_equal(recovered[None], recovered["cpu"])


def test_dedup_state_carried_by_interop():
    chunks = dup_chunks(4, n_chunks=2, n=32, keys=30)
    ref = dedup(JAX, [("b", 1, False), ("c", [r[::2] for r in chunks[0]],
                                         None), ("b", 2, False)])
    events(JAX, ref)
    rest = [("b", 3, False), ("c", [r[::2] for r in chunks[1]], None),
            ("b", 4, False)]
    port = dedup(TORCH, rest)
    for name, value in dedup_state_from_jax(
            jax.tree_util.tree_map(np.asarray, {
                f: getattr(ref, f) for f in ("table", "ckpt_dirty",
                                             "overflow", "saw_delete")}),
            "cpu").items():
        setattr(port, name, value)
    ref_next = dedup(JAX, rest)
    for f in ("table", "ckpt_dirty", "overflow", "saw_delete"):
        setattr(ref_next, f, getattr(ref, f))
    assert events(TORCH, port) == events(JAX, ref_next)
    assert_dedup_states_equal(ref_next, port)


def test_dedup_rejects_a_delete_at_the_barrier():
    spec = [("b", 1, False), ("c", [(1, 10)], [D]), ("b", 2, False)]
    for pkg in BOTH:
        with pytest.raises(RuntimeError, match="append-only"):
            events(pkg, dedup(pkg, spec))


def expand(pkg, spec, subsets, schema=KKV):
    src = source(pkg, spec, schema)
    with pkg.eager():
        return pkg.stream.ExpandExecutor(src, subsets)


@pytest.mark.parametrize("subsets", [[[0], [1]], [[0, 2], [1], [0, 1, 2]]])
def test_expand_subsets_as_reference(subsets):
    """tests/test_executors3.py::test_expand_subsets: one chunk per subset
    in subset order, the other columns nulled, the flag column last."""
    spec = [("b", 1, False), ("c", [(7, 30, 1), (8, None, 2)], None),
            ("c", [(9, 5, 3)], [D]), ("b", 2, False)]
    got = [events(pkg, expand(pkg, spec, subsets)) for pkg in BOTH]
    assert got[1] == got[0]
    assert [r[1] for r in got[0][1:3]] == [
        tuple(v if i in subsets[0] else None
              for i, v in enumerate((7, 30, 1))) + (0,),
        tuple(v if i in subsets[0] else None
              for i, v in enumerate((8, None, 2))) + (0,)]


def test_expand_batch_equals_chunk_path():
    rows = [[(i, i * 2, i * 3)] for i in range(3)]
    per_chunk = [("b", 1, False)] + [("c", r, None) for r in rows] + [
        ("b", 2, False)]
    batched = [("b", 1, False), ("k", [(r, None) for r in rows]),
               ("b", 2, False)]
    assert (events(TORCH, expand(TORCH, batched, [[0], [1, 2]]))
            == events(TORCH, expand(TORCH, per_chunk, [[0], [1, 2]])))
