"""The exchange fabric through both packages on the CPU: the hash
dispatcher's split (with the update-pair rule), permit channels, the
barrier-aligned merge and its watermark minimum, round robin and
broadcast (the scenarios of tests/test_dispatch.py), each run against the
reference's ``risingwave_tpu/stream/dispatch.py`` on the same messages.

The port sends a ChunkBatch to each output as one batch masked per chunk;
the reference unpacks it into chunks: chunk i of the port's batch at an
output must hold the rows and ops of the reference's i-th chunk there.
Keys are integer columns (a VARCHAR key hashes its dictionary id, which
differs between the packages). Tolerance: exact.
"""

import asyncio

import numpy as np
import pytest

import risingwave_tpu.stream.dispatch as JD
import risingwave_tpu_torch.stream.dispatch as TD
from test_torch_recovery import BOTH, JAX

I, D, UD, UI = 0, 1, 2, 3
COLS = (("k", "INT64"), ("j", "INT32"), ("v", "INT64"))


def mod(pkg):
    return JD if pkg is JAX else TD


def dispatcher(pkg, outs, keys, schema):
    if pkg is JAX:
        return JD.HashDispatcher(outs, keys, schema)
    return TD.HashDispatcher(outs, keys, schema, device="cpu")


def both(fn):
    """``asyncio.run(fn(pkg))`` for each package; results equal."""
    got = [asyncio.run(fn(pkg)) for pkg in BOTH]
    assert got[1] == got[0]
    return got[0]


def random_rows(seed: int, n: int):
    """Rows with NULL keys, update pairs (some moving their key), deletes
    and rows made invisible; returns (rows, ops, visible)."""
    rng = np.random.default_rng(seed)
    rows, ops = [], []
    while len(rows) < n:
        k = None if rng.random() < 0.05 else int(rng.integers(-50, 50))
        j = int(rng.integers(0, 4))
        v = int(rng.integers(0, 1000))
        if rng.random() < 0.3 and len(rows) < n - 1:
            k2 = k if rng.random() < 0.5 else int(rng.integers(-50, 50))
            rows += [(k, j, v), (k2, j, v + 1)]
            ops += [UD, UI]
        else:
            rows.append((k, j, v))
            ops.append(int(rng.choice([I, D])))
    visible = rng.random(n) > 0.1
    return rows, ops, visible


def hidden(pkg, chunk, visible):
    """``chunk`` with the rows of ``visible == False`` made invisible."""
    visible = np.pad(visible, (0, chunk.capacity - len(visible)))
    if pkg is JAX:
        import jax.numpy as jnp
        return chunk.replace(vis=chunk.vis & jnp.asarray(visible))
    import torch
    return chunk.replace(vis=chunk.vis & torch.from_numpy(visible))


async def drain_outputs(pkg, outs, n_msgs):
    """Each output's messages as (op, row) lists (chunks) or types."""
    got = []
    for ch in outs:
        msgs = []
        for _ in range(n_msgs):
            m = await ch.recv()
            if isinstance(m, pkg.stream.Barrier | pkg.stream.Watermark):
                msgs.append(type(m).__name__)
            else:
                msgs.append(pkg.common.chunk_to_rows(
                    m, pkg.schema(*COLS), with_ops=True))
        got.append(msgs)
    return got


@pytest.mark.parametrize("n_out,keys", [(2, [0]), (3, [0]), (4, [0, 1]),
                                        (4, [1])])
def test_hash_split_equals_reference(n_out, keys):
    rows, ops, visible = random_rows(n_out * 10 + len(keys), 60)

    async def run(pkg):
        schema = pkg.schema(*COLS)
        outs = [mod(pkg).PermitChannel() for _ in range(n_out)]
        d = dispatcher(pkg, outs, keys, schema)
        chunk = hidden(pkg, pkg.chunk(schema, rows, ops, 64), visible)
        await d.dispatch(chunk)
        await d.dispatch(pkg.stream.Barrier.new(1))
        return await drain_outputs(pkg, outs, 2)

    got = both(run)
    seen = sorted((r for out in got for op, r in out[0]), key=repr)
    assert seen == sorted((r for r, v in zip(rows, visible) if v), key=repr)
    assert all(out[1] == "Barrier" for out in got)


def test_batch_split_equals_reference_chunks():
    """A ChunkBatch of three chunks: the port's one batch per output holds,
    chunk for chunk, the reference's unpacked chunks (and costs three
    permits)."""
    specs = [random_rows(s, 48) for s in (5, 6, 7)]

    async def run(pkg):
        schema = pkg.schema(*COLS)
        outs = [mod(pkg).PermitChannel() for _ in range(3)]
        d = dispatcher(pkg, outs, [0], schema)
        chunks = [hidden(pkg, pkg.chunk(schema, r, o, 64), v)
                  for r, o, v in specs]
        await d.dispatch(pkg.common.chunk.stack_chunks(chunks))
        got = []
        for ch in outs:
            if pkg is JAX:
                parts = [await ch.recv() for _ in chunks]
            else:
                assert ch._sem._value == ch.permits - len(chunks)
                batch = await ch.recv()
                assert ch._sem._value == ch.permits
                parts = [batch.at(i) for i in range(batch.num_chunks)]
            got.append([pkg.common.chunk_to_rows(p, schema, with_ops=True)
                        for p in parts])
        return got

    both(run)


@pytest.mark.parametrize("moved", [True, False])
def test_update_pair_split_or_kept(moved):
    """A U-/U+ pair whose keys land on two outputs becomes Delete + Insert;
    one that stays on one output keeps its ops."""
    async def run(pkg):
        schema = pkg.schema(*COLS)
        outs = [mod(pkg).PermitChannel(), mod(pkg).PermitChannel()]
        d = dispatcher(pkg, outs, [0], schema)
        probe = pkg.chunk(schema, [(i, 0, 0) for i in range(16)], None, 16)
        shards = np.asarray(pkg.common.hashing.vnode_to_shard(
            pkg.common.hashing.vnode_of([probe.columns[0]]), 2))
        b = next(i for i in range(16) if (shards[i] != shards[0]) == moved)
        await d.dispatch(pkg.chunk(schema, [(0, 0, 1), (b, 0, 2)],
                                   [UD, UI], 4))
        return await drain_outputs(pkg, outs, 1)

    got = both(run)
    ops = sorted(op for out in got for op, _ in out[0])
    assert ops == ([I, D] if moved else [UD, UI])


def test_permits_block_sender_not_barriers():
    async def run(pkg):
        ch = mod(pkg).open_channel(permits=2)
        c1 = pkg.chunk(pkg.schema(*COLS), [(1, 1, 1)], None, 2)
        await ch.send(c1)
        await ch.send(c1)
        blocked = asyncio.ensure_future(ch.send(c1))
        await asyncio.sleep(0.01)
        was_blocked = not blocked.done()
        await asyncio.wait_for(ch.send(pkg.stream.Barrier.new(1)),
                               timeout=1)
        await ch.recv()                     # releases one permit
        await asyncio.wait_for(blocked, timeout=1)
        kinds = [type(await ch.recv()).__name__ for _ in range(3)]
        return was_blocked, kinds

    assert both(run) == (True, ["StreamChunk", "Barrier", "StreamChunk"])


def test_merge_aligns_barriers_and_forwards_min_watermark():
    async def run(pkg):
        S = pkg.stream
        chs = [mod(pkg).PermitChannel() for _ in range(3)]
        merge = mod(pkg).MergeExecutor(chs, pkg.schema(*COLS))
        c = pkg.chunk(pkg.schema(*COLS), [(1, 1, 1)], None, 2)
        order = []

        async def consume():
            async for m in merge.execute():
                order.append(repr(m.value) if isinstance(m, S.Watermark)
                             else f"B{m.epoch.curr}"
                             if isinstance(m, S.Barrier) else "C")

        task = asyncio.ensure_future(consume())
        steps = [(0, c), (0, S.Barrier.new(1)), (1, S.Watermark(0, 5)),
                 (1, c), (1, S.Barrier.new(1)), (0, S.Watermark(0, 3)),
                 (2, S.Watermark(0, 9)), (2, S.Barrier.new(1)),
                 (1, S.Watermark(0, 7)), (0, S.Watermark(0, 8)),
                 (2, None), (0, S.Watermark(0, 10)),
                 (1, S.Watermark(0, 12))]
        for i, msg in steps:
            if msg is None:
                chs[i].close()
            else:
                await chs[i].send(msg)
            await asyncio.sleep(0.005)
            order.append("|")
        stop = S.Barrier.new(2, mutation=S.Mutation(S.MutationKind.STOP))
        for ch in chs[:2]:
            await ch.send(stop)
        await asyncio.wait_for(task, timeout=2)
        return order

    got = both(run)
    assert got.count("B1") == 1 and got[-1] == "B2"
    assert [m for m in got if m[0].isdigit()] == ["3", "7", "10"]


def test_round_robin_and_broadcast():
    async def run(pkg):
        outs = [mod(pkg).PermitChannel(), mod(pkg).PermitChannel()]
        rr = mod(pkg).RoundRobinDispatcher(outs)
        c = pkg.chunk(pkg.schema(*COLS), [(1, 1, 1)], None, 2)
        for _ in range(3):
            await rr.dispatch(c)
        await rr.dispatch(pkg.stream.Barrier.new(1))
        sizes = [outs[0]._q.qsize(), outs[1]._q.qsize()]
        bc = mod(pkg).BroadcastDispatcher(outs)
        await bc.dispatch(pkg.stream.Watermark(0, 5))
        kinds = [[type(await ch.recv()).__name__ for _ in range(n + 1)]
                 for ch, n in zip(outs, sizes)]
        return sizes, kinds

    assert both(run) == ([3, 2], [
        ["StreamChunk", "StreamChunk", "Barrier", "Watermark"],
        ["StreamChunk", "Barrier", "Watermark"]])


def test_channel_source_ends_on_close_and_stop():
    async def run(pkg):
        S = pkg.stream
        schema = pkg.schema(*COLS)
        out = []
        for last in (None, S.Barrier.new(
                2, mutation=S.Mutation(S.MutationKind.STOP))):
            ch = mod(pkg).open_channel()
            await ch.send(S.Barrier.new(1))
            if last is None:
                ch.close()
            else:
                await ch.send(last)
            src = mod(pkg).ChannelSource(ch, schema)
            out.append([m.epoch.curr async for m in src.execute()])
        return out

    assert both(run) == [[1], [1, 2]]


def test_round_robin_sends_a_batch_to_one_output():
    """The port routes a ChunkBatch whole to the next output (the
    reference broadcasts a batch: ROADMAP Queue C8)."""
    from test_torch_recovery import TORCH

    async def run():
        outs = [TD.PermitChannel(), TD.PermitChannel()]
        rr = TD.RoundRobinDispatcher(outs)
        schema = TORCH.schema(*COLS)
        batch = TORCH.common.chunk.stack_chunks(
            [TORCH.chunk(schema, [(1, 1, 1)], None, 2)] * 3)
        await rr.dispatch(batch)
        await rr.dispatch(batch)
        return [ch._q.qsize() for ch in outs], outs[0]._sem._value

    assert asyncio.run(run()) == ([1, 1], TD.EXCHANGE_PERMITS - 3)
