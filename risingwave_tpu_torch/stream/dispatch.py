"""Dispatchers, permit-based exchange channels and the merge fan-in.

Counterpart of ``risingwave_tpu/stream/dispatch.py``, the actor delivery
fabric of a multi-fragment job:

  * dispatchers (hash, broadcast, round robin, simple), with the
    update-pair rule: an UpdateDelete/UpdateInsert pair whose rows land on
    different outputs becomes Delete + Insert;
  * permit channels: data takes permits and blocks the SENDER once the
    budget is spent; barriers and watermarks always pass, so control never
    queues behind data;
  * the merge: chunks forward as they arrive, each upstream's barrier is
    held until every live upstream has produced it, and a watermark
    forwards the minimum over the live upstreams once all have one.

The hash split is computed on the card for the whole chunk, or for every
chunk of a ChunkBatch at once: one vnode hash and one visibility mask per
output, with no host sync. A ChunkBatch goes to each output as one batch
masked per chunk (the reference unpacks it into chunks), so the actors
downstream keep their batched ingest; each output sees the same rows and
ops as the reference's. Only the channel plumbing is host asyncio.
"""

from __future__ import annotations

import asyncio
import collections
from typing import AsyncIterator, Optional, Sequence

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, ChunkBatch,
    StreamChunk,
)
from ..common.hashing import vnode_of, vnode_to_shard
from ..common.types import Schema
from .executor import Executor
from .message import Barrier, Message, Watermark

#: the reference planner's exchange budget (``BuildConfig.exchange_permits``)
EXCHANGE_PERMITS = 32


class MsgQueue:
    """Single-consumer unbounded message queue (``put_nowait``/``get``).
    Its ``get`` awaits a bare future and never touches the loop when an
    abandoned consumer is finalized late."""

    def __init__(self) -> None:
        self._items: collections.deque = collections.deque()
        self._waiter: Optional[asyncio.Future] = None

    def put_nowait(self, item) -> None:
        self._items.append(item)
        w = self._waiter
        if w is not None and not w.done():
            w.set_result(None)

    async def put(self, item) -> None:
        # unbounded: PermitChannel does its own flow control first
        self.put_nowait(item)

    async def get(self):
        while not self._items:
            self._waiter = asyncio.get_running_loop().create_future()
            try:
                await self._waiter
            finally:
                self._waiter = None
        return self._items.popleft()

    def qsize(self) -> int:
        return len(self._items)


def _is_data(msg) -> bool:
    return isinstance(msg, (StreamChunk, ChunkBatch))


class PermitChannel:
    """Bounded exchange edge. A chunk takes one permit and a ChunkBatch one
    per chunk (at most the whole budget, or a batch larger than the budget
    could never be sent); the SENDER blocks while the budget is spent.
    Barriers and watermarks always pass."""

    def __init__(self, permits: int = EXCHANGE_PERMITS):
        self._sem = asyncio.Semaphore(permits)
        self._q = MsgQueue()
        self.permits = permits

    def cost(self, msg) -> int:
        if isinstance(msg, ChunkBatch):
            return min(msg.num_chunks, self.permits)
        return 1 if isinstance(msg, StreamChunk) else 0

    async def send(self, msg: Message) -> None:
        n = self.cost(msg)
        for _ in range(n):
            await self._sem.acquire()
        await self._q.put((n, msg))

    async def recv(self) -> Message:
        n, msg = await self._q.get()
        for _ in range(n):
            self._sem.release()
        return msg

    def close(self) -> None:
        self._q.put_nowait((0, None))


def open_channel(permits: int = EXCHANGE_PERMITS) -> PermitChannel:
    """The one way to open an exchange edge, so the flow-control policy
    stays in this module."""
    return PermitChannel(permits)


class ChannelSource(Executor):
    """Executor view of a PermitChannel's receiving end."""

    identity = "ChannelSource"

    def __init__(self, channel: PermitChannel, schema: Schema):
        self.channel = channel
        self.schema = schema

    async def execute(self) -> AsyncIterator[Message]:
        while True:
            msg = await self.channel.recv()
            if msg is None:
                return
            yield msg
            if isinstance(msg, Barrier) and msg.is_stop():
                return


def hash_split(ops: torch.Tensor, vis: torch.Tensor, key_cols,
               outs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(new ops, visibility masks [n_out, ...]) of the hash split over the
    output indices ``outs`` (int32 [n_out], on the chunk's device).
    Tensors are [C] for a chunk or [K, C] for a batch; the update-pair
    partners are the physical neighbours within each chunk (``roll`` along
    the last axis, invisible rows included), as the reference's rule
    reads."""
    n_out = outs.shape[0]
    shard = vnode_to_shard(vnode_of(key_cols), n_out)
    is_ud = ops == OP_UPDATE_DELETE
    is_ui = ops == OP_UPDATE_INSERT
    split_pair = ((is_ud & (torch.roll(shard, -1, -1) != shard))
                  | (is_ui & (torch.roll(shard, 1, -1) != shard)))
    new_ops = torch.where(split_pair & is_ud, torch.full_like(ops, OP_DELETE),
                          torch.where(split_pair & is_ui,
                                      torch.full_like(ops, OP_INSERT), ops))
    outs = outs.view((n_out,) + (1,) * shard.dim())
    return new_ops, vis.unsqueeze(0) & (shard.unsqueeze(0) == outs)


class HashDispatcher:
    """Routes each row to output ``vnode_to_shard(vnode of its key)``;
    barriers and watermarks go to every output. ``device``: where the
    chunks lie."""

    def __init__(self, outputs: Sequence[PermitChannel],
                 key_cols: Sequence[int], schema: Schema,
                 device=DEFAULT_DEVICE):
        self.outputs = list(outputs)
        self.key_cols = tuple(key_cols)
        self.schema = schema
        self._outs = torch.arange(len(self.outputs), dtype=torch.int32,
                                  device=device)

    def split(self, chunk: StreamChunk) -> list[StreamChunk]:
        """One chunk (or a batch's [K, C] chunk) per output, on the card."""
        new_ops, masks = hash_split(
            chunk.ops, chunk.vis, [chunk.columns[i] for i in self.key_cols],
            self._outs)
        rebased = chunk.replace(ops=new_ops)
        return [rebased.replace(vis=masks[o])
                for o in range(len(self.outputs))]

    async def dispatch(self, msg: Message) -> None:
        if isinstance(msg, StreamChunk):
            parts = self.split(msg)
        elif isinstance(msg, ChunkBatch):
            parts = [ChunkBatch(c) for c in self.split(msg.chunk)]
        else:
            for out in self.outputs:
                await out.send(msg)
            return
        for out, part in zip(self.outputs, parts):
            await out.send(part)


class BroadcastDispatcher:
    def __init__(self, outputs: Sequence[PermitChannel]):
        self.outputs = list(outputs)

    async def dispatch(self, msg: Message) -> None:
        for out in self.outputs:
            await out.send(msg)


class RoundRobinDispatcher:
    """Chunk-granular round robin (a ChunkBatch goes whole to one output):
    for stateless fragments, where row placement is free."""

    def __init__(self, outputs: Sequence[PermitChannel]):
        self.outputs = list(outputs)
        self._i = 0

    async def dispatch(self, msg: Message) -> None:
        if _is_data(msg):
            out = self.outputs[self._i % len(self.outputs)]
            self._i += 1
            await out.send(msg)
        else:
            for out in self.outputs:
                await out.send(msg)


class SimpleDispatcher(BroadcastDispatcher):
    """1:1 pipe."""

    def __init__(self, output: PermitChannel):
        super().__init__([output])


class MergeExecutor(Executor):
    """N-ary fan-in with barrier alignment: chunks forward as they arrive;
    an upstream that produced the epoch's barrier is parked until every
    live upstream has. Watermarks are aligned per column: the merge
    forwards the minimum over the live upstreams, once each has reported
    one for that column, and only when it rises."""

    identity = "Merge"

    def __init__(self, channels: Sequence[PermitChannel], schema: Schema):
        self.channels = list(channels)
        self.schema = schema
        # col_idx -> {channel_idx: latest value}; col_idx -> last forwarded
        self._wm: dict[int, dict[int, object]] = {}
        self._wm_sent: dict[int, object] = {}

    def _on_watermark(self, i: int, wm: Watermark,
                      finished: set) -> Optional[Watermark]:
        per_chan = self._wm.setdefault(wm.col_idx, {})
        per_chan[i] = wm.value
        live = [j for j in range(len(self.channels)) if j not in finished]
        if not all(j in per_chan for j in live):
            return None
        lo = min(per_chan[j] for j in live)
        if wm.col_idx in self._wm_sent and lo <= self._wm_sent[wm.col_idx]:
            return None
        self._wm_sent[wm.col_idx] = lo
        return Watermark(wm.col_idx, lo)

    async def execute(self) -> AsyncIterator[Message]:
        n = len(self.channels)
        held: dict[int, Barrier] = {}
        finished: set[int] = set()
        pending: dict[int, asyncio.Future] = {}
        try:
            while True:
                for i, ch in enumerate(self.channels):
                    if i not in pending and i not in finished \
                            and i not in held:
                        pending[i] = asyncio.ensure_future(ch.recv())
                if not pending and not held:
                    return
                if pending:
                    done, _ = await asyncio.wait(
                        pending.values(), return_when=asyncio.FIRST_COMPLETED)
                    for i in list(pending):
                        task = pending[i]
                        if task not in done:
                            continue
                        del pending[i]
                        msg = task.result()
                        if msg is None:
                            finished.add(i)
                        elif isinstance(msg, Barrier):
                            held[i] = msg
                        elif isinstance(msg, Watermark):
                            out = self._on_watermark(i, msg, finished)
                            if out is not None:
                                yield out
                        else:
                            yield msg
                live = [i for i in range(n) if i not in finished]
                if live and all(i in held for i in live):
                    epochs = {held[i].epoch.curr for i in live}
                    if len(epochs) != 1:
                        raise AssertionError(
                            f"barrier misalignment at merge: {sorted(epochs)}")
                    barrier = held[live[0]]
                    held.clear()
                    yield barrier
                    if barrier.is_stop():
                        return
                if not live:
                    return
        finally:
            for task in pending.values():
                task.cancel()
