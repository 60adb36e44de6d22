"""N-input barrier alignment.

Counterpart of ``risingwave_tpu/stream/barrier_align.py``: read all inputs
concurrently; once a barrier arrives on one input, stop polling that input
until every other input's barrier for the same epoch arrives, then emit one
aligned barrier. The polling schedule is the reference's, so the same
scripted inputs interleave the same way in both packages.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Hashable, Mapping

from ..common.chunk import ChunkBatch, StreamChunk
from .executor import Executor
from .message import Barrier, Watermark


async def align_streams(
        inputs: Mapping[Hashable, Executor]) -> AsyncIterator[tuple]:
    """Align barriers across named inputs.

    Yields ("chunk", name, chunk) / ("batch", name, chunk_batch) /
    ("watermark", name, wm) / ("barrier", barrier) events; terminates after
    a stop barrier or when all inputs are exhausted. A ChunkBatch goes on
    whole, for the consumer's batched step."""
    names = list(inputs)
    its = {s: inputs[s].execute().__aiter__() for s in names}
    pending: dict = {}
    held_barrier: dict = {}
    finished: set = set()

    try:
        while len(finished) < len(names):
            for s in names:
                if (s not in pending and s not in held_barrier
                        and s not in finished):
                    pending[s] = asyncio.ensure_future(its[s].__anext__())
            if not pending:
                break
            done, _ = await asyncio.wait(
                pending.values(), return_when=asyncio.FIRST_COMPLETED)
            for s in list(pending):
                task = pending[s]
                if task not in done:
                    continue
                del pending[s]
                try:
                    msg = task.result()
                except StopAsyncIteration:
                    finished.add(s)
                    continue
                if isinstance(msg, Barrier):
                    held_barrier[s] = msg
                elif isinstance(msg, StreamChunk):
                    yield ("chunk", s, msg)
                elif isinstance(msg, ChunkBatch):
                    yield ("batch", s, msg)
                elif isinstance(msg, Watermark):
                    yield ("watermark", s, msg)
            live = [s for s in names if s not in finished]
            if live and all(s in held_barrier for s in live):
                barriers = [held_barrier[s] for s in live]
                epochs = {b.epoch.curr for b in barriers}
                if len(epochs) != 1:
                    raise AssertionError(
                        f"barrier misalignment: epochs {sorted(epochs)}")
                held_barrier.clear()
                yield ("barrier", barriers[0])
                if barriers[0].is_stop():
                    return
    finally:
        for task in pending.values():
            task.cancel()


async def barrier_align(left: Executor,
                        right: Executor) -> AsyncIterator[tuple]:
    """Two-input alignment with "left"/"right" naming (join-style callers)."""
    async for ev in align_streams({"left": left, "right": right}):
        yield ev
