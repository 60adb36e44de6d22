"""Executor protocol: async stream transformers over Messages.

Counterpart of ``risingwave_tpu/stream/executor.py``: every operator is an
async generator of ``Message`` (chunk / barrier / watermark). Barriers flow
through every executor and are yielded after the executor has applied all
chunks of the closing epoch to its state. The per-chunk work runs on the
device; the async generator is only the host control loop.
"""

from __future__ import annotations

from typing import AsyncIterator

from ..common.chunk import ChunkBatch, StreamChunk
from ..common.types import Schema
from .message import Barrier, Message, Watermark


class Executor:
    """Base class. ``schema`` describes the output chunks."""

    schema: Schema
    identity: str = "Executor"

    def execute(self) -> AsyncIterator[Message]:
        raise NotImplementedError


class SingleInputExecutor(Executor):
    """Common shape: transform one upstream, pass barriers/watermarks
    through. Subclasses override ``map_chunk`` (1→0..n chunks), optionally
    ``map_chunk_batch`` and ``on_barrier`` (flush state, emit pending output *before* the
    barrier)."""

    def __init__(self, input: Executor):
        self.input = input

    async def map_chunk(self, chunk: StreamChunk):
        yield chunk

    async def map_chunk_batch(self, batch: ChunkBatch):
        """Batched ingest. The default runs the chunks one by one, which is
        right for every executor; an executor overrides it with a step
        over the whole batch where throughput matters."""
        for i in range(batch.num_chunks):
            async for out in self.map_chunk(batch.at(i)):
                yield out

    async def on_barrier(self, barrier: Barrier):
        if False:  # pragma: no cover - async generator shape
            yield

    async def on_watermark(self, watermark: Watermark):
        yield watermark

    async def execute(self) -> AsyncIterator[Message]:
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                async for out in self.map_chunk(msg):
                    yield out
            elif isinstance(msg, ChunkBatch):
                async for out in self.map_chunk_batch(msg):
                    yield out
            elif isinstance(msg, Barrier):
                outs = [out async for out in self.on_barrier(msg)]
                for out in outs:
                    yield out
                yield msg
                if msg.is_stop():
                    return
            elif isinstance(msg, Watermark):
                async for out in self.on_watermark(msg):
                    yield out
