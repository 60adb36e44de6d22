"""Executor protocol: async stream transformers over Messages.

Counterpart of ``risingwave_tpu/stream/executor.py``: every operator is an
async generator of ``Message`` (chunk / barrier / watermark). Barriers flow
through every executor and are yielded after the executor has applied all
chunks of the closing epoch to its state. The per-chunk work runs on the
device; the async generator is only the host control loop.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

from ..common.chunk import (
    OP_UPDATE_DELETE, OP_UPDATE_INSERT, ChunkBatch, StreamChunk,
)
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


# ---------------------------------------------------------------------------
# Sanity wrappers (the reference's ``EpochCheckExecutor``,
# ``SchemaCheckExecutor`` and ``UpdateCheckExecutor``); a ChunkBatch is
# checked chunk by chunk and passed on whole.
# ---------------------------------------------------------------------------


class _CheckExecutor(SingleInputExecutor):
    def __init__(self, input: Executor):
        super().__init__(input)
        self.schema = input.schema
        self.identity = input.identity

    def check(self, chunk: StreamChunk) -> None:
        pass

    async def map_chunk(self, chunk: StreamChunk):
        self.check(chunk)
        yield chunk

    async def map_chunk_batch(self, batch: ChunkBatch):
        for i in range(batch.num_chunks):
            self.check(batch.at(i))
        yield batch


class EpochCheckExecutor(_CheckExecutor):
    """Barrier epochs must strictly increase."""

    def __init__(self, input: Executor):
        super().__init__(input)
        self._last_epoch: Optional[int] = None

    async def on_barrier(self, barrier: Barrier):
        if self._last_epoch is not None and \
                barrier.epoch.curr <= self._last_epoch:
            raise AssertionError(
                f"epoch regression: {barrier.epoch.curr} after "
                f"{self._last_epoch} at {self.identity}")
        self._last_epoch = barrier.epoch.curr
        if False:  # pragma: no cover - async generator shape
            yield


class SchemaCheckExecutor(_CheckExecutor):
    """Every chunk's column count and dtypes must match the schema."""

    def check(self, chunk: StreamChunk) -> None:
        if len(chunk.columns) != len(self.schema):
            raise AssertionError(
                f"schema check at {self.identity}: chunk has "
                f"{len(chunk.columns)} columns, schema has "
                f"{len(self.schema)}")
        for i, (col, field) in enumerate(zip(chunk.columns, self.schema)):
            if col.data.dtype != field.type.dtype:
                raise AssertionError(
                    f"schema check at {self.identity}: column {i} "
                    f"({field.name}) is {col.data.dtype}, schema says "
                    f"{field.type.dtype}")


class UpdateCheckExecutor(_CheckExecutor):
    """An UpdateDelete must be followed at once by an UpdateInsert within
    its chunk (one host copy of the visible ops per chunk)."""

    def check(self, chunk: StreamChunk) -> None:
        ops = chunk.ops[chunk.vis].tolist()
        pending_ud = False
        for op in ops:
            if pending_ud and op != OP_UPDATE_INSERT:
                raise AssertionError(
                    f"U- not followed by U+ at {self.identity}")
            pending_ud = op == OP_UPDATE_DELETE
        if pending_ud:
            raise AssertionError(
                f"chunk ends with dangling U- at {self.identity}")
