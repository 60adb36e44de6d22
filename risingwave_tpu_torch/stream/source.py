"""Source executors: a scripted sequence of messages, and a pull source
with barriers on a schedule.

Counterpart of ``risingwave_tpu/stream/source.py``: ``MockSource`` replays
a script; ``ScheduledSource`` pulls chunks from a generator and injects a
barrier every ``chunks_per_epoch`` chunks, every
``checkpoint_frequency``-th of them a checkpoint.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Callable, Iterable, Optional

from ..common.chunk import StreamChunk
from ..common.types import Schema
from .executor import Executor
from .message import Barrier, Message, Mutation, MutationKind


class MockSource(Executor):
    identity = "MockSource"

    def __init__(self, schema: Schema, messages: Iterable[Message]):
        self.schema = schema
        self._messages = list(messages)

    def reset(self, messages: Iterable[Message]) -> None:
        """Swap in a fresh message script so a built pipeline can be driven
        again."""
        self._messages = list(messages)

    async def execute(self) -> AsyncIterator[Message]:
        for m in self._messages:
            yield m
            await asyncio.sleep(0)


class ScheduledSource(Executor):
    """Pulls chunks from ``generator`` (a callable returning a StreamChunk,
    or None when exhausted) and injects a barrier every
    ``chunks_per_epoch`` chunks; every ``checkpoint_frequency``-th barrier
    is a checkpoint. An initial barrier opens the first epoch before any
    data; exhaustion, or ``stop_after_epochs`` barriers, ends the stream
    with a STOP barrier."""

    identity = "ScheduledSource"

    def __init__(
        self,
        schema: Schema,
        generator: Callable[[], Optional[StreamChunk]],
        chunks_per_epoch: int = 8,
        checkpoint_frequency: int = 10,
        first_epoch: int = 1,
        stop_after_epochs: Optional[int] = None,
    ):
        self.schema = schema
        self._gen = generator
        self._chunks_per_epoch = chunks_per_epoch
        self._checkpoint_frequency = checkpoint_frequency
        self._epoch = first_epoch
        self._stop_after = stop_after_epochs

    def _stop(self) -> Barrier:
        return Barrier.new(self._epoch + 1, checkpoint=True,
                           mutation=Mutation(MutationKind.STOP))

    async def execute(self) -> AsyncIterator[Message]:
        n_barriers = 0
        yield Barrier.new(self._epoch, checkpoint=False)
        while True:
            for _ in range(self._chunks_per_epoch):
                chunk = self._gen()
                if chunk is None:
                    yield self._stop()
                    return
                yield chunk
                await asyncio.sleep(0)
            self._epoch += 1
            n_barriers += 1
            yield Barrier.new(
                self._epoch,
                checkpoint=n_barriers % self._checkpoint_frequency == 0)
            if self._stop_after is not None and n_barriers >= self._stop_after:
                yield self._stop()
                return
