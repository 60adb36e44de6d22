"""ExpandExecutor — row expansion for grouping sets and distinct aggregates.

Counterpart of ``risingwave_tpu/stream/expand.py``: each input row is
replicated once per column subset, the columns outside the subset nulled
and a ``flag`` column naming the subset, as one chunk per subset of the
input's capacity, in subset order. A ChunkBatch expands into one ChunkBatch
with the subsets inside each chunk.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..common.chunk import (
    ChunkBatch, Column, StreamChunk, interleave_chunks,
)
from ..common.types import INT64, Field, Schema
from .executor import Executor, SingleInputExecutor


class ExpandExecutor(SingleInputExecutor):
    identity = "Expand"

    def __init__(self, input: Executor,
                 column_subsets: Sequence[Sequence[int]]):
        super().__init__(input)
        self.subsets = [tuple(s) for s in column_subsets]
        self.schema = Schema(tuple(input.schema) + (Field("flag", INT64),))

    def _expand(self, chunk: StreamChunk) -> list[StreamChunk]:
        outs = []
        for flag, subset in enumerate(self.subsets):
            cols = [c if ci in subset
                    else Column(c.data, torch.zeros_like(c.mask))
                    for ci, c in enumerate(chunk.columns)]
            cols.append(Column(torch.full_like(chunk.vis, flag,
                                               dtype=torch.int64),
                               torch.ones_like(chunk.vis)))
            outs.append(chunk.with_columns(cols))
        return outs

    async def map_chunk(self, chunk: StreamChunk):
        for out in self._expand(chunk):
            yield out

    async def map_chunk_batch(self, batch: ChunkBatch):
        yield interleave_chunks(self._expand(batch.chunk))
