"""HopWindowExecutor — HOP (sliding) window expansion.

Counterpart of ``risingwave_tpu/stream/hop_window.py``. Each row falls into
``n = window_size / window_slide`` hop windows; a chunk expands into n
chunks of the same capacity, one per hop offset, earliest window first,
visibility-masked. Output schema: the input columns, then ``window_start``
and ``window_end`` (TIMESTAMP).

The reference drops a hop chunk with no visible row, which reads the device
once per hop. Here every hop chunk goes on, so the expansion reads nothing
back: with ``window_size`` a multiple of ``window_slide`` every visible row
with a non-NULL time lies in all n of its candidate windows, so no hop chunk
of a chunk with such a row is empty. A ChunkBatch of K chunks expands into
one ChunkBatch of n·K chunks in the reference's order (the hop offset
inside the chunk).
"""

from __future__ import annotations

import torch

from ..common.chunk import (
    ChunkBatch, Column, StreamChunk, interleave_chunks,
)
from ..common.types import TIMESTAMP, Field, Schema
from .executor import Executor, SingleInputExecutor


class HopWindowExecutor(SingleInputExecutor):
    identity = "HopWindow"

    def __init__(self, input: Executor, time_col: int, window_slide: int,
                 window_size: int):
        super().__init__(input)
        if window_size % window_slide != 0:
            raise ValueError(
                f"window_size {window_size} must be a multiple of "
                f"window_slide {window_slide}")
        self.time_col = time_col
        self.slide = window_slide
        self.size = window_size
        self.n_windows = window_size // window_slide
        self.schema = Schema(tuple(input.schema) + (
            Field("window_start", TIMESTAMP), Field("window_end", TIMESTAMP)))

    def _expand(self, chunk: StreamChunk) -> list[StreamChunk]:
        """The n hop chunks of ``chunk`` ([C] or [K, C] tensors), earliest
        window first. The first candidate start is ``floor(ts / slide) *
        slide - (n - 1) * slide`` (floor division: negative timestamps
        round down)."""
        col = chunk.columns[self.time_col]
        ts = col.data.long()
        base = torch.div(ts, self.slide, rounding_mode="floor") * self.slide
        outs = []
        for i in range(self.n_windows):
            ws = base - (self.n_windows - 1 - i) * self.slide
            we = ws + self.size
            valid = col.mask & (ts < we) & (ts >= ws)
            outs.append(chunk.replace(
                vis=chunk.vis & valid,
                columns=chunk.columns + (Column(ws, valid),
                                         Column(we, valid))))
        return outs

    async def map_chunk(self, chunk: StreamChunk):
        for out in self._expand(chunk):
            yield out

    async def map_chunk_batch(self, batch: ChunkBatch):
        yield interleave_chunks(self._expand(batch.chunk))
