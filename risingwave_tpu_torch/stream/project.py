"""Project and Filter executors (stateless).

Counterparts of ``risingwave_tpu/stream/project.py``. Filter keeps update
pairs consistent as the reference does: if a filter drops one row of a
U-/U+ pair, the other degrades to a plain Delete/Insert.

Both take a ChunkBatch in one step: the expressions are elementwise, so they
run once over the flat [K*C] view of the batch's columns, and the result is
reshaped back to [K, C] (the reference ``vmap``s its step over the batch).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, ChunkBatch,
    StreamChunk, flatten_shards, map_tensors,
)
from ..common.types import Field, Schema
from ..expr.expr import Expr, FunctionCall, InputRef, Literal
from .executor import Executor, SingleInputExecutor
from .message import Watermark

# Expressions monotone in their watermark column: tumble_start carries
# source watermarks onto window-start group keys.
_MONOTONE_FNS = {"tumble_start"}


def derive_watermark(expr: Expr, wm: Watermark):
    """Map an input watermark through one output expression; None if the
    expression does not preserve the watermark order."""
    if isinstance(expr, InputRef):
        return wm.value if expr.index == wm.col_idx else None
    if (isinstance(expr, FunctionCall) and expr.name in _MONOTONE_FNS
            and expr.args and isinstance(expr.args[0], InputRef)
            and expr.args[0].index == wm.col_idx
            and all(isinstance(a, Literal) for a in expr.args[1:])):
        if not isinstance(wm.value, int):
            return None
        from ..common.chunk import Column
        cols = tuple(
            Column(torch.full((1,), wm.value if i == wm.col_idx else 0,
                              dtype=torch.int64),
                   torch.ones(1, dtype=torch.bool))
            for i in range(wm.col_idx + 1))
        one = StreamChunk(torch.zeros(1, dtype=torch.int8),
                          torch.ones(1, dtype=torch.bool), cols)
        res = expr.eval(one)
        if bool(res.mask[0]):
            return res.data[0].item()
    return None


class ProjectExecutor(SingleInputExecutor):
    identity = "Project"

    def __init__(self, input: Executor, exprs: Sequence[Expr],
                 names: Sequence[str] = ()):
        super().__init__(input)
        self.exprs = tuple(exprs)
        names = tuple(names) or tuple(f"expr{i}" for i in range(len(exprs)))
        self.schema = Schema(tuple(Field(n, e.type)
                                   for n, e in zip(names, self.exprs)))

    async def map_chunk(self, chunk: StreamChunk):
        yield chunk.with_columns(tuple(e.eval(chunk) for e in self.exprs))

    async def map_chunk_batch(self, batch: ChunkBatch):
        k, c = batch.num_chunks, batch.chunk_capacity
        flat = flatten_shards(batch.chunk)
        out = flat.with_columns(tuple(e.eval(flat) for e in self.exprs))
        yield ChunkBatch(map_tensors(out, lambda a: a.reshape(k, c)))

    async def on_watermark(self, watermark: Watermark):
        for i, e in enumerate(self.exprs):
            v = derive_watermark(e, watermark)
            if v is not None:
                yield Watermark(i, v)


class FilterExecutor(SingleInputExecutor):
    identity = "Filter"

    def __init__(self, input: Executor, predicate: Expr):
        super().__init__(input)
        self.schema = input.schema
        self.predicate = predicate

    def _keep(self, chunk: StreamChunk) -> torch.Tensor:
        cond = self.predicate.eval(chunk)
        return cond.data & cond.mask  # NULL -> filtered out (SQL WHERE)

    @staticmethod
    def _filtered(chunk: StreamChunk, keep: torch.Tensor) -> StreamChunk:
        """``chunk`` with ``keep`` applied along its last axis (rows of a
        chunk, or of each chunk of a batch): a U- or U+ whose partner is
        dropped degrades to a Delete or Insert."""
        ops = chunk.ops
        is_ud = ops == OP_UPDATE_DELETE
        is_ui = ops == OP_UPDATE_INSERT
        partner_kept = torch.roll(keep, -1, -1)       # U-: its U+ follows
        partner_kept_prev = torch.roll(keep, 1, -1)   # U+: its U- precedes
        new_ops = torch.where(
            is_ud & ~partner_kept, torch.full_like(ops, OP_DELETE),
            torch.where(is_ui & ~partner_kept_prev,
                        torch.full_like(ops, OP_INSERT), ops))
        return chunk.replace(ops=new_ops, vis=chunk.vis & keep)

    async def map_chunk(self, chunk: StreamChunk):
        yield self._filtered(chunk, self._keep(chunk))

    async def map_chunk_batch(self, batch: ChunkBatch):
        keep = self._keep(flatten_shards(batch.chunk))
        yield ChunkBatch(self._filtered(batch.chunk,
                                        keep.reshape(batch.chunk.vis.shape)))
