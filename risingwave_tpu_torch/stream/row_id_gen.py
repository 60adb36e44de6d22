"""RowIdGenExecutor — assign serial row ids to source rows.

Counterpart of ``risingwave_tpu/stream/row_id_gen.py``: the hidden
``_row_id`` pk column of a source, ``id = seq``, ``seq`` a device counter
that starts at ``start_seq`` and grows by one per visible row (the
reference's ids of shard 0; nothing here shards a source). No host sync:
the counter stays on the device, and a ChunkBatch is numbered in one step,
chunk after chunk, as its chunks would be one by one. A source recovered
mid-stream passes a ``start_seq`` above every id its state holds.
"""

from __future__ import annotations

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import ChunkBatch, Column, StreamChunk
from .executor import Executor, SingleInputExecutor


class RowIdGenExecutor(SingleInputExecutor):
    identity = "RowIdGen"

    def __init__(self, input: Executor, row_id_index: int,
                 start_seq: int = 0, device=DEFAULT_DEVICE):
        super().__init__(input)
        self.schema = input.schema
        self.row_id_index = row_id_index
        self.seq = torch.tensor(start_seq, dtype=torch.int64, device=device)

    def _number(self, chunk: StreamChunk) -> StreamChunk:
        """``chunk`` ([C] or [K, C] tensors) with its visible rows numbered
        in row-major order from ``seq``; advances ``seq``."""
        vis = chunk.vis.reshape(-1)
        offset = torch.cumsum(vis, 0) - vis.long()
        ids = (self.seq + offset).reshape(chunk.vis.shape)
        self.seq = self.seq + vis.sum()
        cols = list(chunk.columns)
        cols[self.row_id_index] = Column(ids, torch.ones_like(chunk.vis))
        return chunk.with_columns(cols)

    async def map_chunk(self, chunk: StreamChunk):
        yield self._number(chunk)

    async def map_chunk_batch(self, batch: ChunkBatch):
        yield ChunkBatch(self._number(batch.chunk))
