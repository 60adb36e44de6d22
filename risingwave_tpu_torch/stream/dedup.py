"""AppendOnlyDedupExecutor — drop duplicate pks from an append-only stream.

Counterpart of ``risingwave_tpu/stream/dedup.py``. The seen-key set is a
device hash table; a chunk dedups in one find-or-insert (kernel B3 on the
card), whose winner among the rows of one new key is the lowest row, so
``is_new`` keeps the FIRST row of each key: SQL's keep-first. Applying a
chunk reads nothing back to the host; a barrier reads the sticky flags
once. The durable row is the pk values only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import OP_INSERT, ChunkBatch, StreamChunk
from ..common.types import Schema
from ..ops.hash_table import hit_mask, ht_lookup_or_insert, ht_new
from ..ops.row_set import reload_chunks, write_rows
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier


class AppendOnlyDedupExecutor(SingleInputExecutor):
    identity = "AppendOnlyDedup"

    def __init__(self, input: Executor, pk_indices: Sequence[int],
                 state_table: Optional[StateTable] = None,
                 table_capacity: int = 1 << 16, device=DEFAULT_DEVICE):
        super().__init__(input)
        self.schema = input.schema
        self.pk_indices = tuple(pk_indices)
        self.capacity = table_capacity
        self.state_table = state_table
        self.device = device
        pk_types = [input.schema[i].type for i in self.pk_indices]
        self.table = ht_new(pk_types, table_capacity, device)
        self.ckpt_dirty = torch.zeros(table_capacity, dtype=torch.bool,
                                      device=device)
        self.overflow = torch.zeros((), dtype=torch.bool, device=device)
        self.saw_delete = torch.zeros((), dtype=torch.bool, device=device)
        if state_table is not None:
            self._load_from_state_table()

    def _step(self, chunk: StreamChunk) -> torch.Tensor:
        """Find-or-insert the chunk's keys; the rows to keep (in place)."""
        keys = [chunk.columns[i] for i in self.pk_indices]
        _, slots, is_new, ovf = ht_lookup_or_insert(self.table, keys,
                                                    chunk.vis)
        self.ckpt_dirty |= hit_mask(
            torch.where(is_new, slots, self.capacity), self.capacity)
        self.overflow |= ovf
        self.saw_delete |= (chunk.vis & (chunk.ops != OP_INSERT)).any()
        return is_new

    async def map_chunk(self, chunk: StreamChunk):
        yield chunk.mask_vis(self._step(chunk))

    async def map_chunk_batch(self, batch: ChunkBatch):
        keep = torch.stack([self._step(batch.at(i))
                            for i in range(batch.num_chunks)])
        yield ChunkBatch(batch.chunk.mask_vis(keep))

    async def on_barrier(self, barrier: Barrier):
        overflow, saw_delete = torch.stack(
            [self.overflow, self.saw_delete]).tolist()
        if overflow:
            raise RuntimeError(f"{self.identity}: key table overflow "
                               f"(capacity {self.capacity})")
        if saw_delete:
            raise RuntimeError(f"{self.identity}: non-insert op on "
                               "append-only input")
        if barrier.checkpoint and self.state_table is not None:
            self._checkpoint(barrier.epoch.curr)
        if False:
            yield

    def _checkpoint(self, epoch: int) -> None:
        idx = self.ckpt_dirty.nonzero().squeeze(1)
        if idx.numel():
            from .hash_agg import host_rows
            k = len(self.pk_indices)
            host = host_rows([d[idx] for d in self.table.key_data]
                             + [m[idx] for m in self.table.key_mask])
            write_rows(self.state_table, host[:k], host[k:],
                       np.ones(idx.numel(), bool))
            self.state_table.commit(epoch)
        self.ckpt_dirty.zero_()

    def _load_from_state_table(self) -> None:
        pk_schema = Schema(tuple(self.schema[i] for i in self.pk_indices))
        rows = list(self.state_table.scan_all())
        for chunk in reload_chunks(pk_schema, rows, self.device):
            _, _, _, ovf = ht_lookup_or_insert(self.table, chunk.columns,
                                               chunk.vis)
            if bool(ovf):
                raise RuntimeError("dedup table overflow during recovery")
        self.ckpt_dirty.zero_()
