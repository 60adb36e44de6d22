"""Concurrent backfill: an MV over a table, created while the table keeps
changing.

Counterpart of ``risingwave_tpu/stream/backfill.py::BackfillExecutor``.
The upstream's StateTable is the snapshot: each barrier reads at most
``batch_rows`` rows after the pk cursor (the table's current merged view,
so a later read sees what was committed since) and emits them before the
barrier. Live deltas from the upstream's changelog pass only for the pk
range already read; a row past the cursor reaches the MV through a later
read. That filter is one lexicographic compare of the pk tuple against the
cursor's pk values per chunk, on the card, with no host sync (VARCHAR pk
columns compare by the dictionary's ranks); a chunk or ChunkBatch keeps
its shape, its rows past the cursor made invisible.

The cursor, its pk values and the done flag persist in a progress table at
checkpoints, so a recovered backfill resumes where it stopped, or passes
deltas straight through once done.
"""

from __future__ import annotations

import json
from typing import Optional

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import ChunkBatch, StreamChunk, physical_chunk
from ..common.types import (
    GLOBAL_STRING_DICT, INT64, VARCHAR, Field, Schema, rank_of,
)
from ..storage.state_table import StateTable
from .executor import Executor
from .message import Barrier, Watermark

#: progress row: (id, done, cursor hex, cursor pk values as JSON,
#: rows_done). The pk VALUES are kept beside the encoded cursor so that a
#: resumed backfill filters deltas at exactly the snapshot's boundary:
#: derived again from the rows that survive, they would fall below the
#: cursor when the row at the cursor was deleted, and hide the deltas in
#: between.
PROGRESS_SCHEMA = Schema((
    Field("id", INT64), Field("done", INT64),
    Field("cursor", VARCHAR), Field("cursor_pks", VARCHAR),
    Field("rows_done", INT64),
))


class BackfillExecutor(Executor):
    """``input``: the live deltas (a queue subscribed to the upstream's
    bus). ``upstream_table``: the upstream table's or MV's StateTable."""

    identity = "Backfill"

    def __init__(
        self,
        input: Executor,
        upstream_table: StateTable,
        batch_rows: int = 4096,
        chunk_capacity: int = 1024,
        progress_table: Optional[StateTable] = None,
        on_progress=None,
        device=DEFAULT_DEVICE,
    ):
        self.input = input
        self.schema = upstream_table.schema
        self.upstream = upstream_table
        self.pk_indices = tuple(upstream_table.pk_indices)
        self.batch_rows = batch_rows
        self.chunk_capacity = chunk_capacity
        self.progress_table = progress_table
        self.on_progress = on_progress
        self.device = torch.device(device)
        self.cursor: Optional[bytes] = None
        self.cursor_row: Optional[tuple] = None   # pk values at the cursor
        self.done = False
        self.rows_done = 0
        self._pk_types = [self.schema[i].type for i in self.pk_indices]
        if progress_table is not None:
            rows = list(progress_table.scan_all())
            if rows:
                _id, done, cur_hex, cur_pks, rows_done = rows[0]
                self.done = bool(done)
                self.rows_done = int(rows_done)
                cur = VARCHAR.to_python(cur_hex)
                self.cursor = bytes.fromhex(cur) if cur else None
                pks = VARCHAR.to_python(cur_pks)
                if pks:
                    # logical values (dictionary ids differ by process)
                    self.cursor_row = tuple(
                        t.to_physical(v)
                        for t, v in zip(self._pk_types, json.loads(pks)))

    # -- delta filtering ---------------------------------------------------

    def _filter_delta(self, chunk: StreamChunk) -> StreamChunk:
        """The chunk with its rows past the cursor made invisible (works
        on a chunk's [C] tensors and on a ChunkBatch's [K, C] alike)."""
        if self.cursor_row is None:
            return chunk.mask_vis(torch.zeros_like(chunk.vis))
        lt = torch.zeros_like(chunk.vis)
        eq = torch.ones_like(chunk.vis)
        ranks = host_ranks = None
        for pos, i in enumerate(self.pk_indices):
            d = chunk.columns[i].data
            cur = self.cursor_row[pos]
            if self._pk_types[pos].is_string:
                if ranks is None:
                    ranks = GLOBAL_STRING_DICT.device_ranks(d.device)
                    host_ranks = GLOBAL_STRING_DICT.ranks()
                d = rank_of(ranks, d)
                cur = int(host_ranks[cur])
            lt = lt | (eq & (d < cur))
            eq = eq & (d == cur)
        return chunk.mask_vis(lt | eq)

    # -- snapshot reads ----------------------------------------------------

    def _emit_batch(self):
        rows, last = self.upstream.scan_after(self.cursor, self.batch_rows)
        if rows:
            self.cursor = last
            self.cursor_row = tuple(rows[-1][i] for i in self.pk_indices)
            self.rows_done += len(rows)
        if len(rows) < self.batch_rows:
            self.done = True
        cap = self.chunk_capacity
        for i in range(0, len(rows), cap):
            yield physical_chunk(self.schema, rows[i:i + cap], cap,
                                 self.device)

    def _persist(self, epoch: int) -> None:
        if self.progress_table is None:
            return
        cur_hex = self.cursor.hex() if self.cursor is not None else ""
        pks = "" if self.cursor_row is None else json.dumps(
            [t.to_python(v) for t, v in zip(self._pk_types, self.cursor_row)])
        self.progress_table.insert(
            (0, int(self.done), VARCHAR.to_physical(cur_hex),
             VARCHAR.to_physical(pks), self.rows_done))
        self.progress_table.commit(epoch)

    @property
    def progress(self) -> dict:
        return {"rows_done": self.rows_done, "done": self.done,
                "total_estimate": len(self.upstream)}

    # -- main loop ---------------------------------------------------------

    async def execute(self):
        async for msg in self.input.execute():
            if isinstance(msg, StreamChunk):
                yield msg if self.done else self._filter_delta(msg)
            elif isinstance(msg, ChunkBatch):
                yield msg if self.done else ChunkBatch(
                    self._filter_delta(msg.chunk))
            elif isinstance(msg, Barrier):
                if not self.done:
                    for out in self._emit_batch():
                        yield out
                    if self.on_progress is not None:
                        self.on_progress(self.progress)
                if msg.checkpoint:
                    self._persist(msg.epoch.curr)
                yield msg
                if msg.is_stop():
                    return
            elif isinstance(msg, Watermark):
                yield msg
