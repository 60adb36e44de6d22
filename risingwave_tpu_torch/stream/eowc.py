"""Watermark machinery: WatermarkFilter, Sort (emit-on-window-close), Now.

Counterpart of ``risingwave_tpu/stream/eowc.py``:

  * WatermarkFilter: tracks max(event_time) on the device and drops late
    rows (ts < the watermark so far); the watermark ``max - delay`` goes
    downstream once per barrier, just before it, when it advanced (the
    reference reads it after every chunk and sends each advance at once;
    every consumer acts on it only at the barrier);
  * SortExecutor: buffers rows in the device row set (``ops/row_set.py``,
    pk upserts through kernel B3) and, at each barrier after a watermark,
    emits the rows with ts <= watermark in (ts, pk) order, then frees them;
    once half its slots hold keys it rebuilds the set from the rows it
    still needs, so its capacity bounds the rows held, not the rows seen;
  * NowExecutor: a one-column ``now()`` changelog and watermark per
    barrier.

Applying a chunk reads nothing back to the host; a barrier reads one small
tensor.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    DEFAULT_CHUNK_CAPACITY, OP_DELETE, OP_INSERT, OP_UPDATE_DELETE,
    OP_UPDATE_INSERT, ChunkBatch, Column, StreamChunk, physical_chunk,
)
from ..common.types import TIMESTAMP, Schema
from ..ops.hash_table import set_rows
from ..ops.row_set import reload_chunks, rs_apply_chunk, rs_checkpoint, rs_new
from ..ops.topn import OrderSpec, topn_order
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier, Watermark

_I64_MIN = torch.iinfo(torch.int64).min


class WatermarkFilterExecutor(SingleInputExecutor):
    """``delay``: the watermark's lag behind the max event time seen (the
    out-of-orderness bound). A row is late, and dropped, when its time is
    below the watermark of the rows before it; a row never falls below the
    watermark it advances. Belongs right after a source (insert-only)."""

    identity = "WatermarkFilter"

    def __init__(self, input: Executor, time_col: int, delay: int,
                 state_table: Optional[StateTable] = None,
                 device=DEFAULT_DEVICE):
        super().__init__(input)
        self.schema = input.schema
        self.time_col = time_col
        self.delay = delay
        self.state_table = state_table
        #: the watermark on the device; ``announced`` is the last value sent
        self.current_wm = torch.tensor(_I64_MIN, dtype=torch.int64,
                                       device=device)
        self.announced = _I64_MIN
        if state_table is not None:
            rows = list(state_table.scan_all())
            if rows and rows[0][1] is not None:
                self.current_wm.fill_(rows[0][1])
                self.announced = rows[0][1]

    def _filter(self, chunk: StreamChunk) -> StreamChunk:
        """``chunk`` ([K, C] or [C] tensors) with its late rows dropped, each
        chunk against the watermark of every chunk before it; advances
        ``current_wm``. A chunk with no valid row leaves the watermark
        where it is."""
        col = chunk.columns[self.time_col]
        ts = col.data.long().reshape(-1, chunk.vis.shape[-1])
        valid = (chunk.vis & col.mask).reshape(ts.shape)
        chunk_max = torch.where(valid, ts, _I64_MIN).amax(1)
        advance = torch.where(valid.any(1), chunk_max - self.delay, _I64_MIN)
        after = torch.maximum(torch.cummax(advance, 0).values,
                              self.current_wm)
        before = torch.cat([self.current_wm.reshape(1), after[:-1]])
        keep = valid & (ts >= before[:, None])
        self.current_wm = after[-1]
        return chunk.mask_vis(keep.reshape(chunk.vis.shape))

    async def map_chunk(self, chunk: StreamChunk):
        yield self._filter(chunk)

    async def map_chunk_batch(self, batch: ChunkBatch):
        yield ChunkBatch(self._filter(batch.chunk))

    async def on_barrier(self, barrier: Barrier):
        wm = int(self.current_wm)
        if wm > self.announced:
            self.announced = wm
            yield Watermark(self.time_col, wm)
        if barrier.checkpoint and self.state_table is not None:
            self.state_table.insert((0, None if wm == _I64_MIN else wm))
            self.state_table.commit(barrier.epoch.curr)


class SortExecutor(SingleInputExecutor):
    """EOWC sort: emits buffered rows in (time, pk) order once the
    watermark passes them. Input must be append-only (EOWC contract).

    ``max_live``: the most rows held at any barrier (the row set's
    high-water mark; rows only arrive between barriers)."""

    identity = "Sort"

    def __init__(self, input: Executor, time_col: int,
                 pk_indices: Sequence[int],
                 state_table: Optional[StateTable] = None,
                 table_capacity: int = 1 << 16,
                 out_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 device=DEFAULT_DEVICE):
        super().__init__(input)
        self.schema = input.schema
        self.time_col = time_col
        self.pk_indices = tuple(pk_indices)
        self.capacity = table_capacity
        self.out_capacity = out_capacity
        self.state_table = state_table
        self.device = device
        pk_types = [input.schema[i].type for i in self.pk_indices]
        col_types = [f.type for f in input.schema]
        self.rows = rs_new(pk_types, col_types, table_capacity, device)
        self.order = (OrderSpec(time_col),) + tuple(
            OrderSpec(i) for i in self.pk_indices if i != time_col)
        self._pending_wm: Optional[int] = None
        self.max_live = 0
        if state_table is not None:
            self._load_from_state_table()

    async def map_chunk(self, chunk: StreamChunk):
        rs_apply_chunk(self.rows, chunk, self.pk_indices)
        if False:
            yield

    async def map_chunk_batch(self, batch: ChunkBatch):
        for i in range(batch.num_chunks):
            rs_apply_chunk(self.rows, batch.at(i), self.pk_indices)
        if False:
            yield

    async def on_watermark(self, watermark: Watermark):
        if watermark.col_idx == self.time_col:
            self._pending_wm = watermark.value
        yield watermark

    def _close(self, wm: int):
        """(ripe per slot, sort permutation, inclusive count of ripe slots
        along it)."""
        rows = self.rows
        col = rows.cols[self.time_col]
        ripe = rows.live & col.mask & (col.data.long() <= wm)
        perm = topn_order(rows, torch.zeros_like(rows.live, dtype=torch.int32),
                          self.order)
        return ripe, perm, torch.cumsum(ripe[perm], 0)

    def _gather(self, perm: torch.Tensor, count: torch.Tensor,
                lo: int) -> StreamChunk:
        """Ripe rows of sort rank [lo, lo + out_capacity) as one Insert
        chunk: output row g reads the slot where the count along the sort
        order first reaches lo + g + 1 (no store through a shared cell)."""
        C = self.out_capacity
        g = lo + torch.arange(C, dtype=torch.int64, device=perm.device)
        valid = g < count[-1]
        pos = torch.searchsorted(count, g + 1).clamp_max(count.shape[0] - 1)
        slot = perm[pos]

        def take(a: torch.Tensor) -> torch.Tensor:
            return torch.where(valid, a[slot],
                               torch.zeros((), dtype=a.dtype, device=a.device))

        return StreamChunk(
            torch.zeros(C, dtype=torch.int8, device=perm.device), valid,
            tuple(Column(take(c.data), take(c.mask)) for c in self.rows.cols))

    async def on_barrier(self, barrier: Barrier):
        rows = self.rows
        wm, self._pending_wm = self._pending_wm, None
        stats = [rows.overflow.long(), rows.live.sum()]
        if wm is not None:
            ripe, perm, count = self._close(wm)
            stats.append(count[-1])
        overflow, n_live, n_keys, *n_ripe = torch.stack(
            stats[:2] + [rows.table.occupied.sum()] + stats[2:]).tolist()
        if overflow:
            raise RuntimeError(f"{self.identity}: sort buffer overflow "
                               f"(capacity {self.capacity})")
        self.max_live = max(self.max_live, n_live)
        if wm is not None:
            for lo in range(0, n_ripe[0], self.out_capacity):
                yield self._gather(perm, count, lo)
            rows.live &= ~ripe
            rows.ckpt_dirty |= ripe
        if barrier.checkpoint and self.state_table is not None:
            rs_checkpoint(rows, self.state_table, barrier.epoch.curr)
        if 2 * n_keys > self.capacity:
            self._compact()

    def _compact(self) -> None:
        """Rebuild the row set from the rows it must keep: the live ones and
        those whose delete the next checkpoint still owes. An emitted row's
        pk never comes back, so without this its key would hold a slot for
        good (the reference's Sort does not free them, and fills up after
        ``capacity`` rows in all). The kept rows go in through kernel B3 in
        slot order; their live and checkpoint marks are carried over."""
        old = self.rows
        keep = old.live | (old.ckpt_dirty if self.state_table is not None
                           else torch.zeros_like(old.live))
        idx = keep.nonzero().squeeze(1)
        n = idx.numel()
        self.rows = rs_new([self.schema[i].type for i in self.pk_indices],
                           [f.type for f in self.schema], self.capacity,
                           self.device)
        if n:
            live = old.live[idx]
            chunk = StreamChunk(
                torch.where(live, OP_INSERT, OP_DELETE).to(torch.int8),
                torch.ones(n, dtype=torch.bool, device=idx.device),
                tuple(Column(c.data[idx], c.mask[idx]) for c in old.cols))
            _, slots, applied = rs_apply_chunk(self.rows, chunk,
                                               self.pk_indices)
            self.rows.ckpt_dirty.zero_()
            set_rows(self.rows.ckpt_dirty, slots, applied,
                     old.ckpt_dirty[idx])
        self.rows.overflow |= old.overflow
        self.rows.saw_delete.copy_(old.saw_delete)

    def _load_from_state_table(self) -> None:
        rows = list(self.state_table.scan_all())
        for chunk in reload_chunks(self.schema, rows, self.device):
            rs_apply_chunk(self.rows, chunk, self.pk_indices)
        self.rows.ckpt_dirty.zero_()


class NowExecutor(Executor):
    """Emits the clock of each barrier as a one-row changelog and a
    watermark (the ``now()`` lower bound of temporal filters). ``clock``:
    epoch -> microseconds; the default is a synthetic monotone clock,
    ``epoch * 1_000_000``, so runs are deterministic."""

    identity = "Now"

    def __init__(self, barrier_source: Executor,
                 clock: Optional[Callable[[int], int]] = None,
                 device=DEFAULT_DEVICE):
        self._barriers = barrier_source
        self.schema = Schema.of(("now", TIMESTAMP))
        self._clock = clock or (lambda epoch: epoch * 1_000_000)
        self._last: Optional[int] = None
        self.device = device

    async def execute(self):
        async for msg in self._barriers.execute():
            if not isinstance(msg, Barrier):
                continue
            now = self._clock(msg.epoch.curr)
            if self._last is None:
                chunk = physical_chunk(self.schema, [(now,)], 2, self.device)
            else:
                chunk = physical_chunk(self.schema, [(self._last,), (now,)],
                                       2, self.device)
                chunk = chunk.replace(ops=torch.tensor(
                    [OP_UPDATE_DELETE, OP_UPDATE_INSERT], dtype=torch.int8,
                    device=self.device))
            self._last = now
            yield chunk
            yield Watermark(0, now)
            yield msg
            if msg.is_stop():
                return
