"""Device-resident row set with diff-based delta emission.

Counterpart of ``risingwave_tpu/ops/row_set.py``: the shared core of the
executors whose state is a set of rows keyed by pk, from which a derived
subset is emitted downstream — TopN (the rank window) and DynamicFilter
(the rows that pass the bound).

  * rows live in slot-indexed column tensors behind a pk hash table (kernel
    B3 on the card); ``live`` marks deletions (a slot is reused when its pk
    comes back, never compacted);
  * within a chunk the last writer of a pk wins: a scatter-max of row
    indices picks it, so a Delete then an Insert of one pk leaves the row;
  * at a flush the executor supplies ``in_set`` (bool per slot, any
    membership rule); the core diffs it against what was last emitted
    (membership flag + value copy) and gathers Insert / Delete / U-,U+
    delta chunks in slot order, as the reference does.

Applying a chunk reads nothing back to the host. The state is updated in
place.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, Column,
    StreamChunk, physical_chunk,
)
from .hash_table import (
    DeviceHashTable, hit_mask, ht_lookup_or_insert, ht_new, scatter_reduce,
    set_rows,
)

#: rows per chunk of a recovery reload
LOAD_BATCH = 1024


@dataclasses.dataclass
class RowSetState:
    table: DeviceHashTable             # keyed by the pk columns
    live: torch.Tensor                 # bool[cap]: the row exists now
    cols: tuple[Column, ...]           # stored rows, [cap] per column
    emitted: torch.Tensor              # bool[cap]: in the set at last flush
    emitted_cols: tuple[Column, ...]   # values as of the last emission
    ckpt_dirty: torch.Tensor           # bool[cap]: touched since checkpoint
    overflow: torch.Tensor             # bool scalar, sticky
    saw_delete: torch.Tensor           # bool scalar, sticky

    @property
    def capacity(self) -> int:
        return self.live.shape[0]


def _zero_cols(col_types, capacity: int, device) -> tuple[Column, ...]:
    return tuple(Column(torch.zeros(capacity, dtype=t.dtype, device=device),
                        torch.zeros(capacity, dtype=torch.bool, device=device))
                 for t in col_types)


def rs_new(pk_types: Sequence, col_types: Sequence, capacity: int,
           device=DEFAULT_DEVICE) -> RowSetState:
    def flag(n=capacity):
        return torch.zeros(n, dtype=torch.bool, device=device)

    return RowSetState(
        table=ht_new(pk_types, capacity, device),
        live=flag(), cols=_zero_cols(col_types, capacity, device),
        emitted=flag(),
        emitted_cols=_zero_cols(col_types, capacity, device),
        ckpt_dirty=flag(),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        saw_delete=torch.zeros((), dtype=torch.bool, device=device))


def rs_apply_chunk(state: RowSetState, chunk: StreamChunk,
                   pk_indices: Sequence[int]):
    """Upsert/delete a chunk of rows (in place, no host sync). Returns
    ``(state, slots, applied)``: ``slots`` int64[N] per input row (the
    capacity when invisible or overflowed), ``applied`` bool[N] — the
    winning writer rows whose values landed in the table."""
    cap = state.capacity
    pk_cols = [chunk.columns[i] for i in pk_indices]
    _, slots, _, ovf = ht_lookup_or_insert(state.table, pk_cols, chunk.vis)
    n = chunk.capacity
    row_ids = torch.arange(n, dtype=torch.int64, device=slots.device)
    # last writer wins: the highest row index targeting each slot applies
    last = torch.full((cap,), -1, dtype=torch.int64, device=slots.device)
    scatter_reduce(last, slots, torch.where(chunk.vis, row_ids, -1), "max")
    in_range = slots < cap
    applied = chunk.vis & in_range & (
        last[slots.clamp_max(cap - 1)] == row_ids)
    ops = chunk.ops
    is_insert = (ops == OP_INSERT) | (ops == OP_UPDATE_INSERT)
    is_delete = (ops == OP_DELETE) | (ops == OP_UPDATE_DELETE)
    set_rows(state.live, slots, applied, is_insert)
    for c, src in zip(state.cols, chunk.columns):
        set_rows(c.data, slots, applied, src.data)
        set_rows(c.mask, slots, applied, src.mask)
    state.ckpt_dirty |= hit_mask(torch.where(applied, slots, cap), cap)
    state.overflow |= ovf
    state.saw_delete |= (chunk.vis & is_delete).any()
    return state, slots, applied


def rs_changed(state: RowSetState, in_set: torch.Tensor) -> torch.Tensor:
    """Slots whose downstream-visible row changes: membership flips, or it
    stays in the set with different values."""
    val_changed = torch.zeros_like(state.live)
    for cur, old in zip(state.cols, state.emitted_cols):
        val_changed |= (cur.mask != old.mask) | (
            cur.mask & old.mask & (cur.data != old.data))
    return (state.emitted != in_set) | (state.emitted & in_set & val_changed)


def rs_flush_rank(changed: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix count of the changed slots: computed once per flush
    and shared by every ``rs_gather_delta`` window; its last entry is the
    number of changed slots."""
    return torch.cumsum(changed, 0)


def rs_gather_delta(state: RowSetState, in_set: torch.Tensor,
                    rank: torch.Tensor, lo: int,
                    out_capacity: int) -> StreamChunk:
    """One delta chunk for the changed slots of rank in [lo, lo+G), G =
    out_capacity // 2: two rows per slot (the emitted row, then the current
    row, each vis-masked), in slot order. ``rank``: ``rs_flush_rank`` of
    the changed slots. A gather: output pair g reads the slot where the
    inclusive count first reaches lo + g + 1, so no store goes through a
    shared sentinel cell."""
    G = out_capacity // 2
    dev = rank.device
    g = lo + torch.arange(G, dtype=torch.int64, device=dev)
    valid = g < rank[-1]
    slot = torch.where(valid, torch.searchsorted(rank, g + 1), 0)
    emitted, member = state.emitted[slot], in_set[slot]

    def pairs(first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
        out = torch.stack([first, second], 1).reshape(2 * G)
        if out_capacity > 2 * G:    # odd capacity: the last row stays empty
            out = torch.cat([out, out.new_zeros(1)])
        return out

    def zero_unless(x: torch.Tensor) -> torch.Tensor:
        return torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                                 device=dev))

    ops = pairs(
        torch.where(member, OP_UPDATE_DELETE, OP_DELETE).to(torch.int8),
        torch.where(emitted, OP_UPDATE_INSERT, OP_INSERT).to(torch.int8))
    ops = torch.where(pairs(valid, valid), ops, torch.zeros_like(ops))
    vis = pairs(valid & emitted, valid & member)
    cols = tuple(
        Column(pairs(zero_unless(old.data[slot]), zero_unless(cur.data[slot])),
               pairs(zero_unless(old.mask[slot]), zero_unless(cur.mask[slot])))
        for cur, old in zip(state.cols, state.emitted_cols))
    return StreamChunk(ops, vis, cols)


def reload_chunks(schema, rows: list, device):
    """State-table rows as the physical chunks of a recovery reload, in
    ``LOAD_BATCH``-row chunks (the reference's size: the slot layout
    depends on it)."""
    for i in range(0, len(rows), LOAD_BATCH):
        yield physical_chunk(schema, rows[i:i + LOAD_BATCH], LOAD_BATCH,
                             device)


def rs_finish_flush(state: RowSetState, in_set: torch.Tensor) -> RowSetState:
    """The emitted snapshot becomes ``in_set`` and its rows (in place)."""
    for cur, old in zip(state.cols, state.emitted_cols):
        old.data.copy_(torch.where(in_set, cur.data, old.data))
        old.mask.copy_(torch.where(in_set, cur.mask, old.mask))
    state.emitted.copy_(in_set)
    return state


def write_rows(state_table, datas, masks, live) -> None:
    """Stage host rows (numpy columns ``datas``/``masks``) into
    ``state_table``: an upsert where ``live``, else a delete. The native
    row codec encodes them in one call where it is built."""
    types = state_table.schema.types
    from ..native import codec as native_codec
    codec = native_codec(types)
    if codec is not None:
        live_idx = np.nonzero(live)[0]
        dead_idx = np.nonzero(~live)[0]
        pk = state_table.pk_indices
        pk_d = [datas[i] for i in pk]
        pk_m = [masks[i] for i in pk]
        pk_t = [types[i] for i in pk]
        puts = dict(zip(
            codec.encode_keys(pk_d, pk_m, pk_t, live_idx),
            codec.encode_value_rows(datas, masks, types, live_idx)))
        state_table.stage_encoded(
            puts, codec.encode_keys(pk_d, pk_m, pk_t, dead_idx))
        return
    for r in range(len(live)):
        row = tuple(datas[c][r].item() if masks[c][r] else None
                    for c in range(len(datas)))
        if live[r]:
            state_table.insert(row)
        else:
            state_table.delete(row)


def rs_checkpoint(rows: RowSetState, state_table, epoch: int) -> RowSetState:
    """Incremental checkpoint: write only the slots touched since the last
    one (upsert live rows, delete tombstoned ones) and commit. The dirty
    slots are picked on the device and copied to the host once
    (``write_rows``). Clears ``ckpt_dirty``."""
    idx = rows.ckpt_dirty.nonzero().squeeze(1)
    if idx.numel():
        from ..stream.hash_agg import host_rows
        n = len(rows.cols)
        host = host_rows([c.data[idx] for c in rows.cols]
                         + [c.mask[idx] for c in rows.cols]
                         + [rows.live[idx]])
        write_rows(state_table, host[:n], host[n:2 * n], host[2 * n])
        state_table.commit(epoch)
    rows.ckpt_dirty.zero_()
    return rows
