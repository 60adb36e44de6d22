"""DynamicFilterExecutor — filter LHS rows by a moving one-row RHS bound.

Counterpart of ``risingwave_tpu/stream/dynamic_filter.py``: the pattern
behind ``WHERE v > (SELECT max(...) ...)``. The LHS row set lives on the
device (``ops/row_set.py``, its pk upserts through kernel B3); the RHS is a
single scalar fed by a one-row aggregate stream. The RHS changelog is read
on the host (it is tiny by construction) and its last value is applied at
the barrier, so the epoch's output is consistent with the epoch's closing
bound on both sides. When the bound moves, the rows whose predicate flips
are emitted as Inserts / Deletes: one membership diff over the row set at
each barrier. VARCHAR keys compare by the dictionary's ranks.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    DEFAULT_CHUNK_CAPACITY, OP_INSERT, OP_UPDATE_INSERT, chunk_to_rows,
)
from ..common.types import GLOBAL_STRING_DICT, rank_of
from ..ops.row_set import (
    reload_chunks, rs_apply_chunk, rs_changed, rs_checkpoint,
    rs_finish_flush, rs_flush_rank, rs_gather_delta, rs_new,
)
from ..storage.state_table import StateTable
from .barrier_align import barrier_align
from .executor import Executor
from .message import Barrier

_CMP_FNS = {
    "greater_than": torch.gt,
    "greater_than_or_equal": torch.ge,
    "less_than": torch.lt,
    "less_than_or_equal": torch.le,
}


class DynamicFilterExecutor(Executor):
    """``key_col``: the LHS column compared against the RHS scalar (column
    0 of the RHS input). ``cmp``: greater_than / greater_than_or_equal /
    less_than / less_than_or_equal. ``pk_indices``: the LHS stream pk."""

    identity = "DynamicFilter"

    def __init__(
        self,
        left: Executor,
        right: Executor,
        key_col: int,
        cmp: str,
        pk_indices,
        state_table: Optional[StateTable] = None,
        bound_table: Optional[StateTable] = None,
        table_capacity: int = 1 << 16,
        out_capacity: int = DEFAULT_CHUNK_CAPACITY,
        device=DEFAULT_DEVICE,
    ):
        if cmp not in _CMP_FNS:
            raise ValueError(f"unsupported comparator {cmp}")
        if state_table is not None and bound_table is None:
            raise ValueError(
                "state_table requires bound_table: recovery must restore the "
                "committed bound to rebuild the emitted snapshot")
        self.left, self.right = left, right
        self.schema = left.schema
        self.key_col = key_col
        self.cmp = cmp
        self.pk_indices = tuple(pk_indices)
        self.capacity = table_capacity
        self.out_capacity = out_capacity
        self.state_table = state_table
        self.bound_table = bound_table
        self.device = torch.device(device)
        pk_types = [left.schema[i].type for i in self.pk_indices]
        col_types = [f.type for f in left.schema]
        self.rows = rs_new(pk_types, col_types, table_capacity, device)
        # the committed bound: a value, or None (no RHS row yet, or NULL):
        # then nothing passes, since a comparison with NULL is unknown
        self.bound = None
        self._key_dtype = left.schema[key_col].type.dtype
        self._staged_bound: tuple = ()   # () = no update; (v,) = set to v
        self._is_string_key = left.schema[key_col].type.is_string
        if state_table is not None:
            self._load_from_state_table()

    def _in_set(self) -> torch.Tensor:
        rows = self.rows
        col = rows.cols[self.key_col]
        if self.bound is None:
            return torch.zeros_like(rows.live)
        data = col.data
        bound = torch.tensor(self.bound, dtype=self._key_dtype,
                             device=self.device)
        if self._is_string_key:
            ranks = GLOBAL_STRING_DICT.device_ranks(self.device)
            data, bound = rank_of(ranks, data), rank_of(ranks, bound)
        return rows.live & col.mask & _CMP_FNS[self.cmp](data, bound)

    async def execute(self):
        async for ev in barrier_align(self.left, self.right):
            kind = ev[0]
            if kind in ("chunk", "batch"):
                _, side, msg = ev
                if side == "left":
                    if kind == "chunk":
                        rs_apply_chunk(self.rows, msg, self.pk_indices)
                    else:
                        for i in range(msg.num_chunks):
                            rs_apply_chunk(self.rows, msg.at(i),
                                           self.pk_indices)
                elif kind == "chunk":
                    self._stage_rhs([msg])
                else:
                    self._stage_rhs(msg.at(i) for i in range(msg.num_chunks))
            elif kind == "barrier":
                barrier = ev[1]
                for out in self._flush(barrier):
                    yield out
                yield barrier
                if barrier.is_stop():
                    return
            elif kind == "watermark":
                _, side, wm = ev
                if side == "left":
                    yield wm

    def _stage_rhs(self, chunks) -> None:
        """The RHS is a one-row changelog: the last visible insert wins, a
        delete with no following insert makes the bound invalid."""
        for ch in chunks:
            for op, row in chunk_to_rows(ch, self.right.schema,
                                         with_ops=True, physical=True):
                if op in (OP_INSERT, OP_UPDATE_INSERT):
                    self._staged_bound = (row[0],)   # None = NULL bound
                else:
                    self._staged_bound = (None,)

    def _flush(self, barrier: Barrier):
        if self._staged_bound:
            (v,) = self._staged_bound
            # held as a value of the key's type, as the reference does
            self.bound = (None if v is None else
                          torch.tensor(v, dtype=self._key_dtype).item())
            self._staged_bound = ()
        in_set = self._in_set()
        changed = rs_changed(self.rows, in_set)
        rank = rs_flush_rank(changed)
        # the barrier's one host read: changed count and overflow flag
        n_changed, overflow = torch.stack(
            [rank[-1], self.rows.overflow.long()]).tolist()
        if overflow:
            raise RuntimeError(
                f"{self.identity}: row table overflow (capacity "
                f"{self.capacity}); increase table_capacity")
        for lo in range(0, n_changed, self.out_capacity // 2):
            yield rs_gather_delta(self.rows, in_set, rank, lo,
                                  self.out_capacity)
        if barrier.checkpoint and self.state_table is not None:
            self._checkpoint(barrier.epoch.curr)
        rs_finish_flush(self.rows, in_set)

    # -- persistence ----------------------------------------------------------
    # Durable state: the LHS rows, plus the committed bound in a one-row
    # side table (schema: id, value).

    def _checkpoint(self, epoch: int) -> None:
        rs_checkpoint(self.rows, self.state_table, epoch)
        self.bound_table.insert((0, self.bound))
        self.bound_table.commit(epoch)

    def _load_from_state_table(self) -> None:
        rows = list(self.state_table.scan_all())
        for chunk in reload_chunks(self.schema, rows, self.device):
            rs_apply_chunk(self.rows, chunk, self.pk_indices)
        brows = list(self.bound_table.scan_all())
        if brows and brows[0][1] is not None:
            self.bound = brows[0][1]
        # rebuild the emitted snapshot at the recovered bound, so the first
        # flush emits only genuine deltas
        rs_finish_flush(self.rows, self._in_set())
        self.rows.ckpt_dirty.zero_()
