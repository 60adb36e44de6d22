"""TopN executor family: plain / group, ±append-only, WITH TIES.

Counterpart of ``risingwave_tpu/stream/top_n.py``: one executor covers the
family. The device row set (``ops/row_set.py``) absorbs chunks with
last-writer-wins upserts through kernel B3, and each barrier recomputes the
rank window (``ops/topn.py``) and emits the membership/value diff. The
plain TopN sorts only a candidate subset while its threshold holds and
falls back to a full-sort refill otherwise (also whenever the string
dictionary grew, since a new string can re-rank the stored keys).
GroupTopN gives each row a gid (its group's slot in a second B3 table);
ranks are per gid segment of the same sort. Append-only inputs need no path
of their own; the flag only checks that no delete arrives.

Chunks are applied with no host sync (a ChunkBatch chunk by chunk, the
executor default); a barrier reads one stats tensor. Output schema = input
schema.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import DEFAULT_CHUNK_CAPACITY, StreamChunk
from ..common.types import GLOBAL_STRING_DICT
from ..ops.hash_table import (
    DeviceHashTable, hit_mask, ht_lookup_or_insert, ht_new, set_rows,
)
from ..ops.row_set import (
    RowSetState, reload_chunks, rs_apply_chunk, rs_changed, rs_checkpoint,
    rs_finish_flush, rs_flush_rank, rs_gather_delta, rs_new,
)
from ..ops.topn import (
    OrderSpec, _sentinels, key0_dtype, topn_candidate_flush, topn_in_set,
    topn_refill,
)
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier


@dataclasses.dataclass
class TopNState:
    rows: RowSetState
    group_table: DeviceHashTable   # group key -> gid (its own slot index)
    gid: torch.Tensor              # int64[cap]: group slot per row
    cand: torch.Tensor             # bool[cap]: incremental candidate slots
    t1: torch.Tensor               # scalar: forget threshold (leading key)


class TopNExecutor(SingleInputExecutor):
    """``order``: OrderSpec list; window = [offset, offset+limit).
    ``group_by``: input column indices (empty = plain TopN).
    ``pk_indices``: stream pk of the input — row identity under updates."""

    identity = "TopN"

    def __init__(
        self,
        input: Executor,
        order: Sequence[OrderSpec],
        offset: int,
        limit: int,
        pk_indices: Sequence[int],
        group_by: Sequence[int] = (),
        with_ties: bool = False,
        append_only: bool = False,
        state_table: Optional[StateTable] = None,
        table_capacity: int = 1 << 16,
        out_capacity: int = DEFAULT_CHUNK_CAPACITY,
        device=DEFAULT_DEVICE,
    ):
        super().__init__(input)
        if with_ties and offset != 0:
            raise ValueError("WITH TIES requires OFFSET 0 (reference parity)")
        self.schema = input.schema
        # the pk columns are the final tiebreak, so membership is a function
        # of row values, never of slot order (recovery re-derives it)
        order = list(order)
        self.n_user_keys = len(order)
        ordered = {o.col for o in order}
        order += [OrderSpec(i) for i in pk_indices if i not in ordered]
        self.order = tuple(
            dataclasses.replace(o, is_string=input.schema[o.col].type.is_string)
            for o in order)
        self._has_str_order = any(o.is_string for o in self.order)
        self._rank_ver = -1
        self.offset, self.limit = offset, limit
        self.pk_indices = tuple(pk_indices)
        self.group_by = tuple(group_by)
        self.with_ties = with_ties
        self.append_only = append_only
        self.capacity = table_capacity
        self.out_capacity = out_capacity
        self.state_table = state_table
        self.device = torch.device(device)
        if group_by:
            self.identity = "GroupTopN"

        pk_types = [input.schema[i].type for i in self.pk_indices]
        col_types = [f.type for f in input.schema]
        rows = rs_new(pk_types, col_types, table_capacity, device)
        group_types = [input.schema[i].type for i in self.group_by]

        # plain TopN's fast path sorts a candidate subset per barrier;
        # groups and ties take the full sort
        win = offset + limit
        cand_cap = 1
        while cand_cap < max(2 * win + 128, 512):
            cand_cap *= 2
        self.cand_cap = cand_cap
        self.cand_keep = max(win, cand_cap // 2)
        self.use_incremental = (not group_by and not with_ties
                                and cand_cap < table_capacity)
        big0, _ = _sentinels(key0_dtype(rows, self.order[0]))
        self.state = TopNState(
            rows=rows,
            group_table=ht_new(group_types, table_capacity, device),
            gid=torch.zeros(table_capacity, dtype=torch.int64, device=device),
            cand=torch.zeros(table_capacity, dtype=torch.bool, device=device),
            t1=torch.tensor(big0, dtype=key0_dtype(rows, self.order[0]),
                            device=device))
        self._dirty = False
        self.n_fast_flushes = 0      # incremental flushes…
        self.n_refills = 0           # …and full-sort refills
        if state_table is not None:
            self._load_from_state_table()

    # -- steps ----------------------------------------------------------------

    def _apply(self, chunk: StreamChunk) -> None:
        st = self.state
        rows, slots, applied = rs_apply_chunk(st.rows, chunk, self.pk_indices)
        st.cand |= hit_mask(torch.where(applied, slots, self.capacity),
                            self.capacity)
        if self.group_by:
            gcols = [chunk.columns[i] for i in self.group_by]
            _, gslots, _, govf = ht_lookup_or_insert(st.group_table, gcols,
                                                     applied)
            set_rows(st.gid, slots, applied, gslots)
            rows.overflow |= govf

    def _stats(self, changed, bad) -> list[int]:
        """The flush's one host read: changed count, bad, overflow and
        saw-delete flags."""
        rows = self.state.rows
        return torch.stack([changed.sum(), bad.long(), rows.overflow.long(),
                            rows.saw_delete.long()]).tolist()

    def _cur_ranks(self):
        """(rank table or None, dictionary version), fetched per flush."""
        if not self._has_str_order:
            return None, self._rank_ver
        return (GLOBAL_STRING_DICT.device_ranks(self.device),
                GLOBAL_STRING_DICT.version)

    def _full_in_set(self, str_ranks):
        return topn_in_set(self.state.rows, self.state.gid, self.order,
                           self.offset, self.limit, self.with_ties,
                           n_tie_keys=self.n_user_keys, str_ranks=str_ranks)

    def _refill(self, str_ranks):
        st = self.state
        in_set, cand, t1 = topn_refill(st.rows, st.gid, self.order,
                                       self.offset, self.limit,
                                       self.cand_keep, str_ranks=str_ranks)
        st.cand, st.t1 = cand, t1
        return in_set

    # -- host control ---------------------------------------------------------

    async def map_chunk(self, chunk: StreamChunk):
        self._apply(chunk)
        self._dirty = True
        if False:
            yield

    async def on_barrier(self, barrier: Barrier):
        if not self._dirty:
            # idle barrier: membership cannot have changed
            if barrier.checkpoint and self.state_table is not None:
                self._checkpoint(barrier.epoch.curr)
            return
        self._dirty = False
        st = self.state
        str_ranks, rank_ver = self._cur_ranks()
        no_bad = torch.zeros((), dtype=torch.bool, device=self.device)
        if self.use_incremental:
            # a dictionary grown since the last flush may have re-ranked
            # keys under t1 / the candidates: recompute from the full set
            bad = self._has_str_order and rank_ver != self._rank_ver
            if not bad:
                in_set, cand, t1, bad_t = topn_candidate_flush(
                    st.rows, self.order, self.offset, self.limit, st.cand,
                    self.cand_cap, self.cand_keep, st.t1, str_ranks)
                changed = rs_changed(st.rows, in_set)
                n_changed, bad, ovf, sawdel = self._stats(changed, bad_t)
            if bad:
                in_set = self._refill(str_ranks)
                changed = rs_changed(st.rows, in_set)
                n_changed, _, ovf, sawdel = self._stats(changed, no_bad)
                self.n_refills += 1
            else:
                st.cand, st.t1 = cand, t1
                self.n_fast_flushes += 1
        else:
            in_set = self._full_in_set(str_ranks)
            changed = rs_changed(st.rows, in_set)
            n_changed, _, ovf, sawdel = self._stats(changed, no_bad)
        self._rank_ver = rank_ver
        if ovf:
            raise RuntimeError(
                f"{self.identity}: row table overflow (capacity "
                f"{self.capacity}); increase table_capacity")
        if self.append_only and sawdel:
            raise RuntimeError(
                f"{self.identity}: delete arrived on declared append-only "
                "input")
        rank = rs_flush_rank(changed)
        for lo in range(0, n_changed, self.out_capacity // 2):
            yield rs_gather_delta(st.rows, in_set, rank, lo,
                                  self.out_capacity)
        if barrier.checkpoint and self.state_table is not None:
            self._checkpoint(barrier.epoch.curr)
        rs_finish_flush(st.rows, in_set)

    # -- persistence ----------------------------------------------------------
    # The durable row is the full input row; membership is recomputed on
    # recovery.

    def _checkpoint(self, epoch: int) -> None:
        rs_checkpoint(self.state.rows, self.state_table, epoch)

    def _load_from_state_table(self) -> None:
        rows = list(self.state_table.scan_all())
        if not rows:
            return
        for chunk in reload_chunks(self.schema, rows, self.device):
            self._apply(chunk)
        if bool(self.state.rows.overflow):
            raise RuntimeError(
                f"{self.identity}: row table overflow while reloading "
                f"checkpoint (capacity {self.capacity})")
        # the recovered rows were emitted before the failure: rebuild the
        # emitted snapshot so the first flush emits no spurious inserts;
        # the reloaded slots ARE the checkpoint, so none is dirty
        str_ranks, self._rank_ver = self._cur_ranks()
        if self.use_incremental:
            in_set = self._refill(str_ranks)
        else:
            in_set = self._full_in_set(str_ranks)
        self._dirty = False
        rs_finish_flush(self.state.rows, in_set)
        self.state.rows.ckpt_dirty.zero_()
