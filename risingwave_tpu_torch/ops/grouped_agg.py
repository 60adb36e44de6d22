"""Device-side grouped-aggregation core.

Counterpart of ``risingwave_tpu/ops/grouped_agg.py`` (``AggCore``): the
per-chunk group update, the barrier flush (dirty-group prefix count,
searchsorted gather of one output window, prev-lane advance), watermark
state cleaning and compaction, cold-tier eviction and fault-in, and the
recovery bulk-load. The state is updated in place, except where a step
rebuilds it (``compact``), which returns new tensors and leaves the old
state untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, Column,
    StreamChunk,
)
from ..expr.agg import AggCall
from .hash_table import (
    DeviceHashTable, hit_mask, ht_lookup_or_insert, ht_new, scatter_reduce,
    set_rows, set_where,
)

_I32_MAX = torch.iinfo(torch.int32).max


@dataclasses.dataclass
class AggState:
    table: DeviceHashTable
    lanes: list[torch.Tensor]        # [cap] per lane; lane 0 = row count
    prev_lanes: list[torch.Tensor]   # values as of the last emitted flush
    dirty: torch.Tensor              # bool[cap] since the last barrier flush
    ckpt_dirty: torch.Tensor         # bool[cap] since the last checkpoint
    overflow: torch.Tensor           # bool scalar, sticky
    last_used: torch.Tensor          # int32[cap]: step of the last touch


def stamps(step, n: int, device) -> torch.Tensor:
    """int32[n] of one LRU stamp: a Python int (passed to the fill kernel
    as an argument) or an int32 scalar tensor already on the device."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.int32).expand(n)
    return torch.full((n,), step, dtype=torch.int32, device=device)


class AggCore:
    """Static config + the steps of one grouped-agg operator."""

    def __init__(self, key_types: Sequence, group_keys: Sequence[int],
                 agg_calls: Sequence[AggCall], table_capacity: int,
                 out_capacity: int, device=DEFAULT_DEVICE):
        self.key_types = tuple(key_types)
        self.group_keys = tuple(group_keys)
        self.agg_calls = tuple(agg_calls)
        self.capacity = table_capacity
        self.out_capacity = out_capacity
        self.groups_per_chunk = out_capacity // 2
        self.device = torch.device(device)
        for c in self.agg_calls:
            if c.lanes_unsupported:
                # fixed device lanes cannot dedup or collect; the planner
                # routes these to MaterializedAggExecutor
                raise ValueError(
                    f"{c.kind}{'(distinct)' if c.distinct else ''} needs "
                    "materialized-input state (stream/materialized_agg.py)")
        self.lane_dtypes = [torch.int64]
        self.lane_inits = [0]
        self.call_lane_ofs = []
        for c in self.agg_calls:
            self.call_lane_ofs.append(len(self.lane_dtypes))
            self.lane_dtypes.extend(c.state_dtypes())
            self.lane_inits.extend(c.init_lanes())

    def _init_lanes(self) -> list[torch.Tensor]:
        return [torch.full((self.capacity,), v, dtype=dt, device=self.device)
                for v, dt in zip(self.lane_inits, self.lane_dtypes)]

    def init_state(self) -> AggState:
        cap, dev = self.capacity, self.device
        return AggState(
            table=ht_new(self.key_types, cap, dev),
            lanes=self._init_lanes(),
            prev_lanes=self._init_lanes(),
            dirty=torch.zeros(cap, dtype=torch.bool, device=dev),
            ckpt_dirty=torch.zeros(cap, dtype=torch.bool, device=dev),
            overflow=torch.zeros((), dtype=torch.bool, device=dev),
            last_used=torch.zeros(cap, dtype=torch.int32, device=dev),
        )

    def apply_chunk(self, state: AggState, chunk: StreamChunk,
                    step=None, str_ranks=None) -> AggState:
        """Fold one chunk into the group table (in place), without a host
        sync. ``step``: the LRU stamp of the touched slots (None: no
        tracking, as for an executor without a memory budget).
        ``str_ranks``: the dictionary's rank table, needed by MIN/MAX over
        VARCHAR, which reduce in packed ``rank << 32 | id`` space and store
        the id."""
        key_cols = [chunk.columns[i] for i in self.group_keys]
        _, slots, _, ovf = ht_lookup_or_insert(state.table, key_cols,
                                               chunk.vis)
        signs = chunk.signs()
        lanes = state.lanes
        scatter_reduce(lanes[0], slots, signs, "add")
        for call, ofs in zip(self.agg_calls, self.call_lane_ofs):
            if call.arg >= 0:
                c = chunk.columns[call.arg]
                value, vmask = c.data, c.mask & chunk.vis
            else:
                value, vmask = torch.zeros_like(signs), chunk.vis
            contribs = call.contributions(value, vmask, signs, str_ranks)
            for j, (contrib, op) in enumerate(zip(contribs,
                                                  call.reduce_ops())):
                if call.is_string_minmax:
                    lane = call.pack_lane(lanes[ofs + j], str_ranks)
                    scatter_reduce(lane, slots, contrib, op)
                    lanes[ofs + j].copy_(call.unpack_lane(lane))
                else:
                    scatter_reduce(lanes[ofs + j], slots, contrib, op)
        touched = torch.where(chunk.vis, slots,
                              torch.full_like(slots, self.capacity))
        hit = hit_mask(touched, self.capacity)
        state.dirty |= hit
        state.ckpt_dirty |= hit
        if step is not None:
            # stamps only grow, so the max is the reference's set
            scatter_reduce(state.last_used, touched,
                           stamps(step, touched.shape[0], touched.device),
                           "max")
        state.overflow |= ovf
        return state

    def outputs(self, lanes) -> list[tuple[torch.Tensor, torch.Tensor]]:
        live = lanes[0] > 0
        outs = []
        for call, ofs in zip(self.agg_calls, self.call_lane_ofs):
            call_lanes = [lanes[ofs + j] for j in range(call.num_lanes)]
            data, mask = call.output(call_lanes, live)
            outs.append((data.to(call.output_type.dtype), mask))
        return outs

    def flush_rank(self, state: AggState) -> torch.Tensor:
        """Inclusive prefix count of dirty groups — once per barrier, shared
        by every flush window."""
        return torch.cumsum(state.dirty, 0)

    def gather_flush_chunk(self, state: AggState, rank: torch.Tensor,
                           lo: int) -> StreamChunk:
        """One output chunk for the dirty groups with rank in [lo, lo+G):
        the slot of the k-th dirty group is the first position whose
        inclusive rank reaches k+1 (``searchsorted`` on the left side)."""
        G = self.groups_per_chunk
        ks = lo + torch.arange(G, dtype=torch.int64, device=rank.device)
        pos = torch.searchsorted(rank, ks + 1, right=False)
        valid = (ks + 1) <= rank[-1]
        slot = torch.where(valid, pos, torch.zeros_like(pos))

        def interleave(a, b):
            return torch.stack([a, b], dim=-1).reshape(2 * G)

        prev_g = [lane[slot] for lane in state.prev_lanes]
        cur_g = [lane[slot] for lane in state.lanes]
        prev_live = prev_g[0] > 0
        cur_live = cur_g[0] > 0
        full = torch.full_like(slot, 0, dtype=torch.int8)
        op0 = torch.where(cur_live, full + OP_UPDATE_DELETE, full + OP_DELETE)
        op1 = torch.where(prev_live, full + OP_UPDATE_INSERT,
                          full + OP_INSERT)
        ops = interleave(op0, op1)
        vis = interleave(prev_live & valid, cur_live & valid)

        cols = []
        for kd, km in zip(state.table.key_data, state.table.key_mask):
            d, m = kd[slot], km[slot]
            cols.append(Column(interleave(d, d), interleave(m, m)))
        for (pd, pm), (cd, cm) in zip(self.outputs(prev_g),
                                      self.outputs(cur_g)):
            cols.append(Column(interleave(pd.to(cd.dtype), cd),
                               interleave(pm, cm)))
        return StreamChunk(ops, vis, tuple(cols))

    def finish_flush(self, state: AggState) -> AggState:
        """Advance prev lanes of the flushed groups and clear the dirty set
        (in place)."""
        for cur, prev in zip(state.lanes, state.prev_lanes):
            prev.copy_(torch.where(state.dirty, cur, prev))
        state.dirty.zero_()
        return state

    # -- watermark-driven state cleaning ---------------------------------------

    def clean_below(self, state: AggState, key_pos: int,
                    threshold) -> AggState:
        """Mark groups whose ``key_pos``-th key is below ``threshold`` dead
        (in place): lanes back to their initial values (row count 0) and
        ``ckpt_dirty`` set, so the next checkpoint writes their deletes.
        The table keeps the keys (freeing open-addressing slots in place
        would break probe chains); ``compact`` rebuilds it after the
        checkpoint. No ``dirty`` mark: cleaning frees state, it does not
        retract results already emitted."""
        kd = state.table.key_data[key_pos]
        km = state.table.key_mask[key_pos]
        dead = state.table.occupied & km & (kd < threshold)
        for lane, v in zip(state.lanes, self.lane_inits):
            lane.masked_fill_(dead, v)
        state.ckpt_dirty |= dead
        return state

    def compact(self, state: AggState) -> AggState:
        """A new state whose table holds only the live groups (row count >
        0), inserted in slot order, with every per-slot tensor moved by the
        slot remap. Run after the checkpoint that persisted the deletes
        (it still needs the dead groups' keys). The old state is not
        written."""
        cap = self.capacity
        live = state.table.occupied & (state.lanes[0] > 0)
        key_cols = [Column(kd, km) for kd, km in zip(state.table.key_data,
                                                     state.table.key_mask)]
        new = self.init_state()
        _, slots, _, rebuild_ovf = ht_lookup_or_insert(new.table, key_cols,
                                                       live)
        rows = (live & (slots < cap)).nonzero().squeeze(1)
        dst_idx = slots[rows]

        def move(dst: torch.Tensor, src: torch.Tensor) -> None:
            dst[dst_idx] = src[rows]

        for dst, src in zip(new.lanes + new.prev_lanes,
                            state.lanes + state.prev_lanes):
            move(dst, src)
        move(new.dirty, state.dirty)
        move(new.ckpt_dirty, state.ckpt_dirty)
        move(new.last_used, state.last_used)
        # a group that exhausts probing in the rebuild would be lost:
        # surface it like every overflow path
        new.overflow |= state.overflow | rebuild_ovf
        return new

    # -- eviction to the cold tier ----------------------------------------------
    # Device state is a cache over the state table: eviction frees slots
    # whose durable copy is current; absorb() faults a key's stored lanes
    # back in when it is touched again.

    def live_mask(self, state: AggState) -> torch.Tensor:
        return state.table.occupied & (state.lanes[0] > 0)

    def evict_plan(self, state: AggState, keep: int):
        """The cold live slots to evict so about ``keep`` of the hottest
        remain: (mask bool[cap], n_evicted as a device scalar). A threshold
        on the LRU stamp: ties at the threshold may evict a few more than
        asked, which is harmless (the cold copies are current)."""
        cap = self.capacity
        live = self.live_mask(state)
        n_live = live.sum()
        key = torch.where(live, state.last_used,
                          torch.full_like(state.last_used, _I32_MAX))
        skey = torch.sort(key).values
        k = torch.clamp(n_live - keep, 0, cap - 1)
        thr = skey[torch.clamp_min(k - 1, 0)]
        mask = live & (state.last_used <= thr) & (k > 0)
        return mask, mask.sum()

    def apply_evict(self, state: AggState, mask: torch.Tensor) -> AggState:
        """Reset the evicted slots to their initial values (in place)
        without a ``ckpt_dirty`` mark: the durable row this barrier's
        checkpoint just wrote is the cold copy. Call at a checkpoint
        barrier, after the checkpoint and before ``compact``."""
        for lanes in (state.lanes, state.prev_lanes):
            for lane, v in zip(lanes, self.lane_inits):
                lane.masked_fill_(mask, v)
        state.dirty &= ~mask
        state.ckpt_dirty &= ~mask
        return state

    def absorb(self, state: AggState, key_cols, stored_lanes,
               valid: torch.Tensor, str_ranks=None) -> AggState:
        """Fault evicted groups back in (in place): merge each stored lane
        into the (possibly new) slot with the lane's reduce op, and set
        ``prev_lanes`` to the stored value, the value downstream last saw,
        so the next flush emits an exact U-/U+ pair. ``stored_lanes``: one
        [n] tensor per lane, rows aligned with ``key_cols``."""
        _, slots, _, ovf = ht_lookup_or_insert(state.table, key_cols, valid)
        idx = torch.where(valid, slots, torch.full_like(slots, self.capacity))
        keep = idx < self.capacity
        ops = [("add", None)] + [(op, c) for c in self.agg_calls
                                 for op in c.reduce_ops()]
        for lane, prev, stored, (op, call) in zip(
                state.lanes, state.prev_lanes, stored_lanes, ops):
            if call is not None and call.is_string_minmax:
                packed = call.pack_lane(lane, str_ranks)
                scatter_reduce(packed, idx,
                               call.pack_lane(stored, str_ranks), op)
                lane.copy_(call.unpack_lane(packed))
            else:
                scatter_reduce(lane, idx, stored, op)
            set_where(prev, keep, idx, stored.to(prev.dtype))
        hit = hit_mask(idx, self.capacity)
        state.dirty |= hit
        state.ckpt_dirty |= hit
        state.overflow |= ovf
        return state


#: rows per batch of the recovery bulk-load (the reference's batch size: the
#: slot layout depends on it)
LOAD_BATCH = 1024


def load_rows_into_state(core: AggCore, state: AggState, rows) -> AggState:
    """Recovery bulk-load (in place): fold state-table rows (keys ++ raw
    lanes) into ``state`` in ``LOAD_BATCH``-row batches, as the reference
    does, so the slots come out the same. Callers set ``prev_lanes``
    themselves (the recovered snapshot is the downstream baseline)."""
    rows = list(rows)
    nk = len(core.group_keys)
    bs = LOAD_BATCH
    dev = core.device
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(0, len(rows), bs):
        batch = rows[i:i + bs]
        n = len(batch)
        valid = torch.arange(bs, device=dev) < n
        key_cols = []
        for c in range(nk):
            vals = [r[c] for r in batch]
            mask = np.array([v is not None for v in vals] + [False] * (bs - n))
            data = np.array(
                [v if v is not None else 0 for v in vals] + [0] * (bs - n),
                dtype=core.key_types[c].np_dtype)
            key_cols.append(Column(torch.from_numpy(data).to(dev),
                                   torch.from_numpy(mask).to(dev)))
        _, slots, _, ovf = ht_lookup_or_insert(state.table, key_cols, valid)
        overflow |= ovf
        slots = slots[:n]
        placed = slots < core.capacity
        for j, lane in enumerate(state.lanes):
            vals = np.array([r[nk + j] for r in batch],
                            dtype=np.float64 if lane.is_floating_point()
                            else np.int64)
            set_rows(lane, slots, placed, torch.from_numpy(vals).to(dev))
    if rows and bool(overflow):
        raise RuntimeError(f"agg table overflow during recovery load "
                           f"(capacity {core.capacity})")
    return state
