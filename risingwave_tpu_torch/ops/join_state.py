"""Device-resident streaming hash-join state and the join step.

Counterpart of ``risingwave_tpu/ops/join_state.py``. Each side keeps all its
rows in a bucketed arena:

  * a DeviceHashTable maps join key -> bucket (ops/hash_table.py),
  * each bucket holds up to W rows in struct-of-tensors ``[capacity, W]``
    buffers, with per-row occupancy, tombstones and a **degree** (the number
    of condition-passing matches on the opposite side), which drives
    outer/semi/anti emission with no re-probing.

One input chunk is joined in two vectorized passes — deletes first, then
inserts. The serial-order effects of row-at-a-time processing (degree
transitions when several same-key rows arrive in one chunk) come from the
rank/total counts of kernel B1 (ops/rank_totals.py). Outputs land in an
``[N, 2W+1]`` lane grid (lanes 2w/2w+1 = match w's primary / update-pair
row; lane 2W = the null-padded or self row) that flattens into one
visibility-masked chunk for ``gather_units_window``.

Join-key NULLs never match (SQL semantics). The state is updated in place
and a pass reads nothing back to the host; callers that must rewind take a
``clone()`` first. Each side also keeps a ``ckpt_dirty`` mark per row (rows
changed since the last checkpoint) and an LRU stamp per key, and has its
watermark cleaning (``clean_side_below``), rebuild (``compact_side``) and
cold-tier eviction (``join_evict_plan``, ``apply_evict_side``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, Column,
    StreamChunk,
)
from ..common.types import Schema
from .grouped_agg import stamps
from .hash_table import (
    DeviceHashTable, ht_lookup, ht_lookup_or_insert, ht_new, scatter_reduce,
    set_rows, set_where,
)
from .rank_totals import rank_totals


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT_OUTER = "left_outer"
    RIGHT_OUTER = "right_outer"
    FULL_OUTER = "full_outer"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"

    @property
    def preserves_left(self) -> bool:
        return self in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER)

    @property
    def preserves_right(self) -> bool:
        return self in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER)

    @property
    def semi_anti_side(self) -> Optional[str]:
        if self in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            return "left"
        if self in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            return "right"
        return None

    @property
    def is_anti(self) -> bool:
        return self in (JoinType.LEFT_ANTI, JoinType.RIGHT_ANTI)


@dataclasses.dataclass
class JoinSideState:
    ht: DeviceHashTable                 # join key -> bucket
    row_data: tuple[torch.Tensor, ...]  # per column: dtype[cap, W]
    row_mask: tuple[torch.Tensor, ...]  # per column: bool[cap, W]
    occupied: torch.Tensor              # bool[cap, W]
    tomb: torch.Tensor                  # bool[cap, W] — deleted since ckpt
    degree: torch.Tensor                # int32[cap, W] — opposite matches
    ckpt_dirty: torch.Tensor            # bool[cap, W] — changed since ckpt
    lru: torch.Tensor                   # int32[cap] — key's last-touch step
    ht_overflow: torch.Tensor           # bool scalar, sticky: key table full
    lane_overflow: torch.Tensor         # bool scalar, sticky: bucket full
    inconsistent: torch.Tensor          # bool scalar, sticky

    def clone(self) -> "JoinSideState":
        return JoinSideState(
            ht=self.ht.clone(),
            row_data=tuple(t.clone() for t in self.row_data),
            row_mask=tuple(t.clone() for t in self.row_mask),
            **{f: getattr(self, f).clone() for f in (
                "occupied", "tomb", "degree", "ckpt_dirty", "lru",
                "ht_overflow", "lane_overflow", "inconsistent")})


@dataclasses.dataclass
class JoinState:
    left: JoinSideState
    right: JoinSideState

    def clone(self) -> "JoinState":
        return JoinState(self.left.clone(), self.right.clone())


def _bool(dev) -> torch.Tensor:
    return torch.zeros((), dtype=torch.bool, device=dev)


class JoinCore:
    """Static config + the (state, chunk) -> (state, out) step of one
    streaming hash join."""

    def __init__(
        self,
        left_schema: Schema,
        right_schema: Schema,
        left_keys: Sequence[int],
        right_keys: Sequence[int],
        join_type: JoinType,
        condition=None,
        key_capacity: int = 1 << 13,
        bucket_width: int = 16,
        device=DEFAULT_DEVICE,
    ):
        self.left_schema = left_schema
        self.right_schema = right_schema
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.join_type = join_type
        self.condition = condition
        self.capacity = key_capacity
        self.W = bucket_width
        self.device = torch.device(device)
        lkt = tuple(left_schema[i].type for i in self.left_keys)
        rkt = tuple(right_schema[i].type for i in self.right_keys)
        if tuple(t.dtype for t in lkt) != tuple(t.dtype for t in rkt):
            raise ValueError("equi-join key physical types must match")
        self.key_types = lkt
        sa = join_type.semi_anti_side
        if sa == "left":
            self.out_schema = left_schema
        elif sa == "right":
            self.out_schema = right_schema
        else:
            self.out_schema = left_schema.concat(right_schema)

    # -- state ----------------------------------------------------------------

    def _new_side(self, schema: Schema,
                  key_idx: Sequence[int]) -> JoinSideState:
        cap, W, dev = self.capacity, self.W, self.device

        def z(dtype):
            return torch.zeros((cap, W), dtype=dtype, device=dev)

        return JoinSideState(
            ht=ht_new(tuple(schema[i].type for i in key_idx), cap, dev),
            row_data=tuple(z(f.type.dtype) for f in schema),
            row_mask=tuple(z(torch.bool) for _ in schema),
            occupied=z(torch.bool), tomb=z(torch.bool),
            degree=z(torch.int32), ckpt_dirty=z(torch.bool),
            lru=torch.zeros(cap, dtype=torch.int32, device=dev),
            ht_overflow=_bool(dev), lane_overflow=_bool(dev),
            inconsistent=_bool(dev))

    def init_state(self) -> JoinState:
        return JoinState(
            left=self._new_side(self.left_schema, self.left_keys),
            right=self._new_side(self.right_schema, self.right_keys))

    # -- the step --------------------------------------------------------------

    def apply_chunk(self, state: JoinState, chunk: StreamChunk, *,
                    side: str, step=None, passes=None):
        """Join one chunk arriving on ``side`` (state updated in place);
        returns (state, big_chunk).

        ``big_chunk`` holds the lane grids of the passes that ran (deletes
        before inserts) and is mostly invisible; compact it with
        ``gather_units_window`` before sending downstream. A pass with no
        rows is skipped, as the reference's ``lax.cond`` skips it; its
        invisible grid would add no unit. ``passes``: the host's
        (any delete, any insert) for this chunk (``pass_flags``), read here
        from the device when None; given, the step reads nothing back.

        ``step``: the LRU stamp (None: no tracking). The own side's key
        slot and every probed opposite-side slot are stamped, so the two
        sides' stamps for one key value stay equal: eviction relies on it
        to take a key from BOTH arenas."""
        dels = (chunk.ops == OP_DELETE) | (chunk.ops == OP_UPDATE_DELETE)
        is_del = chunk.vis & dels
        is_ins = chunk.vis & ~dels
        if passes is None:
            passes = torch.stack([is_del.any(), is_ins.any()]).tolist()
        any_del, any_ins = passes
        outs = []
        if any_del:
            outs.append(self._pass(state, chunk, is_del, False, side, step))
        if any_ins:
            outs.append(self._pass(state, chunk, is_ins, True, side, step))
        if not outs:
            outs.append(self._empty_out(chunk.capacity, chunk.device))
        ops = torch.cat([o[0].reshape(-1) for o in outs])
        vis = torch.cat([o[1].reshape(-1) for o in outs])
        cols = tuple(
            Column(torch.cat([o[2][ci][0].reshape(-1) for o in outs]),
                   torch.cat([o[2][ci][1].reshape(-1) for o in outs]))
            for ci in range(len(self.out_schema)))
        return state, StreamChunk(ops, vis, cols)

    # -- internals -------------------------------------------------------------

    def _empty_out(self, N: int, dev):
        L = 2 * self.W + 1
        return (
            torch.zeros((N, L), dtype=torch.int8, device=dev),
            torch.zeros((N, L), dtype=torch.bool, device=dev),
            tuple((torch.zeros((N, L), dtype=f.type.dtype, device=dev),
                   torch.zeros((N, L), dtype=torch.bool, device=dev))
                  for f in self.out_schema))

    def _eval_condition(self, chunk, b_datas, b_masks, side: str):
        """Evaluate the non-equi condition on all candidate pairs ->
        bool[N, W]."""
        N, W = chunk.capacity, self.W
        a_cols = [Column(c.data.repeat_interleave(W),
                         c.mask.repeat_interleave(W))
                  for c in chunk.columns]
        b_cols = [Column(d.reshape(-1), m.reshape(-1))
                  for d, m in zip(b_datas, b_masks)]
        pair = a_cols + b_cols if side == "left" else b_cols + a_cols
        dev = chunk.device
        pseudo = StreamChunk(torch.zeros(N * W, dtype=torch.int8, device=dev),
                             torch.ones(N * W, dtype=torch.bool, device=dev),
                             tuple(pair))
        res = self.condition.eval(pseudo)
        return (res.data & res.mask).reshape(N, W)

    @staticmethod
    def _lane_of_rank(cand: torch.Tensor, rank: torch.Tensor):
        """Per row, the lane of the (rank+1)-th True of ``cand`` [N, W]:
        (lane, found)."""
        cs = torch.cumsum(cand, 1)
        hit = (cs == (rank + 1)[:, None]) & cand
        return hit.to(torch.uint8).argmax(1), hit.any(1)

    def _pass(self, state: JoinState, chunk: StreamChunk, sel: torch.Tensor,
              is_insert: bool, side: str, step=None):
        cap, W = self.capacity, self.W
        N = chunk.capacity
        dev = chunk.device
        A = state.left if side == "left" else state.right
        B = state.right if side == "left" else state.left
        a_key_idx = self.left_keys if side == "left" else self.right_keys
        a_key_cols = [chunk.columns[i] for i in a_key_idx]
        idx = torch.arange(N, device=dev)
        earlier = idx[None, :] < idx[:, None]                     # [N, N]

        has_null_key = torch.zeros(N, dtype=torch.bool, device=dev)
        for c in a_key_cols:
            has_null_key = has_null_key | ~c.mask
        match_ok = sel & ~has_null_key

        # ---- probe the opposite side (all rows at once)
        b_slot, b_found = ht_lookup(B.ht, a_key_cols, match_ok)
        bs = torch.where(b_found, b_slot, torch.zeros_like(b_slot))
        occ_b = B.occupied[bs] & b_found[:, None]                  # [N, W]
        b_datas = [rd[bs] for rd in B.row_data]                    # [N, W]
        b_masks = [rm[bs] & occ_b for rm in B.row_mask]
        matches = occ_b
        if self.condition is not None:
            matches = matches & self._eval_condition(chunk, b_datas, b_masks,
                                                     side)
        c_cnt = matches.sum(1, dtype=torch.int32)                  # [N]

        # ---- rank/total of same-key rows within this pass (kernel B1)
        ident = torch.where(b_found, b_slot,
                            torch.full_like(b_slot, -1)).to(torch.int32)
        r, t = rank_totals(ident, matches.contiguous())
        d0 = B.degree[bs]                                          # [N, W]

        # ---- opposite-side degree maintenance; an unmatched cell adds 0 to
        # a cell of its own (the reference drops it at the cap*W sentinel;
        # one shared cell would serialize the card's atomics)
        lane_w = torch.arange(W, device=dev)[None, :]
        cell = idx[:, None] * W + lane_w
        g = torch.where(matches, bs[:, None] * W + lane_w, cell % (cap * W))
        delta = matches.to(torch.int32) * (1 if is_insert else -1)
        B.degree.view(-1).index_add_(0, g.reshape(-1), delta.reshape(-1))
        if step is not None:
            _stamp(B.lru, b_slot, b_found, step)

        # ---- own-side arena update
        if is_insert:
            _, a_slot, _, ht_ovf = ht_lookup_or_insert(A.ht, a_key_cols, sel)
            a_ok = sel & (a_slot < cap)
            as_ = torch.where(a_ok, a_slot, torch.zeros_like(a_slot))
            aident = torch.where(a_ok, a_slot, torch.full_like(a_slot, -1))
            alower = ((aident[:, None] == aident[None, :])
                      & (aident >= 0)[:, None] & earlier)
            a_rank = alower.sum(1)
            free = ~(A.occupied | A.tomb)[as_]                     # [N, W]
            lane, found = self._lane_of_rank(free, a_rank)
            lane_ok = found & a_ok
            f = as_ * W + lane
            set_rows(A.occupied.view(-1), f, lane_ok, True)
            for rd, c in zip(A.row_data, chunk.columns):
                set_rows(rd.view(-1), f, lane_ok, c.data)
            for rm, c in zip(A.row_mask, chunk.columns):
                set_rows(rm.view(-1), f, lane_ok, c.mask)
            set_rows(A.degree.view(-1), f, lane_ok, c_cnt)
            set_rows(A.ckpt_dirty.view(-1), f, lane_ok, True)
            A.ht_overflow |= ht_ovf | (sel & (a_slot >= cap)).any()
            A.lane_overflow |= (a_ok & ~lane_ok).any()
            if step is not None:
                _stamp(A.lru, a_slot, a_ok, step)
        else:
            a_slot, a_found = ht_lookup(A.ht, a_key_cols, sel)
            as_ = torch.where(a_found, a_slot, torch.zeros_like(a_slot))
            delmatch = A.occupied[as_] & a_found[:, None]
            for rd, rm, c in zip(A.row_data, A.row_mask, chunk.columns):
                srd, srm = rd[as_], rm[as_]
                delmatch = delmatch & (
                    (srm & c.mask[:, None] & (srd == c.data[:, None]))
                    | (~srm & ~c.mask[:, None]))
            # rank among value-identical delete rows -> distinct lanes
            roweq = sel[:, None] & sel[None, :]
            for c in chunk.columns:
                roweq = roweq & (
                    (c.mask[:, None] & c.mask[None, :]
                     & (c.data[:, None] == c.data[None, :]))
                    | (~c.mask[:, None] & ~c.mask[None, :]))
            drank = (roweq & earlier).sum(1)
            lane, lane_ok = self._lane_of_rank(delmatch, drank)
            f = as_ * W + lane
            # values stay in row_data for the durable-tier delete
            set_rows(A.occupied.view(-1), f, lane_ok, False)
            set_rows(A.tomb.view(-1), f, lane_ok, True)
            set_rows(A.ckpt_dirty.view(-1), f, lane_ok, True)
            A.inconsistent |= (sel & ~lane_ok).any()
            if step is not None:
                _stamp(A.lru, a_slot, a_found, step)

        return self._emit(chunk, sel, is_insert, side, matches, c_cnt, r, t,
                          d0, b_datas, b_masks)

    def _emit(self, chunk, sel, is_insert: bool, side: str, matches, c_cnt,
              r, t, d0, b_datas, b_masks):
        """Build the [N, 2W+1] emission grid for one pass."""
        N, W = chunk.capacity, self.W
        dev = chunk.device
        jt = self.join_type
        sa = jt.semi_anti_side
        op_plain = OP_INSERT if is_insert else OP_DELETE

        a_outer = jt.preserves_left if side == "left" else jt.preserves_right
        b_outer = jt.preserves_right if side == "left" else jt.preserves_left

        def full(v, dtype=torch.int8):
            return torch.full((N, W), v, dtype=dtype, device=dev)

        p0 = full(False, torch.bool)   # lane 2w visible
        p1 = full(False, torch.bool)   # lane 2w+1 visible
        op0 = full(op_plain)
        op1 = full(OP_UPDATE_INSERT)
        pself = torch.zeros(N, dtype=torch.bool, device=dev)  # lane 2W
        # per lane: are the A columns non-null
        a0 = full(True, torch.bool)
        a1 = full(True, torch.bool)

        if is_insert:
            trans = matches & (d0 + r == 0)
        else:
            trans = matches & (d0 - t == 0) & (r == t - 1)

        if sa is None:
            p0 = matches
            if b_outer:
                # transition lanes emit an adjacent update pair replacing /
                # restoring the opposite side's null-padded row
                p1 = trans
                op0 = torch.where(trans, full(OP_UPDATE_DELETE), op0)
                if is_insert:
                    a0 = ~trans   # U- row is (B row, A-null)
                else:
                    a1 = full(False, torch.bool)  # U+ row is (B, A-null)
            if a_outer:
                pself = sel & (c_cnt == 0)
        elif sa == side:
            # input on the preserved side: emit/retract own row only
            pself = sel & ((c_cnt == 0) if jt.is_anti else (c_cnt > 0))
        else:
            # input on the non-preserved side: emit/retract opposite rows on
            # degree transitions
            p0 = trans
            plain = OP_INSERT if is_insert != jt.is_anti else OP_DELETE
            op0 = full(plain)

        L = 2 * W + 1

        def lanes(w0, w1, self_v, dtype):
            out = torch.empty((N, L), dtype=dtype, device=dev)
            out[:, 0:2 * W:2] = w0
            out[:, 1:2 * W:2] = w1
            out[:, 2 * W] = self_v
            return out

        ops = lanes(op0, op1, op_plain, torch.int8)
        vis = lanes(p0, p1, pself, torch.bool)

        a_col_list = []   # input side's columns in output
        for c in chunk.columns:
            bd = c.data[:, None].expand(N, W)
            bm = c.mask[:, None].expand(N, W)
            a_col_list.append((lanes(bd, bd, c.data, c.data.dtype),
                               lanes(bm & a0, bm & a1, c.mask, torch.bool)))
        b_col_list = []   # opposite side's columns (null in the self lane)
        for d, m in zip(b_datas, b_masks):
            b_col_list.append((lanes(d, d, 0, d.dtype),
                               lanes(m, m, False, torch.bool)))

        if sa is None:
            cols = (a_col_list + b_col_list if side == "left"
                    else b_col_list + a_col_list)
        elif sa == side:
            cols = a_col_list
        else:
            cols = b_col_list
        return ops, vis, tuple(cols)


def _stamp(lru: torch.Tensor, slots: torch.Tensor, ok: torch.Tensor,
           step) -> None:
    """``lru[slots[ok]] = max(lru, step)`` in place, with no host sync."""
    idx = torch.where(ok, slots, torch.full_like(slots, lru.shape[0]))
    scatter_reduce(lru, idx, stamps(step, idx.shape[0], idx.device), "max")


def pass_flags(chunks: StreamChunk) -> list:
    """(any delete, any insert) per chunk of a [K, C] batch, read to the
    host in one transfer: the ``passes`` argument of ``apply_chunk``."""
    dels = (chunks.ops == OP_DELETE) | (chunks.ops == OP_UPDATE_DELETE)
    return torch.stack([(chunks.vis & dels).any(-1),
                        (chunks.vis & ~dels).any(-1)], -1).tolist()


def clean_side_below(st: JoinSideState, col_idx: int,
                     threshold) -> JoinSideState:
    """Watermark state cleaning (in place): free the rows whose ``col_idx``
    value is below ``threshold``. Freed lanes become tombstones with
    ``ckpt_dirty`` set, so the next checkpoint writes their deletes;
    ``compact_side`` afterwards reclaims the key slots. Opposite-side
    degrees are not adjusted: by the watermark's contract a cleaned row
    can never match again."""
    cleaned = (st.occupied & st.row_mask[col_idx]
               & (st.row_data[col_idx] < threshold))
    st.occupied &= ~cleaned
    st.tomb |= cleaned
    st.ckpt_dirty |= cleaned
    return st


def compact_side(core: JoinCore, old: JoinSideState, schema: Schema,
                 key_idx: Sequence[int]) -> JoinSideState:
    """A new side whose key table holds only the keys with live or
    tombstoned rows, inserted in slot order, with the bucket tensors moved
    by the slot remap (open-addressing slots cannot be freed in place).
    Run after the checkpoint cleared the tombstones. ``old`` is not
    written."""
    cap, W = core.capacity, core.W
    dev = old.occupied.device
    key_types = tuple(schema[i].type for i in key_idx)
    key_live = old.ht.occupied & (old.occupied | old.tomb).any(1)
    key_cols = [Column(kd, km)
                for kd, km in zip(old.ht.key_data, old.ht.key_mask)]
    ht, slots, _, rebuild_ovf = ht_lookup_or_insert(
        ht_new(key_types, cap, dev), key_cols, key_live)
    rows = (key_live & (slots < cap)).nonzero().squeeze(1)
    dst = slots[rows]

    def move(arr: torch.Tensor) -> torch.Tensor:
        out = torch.zeros_like(arr)
        out[dst] = arr[rows]
        return out

    return JoinSideState(
        ht=ht,
        row_data=tuple(move(rd) for rd in old.row_data),
        row_mask=tuple(move(rm) for rm in old.row_mask),
        occupied=move(old.occupied), tomb=move(old.tomb),
        degree=move(old.degree), ckpt_dirty=move(old.ckpt_dirty),
        lru=move(old.lru),
        # a key that exhausts probing in the rebuild would lose its bucket:
        # surface it
        ht_overflow=old.ht_overflow | rebuild_ovf,
        lane_overflow=old.lane_overflow.clone(),
        inconsistent=old.inconsistent.clone())


def _side_evictable_keys(st: JoinSideState) -> torch.Tensor:
    """bool[cap]: key slots with a live row and no NULL key column (their
    rows could not be faulted back by key lookup, so they stay resident
    and do not count toward the budget)."""
    live = st.ht.occupied & st.occupied.any(1)
    for km in st.ht.key_mask:
        live = live & km
    return live


def join_evict_plan(state: JoinState, keep: int):
    """The cold keys to evict from BOTH arenas so about ``keep`` of the
    hottest remain per side. The two sides' stamps for one key value are
    kept equal by ``apply_chunk(step=...)``, so one threshold, the larger
    of the two sides', names the same key set on both. Returns (mask_l
    bool[cap], mask_r bool[cap], packed int64[4] = [n_evict_l, n_evict_r,
    n_live_l, n_live_r])."""
    cap = state.left.lru.shape[0]

    def thr_of(st):
        live = _side_evictable_keys(st)
        n_live = live.sum()
        key = torch.where(live, st.lru,
                          torch.full_like(st.lru, torch.iinfo(torch.int32).max))
        skey = torch.sort(key).values
        k = torch.clamp(n_live - keep, 0, cap - 1)
        thr = torch.where(k > 0, skey[torch.clamp_min(k - 1, 0)],
                          torch.full_like(skey[0], -1))
        return thr, n_live, live

    thr_l, nl, live_l = thr_of(state.left)
    thr_r, nr, live_r = thr_of(state.right)
    thr = torch.maximum(thr_l, thr_r)
    mask_l = live_l & (state.left.lru <= thr)
    mask_r = live_r & (state.right.lru <= thr)
    packed = torch.stack([mask_l.sum(), mask_r.sum(), nl, nr])
    return mask_l, mask_r, packed


def apply_evict_side(st: JoinSideState, mask: torch.Tensor) -> JoinSideState:
    """Clear the evicted keys' buckets (in place) without tombstones or
    dirty marks: the durable rows this barrier's checkpoint wrote are the
    cold copies. Call after the checkpoint cleared tomb/ckpt_dirty and
    before ``compact_side``."""
    m2 = mask[:, None]
    st.occupied &= ~m2
    for rm in st.row_mask:
        rm &= ~m2
    st.degree.masked_fill_(m2, 0)
    st.lru.masked_fill_(mask, 0)
    return st


def import_side(core: JoinCore, old: JoinSideState, schema: Schema,
                key_idx: Sequence[int]) -> JoinSideState:
    """Re-layout one side's state into ``core``'s (bigger) geometry.

    Width growth pads lanes; capacity growth rehashes the keys into a new
    table and moves whole buckets by the slot remap. Degrees move with the
    rows."""
    cap, W = core.capacity, core.W
    old_cap, old_W = old.occupied.shape
    if cap < old_cap or W < old_W:
        raise ValueError("import_side only grows the geometry")
    dev = old.occupied.device

    def pad(a, fill=False):
        out = torch.full((old_cap, W), fill, dtype=a.dtype, device=dev)
        out[:, :old_W] = a
        return out

    row_data = tuple(pad(rd, 0) for rd in old.row_data)
    row_mask = tuple(pad(rm) for rm in old.row_mask)
    occupied = pad(old.occupied)
    tomb = pad(old.tomb)
    degree = pad(old.degree, 0)
    ckpt_dirty = pad(old.ckpt_dirty)

    if cap == old_cap:
        ht = old.ht
        lru = old.lru.clone()

        def move(padded, fill):
            return padded
    else:
        key_types = tuple(schema[i].type for i in key_idx)
        key_cols = [Column(kd, km)
                    for kd, km in zip(old.ht.key_data, old.ht.key_mask)]
        ht, new_slots, _, ovf = ht_lookup_or_insert(
            ht_new(key_types, cap, dev), key_cols, old.ht.occupied)
        if bool(ovf):  # cannot happen: cap > old_cap
            raise RuntimeError("rehash overflow")

        def move(padded, fill):
            out = torch.full(((cap, W) if padded.dim() == 2 else (cap,)),
                             fill, dtype=padded.dtype, device=dev)
            set_where(out, old.ht.occupied, new_slots, padded)
            return out

        lru = move(old.lru, 0)

    return JoinSideState(
        ht=ht,
        row_data=tuple(move(rd, 0) for rd in row_data),
        row_mask=tuple(move(rm, False) for rm in row_mask),
        occupied=move(occupied, False),
        tomb=move(tomb, False),
        degree=move(degree, 0),
        ckpt_dirty=move(ckpt_dirty, False),
        lru=lru,
        ht_overflow=_bool(dev), lane_overflow=_bool(dev),
        inconsistent=old.inconsistent.clone())


def import_state(core: JoinCore, old: JoinState) -> JoinState:
    return JoinState(
        left=import_side(core, old.left, core.left_schema, core.left_keys),
        right=import_side(core, old.right, core.right_schema,
                          core.right_keys))
