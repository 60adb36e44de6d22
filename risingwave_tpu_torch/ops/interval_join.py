"""Bucketed interval/window join core — the fused q7 join.

Counterpart of ``risingwave_tpu/ops/interval_join.py``. Both sides are
bucketed by window id (``ts // window_us``) into a ring of ``n_buckets``
slots; each slot stores up to ``lane_width`` probe rows and the running
MAX of the build value (q7: MAX(price) per window). A chunk step probe-
inserts rows and emits matches against the build rows the downstream has
already seen; the barrier flush matches the build-side delta against the
stored arena as two [n_buckets, W] masks (kernel B2, ``interval_match``)
and gathers them into output chunks, deletes before inserts.

Device discipline, so that an epoch runs without a host sync:

  * ``apply_chunk`` reads nothing back: no ``.item()``, no ``nonzero``, no
    boolean-mask indexing. Every dropped write of the reference
    (``.at[...](mode="drop")``) goes to a cell of its own — a spare cell of
    the row arena past its ``n_buckets * W`` cells, one per chunk row, or
    the row's own index in a per-bucket vector carrying the op's identity
    (``hash_table.scatter_reduce``) — never to one shared sentinel cell,
    which would serialize the card's stores and atomics.
  * ``gather_flush`` finds the k-th flush unit by ``searchsorted`` over the
    masks' inclusive prefix counts (the reference uses a fixed-size
    ``jnp.nonzero``, which would sync here).

State: the row arenas are written in place; the per-bucket vectors are
replaced by new tensors at each step, so a reference taken before a step
keeps the values it had — the fused epoch relies on this for
``old_emitted_max`` across ``finish_flush``.

``interval_match`` launches the CUDA kernel ``csrc/interval_match.cu`` for
CUDA tensors and runs ``interval_match_plain`` (the counterpart of
``interval_match_jnp``) for CPU tensors; neither falls back to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
from collections.abc import Mapping
from typing import Optional

import numpy as np
import torch

from .. import DEFAULT_DEVICE, kernels
from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_INSERT, Column, StreamChunk,
)
from ..common.types import Field, Schema
from .hash_table import scatter_reduce

_NEG = torch.iinfo(torch.int64).min

#: the state's per-bucket vectors and flags (every field but the arenas)
VECTOR_FIELDS = ("win_id", "fill", "touched", "cur_max", "cur_cnt",
                 "emitted_max", "emitted_live", "lane_overflow",
                 "ring_clobber", "saw_delete")


@dataclasses.dataclass
class IntervalJoinState:
    win_id: torch.Tensor       # int64[nb]: window id resident in slot; -1
    fill: torch.Tensor         # int32[nb]: stored probe rows (lanes 0..fill-1)
    row_data: tuple[torch.Tensor, ...]  # per probe column: dtype[nb, W]
    row_mask: tuple[torch.Tensor, ...]  # per probe column: bool[nb, W]
    touched: torch.Tensor      # bool[nb]: bucket hit since last flush
    cur_max: torch.Tensor      # int64[nb]: running MAX incl. unflushed rows
    cur_cnt: torch.Tensor      # int64[nb]: contributing rows (liveness)
    emitted_max: torch.Tensor  # int64[nb]: build value downstream last saw
    emitted_live: torch.Tensor  # bool[nb]: build row exists downstream
    lane_overflow: torch.Tensor  # bool scalar, sticky: bucket lanes full
    ring_clobber: torch.Tensor   # bool scalar, sticky: slot reused dirty
    saw_delete: torch.Tensor     # bool scalar, sticky: probe-side delete
    # flat buffers behind row_data / row_mask: nb*W arena cells, then one
    # spare cell per row of the largest chunk applied so far (dropped rows)
    row_store: tuple[torch.Tensor, ...] = ()
    mask_store: tuple[torch.Tensor, ...] = ()


def _arena(rows: torch.Tensor, spare: int):
    """A flat buffer holding ``rows`` ([nb, W]) then ``spare`` cells, and
    the [nb, W] view of its arena part."""
    nb, w = rows.shape
    store = torch.empty(nb * w + spare, dtype=rows.dtype, device=rows.device)
    view = store[:nb * w].view(nb, w)
    view.copy_(rows)
    return store, view


def new_state(vectors: dict, rows, masks) -> IntervalJoinState:
    """A state from its per-bucket vectors (a dict under the field names)
    and its [nb, W] row and mask arenas, copied into fresh stores."""
    data = [_arena(r, 0) for r in rows]
    mask = [_arena(m, 0) for m in masks]
    return IntervalJoinState(
        **{f: vectors[f] for f in VECTOR_FIELDS},
        row_data=tuple(v for _, v in data),
        row_mask=tuple(v for _, v in mask),
        row_store=tuple(s for s, _ in data),
        mask_store=tuple(s for s, _ in mask))


def _spare_cells(state: IntervalJoinState) -> int:
    return state.row_store[0].numel() - state.row_data[0].numel()


class IntervalJoinCore:
    """Static config + steps of one bucketed interval join.

    ``probe_schema``: schema of the (already projected) probe input.
    ``ts_col``: column holding the window start (any value whose
    ``// window_us`` is the window id). ``val_col``: column compared with
    the build aggregate (q7: price == MAX(price) over the window).
    ``band_col``/``band_us``: optional band — rows only match while the
    ``band_col`` value is in [win_start, win_start + band_us).

    Output schema: probe columns ++ (window_start, agg_val)."""

    def __init__(self, probe_schema: Schema, ts_col: int, val_col: int,
                 window_us: int, n_buckets: int = 1 << 15,
                 lane_width: int = 128,
                 band_col: Optional[int] = None,
                 band_us: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        if window_us <= 0:
            raise ValueError("window_us must be positive")
        if (band_col is None) != (band_us is None):
            raise ValueError("band_col and band_us come together")
        self.probe_schema = probe_schema
        self.ts_col = ts_col
        self.val_col = val_col
        self.window_us = int(window_us)
        self.n_buckets = int(n_buckets)
        self.W = int(lane_width)
        self.band_col = band_col
        self.band_us = band_us
        self.device = torch.device(device)
        self.out_schema = probe_schema.concat(Schema((
            Field("window_start", probe_schema[ts_col].type),
            Field("agg_val", probe_schema[val_col].type),
        )))

    # -- state ----------------------------------------------------------------

    def init_state(self) -> IntervalJoinState:
        nb, W, dev = self.n_buckets, self.W, self.device

        def full(shape, v, dtype):
            return torch.full(shape, v, dtype=dtype, device=dev)

        flag = torch.zeros((), dtype=torch.bool, device=dev)
        return new_state(
            dict(win_id=full((nb,), -1, torch.int64),
                 fill=full((nb,), 0, torch.int32),
                 touched=full((nb,), False, torch.bool),
                 cur_max=full((nb,), _NEG, torch.int64),
                 cur_cnt=full((nb,), 0, torch.int64),
                 emitted_max=full((nb,), _NEG, torch.int64),
                 emitted_live=full((nb,), False, torch.bool),
                 lane_overflow=flag, ring_clobber=flag.clone(),
                 saw_delete=flag.clone()),
            [full((nb, W), 0, f.type.dtype) for f in self.probe_schema],
            [full((nb, W), False, torch.bool) for _ in self.probe_schema])

    def _reserve(self, state: IntervalJoinState, n: int) -> None:
        """Give the row arenas at least ``n`` spare cells (a one-time
        re-allocation when a larger chunk than before arrives)."""
        if _spare_cells(state) >= n:
            return
        data = [_arena(r, n) for r in state.row_data]
        mask = [_arena(m, n) for m in state.row_mask]
        state.row_store = tuple(s for s, _ in data)
        state.row_data = tuple(v for _, v in data)
        state.mask_store = tuple(s for s, _ in mask)
        state.row_mask = tuple(v for _, v in mask)

    # -- chunk step ------------------------------------------------------------

    def apply_chunk(self, state: IntervalJoinState, chunk: StreamChunk):
        """Insert one probe chunk and emit its matches against the build
        rows the downstream has already seen (``emitted_*``; build updates
        land at the next flush). Updates ``state`` and returns
        ``(state, out_chunk)``, out capacity = chunk capacity (at most one
        build row per window, so at most one match per probe row)."""
        nb, W = self.n_buckets, self.W
        N = chunk.capacity
        dev = chunk.device
        self._reserve(state, N)
        ts = chunk.columns[self.ts_col]
        val = chunk.columns[self.val_col]
        is_ins = (chunk.ops == OP_INSERT) | (chunk.ops == OP_UPDATE_INSERT)
        saw_delete = state.saw_delete | (chunk.vis & ~is_ins).any()
        valid = chunk.vis & is_ins & ts.mask & val.mask
        wid = torch.div(ts.data.to(torch.int64), self.window_us,
                        rounding_mode="floor")
        slot = wid % nb
        rows = torch.arange(N, dtype=torch.int64, device=dev)

        # ---- ring turnover: the newest window id claims its slot
        win_id = state.win_id.clone()
        scatter_reduce(win_id, torch.where(valid, slot, nb),
                       torch.where(valid, wid, -1), "max")
        turned = win_id != state.win_id
        cur_live = state.cur_cnt > 0
        slot_dirty = state.touched & (
            (cur_live != state.emitted_live)
            | (cur_live & (state.cur_max != state.emitted_max)))
        # rows whose slot now holds a NEWER window are flagged and dropped
        stale = valid & (win_id[slot] != wid)
        ring_clobber = (state.ring_clobber | (turned & slot_dirty).any()
                        | stale.any())
        ok = valid & ~stale

        fill = torch.where(turned, 0, state.fill)
        touched = state.touched & ~turned
        cur_max = torch.where(turned, _NEG, state.cur_max)
        cur_cnt = torch.where(turned, 0, state.cur_cnt)
        emitted_max = torch.where(turned, _NEG, state.emitted_max)
        emitted_live = state.emitted_live & ~turned

        # ---- lane assignment: rank among same-slot rows by a stable sort,
        # then lane = bucket fill + rank
        sort_key = torch.where(ok, slot, nb)
        order = torch.argsort(sort_key, stable=True)
        ks = sort_key[order]
        run_start = torch.ones(N, dtype=torch.bool, device=dev)
        run_start[1:] = ks[1:] != ks[:-1]
        rank_sorted = rows - torch.cummax(
            torch.where(run_start, rows, 0), 0).values
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted

        lane = fill[slot].to(torch.int64) + rank
        lane_ok = ok & (lane < W)
        lane_overflow = state.lane_overflow | (ok & (lane >= W)).any()
        cell = torch.where(lane_ok, slot * W + lane, nb * W + rows)
        for store, c in zip(state.row_store, chunk.columns):
            store[cell] = c.data
        for store, c in zip(state.mask_store, chunk.columns):
            store[cell] = c.mask
        s_ok = torch.where(lane_ok, slot, nb)
        added = torch.zeros(nb, dtype=torch.int32, device=dev)
        scatter_reduce(added, s_ok, lane_ok.to(torch.int32), "add")
        fill = fill + added
        touched = touched | (added > 0)
        cur_cnt = cur_cnt + added
        v = val.data.to(torch.int64)
        scatter_reduce(cur_max, s_ok, v, "max")

        # ---- probe emission against the flushed build rows
        match = lane_ok & emitted_live[slot] & (v == emitted_max[slot])
        if self.band_col is not None:
            bts = chunk.columns[self.band_col].data.to(torch.int64)
            ws = wid * self.window_us
            match = match & (bts >= ws) & (bts < ws + self.band_us)
        out = self._emit_probe(chunk, slot, wid, emitted_max, match)

        state.win_id, state.fill, state.touched = win_id, fill, touched
        state.cur_max, state.cur_cnt = cur_max, cur_cnt
        state.emitted_max, state.emitted_live = emitted_max, emitted_live
        state.lane_overflow, state.ring_clobber = lane_overflow, ring_clobber
        state.saw_delete = saw_delete
        return state, out

    def _emit_probe(self, chunk, slot, wid, emitted_max, match):
        ts_dtype = self.probe_schema[self.ts_col].type.dtype
        val_dtype = self.probe_schema[self.val_col].type.dtype
        win_start = (wid * self.window_us).to(ts_dtype)
        bmax = emitted_max[slot].to(val_dtype)
        cols = tuple(chunk.columns) + (Column(win_start, match),
                                       Column(bmax, match))
        return StreamChunk(torch.zeros_like(chunk.ops), match, cols)

    # -- barrier flush ---------------------------------------------------------

    def _occ_band(self, state: IntervalJoinState) -> torch.Tensor:
        """bool[nb, W]: stored lanes that are live AND inside the band."""
        lanes = torch.arange(self.W, dtype=torch.int32,
                             device=state.fill.device)
        occ = lanes[None, :] < state.fill[:, None]
        if self.band_col is not None:
            bts = state.row_data[self.band_col].to(torch.int64)
            ws = (state.win_id * self.window_us)[:, None]
            occ = occ & (bts >= ws) & (bts < ws + self.band_us)
        return occ

    def match_inputs(self, state: IntervalJoinState):
        """The flush's inputs to ``interval_match``: stored values, live
        in-band lanes, and per bucket the old emitted max and liveness
        (touched buckets only) and the new max and liveness."""
        cur_live = state.cur_cnt > 0
        return (state.row_data[self.val_col].to(torch.int64),
                self._occ_band(state),
                state.emitted_max, state.touched & state.emitted_live,
                state.cur_max, state.touched & cur_live)

    def flush_plan(self, state: IntervalJoinState):
        """Match grids of the epoch flush: DELETE against the old emitted
        max, INSERT against the new one, for every touched bucket. Returns
        ``(del_mask [nb, W], ins_mask [nb, W], packed int64[4])`` with
        ``packed`` = [n_units, lane_overflow, ring_clobber, saw_delete]."""
        del_mask, ins_mask = interval_match(*self.match_inputs(state))
        packed = torch.stack([
            del_mask.sum() + ins_mask.sum(),
            state.lane_overflow.to(torch.int64),
            state.ring_clobber.to(torch.int64),
            state.saw_delete.to(torch.int64),
        ])
        return del_mask, ins_mask, packed

    def gather_flush(self, state: IntervalJoinState, del_mask, ins_mask,
                     old_emitted_max, lo: int,
                     out_capacity: int) -> StreamChunk:
        """Flush units with global rank in [lo, lo + out_capacity) as one
        output chunk: deletes (against ``old_emitted_max``) rank first,
        inserts (against ``cur_max``) after, each in arena order. Output
        slot j holds unit lo + j, found as the first arena cell whose
        inclusive prefix count reaches its rank. Drive as ``for lo in
        range(0, n_units, out_capacity)``."""
        W = self.W
        dcum = torch.cumsum(del_mask.reshape(-1), 0)
        icum = torch.cumsum(ins_mask.reshape(-1), 0)
        n_del = dcum[-1]
        u = lo + torch.arange(out_capacity, dtype=torch.int64,
                              device=dcum.device)
        take_del = u < n_del
        src = torch.where(take_del,
                          torch.searchsorted(dcum, u + 1),
                          torch.searchsorted(icum, u - n_del + 1))
        vis = u < n_del + icum[-1]
        src = torch.where(vis, src, 0)
        bucket = src // W

        ops = torch.where(take_del, OP_DELETE, OP_INSERT).to(torch.int8)
        cols = [Column(rd.reshape(-1)[src], rm.reshape(-1)[src] & vis)
                for rd, rm in zip(state.row_data, state.row_mask)]
        ts_dtype = self.probe_schema[self.ts_col].type.dtype
        val_dtype = self.probe_schema[self.val_col].type.dtype
        ws = (state.win_id[bucket] * self.window_us).to(ts_dtype)
        bval = torch.where(take_del, old_emitted_max[bucket],
                           state.cur_max[bucket]).to(val_dtype)
        cols.append(Column(ws, vis))
        cols.append(Column(bval, vis))
        return StreamChunk(ops, vis, tuple(cols))

    def finish_flush(self, state: IntervalJoinState) -> IntervalJoinState:
        """Advance the downstream-visible build rows to the current agg and
        clear the touched set. The three vectors are replaced, not written:
        an ``emitted_max`` taken before this call stays the old max."""
        cur_live = state.cur_cnt > 0
        state.emitted_max = torch.where(state.touched, state.cur_max,
                                        state.emitted_max)
        state.emitted_live = torch.where(state.touched, cur_live,
                                         state.emitted_live)
        state.touched = torch.zeros_like(state.touched)
        return state

    # -- checkpoint / recovery -------------------------------------------------

    def export_host(self, state: IntervalJoinState) -> dict:
        """State → named numpy arrays (the checkpoint payload), which
        round-trip exactly through ``import_host``."""
        out = {f: getattr(state, f).cpu().numpy() for f in VECTOR_FIELDS}
        out["row_data"] = [a.cpu().numpy() for a in state.row_data]
        out["row_mask"] = [a.cpu().numpy() for a in state.row_mask]
        return out

    def import_host(self, payload: dict) -> IntervalJoinState:
        """Recovery: a checkpoint payload (this package's ``export_host``
        or the reference's) → fresh state on the core's device."""
        return state_from_host(payload, self.device)


def state_from_host(payload, device) -> IntervalJoinState:
    """A fresh state on ``device`` from host arrays under the state's field
    names: a mapping (``export_host``'s payload) or an object with those
    attributes (the reference's state with numpy leaves)."""
    def get(name):
        return (payload[name] if isinstance(payload, Mapping)
                else getattr(payload, name))

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return new_state({f: t(get(f)) for f in VECTOR_FIELDS},
                     [t(a) for a in get("row_data")],
                     [t(a) for a in get("row_mask")])


# ---------------------------------------------------------------------------
# kernel B2: the flush match grids
# ---------------------------------------------------------------------------


def interval_match_plain(vals, occ, old_max, old_live, new_max, new_live):
    """Plain PyTorch version: per (bucket, lane) delete/insert matches of
    the flush. int64/bool inputs; returns (bool[nb, W], bool[nb, W])."""
    del_mask = occ & old_live[:, None] & (vals == old_max[:, None])
    ins_mask = occ & new_live[:, None] & (vals == new_max[:, None])
    return del_mask, ins_mask


def _check(vals, occ, old_max, old_live, new_max, new_live) -> None:
    for name, t, dtype, dims in (
            ("vals", vals, torch.int64, 2), ("occ", occ, torch.bool, 2),
            ("old_max", old_max, torch.int64, 1),
            ("old_live", old_live, torch.bool, 1),
            ("new_max", new_max, torch.int64, 1),
            ("new_live", new_live, torch.bool, 1)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != dims:
            raise ValueError(f"{name} must have {dims} dimensions")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != vals.device:
            raise ValueError(f"{name} is on {t.device}, vals on "
                             f"{vals.device}")
    nb, w = vals.shape
    if occ.shape != vals.shape or any(
            t.shape != (nb,) for t in (old_max, old_live, new_max, new_live)):
        raise ValueError("shapes: want vals/occ [nb, W] and the four bucket "
                         "vectors [nb]")
    if nb >= 1 << 31 or w >= 1 << 31:
        raise ValueError("nb and W must fit in int32")


def _launcher():
    lib = kernels.load("interval_match")
    fn = lib.interval_match_launch
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def interval_match(vals, occ, old_max, old_live, new_max, new_live):
    """``(del_mask, ins_mask)`` as bool[nb, W]: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(vals, occ, old_max, old_live, new_max, new_live)
    dev = vals.device
    if dev.type == "cpu":
        return interval_match_plain(vals, occ, old_max, old_live, new_max,
                                    new_live)
    if dev.type != "cuda":
        raise ValueError(f"interval_match: unsupported device {dev}")
    nb, w = vals.shape
    del_mask = torch.empty((nb, w), dtype=torch.bool, device=dev)
    ins_mask = torch.empty((nb, w), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(vals.data_ptr(), occ.data_ptr(),
                          old_max.data_ptr(), old_live.data_ptr(),
                          new_max.data_ptr(), new_live.data_ptr(),
                          del_mask.data_ptr(), ins_mask.data_ptr(), nb, w,
                          stream)
    if err != 0:
        raise RuntimeError(
            f"interval_match kernel launch failed: cudaError {err}")
    interval_match.launches += 1
    return del_mask, ins_mask


#: kernel launches since the last reset (launches only, not plain runs)
interval_match.launches = 0
