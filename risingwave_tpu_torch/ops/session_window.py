"""Session-gap window core — the NEXmark q8 shape as device-resident state.

Counterpart of ``risingwave_tpu/ops/session_window.py``. Events are grouped
per key into sessions, maximal runs whose consecutive gaps stay within
``gap_us``; a session row (key, start, end, n_events) is emitted once the
session closes (a later event of the key opens a new one, or the watermark
passes ``last_ts + gap``). The state is a hash table keyed by the session key
(``ops/hash_table.py``, kernel B3 on the card) with three lanes per key (open
session start, last event time, count) and a closed-session buffer that
collects emissions between barriers.

A chunk is sorted by (key slot, ts) with two stable sorts; a segment starts
where the key changes or the gap inside the chunk exceeds ``gap_us``.
Sessions close where a segment ends but its key's run goes on, where a run's
first segment does not extend the stored open session, and at the barrier
for open sessions the watermark has passed. Closures append to the buffer
by rank.

Device discipline, so that an epoch runs without a host sync: the state is
updated in place and nothing is read back. Each of the reference's dropped
writes (``.at[pos].set(v, mode="drop")``) is ``hash_table.set_rows``: the
kept rows, at distinct positions, add ``new - old``; a dropped row adds 0 to
a cell of its own, never to one shared cell. All state lanes are int64,
where that sum is exact.

Assumptions, each with a sticky flag as in the reference: append-only input
(``saw_delete``), per-key event time non-decreasing across chunks
(``out_of_order``), a closed buffer that outlasts one epoch's closures
(``closed_overflow``), a table that holds every key seen (``overflow``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import OP_INSERT, OP_UPDATE_INSERT, Column, StreamChunk
from ..common.types import INT64, TIMESTAMP, Field, Schema
from .hash_table import (
    DeviceHashTable, ht_lookup_or_insert, ht_new, set_rows,
)

#: the state's fields besides the table, in the reference's order
FIELDS = ("sess_start", "last_ts", "count", "closed_key", "closed_start",
          "closed_end", "closed_cnt", "closed_fill", "overflow",
          "closed_overflow", "saw_delete", "out_of_order")


@dataclasses.dataclass
class SessionWindowState:
    table: DeviceHashTable
    sess_start: torch.Tensor      # int64[cap]: open session start; -1 = none
    last_ts: torch.Tensor         # int64[cap]: open session's last event
    count: torch.Tensor           # int64[cap]: open session's event count
    closed_key: torch.Tensor      # int64[ccap]: closed-session buffer
    closed_start: torch.Tensor    # int64[ccap]
    closed_end: torch.Tensor      # int64[ccap]
    closed_cnt: torch.Tensor      # int64[ccap]
    closed_fill: torch.Tensor     # int32 scalar: buffer occupancy
    overflow: torch.Tensor        # bool scalar, sticky: key table full
    closed_overflow: torch.Tensor  # bool scalar, sticky: buffer full
    saw_delete: torch.Tensor      # bool scalar, sticky: non-insert input
    out_of_order: torch.Tensor    # bool scalar, sticky: per-key time rewind


class SessionWindowCore:
    """Static config and the steps of one session-window operator.

    ``key_col``/``ts_col``: input columns (the key an int64 type, the q8
    ids); ``gap_us``: the session gap. Output schema: (key, session_start,
    session_end, n_events)."""

    def __init__(self, in_schema: Schema, key_col: int, ts_col: int,
                 gap_us: int, capacity: int = 1 << 16,
                 closed_capacity: int = 1 << 16, device=DEFAULT_DEVICE):
        if gap_us <= 0:
            raise ValueError("gap_us must be positive")
        if capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.in_schema = in_schema
        self.key_col = key_col
        self.ts_col = ts_col
        self.key_type = in_schema[key_col].type
        self.gap_us = int(gap_us)
        self.capacity = int(capacity)
        self.closed_capacity = int(closed_capacity)
        self.device = torch.device(device)
        self.out_schema = Schema((
            Field(in_schema[key_col].name, self.key_type),
            Field("session_start", TIMESTAMP),
            Field("session_end", TIMESTAMP),
            Field("n_events", INT64),
        ))

    # -- state ----------------------------------------------------------------

    def init_state(self) -> SessionWindowState:
        cap, ccap, dev = self.capacity, self.closed_capacity, self.device

        def zeros(n, dtype=torch.int64):
            return torch.zeros(n, dtype=dtype, device=dev)

        return SessionWindowState(
            table=ht_new((self.key_type,), cap, dev),
            sess_start=torch.full((cap,), -1, dtype=torch.int64, device=dev),
            last_ts=zeros(cap), count=zeros(cap),
            closed_key=zeros(ccap), closed_start=zeros(ccap),
            closed_end=zeros(ccap), closed_cnt=zeros(ccap),
            closed_fill=zeros((), torch.int32),
            overflow=zeros((), torch.bool),
            closed_overflow=zeros((), torch.bool),
            saw_delete=zeros((), torch.bool),
            out_of_order=zeros((), torch.bool))

    # -- chunk step ------------------------------------------------------------

    def apply_chunk(self, state: SessionWindowState,
                    chunk: StreamChunk) -> SessionWindowState:
        """Fold one chunk into the sessions (in place)."""
        cap, ccap, gap = self.capacity, self.closed_capacity, self.gap_us
        n = chunk.capacity
        dev = chunk.device
        key = chunk.columns[self.key_col]
        ts = chunk.columns[self.ts_col]
        is_ins = (chunk.ops == OP_INSERT) | (chunk.ops == OP_UPDATE_INSERT)
        state.saw_delete |= (chunk.vis & ~is_ins).any()
        valid = chunk.vis & is_ins & key.mask & ts.mask
        _, slots, _, ovf = ht_lookup_or_insert(state.table, [key], valid)
        t64 = ts.data.to(torch.int64)

        # sort rows by (slot, ts): valid rows grouped per key, time-ascending
        # inside the group (two stable sorts)
        sort_slot = torch.where(valid, slots, cap)
        o1 = torch.sort(t64, stable=True).indices
        perm = o1[torch.sort(sort_slot[o1], stable=True).indices]
        s = sort_slot[perm]
        t = t64[perm]
        v = valid[perm]
        kv = key.data.to(torch.int64)[perm]
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        true1 = torch.ones(1, dtype=torch.bool, device=dev)

        run_start = torch.cat([true1, s[1:] != s[:-1]])
        t_prev = torch.cat([t[:1], t[:-1]])
        safe_s = s.clamp(0, cap - 1)
        st_start = state.sess_start[safe_s]
        st_last = state.last_ts[safe_s]
        st_cnt = state.count[safe_s]
        has_open = st_start >= 0

        # a segment is a maximal gap-free run of one key inside the chunk
        seg_flag = v & (run_start | (t - t_prev > gap))
        continues = run_start & v & has_open & (t - st_last <= gap)
        state.out_of_order |= (v & run_start & has_open
                               & (t < st_last)).any()
        seg_start_idx = torch.cummax(torch.where(seg_flag, idx, 0), 0).values
        seg_first_ts = t[seg_start_idx]
        seg_cnt = idx - seg_start_idx + 1
        # only a run's first segment can extend the stored open session
        seg_cont = run_start[seg_start_idx] & continues[seg_start_idx]

        nxt_v = torch.cat([v[1:], ~true1])
        nxt_seg = torch.cat([seg_flag[1:], ~true1])
        nxt_s = torch.cat([s[1:], torch.full_like(s[:1], cap)])
        seg_last = v & (~nxt_v | nxt_seg | (nxt_s != s))
        run_last = v & (~nxt_v | (nxt_s != s))

        # closures: (a) a stored open session that a run's first segment
        # does not extend; (b) every segment followed by a later segment of
        # its key
        close_state = v & run_start & has_open & ~continues
        close_seg = seg_last & ~run_last
        cs_start = torch.where(seg_cont, st_start, seg_first_ts)
        cs_cnt = torch.where(seg_cont, st_cnt + seg_cnt, seg_cnt)

        fill = state.closed_fill.to(torch.int64)
        na = close_state.sum()
        posa = fill + torch.cumsum(close_state, 0) - 1
        posb = fill + na + torch.cumsum(close_seg, 0) - 1
        pos = torch.cat([posa, posb])
        keep = torch.cat([close_state, close_seg]) & (pos < ccap)
        for buf, va, vb in ((state.closed_key, kv, kv),
                            (state.closed_start, st_start, cs_start),
                            (state.closed_end, st_last, t),
                            (state.closed_cnt, st_cnt, cs_cnt)):
            set_rows(buf, pos, keep, torch.cat([va, vb]))
        n_new = na + close_seg.sum()
        state.closed_overflow |= fill + n_new > ccap
        state.closed_fill = torch.clamp(fill + n_new, max=ccap).to(
            torch.int32)

        # the run's last segment stays open
        tgt_keep = run_last & (s < cap)
        set_rows(state.sess_start, s, tgt_keep, cs_start)
        set_rows(state.last_ts, s, tgt_keep, t)
        set_rows(state.count, s, tgt_keep, cs_cnt)
        state.overflow |= ovf
        return state

    # -- barrier flush ---------------------------------------------------------

    def flush_plan(self, state: SessionWindowState, watermark):
        """Close the open sessions the watermark has passed (``last_ts + gap
        <= watermark``) into the buffer. Returns ``(state, packed)``,
        ``packed`` = int64[5]: [n_closed, overflow, closed_overflow,
        saw_delete, out_of_order] — one host read covers the emission count
        and every sticky flag."""
        ccap = self.closed_capacity
        openm = (state.table.occupied & (state.sess_start >= 0)
                 & (state.last_ts + self.gap_us <= watermark))
        fill = state.closed_fill.to(torch.int64)
        pos = fill + torch.cumsum(openm, 0) - 1
        keep = openm & (pos < ccap)
        kv = state.table.key_data[0].to(torch.int64)
        for buf, vals in ((state.closed_key, kv),
                          (state.closed_start, state.sess_start),
                          (state.closed_end, state.last_ts),
                          (state.closed_cnt, state.count)):
            set_rows(buf, pos, keep, vals)
        n = openm.sum()
        state.closed_overflow |= fill + n > ccap
        state.closed_fill = torch.clamp(fill + n, max=ccap).to(torch.int32)
        state.sess_start.masked_fill_(openm, -1)
        state.count.masked_fill_(openm, 0)
        packed = torch.stack([
            state.closed_fill.to(torch.int64), state.overflow.long(),
            state.closed_overflow.long(), state.saw_delete.long(),
            state.out_of_order.long()])
        return state, packed

    def snapshot_closed(self, state: SessionWindowState):
        """The epoch's emission payload: copies of the four buffers (the
        next chunk step writes the buffers in place)."""
        return (state.closed_key.clone(), state.closed_start.clone(),
                state.closed_end.clone(), state.closed_cnt.clone())

    def finish_flush(self, state: SessionWindowState) -> SessionWindowState:
        state.closed_fill = torch.zeros_like(state.closed_fill)
        return state

    def gather_closed(self, snapshot, n_closed, lo,
                      out_capacity: int) -> StreamChunk:
        """The closed sessions with buffer rank in [lo, lo + out_capacity) as
        one INSERT chunk (a session closes exactly once); drive as ``for lo
        in range(0, n_closed, out_capacity)``."""
        ck, cs, ce, cn = snapshot
        ccap = ck.shape[0]
        j = lo + torch.arange(out_capacity, dtype=torch.int64,
                              device=ck.device)
        vis = j < n_closed
        src = j.clamp(0, ccap - 1)
        cols = (Column(ck[src].to(self.key_type.dtype), vis),
                Column(cs[src], vis), Column(ce[src], vis),
                Column(cn[src], vis))
        return StreamChunk(torch.zeros(out_capacity, dtype=torch.int8,
                                       device=ck.device), vis, cols)

    # -- checkpoint / recovery -------------------------------------------------

    def export_host(self, state: SessionWindowState) -> dict:
        """State → named numpy arrays (the reference's payload layout),
        which round-trip exactly through ``import_host``."""
        out = {f: getattr(state, f).cpu().numpy() for f in FIELDS}
        out["table_key_data"] = [a.cpu().numpy()
                                 for a in state.table.key_data]
        out["table_key_mask"] = [a.cpu().numpy()
                                 for a in state.table.key_mask]
        out["table_occupied"] = state.table.occupied.cpu().numpy()
        return out

    def import_host(self, payload) -> SessionWindowState:
        """Recovery from a payload of this package's or the reference's
        ``export_host``, or from the reference's state with numpy leaves."""
        return state_from_host(payload, self.device)


def state_from_host(payload, device) -> SessionWindowState:
    """A fresh state on ``device`` from host arrays: an ``export_host``
    payload (a mapping with ``table_*`` entries) or an object with the
    state's attributes and a ``table``."""
    def get(obj, name):
        return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    if isinstance(payload, Mapping):
        table = DeviceHashTable(
            tuple(t(a) for a in payload["table_key_data"]),
            tuple(t(a) for a in payload["table_key_mask"]),
            t(payload["table_occupied"]))
    else:
        tab = payload.table
        table = DeviceHashTable(tuple(t(a) for a in tab.key_data),
                                tuple(t(a) for a in tab.key_mask),
                                t(tab.occupied))
    return SessionWindowState(table=table,
                              **{f: t(get(payload, f)) for f in FIELDS})
