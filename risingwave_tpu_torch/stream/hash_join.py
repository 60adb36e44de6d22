"""HashJoinExecutor — streaming equi-join on device-resident state.

Host control loop over the join step (ops/join_state.py). Counterpart of
``risingwave_tpu/stream/hash_join.py``: every join type, non-equi
conditions, batched ingest, overflow growth, checkpoint and recovery,
watermark state cleaning and cold-tier eviction.

Optimistic emission: reading a chunk's output size and overflow flags is a
host sync, so up to ``emit_batch`` chunks are applied before their packed
stats are fetched in one transfer. The state is updated in place, so the
first chunk of a batch takes a ``clone()`` snapshot; if any chunk of the
batch overflowed, the executor rewinds to it and replays the batch chunk by
chunk through the growing path. A ChunkBatch goes through the same path in
sub-batches of ``emit_batch`` chunks, with one read for the whole batch of
which passes (deletes, inserts) each chunk needs, so applying a sub-batch
reads nothing back.

Durability: each side has an optional StateTable holding its live rows
(pk = the stream pk). A checkpoint barrier writes the rows changed since
the last one (deletes of tombstoned rows, then upserts of live rows).
Degrees are not stored: recovery replays both sides' rows through the
insert path with the output discarded, which rebuilds them exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    DEFAULT_CHUNK_CAPACITY, StreamChunk, count_units, flatten_shards,
    gather_units_window, physical_chunk,
)
from ..common.hashing import shard_rows
from ..ops.join_state import (
    JoinCore, JoinState, JoinType, apply_evict_side, clean_side_below,
    compact_side, import_state, join_evict_plan, pass_flags,
)
from .barrier_align import barrier_align
from .cache import LruClock, canonical_key
from .executor import Executor
from .hash_agg import host_rows

#: rows per chunk of a recovery or fault-in replay (the reference's size: the
#: arena layout depends on it)
REPLAY_BATCH = 1024


class HashJoinExecutor(Executor):
    identity = "HashJoin"

    def __init__(
        self,
        left: Executor,
        right: Executor,
        left_keys: Sequence[int],
        right_keys: Sequence[int],
        join_type: JoinType = JoinType.INNER,
        condition=None,
        left_state_table=None,
        right_state_table=None,
        key_capacity: int = 1 << 13,
        bucket_width: int = 16,
        out_capacity: int = DEFAULT_CHUNK_CAPACITY,
        strict: bool = True,
        interval_clean: Sequence[tuple] = (),
        load_shard: Optional[tuple] = None,
        hbm_key_budget: Optional[int] = None,
        null_aware_anti: bool = False,
        device=DEFAULT_DEVICE,
    ):
        """``interval_clean``: tuples ``(clean_side, clean_col, watch_side,
        watch_col, lag)``: a watermark on ``watch_side``'s ``watch_col``
        frees, at the next checkpoint, the rows of ``clean_side`` whose
        ``clean_col`` is below ``watermark - lag``.

        ``load_shard``: (shard_idx, n_shards): on recovery keep only the
        rows whose join key hashes to this shard.

        ``hbm_key_budget``: cap on LIVE join keys per arena. A checkpoint
        that finds more evicts the coldest keys (LRU by touch step, equal
        across the two sides) from BOTH arenas to the state tables; a chunk
        that mentions an evicted key faults its rows back in. Needs both
        state tables, with pks that start with the join keys (fault-in is a
        pk prefix scan); must be below ``key_capacity``."""
        self.left, self.right = left, right
        self.load_shard = load_shard
        # NOT IN: a NULL on the build side would retract every emitted row,
        # which an incremental anti join cannot express — reject it
        self.null_aware_anti = (bool(null_aware_anti)
                                and join_type == JoinType.LEFT_ANTI)
        self._join_args = dict(join_type=join_type, condition=condition,
                               device=device)
        self._key_args = (left_keys, right_keys)
        self.interval_clean = tuple(interval_clean)
        self._pending_clean: dict[tuple[str, int], object] = {}
        # the highest threshold applied per (side, col): the fault-in filter
        self._applied_clean: dict[tuple[str, int], object] = {}
        self.core = JoinCore(left.schema, right.schema, left_keys,
                             right_keys, key_capacity=key_capacity,
                             bucket_width=bucket_width, **self._join_args)
        self.schema = self.core.out_schema
        self.out_capacity = out_capacity
        self.emit_batch = 16          # chunks applied per host sync
        self.strict = strict
        self.max_state_cells = 1 << 26    # growth ceiling (cap * W)
        self.state_tables = {"left": left_state_table,
                             "right": right_state_table}
        if hbm_key_budget is not None:
            if left_state_table is None or right_state_table is None:
                hbm_key_budget = None      # no cold tier to evict to
            elif hbm_key_budget >= key_capacity:
                raise ValueError("hbm_key_budget must be < key_capacity")
            else:
                # eviction bounds the arenas instead of the ceiling
                self.max_state_cells = 1 << 30
        self.hbm_key_budget = hbm_key_budget
        self._evicted: set = set()
        self._lru_clock = LruClock(hbm_key_budget is not None, device)
        self.state = self.core.init_state()
        self._pending: list = []
        self._rewind_state = None
        if any(self.state_tables.values()):
            self._load_from_state_tables()

    def _pykey(self, values) -> tuple:
        return canonical_key(values, self.core.key_types)

    def _side_info(self, side: str):
        """(schema, join-key column indices) of one input."""
        if side == "left":
            return self.core.left_schema, self.core.left_keys
        return self.core.right_schema, self.core.right_keys

    # -- adaptive growth -------------------------------------------------------

    def _apply_growing(self, side: str, chunk: StreamChunk,
                       step=None) -> StreamChunk:
        """Apply a chunk to a snapshot; on overflow discard it, grow the
        state geometry (bucket width for hot-key skew, key capacity for
        table fill) and retry on the untouched state. ``step``: the LRU
        stamp (a new one when None)."""
        if step is None:
            step = self._lru_clock.next()
        while True:
            trial = self.state.clone()
            _, big = self.core.apply_chunk(trial, chunk, side=side,
                                           step=step)
            l_lane, l_ht, r_lane, r_ht = torch.stack([
                trial.left.lane_overflow, trial.left.ht_overflow,
                trial.right.lane_overflow, trial.right.ht_overflow]).tolist()
            lane_ovf, ht_ovf = l_lane or r_lane, l_ht or r_ht
            if not lane_ovf and not ht_ovf:
                self.state = trial
                return big
            new_W = self.core.W * 2 if lane_ovf else self.core.W
            new_cap = (self.core.capacity * 2 if ht_ovf
                       else self.core.capacity)
            if new_W * new_cap > self.max_state_cells:
                raise RuntimeError(
                    f"{self.identity}: join state would exceed "
                    f"{self.max_state_cells} cells (cap={new_cap}, "
                    f"W={new_W})")
            self._grow(new_cap, new_W)

    def _grow(self, new_cap: int, new_W: int) -> None:
        left_keys, right_keys = self._key_args
        self.core = JoinCore(
            self.left.schema, self.right.schema, left_keys, right_keys,
            key_capacity=new_cap, bucket_width=new_W, **self._join_args)
        self.state = import_state(self.core, self.state)

    # -- optimistic batched emission ------------------------------------------

    def _stage(self, side: str, chunk: StreamChunk, step,
               passes=None) -> None:
        """Apply a chunk optimistically: its output and packed stats wait
        in ``_pending`` for one read of the whole batch. With ``passes``
        given, nothing is read back to the host."""
        if self._rewind_state is None:
            self._rewind_state = self.state.clone()
        _, big = self.core.apply_chunk(self.state, chunk, side=side,
                                       step=step, passes=passes)
        self._pending.append(
            (side, chunk, _pack_stats_of(self.state, big), big))

    def _gather_all(self, big: StreamChunk, n_units: int):
        for lo in range(0, n_units, self.out_capacity // 2):
            yield gather_units_window(big, lo, self.out_capacity)

    def _flush_pending(self):
        if not self._pending:
            return
        packed = torch.stack([p[2] for p in self._pending]).cpu().numpy()
        if not packed[:, :4].any():
            for (_, _, _, big), row in zip(self._pending, packed):
                yield from self._gather_all(big, int(row[4]))
        else:
            # overflow inside the batch: rewind and replay with growth
            self.state = self._rewind_state
            for side, chunk, _, _ in self._pending:
                big = self._apply_growing(side, chunk)
                yield from self._gather_all(big, int(count_units(big)))
        self._pending.clear()
        self._rewind_state = None

    def _consume_batch(self, side: str, batch):
        """A ChunkBatch in sub-batches of ``emit_batch`` chunks: one read of
        every chunk's passes for the whole batch, then per sub-batch the
        chunks applied with no read and one read of their packed stats."""
        flat = flatten_shards(batch.chunk)
        if self.null_aware_anti and side == "right":
            self._reject_null_build_keys(flat)
        if self._evicted:
            hits = self._evicted_hits(side, flat)
            if hits:
                self._fault_in(hits)
        passes = pass_flags(batch.chunk)
        k = batch.num_chunks
        for lo in range(0, k, self.emit_batch):
            n = min(self.emit_batch, k - lo)
            steps = self._lru_clock.advance(n)
            for i in range(n):
                self._stage(side, batch.at(lo + i),
                            None if steps is None else steps[i],
                            passes[lo + i])
            yield from self._flush_pending()

    def _replay(self, side: str, rows: list) -> None:
        """Insert stored rows of one side, output discarded (recovery,
        fault-in), in ``REPLAY_BATCH``-row chunks: one snapshot and one
        read of the overflow flags for all of them; on overflow, rewind and
        replay chunk by chunk through the growing path with the same
        stamps."""
        schema, _ = self._side_info(side)
        dev = self.core.device
        chunks = [physical_chunk(schema, rows[i:i + REPLAY_BATCH],
                                 REPLAY_BATCH, dev)
                  for i in range(0, len(rows), REPLAY_BATCH)]
        if not chunks:
            return
        rewind = self.state.clone()
        steps = [self._lru_clock.next() for _ in chunks]
        for chunk, step in zip(chunks, steps):
            self.core.apply_chunk(self.state, chunk, side=side, step=step,
                                  passes=(False, True))
        # the flags are sticky and clear before a replay: one read
        if bool(torch.stack([st.ht_overflow | st.lane_overflow for st in
                             (self.state.left, self.state.right)]).any()):
            self.state = rewind
            for chunk, step in zip(chunks, steps):
                self._apply_growing(side, chunk, step)

    async def execute(self):
        self._pending = []
        self._rewind_state = None
        async for ev in barrier_align(self.left, self.right):
            kind = ev[0]
            if kind == "batch":
                _, side, batch = ev
                # a batch and the per-chunk window must not interleave
                # rewinds: emit the pending output first
                for out in self._flush_pending():
                    yield out
                for out in self._consume_batch(side, batch):
                    yield out
            elif kind == "chunk":
                _, side, chunk = ev
                if self.null_aware_anti and side == "right":
                    self._reject_null_build_keys(chunk)
                if self._evicted:
                    hits = self._evicted_hits(side, chunk)
                    if hits:
                        # flush the optimistic batch FIRST: the fault-in
                        # changes the state, and a later rewind of the
                        # batch must not lose it
                        for out in self._flush_pending():
                            yield out
                        self._fault_in(hits)
                self._stage(side, chunk, self._lru_clock.next())
                if len(self._pending) >= self.emit_batch:
                    for out in self._flush_pending():
                        yield out
            elif kind == "barrier":
                barrier = ev[1]
                for out in self._flush_pending():
                    yield out
                self._check_flags()
                if barrier.checkpoint:
                    cleaned = self._apply_pending_clean()
                    self._checkpoint(barrier.epoch.curr)
                    if self.hbm_key_budget is not None:
                        cleaned |= self._evict_cold()
                    if cleaned:
                        self._compact()
                yield barrier
                if barrier.is_stop():
                    return
            elif kind == "watermark":
                _, side, wm = ev
                for cs, cc, ws, wc, lag in self.interval_clean:
                    if ws == side and wc == wm.col_idx:
                        key = (cs, cc)
                        thr = wm.value - lag
                        if (key not in self._pending_clean
                                or thr > self._pending_clean[key]):
                            self._pending_clean[key] = thr
                out_idx = self._map_watermark_col(side, wm.col_idx)
                if out_idx is not None:
                    # pending output must not be overtaken by the watermark
                    for out in self._flush_pending():
                        yield out
                    yield wm.__class__(out_idx, wm.value)

    def _reject_null_build_keys(self, chunk: StreamChunk) -> None:
        keyed = chunk.vis
        for i in self.core.right_keys:
            keyed = keyed & chunk.columns[i].mask
        if bool((chunk.vis & ~keyed).any()):
            raise RuntimeError(
                "NULL value in NOT IN (SELECT ...) subquery: PostgreSQL "
                "semantics would drop every row of the view, which a "
                "streaming anti join cannot express incrementally — "
                "filter NULLs in the subquery (WHERE col IS NOT NULL) "
                "or use NOT EXISTS")

    def _map_watermark_col(self, side: str, col_idx: int) -> Optional[int]:
        sa = self.core.join_type.semi_anti_side
        if sa is not None:
            return col_idx if sa == side else None
        return (col_idx if side == "left"
                else col_idx + len(self.core.left_schema))

    def _check_flags(self) -> None:
        flags = torch.stack([
            torch.stack([st.ht_overflow, st.lane_overflow, st.inconsistent])
            for st in (self.state.left, self.state.right)]).tolist()
        for side, (ht_ovf, lane_ovf, inconsistent) in zip(
                ("left", "right"), flags):
            if ht_ovf or lane_ovf:
                raise RuntimeError(
                    f"{self.identity}: {side} join state overflow escaped "
                    f"growth (key_capacity={self.core.capacity}, "
                    f"bucket_width={self.core.W})")
            if self.strict and inconsistent:
                raise RuntimeError(
                    f"{self.identity}: {side} saw delete of an absent row")

    # -- state cleaning, eviction and fault-in ---------------------------------

    def _compact(self) -> None:
        core = self.core
        self.state = JoinState(
            left=compact_side(core, self.state.left, core.left_schema,
                              core.left_keys),
            right=compact_side(core, self.state.right, core.right_schema,
                               core.right_keys))

    def _apply_pending_clean(self) -> bool:
        """Free the rows below the pending watermark thresholds (dead and
        tombstoned; the checkpoint that follows writes their deletes)."""
        if not self._pending_clean:
            return False
        nk = len(self.core.left_keys)
        for (side, col), threshold in self._pending_clean.items():
            clean_side_below(getattr(self.state, side), col, threshold)
            # evicted keys' rows are not on the device: remember the
            # high-water threshold so fault-in drops expired rows
            prev = self._applied_clean.get((side, col))
            if prev is None or threshold > prev:
                self._applied_clean[(side, col)] = threshold
            # and delete them durably now (staged; they commit with this
            # checkpoint), so a restart cannot resurrect them
            table = self.state_tables.get(side)
            if self._evicted and table is not None:
                for k in list(self._evicted):
                    for r in table.scan_prefix(list(k), nk):
                        if r[col] is not None and r[col] < threshold:
                            table.delete(r)
        self._pending_clean.clear()
        return True

    def _evict_cold(self) -> bool:
        """Evict the coldest live keys' buckets from BOTH arenas down to
        3/4 of the budget (this barrier's checkpoint has just written their
        rows). One read covers the budget gate and the plan. Returns True
        if anything was evicted (the caller compacts)."""
        keep = max(self.hbm_key_budget * 3 // 4, 1)
        mask_l, mask_r, packed = join_evict_plan(self.state, keep)
        nel, ner, nl, nr = packed.tolist()
        if max(nl, nr) <= self.hbm_key_budget or (nel == 0 and ner == 0):
            return False
        for side, mask in (("left", mask_l), ("right", mask_r)):
            st = getattr(self.state, side)
            idx = mask.nonzero().squeeze(1)
            if idx.numel():
                for row in zip(*host_rows([kd[idx] for kd in
                                           st.ht.key_data])):
                    self._evicted.add(self._pykey(row))
        apply_evict_side(self.state.left, mask_l)
        apply_evict_side(self.state.right, mask_r)
        return True

    def _evicted_hits(self, side: str, chunk: StreamChunk) -> list:
        """The evicted join keys this chunk mentions (a host read, paid only
        while evicted keys exist)."""
        _, key_idx = self._side_info(side)
        cols = host_rows([chunk.vis]
                         + [chunk.columns[i].mask for i in key_idx]
                         + [chunk.columns[i].data for i in key_idx])
        nk = len(key_idx)
        ok = cols[0].copy()
        for m in cols[1:1 + nk]:
            ok &= m
        present = set(zip(*(d[ok] for d in cols[1 + nk:])))
        return [k for k in (self._pykey(p) for p in present)
                if k in self._evicted]

    def _fault_in(self, keys: list) -> None:
        """Restore the given keys' rows on BOTH sides from the cold tier (a
        pk prefix scan per key) and replay them through the insert path,
        output discarded: degrees rebuild exactly, as in recovery."""
        nk = len(self.core.left_keys)
        for k in keys:
            self._evicted.discard(k)
        for side in ("left", "right"):
            table = self.state_tables[side]
            rows = []
            for k in keys:
                rows.extend(table.scan_prefix(list(k), nk))
            # cleaning already retired the rows below the applied
            # thresholds on the device; an evicted key's stored rows missed
            # it: drop (and durably delete) them rather than resurrect them
            for (cs, cc), thr in self._applied_clean.items():
                if cs != side or not rows:
                    continue
                expired = [r for r in rows
                           if r[cc] is not None and r[cc] < thr]
                for r in expired:
                    table.delete(r)
                if expired:
                    rows = [r for r in rows
                            if r[cc] is None or r[cc] >= thr]
            self._replay(side, rows)

    # -- persistence -------------------------------------------------------------

    def _checkpoint(self, epoch: int) -> None:
        """Write each side's rows changed since the last checkpoint: the
        changed cells are picked on the device and cross to the host in
        one copy. Deletes (tombstoned, not live) go strictly before
        upserts: a same-pk update lands in two different lanes, and the
        delete must not clobber the new row."""
        for side in ("left", "right"):
            table = self.state_tables[side]
            if table is None:
                continue
            st = getattr(self.state, side)
            cells = st.ckpt_dirty.view(-1).nonzero().squeeze(1)
            if not cells.numel():
                continue
            nc = len(st.row_data)
            cols = host_rows([st.occupied.view(-1)[cells],
                              st.tomb.view(-1)[cells]]
                             + [rd.view(-1)[cells] for rd in st.row_data]
                             + [rm.view(-1)[cells] for rm in st.row_mask])
            occ, tomb = cols[0], cols[1]
            datas, masks = cols[2:2 + nc], cols[2 + nc:]
            del_idx = np.nonzero(tomb & ~occ)[0]
            ins_idx = np.nonzero(occ)[0]
            from ..native import codec as native_codec
            types = table.schema.types
            codec = native_codec(types)
            if codec is not None:
                pk = table.pk_indices
                pk_d = [datas[i] for i in pk]
                pk_m = [masks[i] for i in pk]
                pk_t = [types[i] for i in pk]
                table.stage_encoded(
                    dict(zip(codec.encode_keys(pk_d, pk_m, pk_t, ins_idx),
                             codec.encode_value_rows(datas, masks, types,
                                                     ins_idx))),
                    codec.encode_keys(pk_d, pk_m, pk_t, del_idx))
            else:
                def row_at(r):
                    return tuple(datas[c][r].item() if masks[c][r] else None
                                 for c in range(nc))

                for r in del_idx:
                    table.delete(row_at(r))
                for r in ins_idx:
                    table.insert(row_at(r))
            table.commit(epoch)
        _clear_ckpt_marks(self.state)

    def _load_from_state_tables(self) -> None:
        """Recovery: replay both sides' committed rows through the insert
        path (left first, then right), output discarded: degrees rebuild
        exactly. Under an ``hbm_key_budget`` only the first ``budget`` keys
        load hot and the rest stay cold, chosen jointly across the two
        sides (a key is hot or cold on BOTH)."""
        side_rows = {}
        for side in ("left", "right"):
            table = self.state_tables[side]
            rows = list(table.scan_all()) if table is not None else []
            if rows and self.load_shard is not None:
                rows = self._filter_shard(side, rows)
            side_rows[side] = rows
        if self.hbm_key_budget is not None:
            seen: dict = {}
            for side in ("left", "right"):
                _, key_idx = self._side_info(side)
                for r in side_rows[side]:
                    kv = tuple(r[i] for i in key_idx)
                    if all(v is not None for v in kv):   # null keys stay hot
                        seen.setdefault(self._pykey(kv), None)
            if len(seen) > self.hbm_key_budget:
                cold = set(list(seen)[self.hbm_key_budget:])
                self._evicted |= cold
                for side in ("left", "right"):
                    _, key_idx = self._side_info(side)
                    side_rows[side] = [
                        r for r in side_rows[side]
                        if any(r[i] is None for i in key_idx)
                        or self._pykey(tuple(r[i] for i in key_idx))
                        not in cold]
        for side in ("left", "right"):
            if self.state_tables[side] is not None:
                self._replay(side, side_rows[side])
        _clear_ckpt_marks(self.state)

    def _filter_shard(self, side: str, rows: list) -> list:
        """The rows whose join key hashes to this actor's shard (the hash
        the dispatcher routes live rows with)."""
        schema, key_idx = self._side_info(side)
        idx, n_shards = self.load_shard
        return shard_rows([schema[i].type for i in key_idx], rows, n_shards,
                          key_idx)[idx]


def _pack_stats_of(state: JoinState, big: StreamChunk) -> torch.Tensor:
    """Every host-read scalar of one applied chunk in ONE int64 vector:
    [l.lane_ovf, l.ht_ovf, r.lane_ovf, r.ht_ovf, n_units]."""
    return torch.stack([
        state.left.lane_overflow.long(), state.left.ht_overflow.long(),
        state.right.lane_overflow.long(), state.right.ht_overflow.long(),
        count_units(big)])


def _clear_ckpt_marks(state: JoinState) -> JoinState:
    """After a checkpoint (in place): no row is dirty, and the tombstoned
    lanes are free for inserts again."""
    for st in (state.left, state.right):
        st.ckpt_dirty.zero_()
        st.tomb.zero_()
    return state
