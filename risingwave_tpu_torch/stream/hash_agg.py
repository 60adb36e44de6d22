"""HashAggExecutor — incremental group-by aggregation on device state.

Counterpart of ``risingwave_tpu/stream/hash_agg.py``. Group state lives on
the device as an open-addressing table plus per-group aggregate lanes
(ops/grouped_agg.py); a whole chunk, or every chunk of a ChunkBatch, updates
all its groups with no host sync. On every barrier the dirty groups are
gathered into output chunks (Insert / U-,U+ / Delete) and the prev lanes
advance. Row-count lane 0 drives Insert-vs-Update-vs-Delete emission and
group liveness.

Persistence: a second bitmask gathers the groups dirtied since the last
checkpoint; a checkpoint barrier writes just those rows to the StateTable
(picked on the device, one copy to the host) and recovery bulk-loads the
committed rows. A watermark on a group key cleans the groups below it at
the next checkpoint; under ``hbm_group_budget`` the coldest groups are
evicted to the state table and faulted back in when touched.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import DEFAULT_CHUNK_CAPACITY, Column, StreamChunk
from ..common.types import FLOAT64, GLOBAL_STRING_DICT, INT64, Field, Schema
from ..expr.agg import AggCall
from ..ops.grouped_agg import AggCore, load_rows_into_state
from .cache import LruClock, canonical_key
from .executor import Executor, SingleInputExecutor
from .message import Barrier


def host_rows(columns: Sequence[torch.Tensor]) -> list[np.ndarray]:
    """Equal-length 1-D tensors (bool, int32, int64 or float64) on the host
    in ONE device-to-host copy: each is carried in an int64 lane of one
    stacked tensor (a float64 by its bits) and restored on the host."""
    if not columns:
        return []
    packed = torch.stack([c.view(torch.int64) if c.dtype == torch.float64
                          else c.long() for c in columns]).cpu().numpy()
    out = []
    for c, row in zip(columns, packed):
        if c.dtype == torch.float64:
            out.append(row.view(np.float64))
        elif c.dtype == torch.bool:
            out.append(row.astype(bool))
        elif c.dtype == torch.int32:
            out.append(row.astype(np.int32))
        else:
            out.append(row)
    return out


class HashAggExecutor(SingleInputExecutor):
    """``group_keys``: input column indices; ``agg_calls``: AggCall specs.

    Output schema: group key columns then one column per agg call."""

    identity = "HashAgg"

    def __init__(
        self,
        input: Executor,
        group_keys: Sequence[int],
        agg_calls: Sequence[AggCall],
        state_table=None,
        table_capacity: int = 1 << 16,
        out_capacity: int = DEFAULT_CHUNK_CAPACITY,
        load_shard: Optional[tuple] = None,
        load_vnodes: Optional[tuple] = None,
        hbm_group_budget: Optional[int] = None,
        device=DEFAULT_DEVICE,
    ):
        """``load_shard``: (shard_idx, n_shards): on recovery keep only the
        rows whose group key hashes to this shard. ``load_vnodes``:
        (vnode_start, vnode_end): keep only the rows in that vnode range.

        ``hbm_group_budget``: cap on LIVE groups held on the device. A
        checkpoint that finds more evicts the coldest (LRU by touch step)
        to the state table; a later chunk that touches an evicted key
        faults its stored lanes back in. Needs a state table (without one
        it is ignored) and must be below ``table_capacity``."""
        super().__init__(input)
        self.load_shard = load_shard
        self.load_vnodes = load_vnodes
        if hbm_group_budget is not None:
            if state_table is None:
                hbm_group_budget = None       # no cold tier to evict to
            elif hbm_group_budget >= table_capacity:
                raise ValueError("hbm_group_budget must be < table_capacity")
        self.hbm_group_budget = hbm_group_budget
        self._evicted: set = set()
        self._lru_clock = LruClock(hbm_group_budget is not None, device)
        in_schema = input.schema
        key_types = tuple(in_schema[i].type for i in group_keys)
        self.core = AggCore(key_types, group_keys, agg_calls, table_capacity,
                            out_capacity, device)
        self.schema = Schema(
            tuple(in_schema[i] for i in group_keys)
            + tuple(Field(f"agg{i}", c.output_type)
                    for i, c in enumerate(agg_calls)))
        self.state_table = state_table
        self.state = self.core.init_state()
        # group-key watermarks: key position -> threshold, cleaned at the
        # next checkpoint
        self._pending_clean: dict[int, Any] = {}
        if self.state_table is not None:
            self._load_from_state_table()

    @property
    def group_keys(self):
        return self.core.group_keys

    def _str_ranks(self):
        """The rank table as of now, for MIN/MAX over VARCHAR (None when no
        call needs it)."""
        if not any(c.is_string_minmax for c in self.core.agg_calls):
            return None
        return GLOBAL_STRING_DICT.device_ranks(self.core.device)

    @property
    def agg_calls(self):
        return self.core.agg_calls

    def _pykey(self, values) -> tuple:
        return canonical_key(values, self.core.key_types)

    # -- ingest ---------------------------------------------------------------

    async def map_chunk(self, chunk: StreamChunk):
        self.core.apply_chunk(self.state, chunk, self._lru_clock.next(),
                              self._str_ranks())
        if self._evicted:
            self._fault_in(chunk.columns, chunk.vis)
        if False:
            yield

    async def map_chunk_batch(self, batch):
        """The K chunks in order, one ``apply_chunk`` each (the reference's
        scan, slot for slot), with no host sync unless evicted keys exist."""
        steps = self._lru_clock.advance(batch.num_chunks)
        str_ranks = self._str_ranks()
        for i in range(batch.num_chunks):
            self.core.apply_chunk(self.state, batch.at(i),
                                  None if steps is None else steps[i],
                                  str_ranks)
        if self._evicted:
            self._fault_in(batch.chunk.columns, batch.chunk.vis)
        if False:
            yield

    # -- eviction / fault-in ----------------------------------------------------

    def _fault_in(self, columns, vis) -> None:
        """Reload the evicted group keys present in these columns from the
        cold tier and merge their stored lanes into the device state (one
        host read, paid only while evicted keys exist)."""
        nk = len(self.core.group_keys)
        keys_np = host_rows([columns[i].data.reshape(-1)
                             for i in self.core.group_keys]
                            + [vis.reshape(-1)])
        vis_np = keys_np.pop()
        present = set(zip(*(k[vis_np] for k in keys_np)))
        hits = [k for k in present if self._pykey(k) in self._evicted]
        if not hits:
            return
        rows, keys = [], []
        for k in hits:
            pk = self._pykey(k)
            row = self.state_table.get_row(pk)
            if row is not None:
                rows.append(row)
                keys.append(k)
            self._evicted.discard(pk)
        if not rows:
            return
        n = len(rows)
        cap = 1
        while cap < n:
            cap *= 2
        dev = self.core.device
        valid = torch.arange(cap, device=dev) < n
        key_cols = []
        for c, t in enumerate(self.core.key_types):
            data = np.zeros(cap, t.np_dtype)
            data[:n] = [k[c] for k in keys]
            key_cols.append(Column(torch.from_numpy(data).to(dev), valid))
        stored = []
        for j, dt in enumerate(self.core.lane_dtypes):
            arr = np.zeros(cap, np.float64 if dt.is_floating_point
                           else np.int64)
            arr[:n] = [r[nk + j] for r in rows]
            stored.append(torch.from_numpy(arr).to(dev))
        self.core.absorb(self.state, key_cols, stored, valid,
                         self._str_ranks())

    def _evict_cold(self) -> None:
        """Evict the coldest live groups down to 3/4 of the budget (this
        barrier's checkpoint has just written their rows). Groups with a
        NULL key are never evicted: fault-in looks keys up without masks."""
        keep = max(self.hbm_group_budget * 3 // 4, 1)
        mask, _ = self.core.evict_plan(self.state, keep)
        for km in self.state.table.key_mask:
            mask = mask & km
        idx = mask.nonzero().squeeze(1)
        if not idx.numel():
            return
        for row in zip(*host_rows([kd[idx]
                                   for kd in self.state.table.key_data])):
            self._evicted.add(self._pykey(row))
        self.core.apply_evict(self.state, mask)

    # -- barrier ----------------------------------------------------------------

    async def on_barrier(self, barrier: Barrier):
        rank = self.core.flush_rank(self.state)
        probe = [rank[-1], self.state.overflow.long()]
        if self.hbm_group_budget is not None:
            # the live-group census gates eviction; only budgeted
            # executors pay for it
            probe.append(self.core.live_mask(self.state).sum())
        # the barrier's one host read: dirty-group count, overflow flag and,
        # under a budget, the live-group count
        n_dirty, overflow, *live = torch.stack(probe).tolist()
        if overflow:
            raise RuntimeError(
                f"{self.identity}: group table overflow (capacity "
                f"{self.core.capacity}); increase table_capacity")
        lo = 0
        while lo < n_dirty:
            yield self.core.gather_flush_chunk(self.state, rank, lo)
            lo += self.core.groups_per_chunk
        cleaned = False
        if barrier.checkpoint and self._pending_clean:
            # mark dead BEFORE the checkpoint so it writes the deletes (the
            # keys must still be in the table); compact AFTER it
            for key_pos, threshold in self._pending_clean.items():
                self.core.clean_below(self.state, key_pos, threshold)
            self._pending_clean.clear()
            cleaned = True
        if barrier.checkpoint and self.state_table is not None:
            self._checkpoint_to_state_table(barrier.epoch.curr)
            if live and live[0] > self.hbm_group_budget:
                self._evict_cold()
                cleaned = True
        if cleaned:
            self.state = self.core.compact(self.state)
        self.core.finish_flush(self.state)

    async def on_watermark(self, watermark):
        """A watermark on a group key is remapped to its output position and
        schedules state cleaning below it; other columns' watermarks cannot
        pass a grouped agg."""
        if watermark.col_idx in self.core.group_keys:
            pos = self.core.group_keys.index(watermark.col_idx)
            prev = self._pending_clean.get(pos)
            if prev is None or watermark.value > prev:
                self._pending_clean[pos] = watermark.value
            yield watermark.__class__(pos, watermark.value)

    # -- persistence ------------------------------------------------------------

    def _checkpoint_to_state_table(self, epoch: int) -> None:
        """Write the groups dirtied since the last checkpoint to the state
        table: the rows are picked on the device and only they cross to
        the host, in one copy. Live groups are upserts, groups with a row
        count of 0 deletes."""
        st = self.state
        idx = st.ckpt_dirty.nonzero().squeeze(1)
        if idx.numel():
            nk = len(st.table.key_data)
            cols = host_rows([kd[idx] for kd in st.table.key_data]
                             + [km[idx] for km in st.table.key_mask]
                             + [lane[idx] for lane in st.lanes])
            keys_d, keys_m, lanes = cols[:nk], cols[nk:2 * nk], cols[2 * nk:]
            live = lanes[0] > 0
            types = self.state_table.schema.types
            from ..native import codec as native_codec
            codec = native_codec(types)
            if codec is not None:
                ones = np.ones(len(live), bool)
                ins_idx = np.nonzero(live)[0]
                del_idx = np.nonzero(~live)[0]
                key_t = list(types[:nk])
                puts = dict(zip(
                    codec.encode_keys(keys_d, keys_m, key_t, ins_idx),
                    codec.encode_value_rows(keys_d + lanes,
                                            keys_m + [ones] * len(lanes),
                                            types, ins_idx)))
                dels = codec.encode_keys(keys_d, keys_m, key_t, del_idx)
                self.state_table.stage_encoded(puts, dels)
            else:
                for r in range(len(live)):
                    row = tuple(
                        keys_d[c][r].item() if keys_m[c][r] else None
                        for c in range(nk)) + tuple(
                        lane[r].item() for lane in lanes)
                    if live[r]:
                        self.state_table.insert(row)
                    else:
                        self.state_table.delete(row)
            self.state_table.commit(epoch)
        st.ckpt_dirty.zero_()

    def _load_from_state_table(self) -> None:
        """Recovery: bulk-load the committed groups into the device table."""
        from ..common.hashing import filter_rows_vnodes, shard_rows
        rows = list(self.state_table.scan_all())
        key_types = self.core.key_types
        if rows and self.load_shard is not None:
            idx, n_shards = self.load_shard
            rows = shard_rows(key_types, rows, n_shards)[idx]
        if rows and self.load_vnodes is not None:
            rows = filter_rows_vnodes(key_types, rows, *self.load_vnodes)
        if (self.hbm_group_budget is not None
                and len(rows) > self.hbm_group_budget):
            # the durable tier may hold more groups than the budget: load up
            # to the budget, leave the rest cold (NULL-keyed rows always
            # load: fault-in looks keys up without masks)
            nk = len(self.core.group_keys)
            hot = []
            for r in rows:
                key = r[:nk]
                if len(hot) < self.hbm_group_budget or any(
                        v is None for v in key):
                    hot.append(r)
                else:
                    self._evicted.add(self._pykey(key))
            rows = hot
        if not rows:
            return
        load_rows_into_state(self.core, self.state, rows)
        # the recovered snapshot is what downstream saw last: the new
        # baseline of the next flush (a copy: the lanes change in place)
        self.state.prev_lanes = [lane.clone() for lane in self.state.lanes]


def agg_state_schema(key_fields: Sequence[Field],
                     agg_calls: Sequence[AggCall]) -> Schema:
    """Schema of the durable agg state table: keys + raw lanes."""
    lanes = [Field("row_count", INT64)]
    for i, c in enumerate(agg_calls):
        for j, dt in enumerate(c.state_dtypes()):
            lanes.append(Field(f"a{i}_l{j}",
                               INT64 if dt == torch.int64 else FLOAT64))
    return Schema(tuple(key_fields) + tuple(lanes))
