"""StateTable — the relational view over the state store.

A copy of ``risingwave_tpu/storage/state_table.py``: pk-addressed row
storage with buffered writes that become visible at ``commit(epoch)``.
Executors keep hot state on the device and use the table as the durable
tier: they write dirty deltas here on checkpoint barriers and reload with
``scan_all`` on recovery. Rows are physical-value tuples; pk columns are
memcomparable-encoded (``common/row.py``), so iteration order is pk order.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Sequence

from ..common.row import decode_value_row, encode_key, encode_value_row
from ..common.types import Schema
from .state_store import MemoryStateStore


class StateTable:
    def __init__(
        self,
        store: MemoryStateStore,
        table_id: int,
        schema: Schema,
        pk_indices: Sequence[int],
    ) -> None:
        self.store = store
        self.table_id = table_id
        self.schema = schema
        self.pk_indices = tuple(pk_indices)
        self._pk_types = tuple(schema[i].type for i in self.pk_indices)
        self._puts: dict[bytes, tuple] = {}
        self._puts_enc: dict[bytes, bytes] = {}   # pre-encoded (native path)
        self._dels: set[bytes] = set()

    # -- key helpers ----------------------------------------------------------

    def key_of(self, row: Sequence[Any]) -> bytes:
        return encode_key([row[i] for i in self.pk_indices], self._pk_types)

    # -- buffered writes (MemTable semantics) ---------------------------------

    def insert(self, row: Sequence[Any]) -> None:
        k = self.key_of(row)
        self._dels.discard(k)
        self._puts_enc.pop(k, None)
        self._puts[k] = tuple(row)

    def delete(self, row: Sequence[Any]) -> None:
        k = self.key_of(row)
        self._puts.pop(k, None)
        self._puts_enc.pop(k, None)
        self._dels.add(k)

    def stage_encoded(self, puts: dict, dels: Sequence[bytes]) -> None:
        """Batch-staged rows already in durable form — the native
        checkpoint fast path (native/rowcodec.cpp): keys are memcomparable
        bytes, values are value-encoded bytes. Semantically identical to
        insert()/delete() row by row."""
        for k in dels:
            self._puts.pop(k, None)
            self._puts_enc.pop(k, None)
            self._dels.add(k)
        for k, v in puts.items():
            self._dels.discard(k)
            self._puts.pop(k, None)
            self._puts_enc[k] = v

    def update(self, old_row: Sequence[Any], new_row: Sequence[Any]) -> None:
        ko, kn = self.key_of(old_row), self.key_of(new_row)
        if ko != kn:
            self.delete(old_row)
        self.insert(new_row)

    def commit(self, epoch: int) -> None:
        """Hand the buffered epoch delta to the store (visible after the
        store-level commit of this epoch). Rows cross the table/store
        boundary as value-encoded bytes — the store is an opaque KV tier,
        and the durable backend persists process-independent bytes
        (reference: value encoding at the table layer, state_table.rs:62)."""
        if self._puts or self._puts_enc or self._dels:
            encoded = {
                k: encode_value_row(v, self.schema.types)
                for k, v in self._puts.items()
            }
            encoded.update(self._puts_enc)
            self.store.ingest(self.table_id, epoch, encoded, self._dels)
            self._puts, self._puts_enc, self._dels = {}, {}, set()

    def is_dirty(self) -> bool:
        return bool(self._puts or self._puts_enc or self._dels)

    # -- reads (committed + own uncommitted buffer) ---------------------------

    def get_row(self, pk_values: Sequence[Any]) -> Optional[tuple]:
        k = encode_key(list(pk_values), self._pk_types)
        if k in self._dels:
            return None
        if k in self._puts:
            return self._puts[k]
        if k in self._puts_enc:
            return decode_value_row(self._puts_enc[k], self.schema.types)
        v = self.store.get(self.table_id, k)
        return None if v is None else decode_value_row(v, self.schema.types)

    def scan_all(self) -> Iterator[tuple]:
        """Committed rows merged with the uncommitted buffer, pk order."""
        merged: dict[bytes, Optional[Any]] = {
            k: decode_value_row(v, self.schema.types)
            for k, v in self.store.iter_table(self.table_id)
        }
        for k in self._dels:
            merged.pop(k, None)
        merged.update({
            k: decode_value_row(v, self.schema.types)
            for k, v in self._puts_enc.items()})
        merged.update(self._puts)
        for k in sorted(merged):
            v = merged[k]
            if v is not None:
                yield v

    def scan_after(self, after_key: Optional[bytes],
                   limit: int) -> tuple[list[tuple], Optional[bytes]]:
        """Up to ``limit`` rows with encoded pk > ``after_key``, in key
        order, plus the last key read (the resumable backfill cursor —
        reference: snapshot-read chunks, executor/backfill.rs:48-69).
        Reads the CURRENT merged view, so each call observes updates
        committed since the last one — exactly the per-epoch re-read the
        reference's backfill relies on for exactly-once.

        Cost per call: O(log n) bisect into the store's cached sorted
        committed keys + O(batch + staged) merge walk — a backfill over a
        large table never re-sorts the whole table per batch."""
        import bisect
        committed = self.store.committed_view(self.table_id)
        skeys = self.store.sorted_committed_keys(self.table_id)
        # staged overlay (pending epochs + this instance's buffer): small
        # between checkpoints; None = delete
        overlay: dict[bytes, Optional[Any]] = {}
        for e in sorted(self.store._pending):
            overlay.update(self.store._pending[e].get(self.table_id, {}))
        overlay.update(self._puts_enc)
        overlay.update(self._puts)
        raw = set(self._puts)
        for k in self._dels:
            overlay[k] = None
        okeys = sorted(k for k in overlay
                       if after_key is None or k > after_key)
        i = (bisect.bisect_right(skeys, after_key)
             if after_key is not None else 0)
        j = 0
        out: list[tuple] = []
        last = after_key
        while len(out) < limit and (i < len(skeys) or j < len(okeys)):
            ck = skeys[i] if i < len(skeys) else None
            ok = okeys[j] if j < len(okeys) else None
            if ok is None or (ck is not None and ck < ok):
                k, v = ck, committed[ck]
                is_raw = False
                i += 1
            else:
                if ck == ok:
                    i += 1                 # overlay shadows committed
                k, v = ok, overlay[ok]
                is_raw = k in raw
                j += 1
            last = k
            if v is None:
                continue
            out.append(v if is_raw
                       else decode_value_row(v, self.schema.types))
        return out, last

    def scan_prefix(self, prefix_values: Sequence[Any], n_cols: int) -> Iterator[tuple]:
        """Rows whose encoded pk starts with the first ``n_cols`` pk
        columns' encoding, in key order. O(log n) bisect into the store's
        sorted committed keys + the (small) staged overlay — the join
        cold-tier fault-in path calls this per faulted key."""
        import bisect
        prefix = encode_key(list(prefix_values), self._pk_types[:n_cols])
        committed = self.store.committed_view(self.table_id)
        skeys = self.store.sorted_committed_keys(self.table_id)
        merged: dict[bytes, Optional[Any]] = {}
        i = bisect.bisect_left(skeys, prefix)
        while i < len(skeys) and skeys[i].startswith(prefix):
            merged[skeys[i]] = decode_value_row(
                committed[skeys[i]], self.schema.types)
            i += 1
        for e in sorted(self.store._pending):
            for k, v in self.store._pending[e].get(self.table_id, {}).items():
                if k.startswith(prefix):
                    merged[k] = (None if v is None
                                 else decode_value_row(v, self.schema.types))
        for k, v in self._puts_enc.items():
            if k.startswith(prefix):
                merged[k] = decode_value_row(v, self.schema.types)
        for k, v in self._puts.items():
            if k.startswith(prefix):
                merged[k] = v
        for k in self._dels:
            if k.startswith(prefix):
                merged[k] = None
        for k in sorted(merged):
            v = merged[k]
            if v is not None:
                yield v

    def __len__(self) -> int:
        n = self.store.table_len(self.table_id)
        new_puts = sum(
            1 for k in (*self._puts, *self._puts_enc)
            if self.store.get(self.table_id, k) is None)
        dead = sum(1 for k in self._dels if self.store.get(self.table_id, k) is not None)
        return n + new_puts - dead
