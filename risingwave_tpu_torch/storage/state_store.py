"""Epoch-versioned state store (host tier).

A copy of ``risingwave_tpu/storage/state_store.py`` (``MemoryStateStore``):
the truth tier under the device state. Executors keep their state on the
device, flush dirty deltas here on checkpoint barriers and reload from here
on recovery. Writes are buffered per epoch and become visible atomically at
``commit(epoch)``; reads see the latest committed epoch overlaid with the
staged epochs. ``snapshot()`` / ``restore()`` take the same plain dicts of
bytes as the reference's, so a store written by one package restores into
the other.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Optional


class MemoryStateStore:
    """Process-local multi-table KV store with epoch commit.

    Keys are ``(table_id, key_bytes)``; values are opaque bytes (StateTable
    value-encodes rows at this boundary). Not thread-safe: one event loop
    drives it.
    """

    def __init__(self) -> None:
        self._committed: dict[int, dict[bytes, tuple]] = {}
        self._pending: dict[int, dict[int, dict[bytes, Optional[tuple]]]] = {}
        self.committed_epoch: int = 0
        # per-table sorted committed-key cache (range scans / backfill):
        # rebuilt lazily after a commit touches the table
        self._sorted_keys: dict[int, list] = {}
        self._keys_dirty: set[int] = set()

    # -- write path -----------------------------------------------------------

    def ingest(self, table_id: int, epoch: int,
               puts: dict[bytes, tuple], deletes: set[bytes]) -> None:
        buf = self._pending.setdefault(epoch, {}).setdefault(table_id, {})
        for k in deletes:
            buf[k] = None
        buf.update(puts)

    def commit(self, epoch: int) -> None:
        """Atomically apply all writes buffered for epochs ≤ ``epoch``.

        A checkpoint epoch commits every earlier non-checkpoint epoch's
        buffer too, in epoch order — mirroring the reference where
        non-checkpoint barriers stage state that the next checkpoint's
        ``commit_epoch`` makes durable (docs/checkpoint.md:26-44).

        Idempotent per epoch: every executor of an epoch may trigger the
        commit; the first wins (the reference's HummockManager.commit_epoch
        is likewise a single logical commit per epoch)."""
        if epoch <= self.committed_epoch:
            return
        for e in sorted(k for k in self._pending if k <= epoch):
            for table_id, buf in self._pending.pop(e).items():
                tbl = self._committed.setdefault(table_id, {})
                self._keys_dirty.add(table_id)
                for k, v in buf.items():
                    if v is None:
                        tbl.pop(k, None)
                    else:
                        tbl[k] = v
        self.committed_epoch = epoch

    # -- async commit surface (pipelined tick, docs/performance.md) -----------
    # The memory tier commits are dict merges — nothing to offload — so
    # the base implementations are synchronous aliases. DurableStateStore
    # overrides them to hand the committed-delta serialization + segment
    # write to a worker thread (storage/checkpoint.py); every backend
    # answers the same two calls so the session's commit path stays
    # tier-agnostic.

    def commit_async(self, epoch: int) -> None:
        self.commit(epoch)

    def join_commits(self) -> None:
        """Barrier for any deferred commit work (no-op in memory)."""

    # -- read path ------------------------------------------------------------

    def _merged_view(self, table_id: int) -> dict:
        """Read-your-writes view: committed state overlaid with every staged
        (sealed-but-uncommitted) epoch in order — the reference's shared
        buffer makes sealed epochs readable before the checkpoint commits
        them (docs/checkpoint.md:36-44, state visibility vs durability)."""
        view = dict(self._committed.get(table_id, {}))
        for e in sorted(self._pending):
            for k, v in self._pending[e].get(table_id, {}).items():
                if v is None:
                    view.pop(k, None)
                else:
                    view[k] = v
        return view

    def get(self, table_id: int, key: bytes) -> Optional[tuple]:
        for e in sorted(self._pending, reverse=True):
            buf = self._pending[e].get(table_id, {})
            if key in buf:
                return buf[key]
        return self._committed.get(table_id, {}).get(key)

    def iter_table(self, table_id: int) -> Iterator[tuple[bytes, tuple]]:
        yield from sorted(self._merged_view(table_id).items())

    def committed_view(self, table_id: int) -> dict:
        """The committed (checkpointed) rows of a table — the backfill
        range-scan base (staged overlays are applied by the caller)."""
        return self._committed.get(table_id, {})

    def sorted_committed_keys(self, table_id: int) -> list:
        """Sorted committed keys, cached per table and rebuilt only after
        a commit touched the table — keeps range scans O(log n + batch)
        instead of O(n log n) per call."""
        if table_id in self._keys_dirty or table_id not in self._sorted_keys:
            self._sorted_keys[table_id] = sorted(
                self._committed.get(table_id, {}))
            self._keys_dirty.discard(table_id)
        return self._sorted_keys[table_id]

    def iter_prefix(self, table_id: int, prefix: bytes) -> Iterator[tuple[bytes, tuple]]:
        for k, v in self.iter_table(table_id):
            if k.startswith(prefix):
                yield k, v

    def table_len(self, table_id: int) -> int:
        return len(self._merged_view(table_id))


    def drop_table(self, table_id: int) -> None:
        """Free a dropped object's state (committed + pending)."""
        self._committed.pop(table_id, None)
        self._sorted_keys.pop(table_id, None)
        self._keys_dirty.discard(table_id)
        for buf in self._pending.values():
            buf.pop(table_id, None)

    def discard_pending_tables(self, table_ids) -> None:
        """Drop staged-uncommitted buffers for ``table_ids`` only.

        The scoped-recovery primitive (reference: reset_compute_nodes
        clearing the shared buffer, recovery.rs:140): a dead job may have
        staged a torn subset of its tables for an epoch whose checkpoint it
        never completed — those buffers must not ride a later epoch's
        commit. Committed state is untouched."""
        ids = set(table_ids)
        for buf in self._pending.values():
            for tid in ids:
                buf.pop(tid, None)

    # -- snapshot (checkpoint/restore hooks) ----------------------------------

    def snapshot(self) -> dict:
        return {
            "committed_epoch": self.committed_epoch,
            "tables": copy.deepcopy(self._committed),
        }

    def restore(self, snap: dict) -> None:
        self.committed_epoch = snap["committed_epoch"]
        self._committed = copy.deepcopy(snap["tables"])
        self._pending.clear()
        self._sorted_keys.clear()
        self._keys_dirty.clear()
