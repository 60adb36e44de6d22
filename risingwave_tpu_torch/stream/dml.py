"""DmlManager: where table writes meet the stream.

Counterpart of ``risingwave_tpu/stream/dml.py``: the registry maps a table
id to the writer handles of its stream job. A write is staged and reaches
every handle of its table when the conductor drains the stage at the next
barrier's injection, so each write lands inside exactly one epoch. A chunk
may hold inserts, deletes and updates (U- then U+).
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..common.chunk import StreamChunk


class TableDmlHandle:
    """One registered writer endpoint of a table's stream job."""

    def __init__(self, push: Callable[[StreamChunk], None]):
        self._push = push

    def write_chunk(self, chunk: StreamChunk) -> None:
        self._push(chunk)


class DmlManager:
    def __init__(self) -> None:
        self._handles: Dict[int, List[TableDmlHandle]] = {}
        self._staged: Dict[int, List[StreamChunk]] = {}

    def register(self, table_id: int, handle: TableDmlHandle) -> None:
        self._handles.setdefault(table_id, []).append(handle)

    def unregister_table(self, table_id: int) -> None:
        self._handles.pop(table_id, None)
        self._staged.pop(table_id, None)

    def has_staged(self) -> bool:
        return bool(self._staged)

    def stage(self, table_id: int, chunk: StreamChunk) -> None:
        """Buffer a DML chunk; it reaches the table inside the next epoch."""
        if table_id not in self._handles:
            raise KeyError(f"no stream job registered for table {table_id}")
        self._staged.setdefault(table_id, []).append(chunk)

    def drain_into_epoch(self) -> int:
        """Deliver every staged chunk to its handles (the conductor calls
        this just before it injects a barrier); returns the chunks
        delivered."""
        n = 0
        for table_id, chunks in self._staged.items():
            for h in self._handles.get(table_id, []):
                for c in chunks:
                    h.write_chunk(c)
                    n += 1
        self._staged.clear()
        return n
