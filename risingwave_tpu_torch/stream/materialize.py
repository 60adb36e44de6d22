"""MaterializeExecutor — terminal sink writing MV rows to a StateTable.

Counterpart of ``risingwave_tpu/stream/materialize.py``: the egress
boundary, where device chunks become host rows (one copy per chunk). It
ends an MV's tree, and it is the whole of a table's job (DML queue →
[RowIdGen] → Materialize, ``stream/tpch_plans.py``), whose state table is
what a Backfill reads. Conflicts overwrite on pk: an insert replaces the
row stored under its pk (the reference's default), and the chunk passes
on unchanged. A barrier seals the table's epoch; committing the store is
the caller's, after every job has collected the barrier.
"""

from __future__ import annotations

from ..common.chunk import (
    OP_INSERT, OP_UPDATE_INSERT, StreamChunk, chunk_to_rows,
)
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier


class MaterializeExecutor(SingleInputExecutor):
    identity = "Materialize"

    def __init__(self, input: Executor, state_table: StateTable):
        super().__init__(input)
        self.schema = input.schema
        self.table = state_table

    async def map_chunk(self, chunk: StreamChunk):
        for op, phys in chunk_to_rows(chunk, self.schema, with_ops=True,
                                      physical=True):
            if op in (OP_INSERT, OP_UPDATE_INSERT):
                self.table.insert(phys)
            else:
                self.table.delete(phys)
        yield chunk

    async def on_barrier(self, barrier: Barrier):
        self.table.commit(barrier.epoch.curr)
        if False:
            yield

    def rows(self) -> list[tuple]:
        """The MV's rows as python values (a batch scan)."""
        return [tuple(None if v is None else self.schema[i].type.to_python(v)
                      for i, v in enumerate(phys))
                for phys in self.table.scan_all()]
