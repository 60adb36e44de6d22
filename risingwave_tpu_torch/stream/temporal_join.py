"""TemporalJoinExecutor: probe-time lookup against a materialized table.

Counterpart of ``risingwave_tpu/stream/temporal_join.py`` (``FOR
SYSTEM_TIME AS OF PROCTIME()``). The stream side keeps no join state and a
change to the table retracts nothing: each probe row is joined with the
table's rows as they are when it arrives, and the output is append-only.
The table side is read straight from its StateTable: a point get when the
probe keys are the table's whole pk, else an index built by one scan per
chunk. The probe side must be append-only (a delete's enrichment would be
recomputed from the table as it is now and could fail to cancel what was
emitted). Host tier, as in the reference; the output chunks go to ``device``,
where the condition is evaluated.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    DEFAULT_CHUNK_CAPACITY, OP_INSERT, StreamChunk, chunk_to_rows, make_chunk,
)
from ..common.types import Schema
from ..expr.expr import Expr
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor


class TemporalJoinExecutor(SingleInputExecutor):
    identity = "TemporalJoin"

    def __init__(self, input: Executor, right_table: StateTable,
                 left_keys: Sequence[int], right_keys: Sequence[int],
                 outer: bool = False, condition: Optional[Expr] = None,
                 out_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 device=DEFAULT_DEVICE):
        super().__init__(input)
        self.device = device
        self.right_table = right_table
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.outer = outer
        self.condition = condition
        self.out_capacity = out_capacity
        self.in_schema = input.schema
        self.schema = Schema(tuple(input.schema)
                             + tuple(right_table.schema))
        self._point_lookup = (self.right_keys
                              == tuple(right_table.pk_indices))

    def _matches(self, key_vals, index) -> list:
        if any(v is None for v in key_vals):
            return []
        if self._point_lookup:
            row = self.right_table.get_row(key_vals)
            return [row] if row is not None else []
        return index.get(tuple(key_vals), [])

    def _build_index(self) -> dict:
        """Non-pk probe keys: one table scan per chunk, not per row."""
        index: dict = {}
        for r in self.right_table.scan_all():
            index.setdefault(
                tuple(r[i] for i in self.right_keys), []).append(r)
        return index

    async def map_chunk(self, chunk: StreamChunk):
        index = None if self._point_lookup else self._build_index()
        out_rows, out_ops = [], []
        nright = len(self.right_table.schema)
        for op, row in chunk_to_rows(chunk, self.in_schema, with_ops=True,
                                     physical=True):
            if op != OP_INSERT:
                raise AssertionError(
                    "temporal join requires an append-only probe side "
                    "(got a delete/update); join a snapshot instead")
            matches = self._matches([row[i] for i in self.left_keys], index)
            if not matches and self.outer:
                out_rows.append(tuple(row) + (None,) * nright)
                out_ops.append(op)
            for m in matches:
                out_rows.append(tuple(row) + tuple(m))
                out_ops.append(op)
        for i in range(0, len(out_rows), self.out_capacity):
            take = out_rows[i:i + self.out_capacity]
            out = make_chunk(self.schema, take,
                             ops=out_ops[i:i + self.out_capacity],
                             capacity=max(self.out_capacity, len(take)),
                             device=self.device, physical=True)
            if self.condition is not None:
                cond = self.condition.eval(out)
                out = out.mask_vis(cond.data & cond.mask)
            yield out
