"""ProjectSet: set-returning functions in the select list.

Counterpart of ``risingwave_tpu/stream/project_set.py``: each input row
yields one output row per element of the table function's result; plain
expressions are replicated. The output stream key is the input key plus a
hidden element index (the reference's ``projected_row_id``, a last column
named ``_pidx``). Update pairs are rewritten to Delete + Insert: the old
and new rows of a pair may expand to different element counts.

Host tier, as in the reference: the expressions are evaluated on the
device, the expansion runs on the host per row, and the output chunks go
to ``device``. VARCHAR elements are interned into this
package's ``GLOBAL_STRING_DICT``. ``unnest`` over a LIST column gives its
elements through the list's element type (``DataType.elem_type``), so an
``array_agg`` output unnests into typed rows.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    DEFAULT_CHUNK_CAPACITY, OP_DELETE, OP_INSERT, OP_UPDATE_DELETE,
    OP_UPDATE_INSERT, StreamChunk, make_chunk,
)
from ..common.types import (
    GLOBAL_LIST_DICT, GLOBAL_STRING_DICT, INT64, DataType, Field, Schema,
)
from ..expr.expr import Expr
from .executor import Executor, SingleInputExecutor

TABLE_FUNC_KINDS = {"generate_series", "regexp_split_to_table", "unnest"}


@dataclasses.dataclass(frozen=True, eq=False)
class TableFuncCall(Expr):
    """A set-returning call; valid only inside ProjectSet (or in FROM)."""

    name: str
    args: tuple
    type: DataType = INT64

    def eval(self, chunk):  # pragma: no cover
        raise RuntimeError("table function outside ProjectSet")


def series_values(name: str, args: Sequence,
                  elem_type: Optional[DataType] = None) -> list:
    """One row's argument values → the list of its elements (physical
    values: VARCHAR as its dictionary id). ``elem_type``: unnest's element
    type, when its argument is typed as a LIST."""
    if name == "generate_series":
        if len(args) == 2:
            lo, hi, step = args[0], args[1], 1
        else:
            lo, hi, step = args
        if lo is None or hi is None or step in (None, 0):
            return []
        return list(range(int(lo), int(hi) + (1 if step > 0 else -1),
                          int(step)))
    if name == "regexp_split_to_table":
        # dictionary ids (ProjectSet) or python strings (a constant in FROM)
        def as_str(v):
            return v if isinstance(v, str) else GLOBAL_STRING_DICT.lookup(
                int(v))

        s, p = args
        if s is None or p is None:
            return []
        return [GLOBAL_STRING_DICT.intern(x)
                for x in re.split(as_str(p), as_str(s))]
    if name == "unnest":
        # a list-dictionary id (ProjectSet) or the tuple itself (FROM)
        (lst,) = args
        if lst is None:
            return []
        if not isinstance(lst, (tuple, list)):
            lst = GLOBAL_LIST_DICT.lookup(int(lst))
        if elem_type is not None:
            return [None if e is None else elem_type.to_physical(e)
                    for e in lst]
        return [GLOBAL_STRING_DICT.intern(e) if isinstance(e, str) else e
                for e in lst]
    raise ValueError(f"unknown table function {name}")


class ProjectSetExecutor(SingleInputExecutor):
    identity = "ProjectSet"

    def __init__(self, input: Executor, exprs: Sequence[Expr],
                 names: Sequence[str],
                 out_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 device=DEFAULT_DEVICE):
        super().__init__(input)
        self.device = device
        self.exprs = list(exprs)
        self.schema = Schema(tuple(
            Field(n, e.type) for n, e in zip(names, self.exprs)))
        self.out_capacity = out_capacity

    async def map_chunk(self, chunk: StreamChunk):
        vis = chunk.vis.cpu().numpy()
        ops = chunk.ops.cpu().numpy()

        def host(c):
            return c.data.cpu().numpy(), c.mask.cpu().numpy()

        plain_cols: dict[int, tuple] = {}
        tf_args: dict[int, list] = {}
        for ci, e in enumerate(self.exprs):
            if isinstance(e, TableFuncCall):
                tf_args[ci] = [host(a.eval(chunk)) for a in e.args]
            else:
                plain_cols[ci] = host(e.eval(chunk))
        with_pidx = self.schema.names[-1] == "_pidx"
        out_rows: list = []
        out_ops: list = []
        for i in np.nonzero(vis)[0]:
            op = int(ops[i])
            if op == OP_UPDATE_DELETE:
                op = OP_DELETE
            elif op == OP_UPDATE_INSERT:
                op = OP_INSERT
            base = {ci: data[i].item() if mask[i] else None
                    for ci, (data, mask) in plain_cols.items()}
            series: list = [()]
            for ci, e in enumerate(self.exprs):
                if isinstance(e, TableFuncCall):
                    argv = [d[i].item() if m[i] else None
                            for d, m in tf_args[ci]]
                    elem_t = (e.args[0].type.elem_type
                              if e.name == "unnest"
                              and e.args[0].type.is_list else None)
                    series = [(ci, v, idx) for idx, v in enumerate(
                        series_values(e.name, argv, elem_t))]
            for ci, v, idx in series:
                row = [None] * len(self.exprs)
                for pc, bv in base.items():
                    row[pc] = bv
                row[ci] = v
                if with_pidx:
                    row[-1] = idx
                out_rows.append(tuple(row))
                out_ops.append(op)
        for i in range(0, len(out_rows), self.out_capacity):
            take = out_rows[i:i + self.out_capacity]
            yield make_chunk(self.schema, take,
                             ops=out_ops[i:i + self.out_capacity],
                             capacity=max(self.out_capacity, len(take)),
                             device=self.device, physical=True)
