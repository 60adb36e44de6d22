"""Union / Values executors.

Counterpart of ``risingwave_tpu/stream/union.py``. Union is an N-way fan-in
over aligned barriers (``align_streams``); a watermark goes on as the
minimum over the inputs of its column, once every input has sent one, and
again only when that minimum changes (a downstream may see W only when
every input has reached W). ChunkBatches pass through whole.

Values emits its literal rows once, right after the first barrier, then
only barriers.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .. import DEFAULT_DEVICE
from ..common.chunk import make_chunk
from ..common.types import Schema
from .barrier_align import align_streams
from .executor import Executor
from .message import Barrier, Watermark


class UnionExecutor(Executor):
    identity = "Union"

    def __init__(self, inputs: Sequence[Executor]):
        assert inputs, "union of nothing"
        self.inputs = list(inputs)
        self.schema = inputs[0].schema
        for inp in inputs[1:]:
            if [f.type.kind for f in inp.schema] != \
               [f.type.kind for f in self.schema]:
                raise ValueError("union inputs must have identical schemas")
        # (input, col) -> its last watermark; col -> the minimum sent
        self._wm: dict[tuple[int, int], int] = {}
        self._emitted_wm: dict[int, int] = {}

    async def execute(self):
        named = dict(enumerate(self.inputs))
        async for ev in align_streams(named):
            kind = ev[0]
            if kind in ("chunk", "batch"):
                yield ev[2]
            elif kind == "barrier":
                yield ev[1]
                if ev[1].is_stop():
                    return
            else:
                _, name, wm = ev
                self._wm[(name, wm.col_idx)] = wm.value
                per_input = [self._wm.get((i, wm.col_idx))
                             for i in range(len(self.inputs))]
                if all(v is not None for v in per_input):
                    low = min(per_input)
                    if self._emitted_wm.get(wm.col_idx) != low:
                        self._emitted_wm[wm.col_idx] = low
                        yield Watermark(wm.col_idx, low)


class ValuesExecutor(Executor):
    """Emits literal rows once after the first barrier, then only
    barriers."""

    identity = "Values"

    def __init__(self, schema: Schema, rows: Sequence[Sequence],
                 barrier_source: Executor, capacity: Optional[int] = None,
                 device=DEFAULT_DEVICE):
        self.schema = schema
        self._rows = list(rows)
        self._barriers = barrier_source
        self._capacity = capacity
        self.device = device

    async def execute(self):
        emitted = False
        async for msg in self._barriers.execute():
            if isinstance(msg, Barrier):
                yield msg
                if not emitted:
                    emitted = True
                    cap = self._capacity or max(len(self._rows), 1)
                    for i in range(0, len(self._rows), cap):
                        yield make_chunk(self.schema, self._rows[i:i + cap],
                                         capacity=cap, device=self.device)
                if msg.is_stop():
                    return
