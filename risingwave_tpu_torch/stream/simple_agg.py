"""SimpleAgg / StatelessSimpleAgg — global (single-group) aggregation.

Counterpart of ``risingwave_tpu/stream/simple_agg.py``. SimpleAgg keeps the
one group's lanes as device scalars and emits its first row at the first
barrier (the MV of ``SELECT count(*) …`` shows 0 before any input).
StatelessSimpleAgg is the local phase of a two-phase aggregation: one
partial-delta row per chunk, always an Insert (the global agg downstream
combines them by signed sums), on the device its input chunks are on. A
chunk is applied with no host sync; a barrier reads the flush chunk's
visibility once to decide whether to emit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    OP_INSERT, OP_UPDATE_DELETE, OP_UPDATE_INSERT, Column, StreamChunk,
)
from ..common.types import FLOAT64, GLOBAL_STRING_DICT, INT64, Field, Schema
from ..expr.agg import AggCall
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier


@dataclasses.dataclass
class SimpleAggState:
    lanes: list[torch.Tensor]          # scalars; lane 0 = row count
    prev_lanes: list[torch.Tensor]
    dirty: torch.Tensor                # bool scalar
    ever_emitted: torch.Tensor         # bool scalar


class _AggLanes:
    """Lane layout and update logic shared by the two global-agg
    executors."""

    def __init__(self, agg_calls: Sequence[AggCall]):
        for c in agg_calls:
            if c.lanes_unsupported:
                raise ValueError(
                    f"{c.kind}{'(distinct)' if c.distinct else ''} needs "
                    "materialized-input state (stream/materialized_agg.py)")
        self.agg_calls = tuple(agg_calls)
        self.lane_dtypes = [torch.int64]
        self.call_lane_ofs = []
        for c in self.agg_calls:
            self.call_lane_ofs.append(len(self.lane_dtypes))
            self.lane_dtypes.extend(c.state_dtypes())

    def init_lanes(self, device) -> list[torch.Tensor]:
        vals = [0] + [v for c in self.agg_calls for v in c.init_lanes()]
        return [torch.tensor(v, dtype=dt, device=device)
                for v, dt in zip(vals, self.lane_dtypes)]

    def chunk_deltas(self, chunk: StreamChunk,
                     str_ranks=None) -> list[torch.Tensor]:
        """One delta per lane from a chunk. VARCHAR MIN/MAX deltas stay in
        packed rank|id space; ``merge`` unpacks after combining them with
        the stored lane under the same rank table."""
        signs = chunk.signs()
        deltas = [signs.sum().long()]
        for call in self.agg_calls:
            if call.arg >= 0:
                col = chunk.columns[call.arg]
                value, vmask = col.data, col.mask & chunk.vis
            else:
                value, vmask = torch.zeros_like(signs), chunk.vis
            for contrib, op in zip(
                    call.contributions(value, vmask, signs, str_ranks),
                    call.reduce_ops()):
                deltas.append(contrib.sum() if op == "add"
                              else contrib.amin() if op == "min"
                              else contrib.amax())
        return deltas

    def merge(self, lanes, deltas, str_ranks=None) -> list[torch.Tensor]:
        out = [lanes[0] + deltas[0]]
        i = 1
        for call in self.agg_calls:
            for op in call.reduce_ops():
                if op == "add":
                    out.append(lanes[i] + deltas[i])
                else:
                    best = torch.minimum if op == "min" else torch.maximum
                    out.append(call.unpack_lane(best(
                        call.pack_lane(lanes[i], str_ranks), deltas[i])))
                i += 1
        return out

    def outputs(self, lanes) -> list[tuple[torch.Tensor, torch.Tensor]]:
        live = lanes[0] > 0
        outs = []
        for call, ofs in zip(self.agg_calls, self.call_lane_ofs):
            data, mask = call.output(
                [lanes[ofs + j] for j in range(call.num_lanes)], live)
            outs.append((data.to(call.output_type.dtype), mask))
        return outs

    def out_schema(self) -> Schema:
        return Schema(tuple(Field(f"agg{i}", c.output_type)
                            for i, c in enumerate(self.agg_calls)))


def simple_agg_state_schema(agg_calls: Sequence[AggCall]) -> Schema:
    """Schema of the durable simple-agg row: id pk, the raw lanes, the
    ever-emitted flag."""
    fields = [Field("id", INT64)]
    for i, dt in enumerate(_AggLanes(agg_calls).lane_dtypes):
        fields.append(Field(f"l{i}", INT64 if dt == torch.int64 else FLOAT64))
    fields.append(Field("flag", INT64))
    return Schema(tuple(fields))


class SimpleAggExecutor(SingleInputExecutor):
    """Global aggregation: the output is always exactly one logical row."""

    identity = "SimpleAgg"

    def __init__(self, input: Executor, agg_calls: Sequence[AggCall],
                 state_table: Optional[StateTable] = None,
                 device=DEFAULT_DEVICE):
        super().__init__(input)
        self.lanes_def = _AggLanes(agg_calls)
        self.agg_calls = self.lanes_def.agg_calls
        self.schema = self.lanes_def.out_schema()
        self.state_table = state_table
        self.device = torch.device(device)
        self._needs_ranks = any(c.is_string_minmax for c in self.agg_calls)
        self.state = SimpleAggState(
            lanes=self.lanes_def.init_lanes(device),
            prev_lanes=self.lanes_def.init_lanes(device),
            dirty=torch.zeros((), dtype=torch.bool, device=device),
            ever_emitted=torch.zeros((), dtype=torch.bool, device=device))
        if state_table is not None:
            self._load_from_state_table()

    def _apply(self, chunk: StreamChunk) -> None:
        # MIN/MAX over VARCHAR: the rank table as of this update
        str_ranks = (GLOBAL_STRING_DICT.device_ranks(self.device)
                     if self._needs_ranks else None)
        st = self.state
        deltas = self.lanes_def.chunk_deltas(chunk, str_ranks)
        st.lanes = self.lanes_def.merge(st.lanes, deltas, str_ranks)
        st.dirty = st.dirty | chunk.vis.any()

    def _flush(self) -> StreamChunk:
        """A chunk of two rows: row 0 = U- of the previous values (visible
        only if they were emitted), row 1 = U+ (or Insert) of the current
        ones; advances the emitted snapshot."""
        st = self.state
        emit = st.dirty | ~st.ever_emitted
        prev_outs = self.lanes_def.outputs(st.prev_lanes)
        cur_outs = self.lanes_def.outputs(st.lanes)
        second = torch.where(st.ever_emitted, OP_UPDATE_INSERT, OP_INSERT)
        ops = torch.stack([torch.full_like(second, OP_UPDATE_DELETE),
                           second]).to(torch.int8)
        vis = torch.stack([st.ever_emitted & emit, emit])
        cols = tuple(Column(torch.stack([pd, cd]), torch.stack([pm, cm]))
                     for (pd, pm), (cd, cm) in zip(prev_outs, cur_outs))
        st.prev_lanes = list(st.lanes)
        st.dirty = torch.zeros_like(st.dirty)
        st.ever_emitted = st.ever_emitted | emit
        return StreamChunk(ops, vis, cols)

    async def map_chunk(self, chunk: StreamChunk):
        self._apply(chunk)
        if False:
            yield

    async def on_barrier(self, barrier: Barrier):
        chunk = self._flush()
        if bool(chunk.vis.any()):
            yield chunk
        if barrier.checkpoint and self.state_table is not None:
            self._checkpoint(barrier.epoch.curr)

    # -- persistence ----------------------------------------------------------

    def _checkpoint(self, epoch: int) -> None:
        row = tuple(lane.item() for lane in self.state.lanes) + (
            int(bool(self.state.ever_emitted)),)
        self.state_table.insert((0,) + row)
        self.state_table.commit(epoch)

    def _load_from_state_table(self) -> None:
        rows = list(self.state_table.scan_all())
        if not rows:
            return
        row = rows[0]
        dev = self.device
        lanes = [torch.tensor(v, dtype=dt, device=dev)
                 for v, dt in zip(row[1:], self.lanes_def.lane_dtypes)]
        self.state = SimpleAggState(
            lanes=lanes, prev_lanes=list(lanes),
            dirty=torch.zeros((), dtype=torch.bool, device=dev),
            ever_emitted=torch.tensor(bool(row[1 + len(lanes)]),
                                      device=dev))


class StatelessSimpleAggExecutor(SingleInputExecutor):
    """Local (pre-shuffle) agg phase: one partial-delta Insert row per
    chunk (only sum/count shapes are retraction-safe)."""

    identity = "StatelessSimpleAgg"

    def __init__(self, input: Executor, agg_calls: Sequence[AggCall]):
        super().__init__(input)
        for c in agg_calls:
            if c.needs_append_only or c.kind == "avg":
                raise ValueError(
                    f"stateless agg cannot emit {c.kind} partials; the "
                    "planner must split it (avg -> sum+count)")
        self.lanes_def = _AggLanes(agg_calls)
        self.agg_calls = self.lanes_def.agg_calls
        self.schema = self.lanes_def.out_schema()

    def _step(self, chunk: StreamChunk) -> StreamChunk:
        """RAW partial deltas (signed): the global agg downstream combines
        them."""
        deltas = self.lanes_def.chunk_deltas(chunk)
        cols = []
        for call, ofs in zip(self.agg_calls, self.lanes_def.call_lane_ofs):
            data = deltas[ofs].to(call.output_type.dtype)
            if call.arg >= 0:
                c = chunk.columns[call.arg]
                mask = (c.mask & chunk.vis).any()
            else:
                mask = torch.ones((), dtype=torch.bool, device=data.device)
            cols.append(Column(data[None], mask[None]))
        ops = torch.zeros(1, dtype=torch.int8, device=chunk.device)
        return StreamChunk(ops, chunk.vis.any()[None], tuple(cols))

    async def map_chunk(self, chunk: StreamChunk):
        out = self._step(chunk)
        if bool(out.vis.any()):
            yield out
