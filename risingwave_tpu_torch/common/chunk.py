"""Columnar chunk format — the unit of dataflow.

Counterpart of ``risingwave_tpu/common/chunk.py``: a chunk is a
struct-of-tensors of fixed-capacity buffers plus a visibility mask.

Layout per chunk of capacity C:
  * ``ops``  int8[C]   — Insert / Delete / UpdateDelete / UpdateInsert
  * ``vis``  bool[C]   — row visibility (capacity padding ⇒ False)
  * per column: ``data`` dtype[C] and ``mask`` bool[C] (True = non-null)

An update is two adjacent rows (U- then U+) with the same key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from .types import Schema

# Op codes (the reference's Op enum order).
OP_INSERT = 0
OP_DELETE = 1
OP_UPDATE_DELETE = 2
OP_UPDATE_INSERT = 3

DEFAULT_CHUNK_CAPACITY = 1024


@dataclasses.dataclass
class Column:
    data: torch.Tensor  # dtype[C]
    mask: torch.Tensor  # bool[C]; True = non-null


@dataclasses.dataclass
class StreamChunk:
    """A batch of row-level change events (+ visibility padding)."""

    ops: torch.Tensor  # int8[C]
    vis: torch.Tensor  # bool[C]
    columns: tuple[Column, ...]

    @property
    def capacity(self) -> int:
        return self.ops.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ops.device

    def replace(self, **kw) -> "StreamChunk":
        return dataclasses.replace(self, **kw)

    def with_columns(self, columns: Sequence[Column]) -> "StreamChunk":
        return self.replace(columns=tuple(columns))

    def mask_vis(self, keep: torch.Tensor) -> "StreamChunk":
        return self.replace(vis=self.vis & keep)

    def signs(self) -> torch.Tensor:
        """+1 for Insert/UpdateInsert, -1 for Delete/UpdateDelete, 0 for
        invisible rows: the delta weight of aggregation."""
        pos = (self.ops == OP_INSERT) | (self.ops == OP_UPDATE_INSERT)
        one = torch.ones_like(self.ops, dtype=torch.int32)
        s = torch.where(pos, one, -one)
        return torch.where(self.vis, s, torch.zeros_like(s))


@dataclasses.dataclass
class ChunkBatch:
    """K stacked StreamChunks: every tensor carries a leading [K] axis.

    The unit of batched ingest (``risingwave_tpu/common/chunk.py``'s
    ``ChunkBatch``): a source hands an epoch's K chunks over at once and
    each executor takes them in one step; ``at(i)`` is chunk i as views."""

    chunk: StreamChunk  # tensors: [K, C]

    @property
    def num_chunks(self) -> int:
        return self.chunk.ops.shape[0]

    @property
    def chunk_capacity(self) -> int:
        return self.chunk.ops.shape[1]

    def at(self, i: int) -> StreamChunk:
        return map_tensors(self.chunk, lambda a: a[i])


def stack_chunks(chunks: Sequence[StreamChunk]) -> ChunkBatch:
    """Chunks of one capacity and schema as one ChunkBatch."""
    return ChunkBatch(StreamChunk(
        torch.stack([c.ops for c in chunks]),
        torch.stack([c.vis for c in chunks]),
        tuple(Column(torch.stack([c.columns[i].data for c in chunks]),
                     torch.stack([c.columns[i].mask for c in chunks]))
              for i in range(len(chunks[0].columns)))))


def interleave_chunks(chunks: Sequence[StreamChunk]) -> ChunkBatch:
    """n chunks of [K, C] tensors (n outputs of each of K chunks) as one
    ChunkBatch of K·n chunks: chunk-major, the n outputs inside."""
    k, c = chunks[0].vis.shape

    def stack(get):
        return torch.stack([get(o) for o in chunks], 1).reshape(-1, c)

    return ChunkBatch(StreamChunk(
        stack(lambda o: o.ops), stack(lambda o: o.vis),
        tuple(Column(stack(lambda o, j=j: o.columns[j].data),
                     stack(lambda o, j=j: o.columns[j].mask))
              for j in range(len(chunks[0].columns)))))


def map_tensors(chunk: StreamChunk, f) -> StreamChunk:
    """The chunk with ``f`` applied to every tensor (ops, vis, each column's
    data and mask)."""
    return StreamChunk(f(chunk.ops), f(chunk.vis),
                       tuple(Column(f(c.data), f(c.mask))
                             for c in chunk.columns))


def flatten_shards(chunk: StreamChunk) -> StreamChunk:
    """A batched chunk ([k, cap] tensors) as ONE chunk of k*cap rows, in
    row-major order (vis already masks the invalid rows)."""
    return map_tensors(chunk, lambda a: a.reshape((-1,) + a.shape[2:]))


def make_chunk(
    schema: Schema,
    rows: Sequence[Sequence[Any]],
    ops: Optional[Sequence[int]] = None,
    capacity: int = DEFAULT_CHUNK_CAPACITY,
    device=DEFAULT_DEVICE,
    physical: bool = False,
) -> StreamChunk:
    """Host constructor: python rows → padded chunk on ``device``.

    ``physical=True`` takes raw physical values (the state-table storage
    form) and skips the logical encoding: the recovery-reload path."""
    n = len(rows)
    if n > capacity:
        raise ValueError(f"{n} rows > capacity {capacity}")
    if ops is None:
        ops = [OP_INSERT] * n
    ops_arr = np.zeros(capacity, np.int8)
    ops_arr[:n] = np.asarray(list(ops), np.int8)
    vis = np.zeros(capacity, bool)
    vis[:n] = True
    cols = []
    for ci, field in enumerate(schema):
        t = field.type
        sentinel = t.null_sentinel()
        values = [row[ci] for row in rows]
        data = np.full(capacity, sentinel, t.np_dtype)
        mask = np.zeros(capacity, bool)
        if n:
            mask[:n] = [v is not None for v in values]
            data[:n] = [sentinel if v is None else
                        v if physical else t.to_physical(v) for v in values]
        cols.append(Column(torch.as_tensor(data, device=device),
                           torch.as_tensor(mask, device=device)))
    return StreamChunk(torch.as_tensor(ops_arr, device=device),
                       torch.as_tensor(vis, device=device), tuple(cols))


def physical_chunk(schema: Schema, rows: Sequence[Sequence[Any]],
                   capacity: int, device=DEFAULT_DEVICE) -> StreamChunk:
    """Rows of raw physical values → chunk (``make_chunk(physical=True)``)."""
    return make_chunk(schema, rows, capacity=capacity, device=device,
                      physical=True)


def chunk_to_rows(chunk: StreamChunk, schema: Schema,
                  with_ops: bool = False, physical: bool = False) -> list:
    """Chunk → visible python rows (one host copy; tests and egress).

    ``physical=True`` keeps the raw physical values (VARCHAR as its id),
    the state-table storage form."""
    vis = chunk.vis.cpu().numpy()
    idx = np.nonzero(vis)[0]
    cols = []
    for ci in range(len(schema)):
        data = chunk.columns[ci].data.cpu().numpy()[idx]
        mask = chunk.columns[ci].mask.cpu().numpy()[idx].tolist()
        if physical:
            cols.append([v if m else None
                         for v, m in zip(data.tolist(), mask)])
        else:
            conv = schema[ci].type.to_python
            cols.append([conv(v) if m else None for v, m in zip(data, mask)])
    rows = list(zip(*cols)) if cols else [()] * len(idx)
    if with_ops:
        return list(zip(chunk.ops.cpu().numpy()[idx].tolist(), rows))
    return rows


def _update_units(chunk: StreamChunk):
    """Rows grouped into emission units: a visible U- immediately followed by
    a visible U+ forms one 2-row unit; every other visible row is a 1-row
    unit. Returns (unit_index int64[C], attached bool[C], unit_start)."""
    ops, vis = chunk.ops, chunk.vis
    prev_ud = torch.cat([
        torch.zeros(1, dtype=torch.bool, device=ops.device),
        (ops[:-1] == OP_UPDATE_DELETE) & vis[:-1],
    ])
    attached = vis & (ops == OP_UPDATE_INSERT) & prev_ud
    unit_start = vis & ~attached
    unit_index = torch.cumsum(unit_start, 0) - 1  # valid where vis
    return unit_index, attached, unit_start


def count_units(chunk: StreamChunk) -> torch.Tensor:
    """Number of emission units in the chunk (a device scalar)."""
    _, _, unit_start = _update_units(chunk)
    return unit_start.sum()


def gather_units_window(chunk: StreamChunk, lo: int,
                        out_capacity: int) -> StreamChunk:
    """Pack the units with index in [lo, lo + out_capacity//2) into a fresh
    chunk of ``out_capacity`` rows (2 slots per unit; vis masks the gaps).

    A gather: output unit g reads the row where the inclusive count of unit
    starts first reaches lo + g + 1 (``searchsorted``), and the row after it
    when that one is attached. Rows outside the window are never touched,
    so a window over a large, mostly invisible chunk (the fused q7 probe
    drain) costs the window's size, not the chunk's, and no store contends
    for a shared sentinel cell."""
    G = out_capacity // 2
    n = chunk.capacity
    _, attached, unit_start = _update_units(chunk)
    starts = torch.cumsum(unit_start, 0)
    g = lo + torch.arange(G, dtype=torch.int64, device=starts.device)
    valid = g < starts[-1]
    first = torch.where(valid, torch.searchsorted(starts, g + 1), 0)
    second = torch.clamp_max(first + 1, n - 1)
    pair = valid & (first + 1 < n) & attached[second]
    src = torch.stack([first, second], 1).reshape(2 * G)
    vis = torch.stack([valid, pair], 1).reshape(2 * G)
    if out_capacity > 2 * G:       # odd capacity: the last slot stays empty
        src = torch.cat([src, src.new_zeros(1)])
        vis = torch.cat([vis, vis.new_zeros(1)])

    def take(a: torch.Tensor) -> torch.Tensor:
        return torch.where(vis, a[src], torch.zeros((), dtype=a.dtype,
                                                     device=a.device))

    return StreamChunk(take(chunk.ops), vis,
                       tuple(Column(take(c.data), take(c.mask))
                             for c in chunk.columns))
