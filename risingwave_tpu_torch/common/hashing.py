"""Hashing and vnode partitioning, bit for bit with the reference.

Counterpart of ``risingwave_tpu/common/hashing.py``. The reference mixes in
uint64; torch on the CPU has no uint64 right shift, so this module works in
int64: additions and multiplications wrap to the same 64 bits, and each
logical right shift is an arithmetic shift with the sign-extended high bits
masked off.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .chunk import Column

VNODE_COUNT = 256


def _i64(u: int) -> int:
    """The int64 with the same 64 bits as the unsigned constant ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MUL1 = _i64(0xBF58476D1CE4E5B9)
_MUL2 = _i64(0x94D049BB133111EB)
_NULL_TAG = _i64(0xA5A5A5A55A5A5A5A)
_SEED = _i64(0x243F6A8885A308D3)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64 bit patterns."""
    x = x + _GOLDEN
    x = (x ^ _shr(x, 30)) * _MUL1
    x = (x ^ _shr(x, 27)) * _MUL2
    return x ^ _shr(x, 31)


def hash_column(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """int64 (uint64 bits) hash of one column; nulls hash to a fixed tag."""
    if data.dtype == torch.bool:
        raw = data.long()
    elif data.is_floating_point():
        # hash the float32 bit pattern; -0.0 folds onto 0.0
        f = torch.where(data == 0, torch.zeros_like(data), data)
        raw = f.to(torch.float32).view(torch.int32).long() & 0xFFFFFFFF
    else:
        raw = data.long()
    h = _splitmix64(raw)
    return torch.where(mask, h, torch.full_like(h, _NULL_TAG))


def hash_columns(cols: Sequence[Column]) -> torch.Tensor:
    """Combine per-column hashes into one 64-bit key hash per row."""
    if not cols:
        raise ValueError("hash_columns needs at least one column")
    h = torch.full_like(cols[0].data, _SEED, dtype=torch.int64)
    for c in cols:
        h = _splitmix64(h ^ hash_column(c.data, c.mask))
    return h


def vnode_of(cols: Sequence[Column]) -> torch.Tensor:
    """Per-row vnode in [0, VNODE_COUNT): the uint64 ``% 256`` as ``& 255``."""
    return (hash_columns(cols) & (VNODE_COUNT - 1)).to(torch.int32)


def vnode_to_shard(vnode: torch.Tensor, num_shards: int) -> torch.Tensor:
    """vnode → parallel shard: contiguous vnode ranges, one per shard."""
    per = VNODE_COUNT // num_shards
    return torch.clamp_max(vnode // per, num_shards - 1).to(torch.int32)


def vnodes_of_rows(key_types: Sequence, key_rows: Sequence) -> list:
    """Host-side vnode of each key-value tuple, by the same hash that every
    routing path uses (``vnode_of``, here on CPU tensors). ``key_rows``
    holds the distribution-key values, in key order."""
    key_rows = list(key_rows)
    out: list = []
    bs = 1024
    for i in range(0, len(key_rows), bs):
        batch = key_rows[i:i + bs]
        cols = []
        for c, t in enumerate(key_types):
            vals = [r[c] for r in batch]
            data = np.array([v if v is not None else 0 for v in vals],
                            dtype=t.np_dtype)
            mask = np.array([v is not None for v in vals], dtype=bool)
            cols.append(Column(torch.from_numpy(data),
                               torch.from_numpy(mask)))
        out.extend(vnode_of(cols).tolist())
    return out


def filter_rows_vnodes(key_types: Sequence, rows: Sequence,
                       vnode_start: int, vnode_end: int) -> list:
    """Key-prefixed rows whose distribution key hashes into
    ``[vnode_start, vnode_end)``."""
    rows = list(rows)
    if vnode_start <= 0 and vnode_end >= VNODE_COUNT:
        return rows
    vns = vnodes_of_rows(key_types, [r[:len(key_types)] for r in rows])
    return [r for r, vn in zip(rows, vns) if vnode_start <= vn < vnode_end]


def shard_rows(key_types: Sequence, rows: Sequence, n_shards: int,
               key_indices: Optional[Sequence[int]] = None) -> list:
    """Rows partitioned into ``n_shards`` lists by ``vnode_to_shard``, the
    map live routing uses. ``key_indices`` names the key columns in each row
    (default: the first ``len(key_types)``)."""
    rows = list(rows)
    idx = (list(range(len(key_types))) if key_indices is None
           else list(key_indices))
    vns = vnodes_of_rows(key_types, [[r[i] for i in idx] for r in rows])
    shards = vnode_to_shard(torch.tensor(vns, dtype=torch.int32),
                            n_shards).tolist()
    out: list[list] = [[] for _ in range(n_shards)]
    for r, sh in zip(rows, shards):
        out[sh].append(r)
    return out
