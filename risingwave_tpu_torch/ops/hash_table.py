"""Device-resident open-addressing hash table (key → slot index).

Counterpart of ``risingwave_tpu/ops/hash_table.py``. A whole chunk of keys is
probed at once in rounds of gather / compare / claim, capped at
``MAX_PROBE_ROUNDS`` rounds in all; the reference runs the rounds in a
``lax.while_loop`` on the device. For tensors on a CUDA device,
``ht_lookup_or_insert`` and ``ht_lookup`` launch kernel B3
(``csrc/hash_probe.cu``), which hashes the keys (bit for bit
``common/hashing.hash_columns``), finds each row's first match-or-empty slot
a window of slots at a time, settles every row that meets an empty slot
from the bids placed there, and runs the claim rounds only among the rows
that lose a slot to another key, reading nothing back to the host. For tensors on the CPU they run the
plain versions, ``ht_lookup_or_insert_plain`` and ``ht_lookup_plain``: the
same rounds as a Python loop that reads ``any(~done)`` from the device each
round. Neither falls back to the other.

The slot layout is equal slot for slot to the reference's, because flush
output order follows slot order: an empty slot wanted by several rows in one
round goes to the row with the smallest index (the plain version finds it
through a stable sort, the kernel through an atomicMin claim word per slot).
Group keys compare GROUP-BY style (NULL == NULL). Slots are never freed.

The table is updated in place.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import torch

from .. import DEFAULT_DEVICE, kernels
from ..common.chunk import Column
from ..common.hashing import hash_columns

MAX_PROBE_ROUNDS = 128


@dataclasses.dataclass
class DeviceHashTable:
    key_data: tuple[torch.Tensor, ...]   # per key column: dtype[cap]
    key_mask: tuple[torch.Tensor, ...]   # per key column: bool[cap]
    occupied: torch.Tensor               # bool[cap]

    @property
    def capacity(self) -> int:
        return self.occupied.shape[0]

    def clone(self) -> "DeviceHashTable":
        return DeviceHashTable(tuple(t.clone() for t in self.key_data),
                               tuple(t.clone() for t in self.key_mask),
                               self.occupied.clone())


def ht_new(key_types: Sequence, capacity: int,
           device=DEFAULT_DEVICE) -> DeviceHashTable:
    """``key_types``: DataTypes of the key columns. ``capacity``: power of 2."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    return DeviceHashTable(
        key_data=tuple(torch.zeros(capacity, dtype=t.dtype, device=device)
                       for t in key_types),
        key_mask=tuple(torch.zeros(capacity, dtype=torch.bool, device=device)
                       for _ in key_types),
        occupied=torch.zeros(capacity, dtype=torch.bool, device=device),
    )


def hit_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """bool[n], True at each of ``idx`` (entries equal to ``n`` are dropped:
    the reference's ``.at[idx].set(True, mode="drop")`` into zeros). Every
    write is True, so duplicate indices cannot race."""
    hit = torch.zeros(n + 1, dtype=torch.bool, device=idx.device)
    # index_fill_ takes the scalar as a kernel argument; ``hit[idx] = True``
    # would copy it to the card first, a host sync
    hit.index_fill_(0, idx, True)
    return hit[:-1]


def set_where(target: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
              values) -> None:
    """``target[idx[valid]] = values[valid]`` in place (``values`` may be a
    scalar). The caller guarantees that the valid indices are distinct."""
    rows = valid.nonzero().squeeze(1)
    if isinstance(values, torch.Tensor):
        values = values[rows]
    target[idx[rows]] = values


_BITS_OF_SIZE = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                 8: torch.int64}


def set_rows(target: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
             values) -> None:
    """``target[pos[keep]] = values[keep]`` in place, without a host sync,
    for a 1-D ``target`` of any fixed-width dtype (``values`` may be a
    scalar). Kept positions must be distinct and in range; every other row
    adds 0 to a cell of its own. The write adds the difference of the bit
    patterns as integers of the target's width, which wraps, so each value
    lands bit for bit."""
    bits = _BITS_OF_SIZE[target.element_size()]
    t = target.view(bits)
    if not isinstance(values, torch.Tensor):
        values = torch.full(pos.shape, values, dtype=target.dtype,
                            device=pos.device)
    v = values.to(target.dtype).view(bits)
    own = torch.arange(pos.shape[0], device=pos.device) % t.shape[0]
    idx = torch.where(keep, pos, own)
    t.index_add_(0, idx, torch.where(keep, v - t[idx], 0))


def _keys_equal_at(table: DeviceHashTable, cand: torch.Tensor,
                   datas: Sequence[torch.Tensor],
                   masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise: does the key stored at slot ``cand`` equal each probe key?"""
    eq = torch.ones(cand.shape, dtype=torch.bool, device=cand.device)
    for td, tm, d, m in zip(table.key_data, table.key_mask, datas, masks):
        sd = td[cand]
        sm = tm[cand]
        eq = eq & ((sm & m & (sd == d)) | (~sm & ~m))
    return eq


def ht_lookup_or_insert_plain(table: DeviceHashTable,
                              key_cols: Sequence[Column],
                              valid: torch.Tensor):
    """Plain PyTorch find-or-insert, with ``ht_lookup_or_insert``'s
    contract: a host loop of rounds that syncs the host in each round
    (``any(~done)`` and ``set_where``'s ``nonzero``)."""
    cap = table.capacity
    datas = [c.data for c in key_cols]
    masks = [c.mask for c in key_cols]
    n = valid.shape[0]
    dev = valid.device
    h = hash_columns(key_cols) & (cap - 1)
    done = ~valid
    offset = torch.zeros(n, dtype=torch.int64, device=dev)
    is_new = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(MAX_PROBE_ROUNDS):
        if not bool((~done).any()):
            break
        cand = (h + offset) & (cap - 1)
        occ = table.occupied[cand]
        eq = occ & _keys_equal_at(table, cand, datas, masks)
        newly_found = ~done & eq
        # claim: among rows wanting the same empty slot the smallest row
        # index wins — a stable sort of (slot, row) pairs over the chunk
        want = ~done & ~occ
        cand_eff = torch.where(want, cand, torch.full_like(cand, cap))
        sorted_slot, order = torch.sort(cand_eff, stable=True)
        first = torch.ones_like(want)
        first[1:] = sorted_slot[1:] != sorted_slot[:-1]
        winner = torch.zeros_like(want)
        winner[order] = first & (sorted_slot < cap)
        # winners hold distinct slots
        set_where(table.occupied, winner, cand, True)
        for kd, d in zip(table.key_data, datas):
            set_where(kd, winner, cand, d)
        for km, m in zip(table.key_mask, masks):
            set_where(km, winner, cand, m)
        # a true collision advances the probe; settled rows freeze
        offset = offset + (~done & occ & ~eq).long()
        done = done | newly_found | winner
        is_new = is_new | winner
    settled = done & valid
    slots = torch.where(settled, (h + offset) & (cap - 1),
                        torch.full_like(h, cap))
    overflow = (valid & ~done).any()
    return table, slots, is_new & valid, overflow


def ht_lookup_plain(table: DeviceHashTable, key_cols: Sequence[Column],
                    valid: torch.Tensor):
    """Plain PyTorch read-only probe (see ``ht_lookup``)."""
    cap = table.capacity
    datas = [c.data for c in key_cols]
    masks = [c.mask for c in key_cols]
    n = valid.shape[0]
    dev = valid.device
    h = hash_columns(key_cols) & (cap - 1)
    done = ~valid
    offset = torch.zeros(n, dtype=torch.int64, device=dev)
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(MAX_PROBE_ROUNDS):
        if not bool((~done).any()):
            break
        cand = (h + offset) & (cap - 1)
        occ = table.occupied[cand]
        eq = occ & _keys_equal_at(table, cand, datas, masks)
        hit = ~done & eq
        miss = ~done & ~occ          # empty slot ⇒ key absent
        done = done | hit | miss
        found = found | hit
        offset = offset + (~done).long()
    slots = torch.where(found, (h + offset) & (cap - 1),
                        torch.full_like(h, cap))
    return slots, found


# ---------------------------------------------------------------------------
# kernel B3
# ---------------------------------------------------------------------------

#: key dtypes the kernel takes, by the code the launcher reads
_DTYPE_CODES = {torch.bool: 0, torch.int32: 1, torch.int64: 2,
                torch.float64: 3}
_MAX_KEY_COLS = 4
_PATHS = {"auto": 0, "phased": 1, "grid": 2}
_CLAIM_FREE = 0x7FFFFFFF


def _library():
    lib = kernels.load("hash_probe")
    if lib.hash_probe_find_launch.argtypes is None:  # no 32-bit pointers
        ptr, arr = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        head = [ptr, ctypes.c_longlong, ctypes.c_int, arr, arr,
                ctypes.POINTER(ctypes.c_int), arr, arr, ptr,
                ctypes.c_longlong]
        lib.hash_probe_insert_launch.argtypes = head + [ptr] * 4 + [
            ctypes.c_longlong, ctypes.c_int, ptr]
        lib.hash_probe_insert_launch.restype = ctypes.c_int
        lib.hash_probe_find_launch.argtypes = head + [ptr] * 3
        lib.hash_probe_find_launch.restype = ctypes.c_int
        lib.hash_probe_workspace_words.argtypes = [ctypes.c_longlong] * 2
        for f in (lib.hash_probe_workspace_words, lib.hash_probe_header_words,
                  lib.hash_probe_rounds_word):
            f.restype = ctypes.c_longlong
    return lib


#: (device index, stream) -> (int32 words, rows, capacity): the header, the
#: absent-row list for ``rows`` rows a call, the claim words for tables of
#: up to ``capacity`` slots; every launch leaves it at rest
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, int, int]] = {}


def _workspace(lib, dev: torch.device, stream: int, n: int, cap: int):
    """``(words, rows)`` of the workspace for this device and stream, made
    anew when a call brings more rows or a larger table than it has seen;
    the header starts at 0 and the claim words free."""
    ws = _workspaces.get((dev.index, stream))
    if ws is None or ws[1] < n or ws[2] < cap:
        rows, cap = max(n, ws[1] if ws else 0), max(cap, ws[2] if ws else 0)
        words = torch.full((lib.hash_probe_workspace_words(rows, cap),),
                           _CLAIM_FREE, dtype=torch.int32, device=dev)
        words[:lib.hash_probe_header_words()].zero_()
        ws = _workspaces[(dev.index, stream)] = (words, rows, cap)
    return ws[0], ws[1]


def last_claim_rounds(device=None) -> int:
    """The claim rounds the last phased find-or-insert on ``device`` and its
    current stream ran (reads the card: for checks, not for a main path)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    word = _library().hash_probe_rounds_word()
    return int(_workspaces[(dev.index, stream)][0][word])


def _launch_args(table: DeviceHashTable, key_cols: Sequence[Column],
                 valid: torch.Tensor):
    """The launchers' common arguments, after checking what the kernel
    takes; the tensors are returned too, to keep them alive."""
    if not 1 <= len(key_cols) <= _MAX_KEY_COLS:
        raise ValueError(f"the probe kernel takes 1 to {_MAX_KEY_COLS} key "
                         f"columns, got {len(key_cols)}")
    if len(key_cols) != len(table.key_data):
        raise ValueError("key columns and table columns differ in number")
    if valid.dtype != torch.bool or valid.dim() != 1:
        raise TypeError("valid must be bool[N]")
    n = valid.shape[0]
    dev = valid.device
    datas, masks, codes = [], [], []
    for c, td, tm in zip(key_cols, table.key_data, table.key_mask):
        if c.data.dtype != td.dtype:
            raise TypeError(f"key column {c.data.dtype} against table "
                            f"column {td.dtype}")
        if c.data.dtype not in _DTYPE_CODES:
            raise TypeError(f"the probe kernel takes no {c.data.dtype} key")
        for t in (c.data, c.mask, td, tm):
            if t.device != dev:
                raise ValueError("key columns, table and valid are on "
                                 "different devices")
        if c.data.shape != (n,) or c.mask.shape != (n,) \
                or c.mask.dtype != torch.bool:
            raise ValueError("each key column must be [N] with a bool mask")
        if not (td.is_contiguous() and tm.is_contiguous()):
            raise ValueError("table columns must be contiguous")
        datas.append(c.data.contiguous())
        masks.append(c.mask.contiguous())
        codes.append(_DTYPE_CODES[c.data.dtype])
    if not table.occupied.is_contiguous():
        raise ValueError("table.occupied must be contiguous")
    valid = valid.contiguous()
    ncols = len(key_cols)
    arr = ctypes.c_void_p * ncols
    args = (valid.data_ptr(), n, ncols,
            arr(*(d.data_ptr() for d in datas)),
            arr(*(m.data_ptr() for m in masks)),
            (ctypes.c_int * ncols)(*codes),
            arr(*(t.data_ptr() for t in table.key_data)),
            arr(*(t.data_ptr() for t in table.key_mask)),
            table.occupied.data_ptr(), table.capacity)
    return args, (valid, datas, masks)


def ht_lookup_or_insert(table: DeviceHashTable, key_cols: Sequence[Column],
                        valid: torch.Tensor, path: str = "auto"):
    """Find-or-insert a batch of keys, updating ``table`` in place.

    Returns ``(table, slots, is_new, overflow)``:
      * ``slots`` int64[N]: slot per row (== capacity for invalid/overflow
        rows),
      * ``is_new`` bool[N]: True for the single winning row that inserted a
        previously-absent key,
      * ``overflow`` bool scalar tensor: some valid row failed to find/claim
        a slot.

    Kernel B3 on a CUDA tensor, no host sync; ``path`` picks its phased
    path ("phased": the windowed find with a bid on each absent row's first
    empty slot, then, in the last block, the settling of those slots and
    the claim rounds among the rows that lost one to another key), its
    cooperative grid path ("grid": the rounds over every row) or, by N, one
    of them ("auto"), all with the same result. The plain version on a CPU
    tensor."""
    dev = valid.device
    if dev.type == "cpu":
        return ht_lookup_or_insert_plain(table, key_cols, valid)
    if dev.type != "cuda":
        raise ValueError(f"ht_lookup_or_insert: unsupported device {dev}")
    args, keep = _launch_args(table, key_cols, valid)
    n = valid.shape[0]
    slots = torch.empty(n, dtype=torch.int64, device=dev)
    is_new = torch.empty(n, dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws, rows = _workspace(lib, dev, stream, n, table.capacity)
        err = lib.hash_probe_insert_launch(
            *args, slots.data_ptr(), is_new.data_ptr(), overflow.data_ptr(),
            ws.data_ptr(), rows, _PATHS[path], stream)
    del keep
    if err != 0:
        raise RuntimeError(f"hash_probe insert launch failed: cudaError "
                           f"{err}")
    ht_lookup_or_insert.launches += 1
    return table, slots, is_new, overflow


def ht_lookup(table: DeviceHashTable, key_cols: Sequence[Column],
              valid: torch.Tensor):
    """Read-only probe. Returns ``(slots, found)``; slots == capacity if
    absent. Kernel B3's find on a CUDA tensor, the plain version on a CPU
    tensor."""
    dev = valid.device
    if dev.type == "cpu":
        return ht_lookup_plain(table, key_cols, valid)
    if dev.type != "cuda":
        raise ValueError(f"ht_lookup: unsupported device {dev}")
    args, keep = _launch_args(table, key_cols, valid)
    n = valid.shape[0]
    slots = torch.empty(n, dtype=torch.int64, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_probe_find_launch(*args, slots.data_ptr(),
                                         found.data_ptr(), stream)
    del keep
    if err != 0:
        raise RuntimeError(f"hash_probe find launch failed: cudaError {err}")
    ht_lookup.launches += 1
    return slots, found


#: kernel launches since the last reset (launches only, not plain runs)
ht_lookup_or_insert.launches = 0
ht_lookup.launches = 0


def _identity(dtype: torch.dtype, op: str):
    if op == "add":
        # -0.0 leaves every float unchanged, -0.0 included
        return -0.0 if dtype.is_floating_point else 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def scatter_reduce(target: torch.Tensor, slots: torch.Tensor,
                   contrib: torch.Tensor, op: str) -> torch.Tensor:
    """Grouped reduction into per-slot state, in place:
    ``target[slot] ⊕= contrib``.

    Rows at the capacity sentinel are dropped: each is redirected to a slot
    of its own (row index mod capacity, so the card's atomics do not all
    contend for one slot) carrying the identity of ``op``. Duplicate slots
    combine exactly for integer lanes; a float64 sum on the card adds in an
    unspecified order."""
    if op not in ("add", "min", "max"):
        raise ValueError(op)
    cap = target.shape[0]
    keep = slots < cap
    spread = torch.arange(slots.shape[0], device=slots.device) % cap
    idx = torch.where(keep, slots, spread)
    src = torch.where(keep, contrib.to(target.dtype),
                      torch.full_like(target[:1], _identity(target.dtype, op)))
    if op == "add":
        return target.index_add_(0, idx, src)
    return target.scatter_reduce_(0, idx, src, reduce="a" + op,
                                  include_self=True)
