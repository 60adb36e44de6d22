"""Carry state across from the JAX package.

Turns the reference's ``StreamChunk``, ``DeviceHashTable``, ``AggState``,
``JoinState``, ``IntervalJoinState``, ``SessionWindowState``, ``Q3State``,
``RowSetState``, ``TopNState``, ``SimpleAggState``, the AppendOnlyDedup
table and PRNG keys into this package's tensors on a given device, and the
host-tier states of the OverWindow executors (per-partition caches and EOWC
accumulators) and a Backfill's progress into this package's classes.
Chunks and states carry columns of every scalar kind as their physical
values (DECIMAL its scaled int64, DATE its int32 days). Store snapshots
need no converter: the row encodings are byte for byte the reference's,
so ``MemoryStateStore.restore`` takes the reference's ``snapshot()``, a
Backfill's progress table with it. The reference
objects arrive as nested numpy arrays under the JAX field names: either the
flax dataclasses with numpy leaves (``jax.tree_util.tree_map(np.asarray,
state)``) or plain mappings. Nothing of JAX is imported here. The agg and
join states carry their checkpoint marks and LRU stamps across too. Host
states hold physical values, so a VARCHAR id in them is the reference's
dictionary's: a caller carrying strings re-interns them. ``reintern`` and
``physical_row_from_jax`` do that for one value or row, and
``chunk_from_jax`` for a chunk given its schema: VARCHAR, BYTEA and JSONB
ids by their text, LIST and STRUCT ids by their content (nested structs
field by field), through the reference's dictionaries passed in. The HLL
lanes of an agg state are plain int64 lanes and carry across as they are.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Optional, Sequence

import numpy as np
import torch

from . import DEFAULT_DEVICE
from .common.chunk import Column, StreamChunk
from .common.types import GLOBAL_STRING_DICT, DataType, Schema
from .ops.grouped_agg import AggState
from .ops.hash_table import DeviceHashTable
from .ops.interval_join import IntervalJoinState, state_from_host
from .ops.join_state import JoinSideState, JoinState
from .ops.row_set import RowSetState
from .ops import session_window, stream_q3
from .stream.over_window import _Partition
from .stream.simple_agg import SimpleAggState
from .stream.top_n import TopNState


def _get(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensor(a: Any, device) -> torch.Tensor:
    return torch.tensor(np.array(a), device=device)


def _content(v: Any, t: DataType) -> Any:
    """A python value of type ``t`` as this package interns it: a struct
    (or a nested one) as a tuple of its fields' values, a list as a
    tuple of elements."""
    if v is None:
        return None
    if t.is_struct:
        return tuple(_content(e, ft)
                     for e, (_, ft) in zip(v, t.struct_fields))
    if t.is_list:
        return tuple(_content(e, t.elem_type) for e in v)
    return v


def reintern(value: Any, t: DataType, strings: Any, lists: Any) -> Any:
    """A physical value of the reference's as this package's: a VARCHAR,
    BYTEA or JSONB id re-interned by its text (``strings``: the
    reference's string dictionary), a LIST or STRUCT id by its content
    (``lists``: its list dictionary); any other value as it is."""
    if value is None:
        return None
    if t.is_string:
        return GLOBAL_STRING_DICT.intern(strings.lookup(int(value)))
    if t.is_list or t.is_struct:
        return t.to_physical(_content(lists.lookup(int(value)), t))
    return value


def physical_row_from_jax(row: Sequence, types: Sequence[DataType],
                          strings: Any, lists: Any) -> tuple:
    """A host state's physical row (a MaterializedAgg multiset key, an
    OverWindow entry) with its dictionary ids re-interned."""
    return tuple(reintern(v, t, strings, lists) for v, t in zip(row, types))


def chunk_from_jax(chunk: Any, device=DEFAULT_DEVICE,
                   schema: Optional[Schema] = None, strings: Any = None,
                   lists: Any = None) -> StreamChunk:
    """The reference's chunk; with ``schema``, its dictionary-typed
    columns re-interned through the reference's ``strings`` and ``lists``
    dictionaries (``reintern``)."""
    cols = []
    for ci, c in enumerate(_get(chunk, "columns")):
        data = np.array(_get(c, "data"))
        mask = np.array(_get(c, "mask"))
        t = None if schema is None else schema[ci].type
        if t is not None and (t.is_string or t.is_list or t.is_struct):
            # NULL rows keep their 0 (an empty struct has no arity)
            uniq, inv = np.unique(data[mask], return_inverse=True)
            mapped = np.array([reintern(u, t, strings, lists)
                               for u in uniq.tolist()], data.dtype)
            data = np.zeros_like(data)
            data[mask] = mapped[inv.reshape(-1)]
        cols.append(Column(torch.tensor(data, device=device),
                           torch.tensor(mask, device=device)))
    return StreamChunk(
        _tensor(_get(chunk, "ops"), device), _tensor(_get(chunk, "vis"), device),
        tuple(cols))


def hash_table_from_jax(table: Any, device=DEFAULT_DEVICE) -> DeviceHashTable:
    return DeviceHashTable(
        key_data=tuple(_tensor(a, device) for a in _get(table, "key_data")),
        key_mask=tuple(_tensor(a, device) for a in _get(table, "key_mask")),
        occupied=_tensor(_get(table, "occupied"), device))


def agg_state_from_jax(state: Any, device=DEFAULT_DEVICE) -> AggState:
    return AggState(
        table=hash_table_from_jax(_get(state, "table"), device),
        lanes=[_tensor(a, device) for a in _get(state, "lanes")],
        prev_lanes=[_tensor(a, device) for a in _get(state, "prev_lanes")],
        dirty=_tensor(_get(state, "dirty"), device),
        ckpt_dirty=_tensor(_get(state, "ckpt_dirty"), device),
        overflow=_tensor(_get(state, "overflow"), device),
        last_used=_tensor(_get(state, "last_used"), device))


def _columns(cols: Any, device) -> tuple[Column, ...]:
    return tuple(Column(_tensor(_get(c, "data"), device),
                        _tensor(_get(c, "mask"), device)) for c in cols)


def row_set_state_from_jax(state: Any, device=DEFAULT_DEVICE) -> RowSetState:
    return RowSetState(
        table=hash_table_from_jax(_get(state, "table"), device),
        live=_tensor(_get(state, "live"), device),
        cols=_columns(_get(state, "cols"), device),
        emitted=_tensor(_get(state, "emitted"), device),
        emitted_cols=_columns(_get(state, "emitted_cols"), device),
        ckpt_dirty=_tensor(_get(state, "ckpt_dirty"), device),
        overflow=_tensor(_get(state, "overflow"), device),
        saw_delete=_tensor(_get(state, "saw_delete"), device))


def topn_state_from_jax(state: Any, device=DEFAULT_DEVICE) -> TopNState:
    """The reference's ``TopNState``; its int32 gids widen to int64."""
    return TopNState(
        rows=row_set_state_from_jax(_get(state, "rows"), device),
        group_table=hash_table_from_jax(_get(state, "group_table"), device),
        gid=_tensor(_get(state, "gid"), device).long(),
        cand=_tensor(_get(state, "cand"), device),
        t1=_tensor(_get(state, "t1"), device))


def dedup_state_from_jax(executor: Any, device=DEFAULT_DEVICE) -> dict:
    """An ``AppendOnlyDedupExecutor``'s device state (its ``table``,
    ``ckpt_dirty``, ``overflow`` and ``saw_delete``), by field name."""
    return {"table": hash_table_from_jax(_get(executor, "table"), device),
            **{f: _tensor(_get(executor, f), device)
               for f in ("ckpt_dirty", "overflow", "saw_delete")}}


def over_window_state_from_jax(executor: Any) -> dict:
    """An ``OverWindowExecutor``'s host state by field name: its partitions
    (``_parts``: sorted entries with per-position values, accumulators and
    dense ordinals, as this package's ``_Partition``), the pk index
    (``_pk_loc``) and the emitted output (``_out``), copied as they are."""
    parts = {}
    for key, p in _get(executor, "_parts").items():
        q = parts[key] = _Partition()
        q.entries, q.vals, q.accs, q.dense = (
            list(p.entries), list(p.vals), list(p.accs), list(p.dense))
    return {"_parts": parts, "_pk_loc": dict(_get(executor, "_pk_loc")),
            "_out": {k: dict(v) for k, v in _get(executor, "_out").items()}}


def eowc_state_from_jax(executor: Any) -> dict:
    """An ``EowcOverWindowExecutor``'s host state by field name: the
    per-partition accumulators (``_accs``), the open peer groups
    (``_pending``) and the watermark (``_wm``), copied as they are."""
    return {"_accs": {k: {**st, "accs": list(st["accs"])}
                      for k, st in _get(executor, "_accs").items()},
            "_pending": {k: list(rows)
                         for k, rows in _get(executor, "_pending").items()},
            "_wm": _get(executor, "_wm")}


def simple_agg_state_from_jax(state: Any,
                              device=DEFAULT_DEVICE) -> SimpleAggState:
    return SimpleAggState(
        lanes=[_tensor(a, device) for a in _get(state, "lanes")],
        prev_lanes=[_tensor(a, device) for a in _get(state, "prev_lanes")],
        dirty=_tensor(_get(state, "dirty"), device),
        ever_emitted=_tensor(_get(state, "ever_emitted"), device))


def join_side_from_jax(side: Any, device=DEFAULT_DEVICE) -> JoinSideState:
    return JoinSideState(
        ht=hash_table_from_jax(_get(side, "ht"), device),
        row_data=tuple(_tensor(a, device) for a in _get(side, "row_data")),
        row_mask=tuple(_tensor(a, device) for a in _get(side, "row_mask")),
        occupied=_tensor(_get(side, "occupied"), device),
        tomb=_tensor(_get(side, "tomb"), device),
        degree=_tensor(_get(side, "degree"), device),
        ckpt_dirty=_tensor(_get(side, "ckpt_dirty"), device),
        lru=_tensor(_get(side, "lru"), device),
        ht_overflow=_tensor(_get(side, "ht_overflow"), device),
        lane_overflow=_tensor(_get(side, "lane_overflow"), device),
        inconsistent=_tensor(_get(side, "inconsistent"), device))


def join_state_from_jax(state: Any, device=DEFAULT_DEVICE) -> JoinState:
    return JoinState(left=join_side_from_jax(_get(state, "left"), device),
                     right=join_side_from_jax(_get(state, "right"), device))


def interval_join_state_from_jax(state: Any,
                                 device=DEFAULT_DEVICE) -> IntervalJoinState:
    return state_from_host(state, device)


def session_state_from_jax(state: Any, device=DEFAULT_DEVICE
                           ) -> session_window.SessionWindowState:
    """The reference's ``SessionWindowState`` with numpy leaves, or its
    ``export_host`` payload."""
    return session_window.state_from_host(state, device)


def q3_state_from_jax(state: Any, device=DEFAULT_DEVICE) -> stream_q3.Q3State:
    """The reference's ``Q3State`` with numpy leaves, or its
    ``export_host`` payload."""
    return stream_q3.state_from_host(state, device)


def prng_key_from_jax(key_data: Any, device=DEFAULT_DEVICE) -> torch.Tensor:
    """A reference key's two uint32 words (``jax.random.key_data(key)`` as
    numpy) as this package's Threefry key (``connector/threefry.py``)."""
    words = np.asarray(key_data)
    if words.dtype != np.uint32 or words.shape[-1:] != (2,):
        raise ValueError(f"want uint32[..., 2] key data, got {words.dtype}"
                         f"{list(words.shape)}")
    return torch.tensor(words.astype(np.int64), device=device)


def backfill_progress_from_jax(executor: Any) -> dict:
    """A reference BackfillExecutor's progress, as the attributes of this
    package's (``cursor``, ``cursor_row``, ``done``, ``rows_done``): its
    encoded cursor and the cursor's physical pk values (a VARCHAR one the
    reference's id)."""
    row = executor.cursor_row
    return {"cursor": executor.cursor,
            "cursor_row": None if row is None else tuple(
                v.item() if hasattr(v, "item") else v for v in row),
            "done": bool(executor.done),
            "rows_done": int(executor.rows_done)}
