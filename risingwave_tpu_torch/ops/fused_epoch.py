"""Fused epochs: source generation → projection → stateful core, with the
whole epoch's source drawn in one call.

Counterpart of ``risingwave_tpu/ops/fused_epoch.py`` and its four surfaces:

* ``fused_source_agg_epoch`` — the q5 shape: source → project → AggCore.
* ``fused_source_join_epoch`` — the q7 shape: source → project → bucketed
  interval join (ops/interval_join.py), including the barrier flush, so a
  whole epoch — k chunks of ingest and probe plus the build-side update —
  is one call.
* ``fused_source_session_epoch`` — the q8 shape: source → project →
  session-gap windows (ops/session_window.py), including the watermark's
  close at the barrier.
* ``fused_source_q3_epoch`` — the TPC-H q3 shape: orders-table build,
  lineitem probe, revenue agg and top-n churn (ops/stream_q3.py).

The reference traces one ``lax.scan`` into one dispatch. PyTorch runs
eagerly, so here an epoch is one generator call for all k chunks (chunk i
drawn from ``fold_in(key, i)`` at event ``start + i * rows_per_chunk``, as
in the reference) followed by a Python loop of k chunk steps, each a short
run of kernel launches.

Host syncs: no epoch body reads anything back to the host (the hash probes
run in kernel B3, ``ops/hash_table.py``); the one sync per epoch is the
caller reading ``packed``.

``chunk_fn(start, key)`` must accept a batch — ``start`` int64[k] and
``key`` [k, 2] — and return [k, cap] columns
(``DeviceBidGenerator.chunk_fn`` and ``DeviceQ3Generator.chunk_fn`` do).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..common.chunk import Column, StreamChunk, map_tensors
from ..connector import threefry


def epoch_chunks(chunk_fn: Callable, rows_per_chunk: int, start, key,
                  k: int) -> StreamChunk:
    """The k chunks of one epoch, [k, cap] columns, from one batched source
    call: chunk i starts at event ``start + i * rows_per_chunk`` and draws
    from ``fold_in(key, i)``."""
    i = torch.arange(k, dtype=torch.int64, device=key.device)
    return chunk_fn(start + i * rows_per_chunk, threefry.fold_in(key, i))


def _project(chunk: StreamChunk, exprs) -> StreamChunk:
    return chunk.with_columns(tuple(e.eval(chunk) for e in exprs))


def agg_epoch_body(chunk_fn: Callable, exprs: Sequence, core,
                   rows_per_chunk: int) -> Callable:
    """Build ``epoch(state, start_event, key, k) -> state``: ``k``
    generated and projected chunks folded into ``core``
    (ops/grouped_agg.AggCore). ``chunk_fn``: a batched source (see the
    module docstring); ``exprs``: projection onto the agg input schema."""
    exprs = tuple(exprs)

    def epoch(state, start, key, k: int):
        batch = epoch_chunks(chunk_fn, rows_per_chunk, start, key, k)
        for i in range(k):
            ch = map_tensors(batch, lambda a: a[i])
            state = core.apply_chunk(state, _project(ch, exprs))
        return state

    return epoch


def join_epoch_body(chunk_fn: Callable, exprs: Sequence, core,
                    rows_per_chunk: int) -> Callable:
    """Build ``epoch(state, start_event, key, k)`` for the q7 join shape:
    generate, project and probe-insert ``k`` chunks into ``core``
    (ops/interval_join.IntervalJoinCore), then compute the barrier flush and
    advance the downstream-visible build rows.

    The epoch returns ``(state, probe_out, del_mask, ins_mask,
    old_emitted_max, packed)``:

    * ``probe_out``: [k, cap] StreamChunk of probe-time matches
      (``flatten_shards`` + ``gather_units_window`` drain it);
    * ``del_mask``/``ins_mask``/``old_emitted_max``: inputs of
      ``core.gather_flush``;
    * ``packed``: int64[5] = [n_flush_units, lane_overflow, ring_clobber,
      saw_delete, n_probe_units] — one host read per epoch covers every
      flag and both emission counts.
    """
    exprs = tuple(exprs)

    def epoch(state, start, key, k: int):
        batch = epoch_chunks(chunk_fn, rows_per_chunk, start, key, k)
        outs = []
        for i in range(k):
            ch = map_tensors(batch, lambda a: a[i])
            state, out = core.apply_chunk(state, _project(ch, exprs))
            outs.append(out)
        probe_out = StreamChunk(
            torch.stack([o.ops for o in outs]),
            torch.stack([o.vis for o in outs]),
            tuple(Column(torch.stack([o.columns[j].data for o in outs]),
                         torch.stack([o.columns[j].mask for o in outs]))
                  for j in range(len(outs[0].columns))))
        # finish_flush replaces emitted_max, so this stays the old max
        old_emitted_max = state.emitted_max
        del_mask, ins_mask, packed = core.flush_plan(state)
        state = core.finish_flush(state)
        packed = torch.cat([packed, probe_out.vis.sum().reshape(1)])
        return state, probe_out, del_mask, ins_mask, old_emitted_max, packed

    return epoch


def session_epoch_body(chunk_fn: Callable, exprs: Sequence, core,
                       rows_per_chunk: int) -> Callable:
    """Build ``epoch(state, start_event, key, k, watermark)`` for the q8
    session shape (ops/session_window.SessionWindowCore): ``k`` generated
    (and, given ``exprs``, projected) chunks sessionized, then the open
    sessions the ``watermark`` has passed close, the epoch's closed-session
    buffer is copied out for emission and the buffer clears.

    The epoch returns ``(state, snapshot, packed)``; ``packed`` = int64[5]:
    [n_closed, table_overflow, closed_overflow, saw_delete, out_of_order];
    ``core.gather_closed(snapshot, n_closed, lo, cap)`` packs the emission
    windows."""
    exprs = tuple(exprs)

    def epoch(state, start, key, k: int, watermark):
        batch = epoch_chunks(chunk_fn, rows_per_chunk, start, key, k)
        for i in range(k):
            ch = map_tensors(batch, lambda a: a[i])
            if exprs:
                ch = _project(ch, exprs)
            state = core.apply_chunk(state, ch)
        state, packed = core.flush_plan(state, watermark)
        snapshot = core.snapshot_closed(state)
        state = core.finish_flush(state)
        return state, snapshot, packed

    return epoch


def q3_epoch_body(chunk_fn: Callable, core, rows_per_chunk: int) -> Callable:
    """Build ``epoch(state, start_event, key, k)`` for the TPC-H q3 shape
    (ops/stream_q3.Q3Core): ``k`` order/lineitem event chunks build, probe
    and aggregate, then the top-``limit`` is recomputed and its churn
    emitted.

    The epoch returns ``(state, out_chunk, packed)``; ``out_chunk`` is the
    fixed [2·limit]-row delete/insert churn; ``packed`` = int64[4]:
    [n_out, orders_overflow, agg_overflow, saw_delete]."""

    def epoch(state, start, key, k: int):
        batch = epoch_chunks(chunk_fn, rows_per_chunk, start, key, k)
        for i in range(k):
            state = core.apply_chunk(state, map_tensors(batch,
                                                        lambda a: a[i]))
        return core.flush(state)

    return epoch


# the reference jits and profiles its bodies; eagerly, a body is the epoch
# function itself
fused_source_agg_epoch = agg_epoch_body
fused_source_join_epoch = join_epoch_body
fused_source_session_epoch = session_epoch_body
fused_source_q3_epoch = q3_epoch_body


#: epoch constructors by shape name
EPOCH_BUILDERS = {
    "source_agg": fused_source_agg_epoch,          # NEXmark q5
    "source_join": fused_source_join_epoch,        # NEXmark q7
    "source_session": fused_source_session_epoch,  # NEXmark q8
    "source_q3": fused_source_q3_epoch,            # TPC-H q3
}
