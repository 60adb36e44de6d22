"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. card and build — the card's name and power limit, then ``nvcc`` builds
     every kernel under ``risingwave_tpu_torch/csrc/`` (all in parallel);
  2. each kernel against its plain PyTorch version on the card, exactly
     (integer counts, boolean masks), and both timed, at the inputs listed in
     ``RANK_CASES`` and ``MATCH_CASES``;
  3. the NEXmark q7 core through the executor entry points (Project →
     HashAgg(max) → HashJoin(price = max)) at the benchmark's sizes, with
     the launch counts reset just before and read just after; the final
     output multiset must equal an independent numpy evaluation of q7;
  4. the NEXmark q5 core (Project → HashAgg(count(*))), checked against a
     numpy group-by count;
  5. the fused q7 epoch (on-device bids → Project → bucketed interval join
     → barrier flush) at the benchmark's full width: a warm-up epoch, timed
     epochs, then one epoch under ``torch.cuda.set_sync_debug_mode("error")``
     (its body must not sync the host); both emission surfaces drained each
     epoch, flags clear, net output equal to numpy q7 over the same bids;
  6. the fused q5 epoch at full width with the executor's barrier path,
     checked against a numpy group-by count;
  7. profiled runs (q7 and q5 executors, one fused q7 and one fused q5
     epoch): the device's busy share and top kernels; then one JSON line of
     every kernel: launches on its path's run, exact agreement, its time and
     its plain version's time on the inputs that run gave it, and its bound
     on an H100 (for B1 also its time and bound summed over every input of
     the q7 run, with each input's count of keyed rows);
  8. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import collections
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

CHUNK = 4096                 # rows per chunk (bench.py CHUNK)
Q7_WINDOW_US = 5_000         # bench.py Q7_WINDOW_US
Q5_WINDOW_US = 10_000_000    # bench.py WINDOW_US
EPOCHS = 5                   # the first is the warm-up epoch
CHUNKS_PER_EPOCH = 16
SEED = 42
# fused epochs at the bench's full width (bench.py:71-95)
FUSED_CHUNKS_PER_EPOCH = 256
Q7_BUCKETS = 1 << 15
Q7_LANES = 128
Q5_TABLE_CAPACITY = 1 << 21
FUSED_TIMED_EPOCHS = 3       # after one warm-up epoch
Q7_FUSED_SEED = 23           # bench.py measure_q7_fused
Q5_FUSED_SEED = 17           # bench.py measure_q5_fused
# (N, W, ident pattern) — each compared exactly with the plain version;
# N = 32768 is above what kernel B1 sorts in one block's shared memory;
# probe_256 and few_257 are chunks whose rows mostly have ident < 0
RANK_CASES = [(4096, 128, "clustered"), (4000, 128, "clustered"),
              (4096, 128, "distinct"), (4096, 128, "none"),
              (4096, 128, "one_hot_key"), (4096, 16, "clustered"),
              (4096, 128, "interleaved"), (4000, 128, "one_hot_key"),
              (1, 1, "clustered"), (4096, 129, "clustered"),
              (4096, 128, "wide"), (32768, 128, "clustered"),
              (4096, 128, "probe_256"), (4096, 129, "few_257")]
# (nb, W, pattern) — interval_match against its plain version, exactly
MATCH_CASES = [(Q7_BUCKETS, Q7_LANES, "random"), (1000, 128, "random"),
               (777, 100, "random"), (Q7_BUCKETS, Q7_LANES, "all_occupied"),
               (Q7_BUCKETS, Q7_LANES, "none_occupied"),
               (4096, 128, "high_words")]
# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def rank_inputs(n: int, w: int, pattern: str, seed: int, device):
    rng = np.random.default_rng(seed)
    if pattern == "clustered":      # hot keys, ~50 rows each, some -1
        ident = (np.arange(n) // 50).astype(np.int32)
        ident[rng.random(n) < 0.1] = -1
    elif pattern == "distinct":     # every row its own key
        ident = np.arange(n, dtype=np.int32)
    elif pattern == "none":
        ident = np.full(n, -1, np.int32)
    elif pattern == "one_hot_key":
        ident = np.zeros(n, np.int32)
    elif pattern == "interleaved":  # 64 keys in turn: no two rows adjacent
        ident = (np.arange(n) % 64).astype(np.int32)
    elif pattern == "wide":         # ~1,000 keys in random order, some -1
        ident = rng.integers(-1, 1000, n).astype(np.int32)
    elif pattern.startswith(("probe_", "few_")):
        # probe_k: a join probe chunk whose first k rows find one window,
        # the rest none; few_k: k rows at random, over 8 keys
        k = int(pattern.split("_")[1])
        ident = np.full(n, -1, np.int32)
        if pattern.startswith("probe_"):
            ident[:k] = 3
        else:
            ident[rng.choice(n, k, replace=False)] = rng.integers(0, 8, k)
    else:
        raise ValueError(pattern)
    matches = rng.random((n, w)) < 0.3
    return (torch.as_tensor(ident, device=device),
            torch.as_tensor(matches, device=device))


def check_rank_totals(device) -> int:
    """Exact agreement at every listed shape; returns the max |error|."""
    from risingwave_tpu_torch.ops.rank_totals import (
        rank_totals, rank_totals_plain,
    )
    worst = 0
    for k, (n, w, pattern) in enumerate(RANK_CASES):
        ident, matches = rank_inputs(n, w, pattern, k, device)
        r, t = rank_totals(ident, matches)
        r0, t0 = rank_totals_plain(ident, matches)
        torch.cuda.synchronize()
        err = max(int((r - r0).abs().max()), int((t - t0).abs().max()))
        if err:
            raise AssertionError(f"rank_totals differs from plain at "
                                 f"N={n} W={w} {pattern}")
        worst = max(worst, err)
        ms, _ = time_cuda(lambda: rank_totals(ident, matches))
        plain_ms, _ = time_cuda(lambda: rank_totals_plain(ident, matches),
                                iters=10 if n > CHUNK else 50)
        print(f"rank_totals N={n} W={w} {pattern}: max_abs_err={err} "
              f"kernel_ms={ms} bound_ms={rank_totals_bound(ident, matches)[0]}"
              f" plain_ms={plain_ms}")
        del r0, t0
    return worst


def b2_case_inputs(nb: int, w: int, pattern: str, seed: int, device):
    """Flush inputs of kernel B2: stored values, occupancy, and each
    bucket's old/new max and liveness."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 5, (nb, w)).astype(np.int64)
    old_max = rng.integers(0, 5, nb).astype(np.int64)
    new_max = rng.integers(0, 5, nb).astype(np.int64)
    occ = rng.random((nb, w)) < 0.7
    if pattern == "all_occupied":
        occ[:] = True
    elif pattern == "none_occupied":
        occ[:] = False
    elif pattern == "high_words":   # equal low words, high words differ
        vals += rng.integers(0, 2, (nb, w)).astype(np.int64) << 33
        old_max += rng.integers(0, 2, nb).astype(np.int64) << 33
        new_max += rng.integers(0, 2, nb).astype(np.int64) << 32
    elif pattern != "random":
        raise ValueError(pattern)
    arrays = (vals, occ, old_max, rng.random(nb) < 0.8, new_max,
              rng.random(nb) < 0.8)
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def mask_errors(got, want) -> int:
    """Cells where two (del, ins) mask pairs differ."""
    return sum(int((a != b).sum()) for a, b in zip(got, want))


def check_interval_match(device) -> int:
    """Exact agreement at every listed shape; returns the cells that
    differ (0)."""
    from risingwave_tpu_torch.ops.interval_join import (
        interval_match, interval_match_plain,
    )
    for k, (nb, w, pattern) in enumerate(MATCH_CASES):
        args = b2_case_inputs(nb, w, pattern, k, device)
        err = mask_errors(interval_match(*args), interval_match_plain(*args))
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"interval_match differs from plain at "
                                 f"nb={nb} W={w} {pattern}: {err} cells")
        ms, _ = time_cuda(lambda: interval_match(*args))
        plain_ms, _ = time_cuda(lambda: interval_match_plain(*args))
        print(f"interval_match nb={nb} W={w} {pattern}: cells_differing=0 "
              f"kernel_ms={ms} plain_ms={plain_ms} "
              f"bound_ms={interval_match_bound(nb, w)[0]}")
    return 0


def interval_match_bound(nb: int, w: int):
    """Least time on an H100: vals (8 B) and occ (1 B) per cell and 18 B
    per bucket read once, del and ins (1 B each) per cell written once; two
    compares per cell are far below any compute limit."""
    return (11 * nb * w + 18 * nb) / HBM_BYTES_PER_S * 1e3, "bytes"


def time_cuda(fn, iters: int = 50, warmup: int = 5, by_kernel=None):
    """Milliseconds per call after a warm-up: (device, wall). ``device`` is
    the summed self time of every kernel the calls ran, from the profiler's
    CUDA trace (the card's own work, free of Python launch cost); ``wall``
    is CUDA-event time around the loop, which a host-bound call inflates.
    ``device`` is None if the profiler recorded no kernel. A dict given as
    ``by_kernel`` receives each kernel's share, by name."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / 1e3 / iters
           for e in prof.key_averages()
           if getattr(e, "self_device_time_total", 0) > 0}
    if by_kernel is not None:
        by_kernel.update(per)
    return (sum(per.values()) if per else None), wall


def rank_totals_bound(ident: torch.Tensor, matches: torch.Tensor):
    """Least time on an H100 for these inputs: ident and matches read once,
    r and t written once, at the memory rate. The kernel's sort and
    segmented scan do O(N log N + N W) simple operations for every key
    pattern, far below any compute peak, so the bytes bound it. Returns
    (ms, "bytes", dense_ms), ``dense_ms`` being the TPU formulation's two
    dense [N,N]x[N,W] products at the int8 tensor-core peak."""
    n, w = matches.shape
    nbytes = n * ident.element_size() + n * w * matches.element_size() \
        + 2 * n * w * 4
    dense_ms = 4 * n * n * w / INT8_TC_OPS_PER_S * 1e3
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", dense_ms


# ---------------------------------------------------------------------------
# phases 3 and 4: the executor pipelines
# ---------------------------------------------------------------------------

def bid_chunks(n_chunks: int, device):
    from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=CHUNK), seed=SEED,
                           device=device)
    return [gen.next_bid_chunk() for _ in range(n_chunks)]


def scripted(chunks, chunks_per_epoch: int):
    from risingwave_tpu_torch.stream import Barrier
    msgs = [Barrier.new(1)]
    for i in range(0, len(chunks), chunks_per_epoch):
        msgs.extend(chunks[i:i + chunks_per_epoch])
        msgs.append(Barrier.new(len(msgs)))
    return msgs


def host_bids(chunks):
    """(auction, price, date_time) numpy columns of every visible row."""
    cols = []
    for idx in (0, 2, 5):
        cols.append(np.concatenate([c.columns[idx].data[c.vis].cpu().numpy()
                                    for c in chunks]))
    return cols


class Drain:
    """Output chunks copied to the host (one copy per chunk, as a
    materializing consumer takes them), reduced to a multiset at the end."""

    def __init__(self):
        self.parts = []

    def add(self, chunk) -> None:
        from risingwave_tpu_torch.common import OP_INSERT, OP_UPDATE_INSERT
        sign = torch.where((chunk.ops == OP_INSERT)
                           | (chunk.ops == OP_UPDATE_INSERT), 1, -1)
        null = torch.zeros_like(chunk.vis)
        for c in chunk.columns:
            null |= ~c.mask
        host = torch.stack(
            [chunk.vis.long(), (chunk.vis & null).long(), sign]
            + [c.data.long() for c in chunk.columns]).cpu().numpy()
        if host[1].any():
            raise AssertionError("a visible output row holds a NULL")
        vis = host[0].astype(bool)
        self.parts.append((host[3:, vis].T, host[2, vis]))

    def multiset(self) -> collections.Counter:
        if not self.parts:
            return collections.Counter()
        return counter_of(np.concatenate([r for r, _ in self.parts]),
                          np.concatenate([s for _, s in self.parts]))


async def drive(executor, n_barriers_warm: int):
    """Run ``executor`` to its end; returns (output multiset, seconds after
    the warm-up barrier)."""
    from risingwave_tpu_torch.common import StreamChunk
    from risingwave_tpu_torch.stream import Barrier
    out = Drain()
    seen = 0
    t0 = None
    async for m in executor.execute():
        if isinstance(m, StreamChunk):
            out.add(m)
        elif isinstance(m, Barrier):
            seen += 1
            if seen == n_barriers_warm:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out.multiset(), secs


def q7_pipeline(chunks, device):
    from risingwave_tpu_torch.common import INT64, TIMESTAMP
    from risingwave_tpu_torch.expr import Literal, agg, call, col
    from risingwave_tpu_torch.stream import (
        HashAggExecutor, HashJoinExecutor, MockSource, ProjectExecutor,
    )
    from risingwave_tpu_torch.connector import BID_SCHEMA

    window = call("tumble_start", col(5, TIMESTAMP),
                  Literal(Q7_WINDOW_US, INT64))
    probe = ProjectExecutor(
        MockSource(BID_SCHEMA, scripted(chunks, CHUNKS_PER_EPOCH)),
        [window, col(0, INT64), col(2, INT64)],
        names=("window_start", "auction", "price"))
    build_pre = ProjectExecutor(
        MockSource(BID_SCHEMA, scripted(chunks, CHUNKS_PER_EPOCH)),
        [window, col(2, INT64)], names=("window_start", "price"))
    build = HashAggExecutor(build_pre, [0], [agg("max", 1, INT64)],
                            table_capacity=1 << 16, out_capacity=CHUNK,
                            device=device)
    cond = call("equal", col(2, INT64), col(4, INT64))   # price = max
    return HashJoinExecutor(probe, build, [0], [0], condition=cond,
                            key_capacity=1 << 16, bucket_width=128,
                            out_capacity=CHUNK, device=device)


def run_q7_capturing(chunks, device):
    """Drive the q7 executor over ``chunks`` with every kernel-B1 input
    kept: (output multiset, seconds after the warm-up barrier, B1 launches
    in the run, [(ident, matches), ...] in call order). The launch count is
    reset just before the run and read just after."""
    from risingwave_tpu_torch.ops import join_state
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    captured = []

    def capturing(ident, matches):
        captured.append((ident.clone(), matches.clone()))
        return rt_mod.rank_totals(ident, matches)

    join_state.rank_totals = capturing
    try:
        q7 = q7_pipeline(chunks, device)
        rt_mod.rank_totals.launches = 0
        got, secs = asyncio.run(drive(q7, 2))
        launches = rt_mod.rank_totals.launches
    finally:
        join_state.rank_totals = rt_mod.rank_totals
    return got, secs, launches, captured


def keyed_rows(captured) -> list[int]:
    """Rows with ident >= 0 in each captured B1 input."""
    return [int((ident >= 0).sum()) for ident, _ in captured]


def q7_expected(chunks) -> collections.Counter:
    return q7_expected_cols(*host_bids(chunks))


def q7_expected_cols(auction, price, ts) -> collections.Counter:
    """q7 in numpy: per window, every bid whose price equals the window's
    max, as (window_start, auction, price, window_start, max) rows."""
    ws = ts // Q7_WINDOW_US * Q7_WINDOW_US
    uniq, inverse = np.unique(ws, return_inverse=True)
    win_max = np.full(len(uniq), np.iinfo(np.int64).min)
    np.maximum.at(win_max, inverse, price)
    hit = price == win_max[inverse]
    rows = np.stack([ws[hit], auction[hit], price[hit], ws[hit],
                     price[hit]], 1)
    return counter_of(rows, np.ones(len(rows), np.int64))


def counter_of(rows: np.ndarray, signs: np.ndarray) -> collections.Counter:
    """Signed rows reduced to a multiset; fails on a negative count."""
    if len(rows) == 0:
        return collections.Counter()
    keys, inverse = np.unique(rows, axis=0, return_inverse=True)
    counts = np.zeros(len(keys), np.int64)
    np.add.at(counts, inverse.reshape(-1), signs)
    if (counts < 0).any():
        raise AssertionError("output retracts a row it never emitted")
    return collections.Counter({tuple(int(x) for x in k): int(c)
                                for k, c in zip(keys, counts) if c})


def trace(pipeline, chunks, device) -> dict:
    """One run of ``pipeline(chunks, device)`` under the profiler's CUDA
    trace, summarized by ``trace_summary``."""
    from torch.profiler import ProfilerActivity, profile
    executor = pipeline(chunks, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asyncio.run(drive(executor, 1))
        wall = time.perf_counter() - t0
    return trace_summary(prof, wall, len(chunks) * CHUNK)


def trace_summary(prof, wall: float, rows_in: int) -> dict:
    """Wall seconds, summed device seconds, the device's busy share, the
    device operations run (kernels and copies) and the five with the most
    device time."""
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    rows = sorted(((e.self_device_time_total, e.key) for e in events),
                  reverse=True)
    busy = sum(us for us, _ in rows) / 1e6
    return {"rows_in": rows_in, "wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "device_ops": sum(e.count for e in events),
            "top": [[k[:60], us / 1e3] for us, k in rows[:5]]}


def q5_pipeline(chunks, device):
    from risingwave_tpu_torch.common import INT64, TIMESTAMP
    from risingwave_tpu_torch.expr import Literal, call, col, count_star
    from risingwave_tpu_torch.stream import (
        HashAggExecutor, MockSource, ProjectExecutor,
    )
    from risingwave_tpu_torch.connector import BID_SCHEMA

    proj = ProjectExecutor(
        MockSource(BID_SCHEMA, scripted(chunks, CHUNKS_PER_EPOCH)),
        [call("tumble_start", col(5, TIMESTAMP),
              Literal(Q5_WINDOW_US, INT64)), col(0, INT64)],
        names=("window_start", "auction"))
    return HashAggExecutor(proj, [0, 1], [count_star()],
                           table_capacity=1 << 21, out_capacity=CHUNK,
                           device=device)


def q5_expected(chunks) -> collections.Counter:
    auction, _, ts = host_bids(chunks)
    return q5_expected_cols(auction, ts)


def q5_expected_cols(auction, ts) -> collections.Counter:
    ws = ts // Q5_WINDOW_US * Q5_WINDOW_US
    keys, counts = np.unique(np.stack([ws, auction], 1), axis=0,
                             return_counts=True)
    return collections.Counter(
        (int(w), int(a), int(c)) for (w, a), c in zip(keys, counts))


# ---------------------------------------------------------------------------
# phases 5 and 6: the fused epochs
# ---------------------------------------------------------------------------

def fused_keys(seed: int, batch_no: int, device):
    from risingwave_tpu_torch.connector import threefry
    return threefry.fold_in(threefry.prng_key(seed, device), batch_no)


def epoch_bids(gen, start: int, key, k: int):
    """(auction, price, date_time) on the host: the bids an epoch body
    draws from ``start`` and ``key``."""
    from risingwave_tpu_torch.ops.fused_epoch import epoch_chunks
    ch = epoch_chunks(gen.chunk_fn(), gen.cfg.chunk_capacity, start, key, k)
    return [ch.columns[j].data.reshape(-1).cpu().numpy() for j in (0, 2, 5)]


class FusedQ7:
    """The fused q7 epoch (bench.py measure_q7_fused) on one card."""

    def __init__(self, device, n_buckets: int, lanes: int, chunk: int,
                 k: int):
        from risingwave_tpu_torch.common import INT64, TIMESTAMP, Field, Schema
        from risingwave_tpu_torch.connector import (
            DeviceBidGenerator, NexmarkConfig,
        )
        from risingwave_tpu_torch.expr import Literal, call, col
        from risingwave_tpu_torch.ops.fused_epoch import (
            fused_source_join_epoch,
        )
        from risingwave_tpu_torch.ops.interval_join import IntervalJoinCore
        exprs = [call("tumble_start", col(5, TIMESTAMP),
                      Literal(Q7_WINDOW_US, INT64)),
                 col(0, INT64), col(2, INT64)]
        schema = Schema((Field("window_start", TIMESTAMP),
                         Field("auction", INT64), Field("price", INT64)))
        self.core = IntervalJoinCore(schema, ts_col=0, val_col=2,
                                     window_us=Q7_WINDOW_US,
                                     n_buckets=n_buckets, lane_width=lanes,
                                     device=device)
        self.gen = DeviceBidGenerator(NexmarkConfig(chunk_capacity=chunk),
                                      device=device)
        self.epoch_fn = fused_source_join_epoch(self.gen.chunk_fn(), exprs,
                                                self.core, chunk)
        self.device, self.chunk, self.k = device, chunk, k
        self.state = self.core.init_state()
        self.start = 0
        self.batch_no = 0
        self.bids = []

    def epoch(self, drain: Drain, sync_check: bool = False) -> None:
        """One epoch and its drains: the probe-time matches and the flush.
        With ``sync_check`` the epoch body runs with synchronizing CUDA
        calls made errors."""
        from risingwave_tpu_torch.common import (
            flatten_shards, gather_units_window,
        )
        key = fused_keys(Q7_FUSED_SEED, self.batch_no, self.device)
        self.bids.append((self.start, key))
        if sync_check:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            (self.state, probe_out, del_m, ins_m, old,
             packed) = self.epoch_fn(self.state, self.start, key, self.k)
        finally:
            if sync_check:
                torch.cuda.set_sync_debug_mode("default")
        self.start += self.k * self.chunk
        self.batch_no += 1
        n_flush, ovf, clobber, sawdel, n_probe = packed.tolist()
        if ovf or clobber or sawdel:
            raise AssertionError(f"fused q7 flags: lane_overflow={ovf} "
                                 f"ring_clobber={clobber} saw_delete={sawdel}")
        flat = flatten_shards(probe_out)
        for lo in range(0, n_probe, self.chunk // 2):
            drain.add(gather_units_window(flat, lo, self.chunk))
        for lo in range(0, n_flush, self.chunk):
            drain.add(self.core.gather_flush(self.state, del_m, ins_m, old,
                                             lo, self.chunk))

    def expected(self) -> collections.Counter:
        cols = [epoch_bids(self.gen, start, key, self.k)
                for start, key in self.bids]
        return q7_expected_cols(*(np.concatenate(c) for c in zip(*cols)))


class FusedQ5:
    """The fused q5 epoch with the executor's barrier path (bench.py
    measure_q5_fused) on one card."""

    def __init__(self, device, table_capacity: int, chunk: int, k: int):
        from risingwave_tpu_torch.common import INT64, TIMESTAMP
        from risingwave_tpu_torch.connector import (
            DeviceBidGenerator, NexmarkConfig,
        )
        from risingwave_tpu_torch.expr import Literal, call, col, count_star
        from risingwave_tpu_torch.ops.fused_epoch import (
            fused_source_agg_epoch,
        )
        from risingwave_tpu_torch.ops.grouped_agg import AggCore
        exprs = [call("tumble_start", col(5, TIMESTAMP),
                      Literal(Q5_WINDOW_US, INT64)), col(0, INT64)]
        self.core = AggCore((TIMESTAMP, INT64), (0, 1), [count_star()],
                            table_capacity, chunk, device)
        self.gen = DeviceBidGenerator(NexmarkConfig(chunk_capacity=chunk),
                                      device=device)
        self.epoch_fn = fused_source_agg_epoch(self.gen.chunk_fn(), exprs,
                                               self.core, chunk)
        self.device, self.chunk, self.k = device, chunk, k
        self.state = self.core.init_state()
        self.start = 0
        self.batch_no = 0
        self.bids = []

    def epoch(self, drain: Drain) -> None:
        key = fused_keys(Q5_FUSED_SEED, self.batch_no, self.device)
        self.bids.append((self.start, key))
        self.state = self.epoch_fn(self.state, self.start, key, self.k)
        self.start += self.k * self.chunk
        self.batch_no += 1
        rank = self.core.flush_rank(self.state)
        n_dirty, overflow = torch.stack(
            [rank[-1], self.state.overflow.long()]).tolist()
        if overflow:
            raise AssertionError("fused q5: group table overflow")
        for lo in range(0, n_dirty, self.core.groups_per_chunk):
            drain.add(self.core.gather_flush_chunk(self.state, rank, lo))
        self.core.finish_flush(self.state)

    def expected(self) -> collections.Counter:
        cols = [epoch_bids(self.gen, start, key, self.k)
                for start, key in self.bids]
        auction, _, ts = (np.concatenate(c) for c in zip(*cols))
        return q5_expected_cols(auction, ts)


def run_fused(runner, timed_epochs: int):
    """A warm-up epoch, then ``timed_epochs`` epochs on the host clock
    (drains to the host included). Returns (the drain, timed source rows
    per second)."""
    drain = Drain()
    runner.epoch(drain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed_epochs):
        runner.epoch(drain)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return drain, timed_epochs * runner.k * runner.chunk / secs


def trace_fused(runner) -> dict:
    """One more epoch of ``runner`` (drains included) under the profiler's
    CUDA trace: as ``trace``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.epoch(Drain())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return trace_summary(prof, wall, runner.k * runner.chunk)


def kernel_times(kernel, plain, args):
    """(ms, plain_ms, call_ms, plain_call_ms, timing) of a kernel and its
    plain version on ``args``: device times from the profiler, or CUDA
    event times where the profiler recorded no kernel."""
    ms, call_ms = time_cuda(lambda: kernel(*args))
    plain_ms, plain_call_ms = time_cuda(lambda: plain(*args))
    if ms is None or plain_ms is None:
        return call_ms, plain_call_ms, call_ms, plain_call_ms, "events"
    return ms, plain_ms, call_ms, plain_call_ms, "profiler"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.ops import interval_join
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    im_fn = interval_join.interval_match
    device = "cuda"

    # -- phase 1: card and build
    card = card_line()
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}")
    print(f"build_s={build_s:.3f}")

    # -- phase 2: kernels against their plain versions
    max_err = check_rank_totals(device)
    match_err = check_interval_match(device)

    # -- phase 3: q7 core; capture the kernel's busiest real input
    n_chunks = EPOCHS * CHUNKS_PER_EPOCH
    chunks = bid_chunks(n_chunks, device)
    got, secs, q7_launches, captured = run_q7_capturing(chunks, device)
    want = q7_expected(chunks)
    if got != want:
        raise AssertionError(f"q7 output differs from numpy q7: "
                             f"{sum((got - want).values())} extra, "
                             f"{sum((want - got).values())} missing rows")
    timed_rows = (n_chunks - CHUNKS_PER_EPOCH) * CHUNK
    print(f"q7: rows_out={sum(got.values())} source_rows/s="
          f"{timed_rows / secs:.1f} rank_totals.launches={q7_launches}")
    if q7_launches <= 0:
        raise AssertionError("the q7 run never launched rank_totals")

    # -- phase 4: q5 core
    q5 = q5_pipeline(chunks, device)
    got5, secs5 = asyncio.run(drive(q5, 2))
    if got5 != q5_expected(chunks):
        raise AssertionError("q5 output differs from numpy group-by count")
    print(f"q5: groups={len(got5)} source_rows/s={timed_rows / secs5:.1f}")

    # -- phase 5: fused q7 at full width; then one more epoch, untimed,
    # whose body runs with synchronizing calls made errors and whose
    # flush input to B2 is kept
    fq7 = FusedQ7(device, Q7_BUCKETS, Q7_LANES, CHUNK,
                  FUSED_CHUNKS_PER_EPOCH)
    im_fn.launches = 0
    drain7, rate7 = run_fused(fq7, FUSED_TIMED_EPOCHS)
    match_input = []
    core_match_inputs = fq7.core.match_inputs

    def capturing(state):
        args = core_match_inputs(state)
        match_input[:] = [a.clone() for a in args]
        return args

    fq7.core.match_inputs = capturing
    try:
        fq7.epoch(drain7, sync_check=True)
    finally:
        del fq7.core.match_inputs
    q7f_launches = im_fn.launches
    got7 = drain7.multiset()
    want7 = fq7.expected()
    if got7 != want7:
        raise AssertionError(f"fused q7 output differs from numpy q7: "
                             f"{sum((got7 - want7).values())} extra, "
                             f"{sum((want7 - got7).values())} missing rows")
    print(f"q7_fused: epochs={fq7.batch_no} rows_out={sum(got7.values())} "
          f"source_rows/s={rate7:.1f} interval_match.launches="
          f"{q7f_launches} sync_free_epoch=ok")
    if q7f_launches <= 0:
        raise AssertionError("the fused q7 run never launched "
                             "interval_match")

    # -- phase 6: fused q5 at full width
    fq5 = FusedQ5(device, Q5_TABLE_CAPACITY, CHUNK, FUSED_CHUNKS_PER_EPOCH)
    drain5, rate5 = run_fused(fq5, FUSED_TIMED_EPOCHS)
    got5f = drain5.multiset()
    if got5f != fq5.expected():
        raise AssertionError("fused q5 output differs from numpy group-by "
                             "count")
    print(f"q5_fused: epochs={fq5.batch_no} groups={len(got5f)} "
          f"source_rows/s={rate5:.1f}")

    # -- phase 7: where the time goes (device busy share)
    head = chunks[:2 * CHUNKS_PER_EPOCH]
    print("q7_trace: " + json.dumps(trace(q7_pipeline, head, device)))
    print("q5_trace: " + json.dumps(trace(q5_pipeline, head, device)))
    print("q7_fused_trace: " + json.dumps(trace_fused(fq7)))
    print("q5_fused_trace: " + json.dumps(trace_fused(fq5)))

    # kernel times on the inputs their path gave them: B1 on the q7 run's
    # input with the most keyed rows, B2 on the fused q7 run's last flush
    ident, matches = max(captured, key=lambda im: int((im[0] >= 0).sum()))
    n, w = matches.shape
    for kern, plain in zip(rt_mod.rank_totals(ident, matches),
                           rt_mod.rank_totals_plain(ident, matches)):
        max_err = max(max_err, int((kern - plain).abs().max()))
    if max_err:
        raise AssertionError("rank_totals differs from plain on q7's input")
    ms, plain_ms, call_ms, plain_call_ms, timing = kernel_times(
        rt_mod.rank_totals, rt_mod.rank_totals_plain, (ident, matches))
    bound_ms, bound_by, dense_ms = rank_totals_bound(ident, matches)
    # B1 over every input of the q7 run, one call each: its device time on
    # the path, and the bound summed the same way
    path_ms, _ = time_cuda(
        lambda: [rt_mod.rank_totals(*im) for im in captured], iters=10)
    path_bound_ms = sum(rank_totals_bound(*im)[0] for im in captured)
    keyed = keyed_rows(captured)
    print(f"rank_totals q7 inputs: calls={len(captured)} "
          f"path_ms={path_ms} path_bound_ms={path_bound_ms} "
          f"keyed_rows={keyed}")
    match_err += mask_errors(im_fn(*match_input),
                             interval_join.interval_match_plain(*match_input))
    if match_err:
        raise AssertionError("interval_match differs from plain on the "
                             "fused q7 flush input")
    nb, lanes = match_input[0].shape
    m_ms, m_plain_ms, m_call_ms, m_plain_call_ms, m_timing = kernel_times(
        im_fn, interval_join.interval_match_plain, match_input)
    m_bound_ms, m_bound_by = interval_match_bound(nb, lanes)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "rank_totals", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/rank_totals.cu",
        "replaces": "risingwave_tpu/ops/pallas_rank.py:85",
        "tpu_counterpart": "risingwave_tpu/ops/pallas_rank.py::_kernel",
        "path": "q7 executor", "launches": q7_launches,
        "equal": max_err == 0, "max_abs_err": max_err, "shape": [n, w],
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "call_ms": call_ms, "plain_call_ms": plain_call_ms,
        "timing": timing,
        "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
        "bound_by": bound_by, "dense_formulation_bound_ms": dense_ms,
        "path_calls": len(captured), "path_ms": path_ms,
        "path_bound_ms": path_bound_ms, "library_ms": None}, {
        "name": "interval_match", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/interval_match.cu",
        "replaces": "risingwave_tpu/ops/interval_join.py:412",
        "tpu_counterpart":
            "risingwave_tpu/ops/interval_join.py::_match_kernel",
        "path": "fused q7", "launches": q7f_launches,
        "equal": match_err == 0, "max_abs_err": match_err,
        "shape": [nb, lanes],
        "ms": m_ms, "kernel_ms": m_ms, "plain_ms": m_plain_ms,
        "call_ms": m_call_ms, "plain_call_ms": m_plain_call_ms,
        "timing": m_timing,
        "bound_ms": m_bound_ms, "bound_us": m_bound_ms * 1e3,
        "bound_by": m_bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
