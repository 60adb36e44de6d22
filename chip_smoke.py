"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

  1. card and build — the card's name and power limit, then ``nvcc`` builds
     every kernel under ``risingwave_tpu_torch/csrc/`` (all in parallel);
  2. each kernel against its plain PyTorch version on the card, exactly
     (integer counts, boolean masks, hash-table slots), and both timed
     with a cold L2 (``time_cuda``; a kernel that reads under its bound
     fails the run; L2 is evicted and left clean before every timed
     call), at the inputs listed in ``RANK_CASES``,
     ``MATCH_CASES`` and ``HASH_CASES`` (kernel B3's find-or-insert on
     both of its paths, the float64 inputs also against the plain version
     on CPU copies; the card's float64 → float32 cast of six NaN patterns
     beside the CPU's);
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
     checked against a numpy group-by count, and one epoch under the sync
     check;
  7. the fused q8 epoch (bidder session windows, 0.5 s gap) at the
     benchmark's shape: closed sessions equal to a numpy sessionization of
     the same bids, flags clear, one epoch under the sync check;
  8. the fused TPC-H q3 epoch at the benchmark's shape: after every epoch
     the top 10 rebuilt from the emitted deletes and inserts equals numpy q3
     over every event so far, flags clear; a second run takes one epoch
     under the sync check;
  9. the q5 executor as bench.py drives it: per epoch one ChunkBatch of 256
     chunks from the device generator through Project → HashAgg(count(*))
     (1<<21 groups), one warm-up and three timed epochs, then one epoch
     whose batched ingest runs under the sync check; the net output equal
     to numpy's group-by count; source rows/s and the device's busy share;
 10. the same over a StateTable on a MemoryStateStore, every barrier a
     checkpoint, a watermark before the checkpoint of epoch 2 (state
     cleaning, then compaction of the 1<<21 table through kernel B3), the
     executor dropped after epoch 2 of 4 and recovered from the store: the
     net output equal to an uninterrupted run's and numpy's, the stored
     rows equal to numpy's groups at or above the watermark; the native row
     codec required; checkpoint ms, compaction ms, recovery seconds and
     kernel B3's launches in the recovery and the compaction;
 11. the q7 executor as bench.py drives it (two generators of one seed,
     batched on both inputs, bench.py's 64 + 256 + 256 chunks), checked
     against numpy q7;
 12. the same with state tables on the agg and both join sides, dropped
     after epoch 2 of 3 and recovered (the join replays both sides through
     kernels B1 and B3): the net output equal to numpy's and the
     uninterrupted run's;
 13. NEXmark q105 from the host generator (seed 42, one auction chunk per
     bid chunk, one warm-up and three timed epochs of 16 chunks per
     source): both sources → RowIdGen → Project → HashJoin (1<<16 keys ×
     bucket width 2048, which must not grow) → Project → HashAgg(count,
     1<<19) → Project → TopN(limit 1000, 1<<19) → Materialize; the MV
     equal to numpy's top 1000 under (count desc, id asc, item_name asc by
     string); kernel B1's busiest input (the most keyed rows) kept,
     checked against the plain version and timed with the kernels, and
     kernel B3's busiest
     input at the agg's group table and at the TopN's row set (the call
     with the most valid rows, the latest of equals); the join arena's
     bytes, the TopN's fast flushes and refills;
 14. NEXmark q102 over the same chunks: the q105 join and agg →
     DynamicFilter(>=, 1<<19) whose bound is bids → MaterializedAgg(count(*),
     count(DISTINCT auction)) → Project(divide); the MV equal to numpy's
     groups whose count is at least floor(bids / distinct auctions); B3's
     busiest input at the DynamicFilter's row set kept;
 15. NEXmark q18: bids → RowIdGen → Project → GroupTopN((bidder, auction),
     date_time desc, limit 1, WITH TIES, row and group tables 1<<19) →
     Project → Materialize, the MV equal to numpy's latest bids per group;
     one more epoch whose batched ingest (RowIdGen, Project, GroupTopN)
     runs under the sync check; then the four epochs over a StateTable,
     every barrier a checkpoint, dropped after epoch 2 and recovered
     through kernel B3, the bids' row ids resuming above the first half's:
     the MV equal to the uninterrupted run's; checkpoint ms and recovery
     seconds; B3's busiest inputs at the GroupTopN's row set and group
     table kept;
 16. NEXmark q5 as its SQL reads, over HOP(date_time, 2 s, 10 s), in bench
     form: two device generators of one seed, one per branch, each epoch
     one ChunkBatch of 256 chunks per source; left RowIdGen → HopWindow →
     Project → HashAgg(count(*), 1<<21), right the same → Project →
     MaterializedAgg(max) (host tier) → Project, joined on (starttime,
     num) (1<<15 keys × bucket width 4096, kernels B1 and B3) → Project →
     Materialize; a warm-up, three timed epochs and one whose ingest
     (RowIdGen, HopWindow, Project, the count aggs) runs under the sync
     check; the MV equal to numpy's q5, flags clear, no table grown; the
     rows into the MaterializedAgg per epoch, the table loads; kernel B3's
     busiest input at each count agg and B1's at the join kept;
 17. the EOWC running window (sum(price) and row_number() per auction by
     date_time, EMIT ON WINDOW CLOSE) over the host bids of phases 13-14
     with WATERMARK FOR date_time AS date_time - 4 s: RowIdGen →
     WatermarkFilter → Sort (the device row set, 1<<18, B3) →
     EowcOverWindow → Project → Materialize; the MV equal to numpy's over
     the rows below the final watermark; then over state tables, every
     barrier a checkpoint, dropped after epoch 2 and recovered: the same
     MV; the Sort's high-water mark of held rows, checkpoint ms, recovery
     seconds; B3's busiest input at the Sort's row set kept;
 18. NEXmark q13 over the same bids: a 10,000-row side table loaded
     through Values → Materialize, then RowIdGen → Project(auction %
     10000) → TemporalJoin → Project → Materialize; the MV equal to numpy's
     lookup;
 19. bids → AppendOnlyDedup(auction, bidder) (1<<21 slots, B3) →
     Materialize in bench form, the MV equal to numpy's first bid per
     pair; one chunk with duplicate keys through B3 on both of its paths
     (``is_new`` on each new key's lowest row); a checkpoint, drop and
     recovery through B3 giving the same MV; B3's busiest input kept;
 20. Expand (two subsets), ProjectSet(generate_series(1, price % 4)),
     Union of two bid sources with watermarks (the minimum re-emitted),
     Values and Now, each equal to numpy's;
 21. TPC-H q3 and q10 as streaming MVs over tables (``stream/tpch_plans``):
     customer, orders, lineitem and nation generated from a seed by the
     TPC-H 3.0.1 rules (scale factor ``TPCH_SF``), loaded through DML into
     their table jobs in chunks of 4096 rows; q3 and q10 created over
     Backfill leaves and backfilled to their end, one after the other, at
     the reference's batch of 4 chunks per barrier; then TPC-H's refresh
     functions, one per epoch, every barrier a checkpoint (RF1 inserts SF
     x 1,500 orders with their lineitems, RF2 deletes as many); both MVs
     equal to a numpy evaluation of their SQL after the backfill, after
     the RF1s and after the RF2s (revenue as a scaled int64); load and
     backfill rows/s, each refresh's rows and staleness (DML push to the
     barrier after it completing on both MVs), checkpoint ms, the device
     busy share of one refresh epoch, B1 and B3 launches, peak device
     memory; B1's busiest join input and B3's busiest join-key and agg
     inputs kept;
 22. the rest of the NEXmark suite over phase 13's chunks (q0, q9, q10,
     q14-q17, q20-q22, q101, q103, q104, q106, the reference planner's
     trees at q105's capacities; q9's GroupTopN ``Q9_TOPN_CAPACITY``),
     each MV equal to a numpy and Python recomputation over the same rows
     (``ExtData``); source rows/s, rows out, B1 and B3 launches per query;
     B1's busiest input over q9 and q20 and B3's at q17's group table
     kept; then q17 as a multi-fragment job (bids as one ChunkBatch per
     epoch → RowIdGen → Project(to_char) → HashDispatcher over (auction,
     day) → HashAgg actors sharing one state table → Merge): rows/s at
     parallelism 1 and 4, each MV gated; one epoch of the
     dispatcher's split and the 4 actors' batched ingest under the sync
     check; then at parallelism 4 into a SinkExecutor over a jsonl
     FileSink, every barrier a checkpoint: ``sink.deliver`` fails for
     ``SINK_DEGRADE_AFTER`` epochs, the sink degrades and its log takes
     the changes, ``resume()``, the next epoch drains the log, the job is
     dropped there and recovered at parallelism 2 from the store, its last
     epoch delivered; the file's changelog must fold to numpy's q17 and
     hold exactly the rows logged (sink ms per barrier, recovery seconds);
     then q20's join as 4 actors (a quarter of the keys each), gated as
     above;
 23. over phase 13's bids (one warm-up and three timed epochs of 16
     chunks): (a) bids as one ChunkBatch per epoch → Project → HashAgg(GROUP
     BY auction: count(*), approx_count_distinct(bidder),
     approx_count_distinct(price); ``HLL_AGG_CAPACITY`` groups) →
     Materialize, and SimpleAgg(approx_count_distinct(bidder),
     approx_count_distinct(channel)): every group's 16 registers equal a
     numpy mirror of the reference's rule bit for bit, every estimate
     numpy's from them, one more epoch's batched ingest under the sync
     check (registers gated again); the estimates' median and maximum
     relative error against the exact distinct counts as records; (b) bids
     → MaterializedAgg(GROUP BY bidder: array_agg(auction), count(*)) →
     Project(bidder, array_length, the first element) → Materialize, equal
     to Python's sorted lists; (c) the bids rendered as JSON lines (auction,
     who {bidder, channel}, payload {price, channel, url, date_time}),
     parsed inside the timed window by ``parse_json_lines`` → Project(
     payload ->> 'channel', CAST(payload ->> 'price' AS BIGINT),
     (who).bidder) → HashAgg(GROUP BY channel: count(*), sum(price),
     approx_count_distinct(bidder)) → Materialize, equal to numpy's; each
     part's source rows/s and B3 launches; B3's busiest input at (a)'s
     group table kept;
 24. SQL end to end through the port's ``Session(device="cuda")``: (a)
     the NEXmark sources by tests/test_nexmark_queries.py's DDL, then
     q105, q105 without its TopN (every group of its join gated), q17, q18
     and q7 each created by ``CREATE MATERIALIZED VIEW`` in a Session of
     its own (chunks of 4096 rows, 16 per source leaf per
     tick, one warm-up and three timed ticks; phase 13's capacities, q7's
     join sized from the bids' prices; no join grows), each MV equal to
     numpy over phase 13's chunks (what a fresh generator per leaf, seed
     42, emits); in q17's Session a SELECT grouped by auction
     (BatchHashAgg, a group per auction of q17), a join
     of q17 with an MV over it (BatchHashJoin), an ORDER BY ... LIMIT and
     a window function (the stream fold), each equal to numpy; source
     rows/s per Session, each SELECT's ms, B1 and B3 launches per MV, peak
     device memory; (b) tests/test_tpch.py's tables loaded from phase
     21's generator at SF ``SQL_TPCH_SF`` by multi-row INSERT statements,
     q3 and q10 created by SQL and backfilled, then an RF1 by INSERT, an
     RF2 by DELETE ... IN (...) and an UPDATE of a customer's segment,
     both MVs equal to numpy after each; load rows/s and staleness per
     refresh;
 25. each kernel and its plain version timed on the inputs its path gave
     it, as in phase 2 (B1 on q7's, q105's, q5_hop's, the TPC-H joins' and
     q9's or q20's busiest inputs and summed over every input of the q7
     run, with each input's count of keyed rows; B2 on the fused q7 run's
     last flush; B3 on the q5 compaction's input and on the thirteen inputs
     kept in phases 13-23, each also held against the plain version slot
     for slot on both of its paths); then profiled runs (q7 and q5
     executors, two epochs of q105,
     q18, the EOWC running window and q5 over HOP windows, one fused q7,
     q5, q8 and q3 epoch): the device's busy share and top kernels; then
     one JSON line of every kernel: launches on its paths' runs (B1's and
     B3's on each path's run), exact agreement, its time and its plain
     version's, and its bound on an H100;
 26. the last line: ``{"ok": true, "device": {...}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
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
# bench.py measure_q7's executor shape
Q7_AGG_CAPACITY = 1 << 16
Q7_KEY_CAPACITY = 1 << 16
Q7_BUCKET_WIDTH = 128
# its chunks per epoch: a warm-up epoch of 64, then 512 timed (bench.py
# measure_q7 with Q7_N_CHUNKS); a fourth epoch of 256 would take the 5 ms
# windows past the agg's 1<<16 groups
Q7_EPOCHS = [64, 256, 256]
FUSED_TIMED_EPOCHS = 3       # after one warm-up epoch
Q7_FUSED_SEED = 23           # bench.py measure_q7_fused
Q5_FUSED_SEED = 17           # bench.py measure_q5_fused
Q8_FUSED_SEED = 31           # bench.py measure_q8_fused
Q3_FUSED_SEED = 37           # bench.py measure_q3_fused
Q8_GAP_US = 500_000          # bench.py Q8_GAP_US
Q8_TABLE_CAP = 1 << 18       # bench.py Q8_TABLE_CAP
Q8_CLOSED_CAP = 1 << 17      # bench.py Q8_CLOSED_CAP
Q3_ORDERS_CAP = 1 << 17      # bench.py Q3_ORDERS_CAP
Q3_AGG_CAP = 1 << 17         # bench.py Q3_AGG_CAP
# q8 and q3: one warm-up epoch and two timed, the bench's 256 + 512 chunks
Q8_Q3_TIMED_EPOCHS = 2
# q105, q102 and q18 (host generator, one chunk per source per tick): one
# warm-up and three timed epochs of 16 chunks per source
NEX_EPOCHS = 4
NEX_CHUNKS_PER_EPOCH = 16
Q105_LIMIT = 1000
# the join holds every auction and bid: ~12,800 auction ids, the hottest
# with ~1,560 bids, so it never grows in the timed epochs
Q105_KEY_CAPACITY = 1 << 16
Q105_BUCKET_WIDTH = 2048
Q105_AGG_CAPACITY = 1 << 19      # ~205,000 (id, item_name) groups
Q105_TOPN_CAPACITY = 1 << 19
Q18_TABLE_CAPACITY = 1 << 19     # every bid is a row (5 epochs: 327,680)
# q5 over HOP windows (phase 16; slide and size: nexmark_plans.HOP_SLIDE,
# HOP_SIZE): the phase-9 device bids. Each count agg ends 5 epochs of 256
# chunks with ~1.28M (window, auction) groups in its 1<<21 table
# (Q5_TABLE_CAPACITY); the join holds ~13,400 (window_start, num) keys, the
# largest ~2,000 rows
Q5_HOP_CHUNKS_PER_EPOCH = 256
Q5_HOP_KEY_CAPACITY = 1 << 15
Q5_HOP_BUCKET_WIDTH = 4096
# the EOWC running window (phase 17; nexmark_plans.EOWC_DELAY, 4 s): the
# Sort holds the bids inside the delay (4 s at 10,000 bids/s) plus one
# epoch (65,536), twice over, rounded up to a power of two
EOWC_SORT_CAPACITY = 1 << 18
# the dedup's key table (phase 19: ~602,000 (auction, bidder) pairs in 4
# epochs of 256 chunks)
DEDUP_TABLE_CAPACITY = 1 << 21
# (N, W, ident pattern) — each compared exactly with the plain version;
# N = 32768 is above what kernel B1 sorts in one block's shared memory;
# probe_256 and few_257 are chunks whose rows mostly have ident < 0
RANK_CASES = [(4096, 128, "clustered"), (4000, 128, "clustered"),
              (4096, 128, "distinct"), (4096, 128, "none"),
              (4096, 128, "one_hot_key"), (4096, 16, "clustered"),
              (4096, 128, "interleaved"), (4000, 128, "one_hot_key"),
              (1, 1, "clustered"), (4096, 129, "clustered"),
              (4096, 128, "wide"), (32768, 128, "clustered"),
              (4096, 128, "probe_256"), (4096, 129, "few_257"),
              (4096, Q105_BUCKET_WIDTH, "q105")]
# (nb, W, pattern) — interval_match against its plain version, exactly
MATCH_CASES = [(Q7_BUCKETS, Q7_LANES, "random"), (1000, 128, "random"),
               (777, 100, "random"), (Q7_BUCKETS, Q7_LANES, "all_occupied"),
               (Q7_BUCKETS, Q7_LANES, "none_occupied"),
               (4096, 128, "high_words")]
# kernel B3 (the hash probe) against its plain version, slot for slot: each
# find-or-insert case on both of the kernel's paths (phased, cooperative
# grid), each find case once; see ``hash_case``
HASH_CASES = [("q5", "insert"), ("load_0.7", "insert"), ("one_key", "insert"),
              ("distinct_new", "insert"), ("null_10pct", "insert"),
              ("all_null", "insert"), ("int32_bool", "insert"),
              ("float_zero_nan", "insert"), ("overflow", "insert"),
              ("n_65536", "insert"), ("late_arrival", "insert"),
              ("all_absent_loaded", "insert"), ("nan_payloads", "insert"),
              ("find_hits_misses", "find"), ("find_full_table", "find")]
B3_PATHS = ("phased", "grid")
# calls over which B3's plain version is timed (20 before the TPC-H phase
# needed the time)
PLAIN_PROBE_ITERS = 5
# B3's kernels, as the profiler names them
B3_KERNELS = ("insert_phased_kernel", "find_window_kernel",
              "insert_grid_kernel")
# float64 NaN bit patterns and the float32 bits the CPU casts them to (sign,
# quiet bit, the top 22 mantissa bits)
NAN_PATTERNS = {0x7FF8000000000000: 0x7FC00000, 0xFFF8000000000000: 0xFFC00000,
                0x7FF0000000000001: 0x7FC00000, 0x7FF80000DEADBEEF: 0x7FC00006,
                0x7FF4000000000000: 0x7FE00000, 0x7FFFFFFFFFFFFFFF: 0x7FFFFFFF}
# H100 SXM published peaks (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
INT8_TC_OPS_PER_S = 1979e12
L2_FLUSH_BYTES = 128 << 20   # a copy or read this size evicts the 50 MB L2
LEAD_CYCLES = 1_000_000      # ~0.5 ms of spin: the host's lead on the card
CYCLES_PER_MS = 2_000_000    # the H100's SM clock is at most 1.98 GHz


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
    elif pattern == "q105":
        # q105's join at its width: 90% of rows on three hot keys whose
        # buckets hold ~1,500 rows, the rest on 200 keys of ~40 rows
        hot = rng.random(n) < 0.9
        ident = np.where(hot, rng.integers(0, 3, n),
                         rng.integers(3, 203, n)).astype(np.int32)
        fill = np.where(hot, 0.75, 0.02)[:, None]
        matches = rng.random((n, w)) < fill
        return (torch.as_tensor(ident, device=device),
                torch.as_tensor(matches, device=device))
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
        ms, _, timing = time_cuda(lambda: rank_totals(ident, matches))
        plain_ms, _, plain_timing = time_cuda(
            lambda: rank_totals_plain(ident, matches),
            iters=10 if n > CHUNK else 50)
        bound_ms = rank_totals_bound(ident, matches)[0]
        held_to_bound(f"rank_totals N={n} W={w} {pattern}", ms, bound_ms)
        print(f"rank_totals N={n} W={w} {pattern}: max_abs_err={err} "
              f"kernel_ms={ms} bound_ms={bound_ms} plain_ms={plain_ms} "
              f"timing={timing_label(timing, plain_timing)}")
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
        ms, _, timing = time_cuda(lambda: interval_match(*args))
        plain_ms, _, plain_timing = time_cuda(
            lambda: interval_match_plain(*args))
        bound_ms = interval_match_bound(nb, w)[0]
        held_to_bound(f"interval_match nb={nb} W={w} {pattern}", ms,
                      bound_ms)
        print(f"interval_match nb={nb} W={w} {pattern}: cells_differing=0 "
              f"kernel_ms={ms} plain_ms={plain_ms} bound_ms={bound_ms} "
              f"timing={timing_label(timing, plain_timing)}")
    return 0


def interval_match_bound(nb: int, w: int):
    """Least time on an H100: vals (8 B) and occ (1 B) per cell and 18 B
    per bucket read once, del and ins (1 B each) per cell written once; two
    compares per cell are far below any compute limit."""
    return (11 * nb * w + 18 * nb) / HBM_BYTES_PER_S * 1e3, "bytes"


def _key_cols(arrays, device):
    from risingwave_tpu_torch.common import Column
    return [Column(torch.as_tensor(d, device=device),
                   torch.as_tensor(m, device=device)) for d, m in arrays]


def keys_by_home(cap: int, per: int, rng) -> np.ndarray:
    """[cap, per] distinct int64 keys, ``per`` for each home slot of a
    one-column table of ``cap`` slots (``hash_columns`` on the CPU)."""
    from risingwave_tpu_torch.common import hash_columns
    pool = rng.choice(1 << 40, cap * per * 12, replace=False)
    home = (hash_columns(_key_cols([(pool, np.ones(len(pool), bool))],
                                   "cpu")) & (cap - 1)).numpy()
    order = np.argsort(home, kind="stable")
    first = np.searchsorted(home[order], np.arange(cap))
    if (np.bincount(home, minlength=cap) < per).any():
        raise AssertionError("too few keys for some home slot")
    return pool[order[first[:, None] + np.arange(per)]]


def hash_case(name: str, device, seed: int = 0):
    """(table, key columns, valid) of a ``HASH_CASES`` entry. Tables that
    start non-empty are filled through the plain find-or-insert, except the
    full table of ``find_full_table``, whose keys are laid out directly."""
    from risingwave_tpu_torch.common import BOOL, FLOAT64, INT32, INT64, \
        TIMESTAMP
    from risingwave_tpu_torch.ops.hash_table import (
        ht_lookup_or_insert_plain, ht_new,
    )
    rng = np.random.default_rng(seed)
    n = CHUNK
    ones = np.ones(n, bool)

    def table_with(types, cap, arrays):
        table = ht_new(types, cap, device)
        if arrays:
            cols = _key_cols(arrays, device)
            valid = torch.ones(len(arrays[0][0]), dtype=torch.bool,
                               device=device)
            ht_lookup_or_insert_plain(table, cols, valid)
        return table

    if name == "q5":
        # (window_start, auction) pairs of a q5 table in steady state: 90%
        # of a chunk's rows find their group, the rest insert ~100 new ones
        win = 1_600_000_000_000_000 + rng.integers(0, 40, 150_000) \
            * Q5_WINDOW_US
        auc = rng.integers(1_000, 60_000, 150_000)
        pool = np.unique(np.stack([win, auc], 1), axis=0)
        table = table_with((TIMESTAMP, INT64), Q5_TABLE_CAPACITY,
                           [(pool[:, 0], np.ones(len(pool), bool)),
                            (pool[:, 1], np.ones(len(pool), bool))])
        new = np.stack([win[:100], 100_000 + np.arange(100)], 1)
        pick = rng.random(n) < 0.9
        rows = np.where(pick[:, None], pool[rng.integers(0, len(pool), n)],
                        new[rng.integers(0, 100, n)])
        arrays = [(rows[:, 0], ones), (rows[:, 1], ones)]
        valid = ones
    elif name == "load_0.7":
        cap = 1 << 14
        keys = rng.choice(1 << 40, int(0.7 * cap), replace=False)
        table = table_with((INT64,), cap, [(keys, np.ones(len(keys), bool))])
        new = rng.choice(1 << 40, 1500, replace=False) + (1 << 41)
        arrays = [(np.where(rng.random(n) < 0.5, rng.choice(keys, n),
                            rng.choice(new, n)), ones)]
        valid = ones
    elif name == "one_key":
        table = table_with((INT64,), 1 << 12, None)
        arrays = [(np.full(n, 7), ones)]
        valid = ones
    elif name == "distinct_new":
        table = table_with((INT64,), 1 << 16, None)
        arrays = [(rng.permutation(n) * 1_000_003 - 5 * n, ones)]
        valid = ones
    elif name in ("null_10pct", "all_null"):
        table = table_with((INT64, INT64), 1 << 13, None)
        share = 0.9 if name == "null_10pct" else 0.0
        arrays = [(rng.integers(0, 500, n), rng.random(n) < share),
                  (rng.integers(0, 7, n), rng.random(n) < share)]
        valid = rng.random(n) < 0.9
    elif name == "int32_bool":
        table = table_with((INT32, BOOL), 1 << 12, None)
        arrays = [(rng.integers(-50, 50, n).astype(np.int32),
                   rng.random(n) < 0.9), (rng.random(n) < 0.5, ones)]
        valid = rng.random(n) < 0.85
    elif name == "float_zero_nan":
        table = table_with((FLOAT64,), 1 << 13, None)
        vals = np.round(rng.standard_normal(n) * 100, 1)
        vals[rng.random(n) < 0.2] = 0.0
        vals[rng.random(n) < 0.2] = -0.0
        vals[rng.choice(n, 20, replace=False)] = np.nan
        arrays = [(vals, rng.random(n) < 0.95)]
        valid = ones
    elif name == "overflow":
        # 56 free slots for 512 new keys: the rest cannot settle in 128
        keys = rng.choice(1 << 40, 200, replace=False)
        table = table_with((INT64,), 256, [(keys, np.ones(200, bool))])
        arrays = [((1 << 41) + rng.choice(1 << 30, 512, replace=False),
                   np.ones(512, bool))]
        valid = np.ones(512, bool)
    elif name == "n_65536":
        m = 1 << 16
        pairs = rng.integers(0, 30_000, (m, 2)) * np.array([1, 3])
        table = table_with((INT64, INT64), 1 << 17,
                           [(pairs[:10_000, 0], np.ones(10_000, bool)),
                            (pairs[:10_000, 1], np.ones(10_000, bool))])
        arrays = [(pairs[:, 0], np.ones(m, bool)),
                  (pairs[:, 1], rng.random(m) < 0.95)]
        valid = rng.random(m) < 0.95
    elif name == "late_arrival":
        # 1,024 runs of 2-5 occupied slots, each key at its home slot, with
        # an empty slot e after each run. Rows 0-2047 hold new keys homed at
        # a run's first or second slot: they pass the run and reach e in
        # round 1-5. Rows 2048-3071 hold new keys homed at e itself, so in
        # the reference they take e in round 0 from the smaller rows; the
        # last 1,024 rows repeat earlier rows' keys.
        cap = 1 << 14
        runs = 1024
        base = np.arange(runs) * (cap // runs)
        length = rng.integers(2, 6, runs)
        by_home = keys_by_home(cap, 6, rng)
        pre = np.concatenate([by_home[(base + t) % cap, 0][t < length]
                              for t in range(5)])
        pre_slots = np.concatenate([(base + t)[t < length] for t in range(5)])
        table = table_with((INT64,), cap, None)
        table.key_data[0][torch.as_tensor(pre_slots, device=device)] = \
            torch.as_tensor(pre, device=device)
        for t in (table.key_mask[0], table.occupied):
            t[torch.as_tensor(pre_slots, device=device)] = True
        keys = np.concatenate([by_home[base, 1], by_home[base + 1, 1],
                               by_home[base + length, 2]])
        keys = np.concatenate([keys, keys[rng.integers(0, len(keys),
                                                       n - len(keys))]])
        arrays = [(keys, ones)]
        valid = ones
    elif name == "all_absent_loaded":
        # every row a new distinct key, into a table at load 0.5
        cap = 1 << 14
        keys = rng.choice(1 << 40, cap // 2 + n, replace=False)
        table = table_with((INT64,), cap, [(keys[n:], np.ones(cap // 2,
                                                              bool))])
        arrays = [(keys[:n], ones)]
        valid = ones
    elif name == "nan_payloads":
        # the six NaN patterns of NAN_PATTERNS, four rows each, among
        # ordinary keys half of which the table holds
        vals = np.round(rng.standard_normal(2_000) * 100, 2)
        table = table_with((FLOAT64,), 1 << 13,
                           [(vals, np.ones(len(vals), bool))])
        rows = np.where(rng.random(n) < 0.5, rng.choice(vals, n),
                        np.round(rng.standard_normal(n) * 100, 2) + 0.001)
        nans = np.array(list(NAN_PATTERNS) * 4, np.uint64).view(np.float64)
        rows[rng.choice(n, len(nans), replace=False)] = nans
        arrays = [(rows, ones)]
        valid = ones
    elif name == "find_hits_misses":
        keys = rng.choice(1 << 40, (8_000, 2))
        table = table_with((INT64, INT64), 1 << 14,
                           [(keys[:, 0], np.ones(8_000, bool)),
                            (keys[:, 1], np.ones(8_000, bool))])
        probe = np.where((rng.random(n) < 0.5)[:, None],
                         keys[rng.integers(0, 8_000, n)],
                         rng.choice(1 << 40, (n, 2)) + (1 << 41))
        arrays = [(probe[:, 0], ones), (probe[:, 1], rng.random(n) < 0.95)]
        valid = rng.random(n) < 0.9
    elif name == "find_full_table":
        # every slot taken, keys placed directly: a miss probes 128 slots
        cap = 256
        table = table_with((INT64,), cap, None)
        keys = rng.choice(10_000, cap, replace=False)
        table.key_data[0].copy_(torch.as_tensor(keys, device=device))
        table.key_mask[0].fill_(True)
        table.occupied.fill_(True)
        arrays = [(rng.integers(0, 10_000, n), ones)]
        valid = ones
    else:
        raise ValueError(name)
    cols = _key_cols(arrays, device)
    return table, cols, torch.as_tensor(np.asarray(valid), device=device)


def table_errors(a, b) -> int:
    """Slots where two hash tables differ (float keys compared by bits)."""
    def bits(t):
        t = t.cpu()
        return t.view(torch.int64) if t.dtype == torch.float64 else t
    err = int((a.occupied.cpu() != b.occupied.cpu()).sum())
    for x, y in zip(a.key_data + a.key_mask, b.key_data + b.key_mask):
        err += int((bits(x) != bits(y)).sum())
    return err


def probe_lengths(table, cols, valid, slots, op: str) -> torch.Tensor:
    """Each row's probes in the reference's sequential order, from its home
    slot: a settled row's final offset + 1, an unsettled row's
    MAX_PROBE_ROUNDS, a find's up to its match or its empty slot, an invalid
    row's 0."""
    from risingwave_tpu_torch.common import hash_columns
    from risingwave_tpu_torch.ops.hash_table import (
        MAX_PROBE_ROUNDS, _keys_equal_at,
    )
    cap = table.capacity
    start = hash_columns(cols) & (cap - 1)
    if op == "find":
        done = ~valid
        lengths = torch.zeros_like(start)
        for off in range(MAX_PROBE_ROUNDS):
            cand = (start + off) & (cap - 1)
            occ = table.occupied[cand]
            lengths += (~done).long()
            done = done | ~occ | (occ & _keys_equal_at(
                table, cand, [c.data for c in cols], [c.mask for c in cols]))
        return lengths
    settled = valid & (slots < cap)
    return torch.where(settled, ((slots - start) & (cap - 1)) + 1,
                       torch.where(valid, MAX_PROBE_ROUNDS, 0))


def hash_probe_bound(table, cols, valid, slots, found_or_new, op: str):
    """Least time on an H100 for these inputs, from the plain version's
    result: per row ``valid`` read and ``slots`` (8 B) and the flag (1 B)
    written; per valid row its key words and masks read (an invalid row
    needs no key); per probe taken (``probe_lengths``) one ``occupied`` byte
    and each column's key word and mask read; per inserted key its words,
    masks and ``occupied`` written. The hash and the compares are far below
    any compute limit, so the bytes bound it."""
    key_bytes = sum(c.data.element_size() + 1 for c in cols)
    n = valid.shape[0]
    n_valid = int(valid.sum())
    probes = int(probe_lengths(table, cols, valid, slots, op).sum())
    inserted = int(found_or_new.sum()) if op == "insert" else 0
    nbytes = n * (1 + 8 + 1) + n_valid * key_bytes \
        + probes * (1 + key_bytes) + inserted * (key_bytes + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def hash_probe_floor(table, cols, valid, slots, found_or_new, op: str):
    """A sector-granular floor beside ``hash_probe_bound``, in ms at the
    H100's memory rate: the same per-row bytes (keys for valid rows only),
    but a row's probes (a run of ``probe_lengths`` consecutive slots from
    its home, wrapping at the capacity) move every 32-byte sector the run touches in ``occupied`` and
    in each key column's words and masks, and each inserted key moves one
    whole sector per array it writes and one for its claim word. It leaves
    out that the path waits on at least two dependent memory round trips."""
    from risingwave_tpu_torch.common import hash_columns
    cap = table.capacity
    n = valid.shape[0]
    start = hash_columns(cols) & (cap - 1)
    length = torch.clamp(probe_lengths(table, cols, valid, slots, op),
                         max=cap)
    first = torch.minimum(length, cap - start)

    def sectors(a, k, e):   # sectors of elements [a, a + k) of size e
        return torch.where(k > 0, ((a + k) * e - 1) // 32 - a * e // 32 + 1,
                           0)

    n_sectors = 0
    for e in [1] + [c.data.element_size() for c in cols] + [1] * len(cols):
        n_sectors += int((sectors(start, first, e)
                          + sectors(torch.zeros_like(start), length - first,
                                    e)).sum())
    key_bytes = sum(c.data.element_size() + 1 for c in cols)
    inserted = int(found_or_new.sum()) if op == "insert" else 0
    nbytes = n * (1 + 8 + 1) + int(valid.sum()) * key_bytes \
        + 32 * n_sectors \
        + 32 * inserted * (2 + 2 * len(cols))
    return nbytes / HBM_BYTES_PER_S * 1e3


def compare_hash_probe(table, cols, valid, op: str, path: str = "auto"):
    """Kernel B3 against its plain version on one input, each on its own
    copy of ``table``: ``(differences, plain result)``, the differences
    counted over slots, is_new or found, overflow and, for find-or-insert,
    the final table. With a float64 key the kernel is also held against the
    plain version on CPU copies of the inputs (the reference's float32
    casts, NaN bits included, are the CPU's)."""
    from risingwave_tpu_torch.common import Column
    from risingwave_tpu_torch.ops.hash_table import (
        ht_lookup, ht_lookup_or_insert, ht_lookup_or_insert_plain,
        ht_lookup_plain,
    )

    def plain(table, cols, valid):
        if op == "insert":
            return ht_lookup_or_insert_plain(table, cols, valid)
        return (table,) + ht_lookup_plain(table, cols, valid) \
            + (torch.zeros((), dtype=torch.bool),)

    def differences(got, want):
        (gt, *gr), (wt, *wr) = got, want
        err = sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(gr, wr))
        return err + (table_errors(gt, wt) if op == "insert" else 0)

    got_t = table.clone()
    if op == "insert":
        got = ht_lookup_or_insert(got_t, cols, valid, path=path)
    else:
        got = (got_t,) + ht_lookup(got_t, cols, valid) \
            + (torch.zeros((), dtype=torch.bool),)
    want = plain(table.clone(), cols, valid)
    err = differences(got, want)
    if any(c.data.dtype == torch.float64 for c in cols):
        on_cpu = plain(to_device(table, "cpu"),
                       [Column(c.data.cpu(), c.mask.cpu()) for c in cols],
                       valid.cpu())
        err += differences(got, on_cpu)
    return err, tuple(want[1:])


def to_device(table, device):
    """A copy of a hash table on ``device``."""
    from risingwave_tpu_torch.ops.hash_table import DeviceHashTable
    return DeviceHashTable(
        *(tuple(t.to(device, copy=True) for t in ts)
          for ts in (table.key_data, table.key_mask)),
        table.occupied.to(device, copy=True))


def nan_cast_bits(device) -> list:
    """The float32 bits of each NAN_PATTERNS float64 cast on ``device``."""
    bits = torch.tensor([b - (1 << 64) if b >= 1 << 63 else b
                         for b in NAN_PATTERNS], dtype=torch.int64)
    f = bits.view(torch.float64).to(device).to(torch.float32)
    return [b & 0xFFFFFFFF for b in f.view(torch.int32).cpu().tolist()]


def check_hash_probe(device, time_it: bool = True) -> dict:
    """Kernel B3 against its plain version on every ``HASH_CASES`` input,
    slot for slot, each find-or-insert case on both kernel paths. Returns
    the q5 input's timing (insert) and find_hits_misses' (find) for the
    kernels line."""
    from risingwave_tpu_torch.ops.hash_table import (
        ht_lookup, ht_lookup_or_insert, ht_lookup_or_insert_plain,
        ht_lookup_plain, last_claim_rounds,
    )
    card = nan_cast_bits(device)
    print(f"nan_cast: cpu={[hex(b) for b in NAN_PATTERNS.values()]} "
          f"card={[hex(b) for b in card]} "
          f"equal={card == list(NAN_PATTERNS.values())}")
    timings = {}
    for name, op in HASH_CASES:
        table, cols, valid = hash_case(name, device)
        for path in B3_PATHS if op == "insert" else ("auto",):
            err, (s0, f0, o0) = compare_hash_probe(table, cols, valid, op,
                                                   path)
            if err:
                raise AssertionError(f"hash_probe {op} differs from plain "
                                     f"on {name}, {path} path: {err} "
                                     f"differences")
        if op == "insert":
            def kernel(t):
                ht_lookup_or_insert(t, cols, valid)

            def plain(t):
                ht_lookup_or_insert_plain(t, cols, valid)
        else:
            def kernel(t):
                ht_lookup(t, cols, valid)

            def plain(t):
                ht_lookup_plain(t, cols, valid)
        bound_ms, bound_by = hash_probe_bound(table, cols, valid, s0, f0, op)
        floor_ms = hash_probe_floor(table, cols, valid, s0, f0, op)
        line = (f"hash_probe {op} {name}: N={valid.shape[0]} "
                f"cap={table.capacity} differences=0 "
                f"overflow={bool(o0)} hits_or_new={int(f0.sum())} "
                f"bound_ms={bound_ms} sector_floor_ms={floor_ms}")
        if time_it:
            ms, plain_ms, call_ms, timing = probe_times(kernel, plain,
                                                        table)
            held_to_bound(f"hash_probe {op} {name}", ms, bound_ms)
            # the claim rounds of the phased path's last (timed) call
            rounds = last_claim_rounds(device) \
                if op == "insert" and valid.shape[0] <= CHUNK else None
            line += (f" kernel_ms={ms} call_ms={call_ms} "
                     f"plain_ms={plain_ms} timing={timing} "
                     f"claim_rounds={rounds}")
            if name in ("q5", "find_hits_misses"):
                timings[op] = {"ms": ms, "plain_ms": plain_ms,
                               "call_ms": call_ms, "timing": timing,
                               "bound_ms": bound_ms,
                               "bound_by": bound_by, "floor_ms": floor_ms,
                               "claim_rounds": rounds, "case": name}
        print(line)
    return timings


def probe_times(kernel, plain, table):
    """(kernel ms, plain ms, kernel call ms, timing) per find-or-insert
    call, as ``time_cuda`` reads them: each call on its own copy of
    ``table``, made before the timed loops. The plain version, which syncs
    the host every round and takes 10-50 ms a call, is timed over
    ``PLAIN_PROBE_ITERS`` calls."""
    ms, call_ms, k_timing = time_cuda(kernel, iters=20,
                                      fresh=lambda: (table.clone(),))
    plain_ms, _, p_timing = time_cuda(plain, iters=PLAIN_PROBE_ITERS,
                                      warmup=1,
                                      fresh=lambda: (table.clone(),))
    return ms, plain_ms, call_ms, timing_label(k_timing, p_timing)


def timing_label(kernel: str, plain: str) -> str:
    """How a kernel's and its plain version's device times were read
    (``time_cuda``'s ``timing``): one label, or "kernel: ..., plain: ..."
    where they differ."""
    if kernel == plain:
        return kernel
    return f"kernel: {kernel}, plain: {plain}"


def l2_flush_buffers():
    """The two buffers of ``flush_l2``, made once per process."""
    if not _FLUSH:
        src = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        _FLUSH.extend((src, torch.empty_like(src),
                       torch.zeros(L2_FLUSH_BYTES // 2, dtype=torch.int16,
                                   device="cuda")))
    return _FLUSH


def flush_l2() -> None:
    """Evict the 50 MB L2 and leave it clean: a device copy of
    ``L2_FLUSH_BYTES`` evicts every line but leaves L2 full of dirty lines
    of its destination, whose write-back would land inside the next
    kernel's time; a read-only pass over another buffer of the same size
    (int16 row maxima, 128 KiB written: rows short enough that the
    reduction needs no cross-block semaphore, so no memset) then evicts
    those, so their write-back falls here."""
    src, dst, probe = l2_flush_buffers()
    dst.copy_(src)
    probe.view(1 << 16, -1).amax(dim=1)


def flush_kernel_counts(iters: int, flush=flush_l2) -> dict:
    """The kernels ``flush`` launches and how many of each per flush, by
    name, from a profiled loop of flushes alone (learned once per process
    and flush; no name is assumed)."""
    if flush not in _FLUSH_KERNELS:
        from torch.profiler import ProfilerActivity, profile
        l2_flush_buffers()
        flush()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush()
            torch.cuda.synchronize()
        names = {}
        for e in prof.key_averages():
            if getattr(e, "self_device_time_total", 0) > 0:
                if e.count % iters:
                    raise AssertionError(
                        f"a trace of {iters} L2 flushes held {e.count} "
                        f"launches of {e.key}")
                names[e.key] = e.count // iters
        if not names:
            raise AssertionError("a trace of L2 flushes held no kernel")
        print(f"l2 flush kernels ({flush.__name__}): " + json.dumps(names))
        _FLUSH_KERNELS[flush] = names
    return _FLUSH_KERNELS[flush]


_FLUSH: list = []            # flush_l2's buffers
_FLUSH_KERNELS: dict = {}    # flush -> {kernel name: launches per flush}


def time_cuda(fn, iters: int = 50, warmup: int = 5, by_kernel=None,
              fresh=None, flush=flush_l2):
    """Milliseconds per call, ``(device, wall, timing)``. A call is
    ``fn(*fresh())``: ``fresh`` makes each call's own arguments (a copy of
    a table the call changes), all of a loop's before that loop starts, so
    no copy is timed; without it ``fn()``.

    ``device`` is the card's own work per call with a cold, clean L2:
    ``flush_l2`` runs before every call, as the path's caller finds L2
    after a chunk's or an epoch's other work; then the summed self time of
    every kernel the calls ran, from the profiler's CUDA trace (``timing``
    "profiler"), leaving out the flush's own kernels by name
    (``flush_kernel_counts``). Where the trace lost kernels (none
    recorded, a kernel's count not a whole multiple of the calls, or a
    flush kernel's count other than the flushes', as when the call itself
    launches a kernel of that name), CUDA events recorded just before and
    after each call give it instead (``timing`` "events", with the counts
    the trace held); a spin after each flush, of ``LEAD_CYCLES`` or twice
    ``wall`` if longer, gives the host its lead, so the events bracket the
    call's device work and its launch latency (and the waits of a call
    that syncs inside). ``wall`` is CUDA-event time around a loop of
    back-to-back calls without flushes, which a host-bound call inflates.
    A dict given as ``by_kernel`` receives each kernel's share of
    ``device``, by name, from the profiler. ``flush`` replaces
    ``flush_l2`` where a script compares evictions."""
    from torch.profiler import ProfilerActivity, profile
    make = fresh or tuple
    flush_names = flush_kernel_counts(iters, flush)
    for _ in range(warmup):
        fn(*make())
    argv = [make() for _ in range(iters)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in argv:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters

    argv = [make() for _ in range(iters)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for args in argv:
            flush()
            fn(*args)
        torch.cuda.synchronize()
    per, counts, flushes_whole = {}, set(), True
    for e in prof.key_averages():
        if getattr(e, "self_device_time_total", 0) <= 0:
            continue
        if e.key in flush_names:
            flushes_whole &= e.count == flush_names[e.key] * iters
            continue
        per[e.key] = e.self_device_time_total / 1e3 / iters
        counts.add(e.count)
    if per and flushes_whole and all(c % iters == 0 for c in counts):
        if by_kernel is not None:
            by_kernel.update(per)
        return sum(per.values()), wall, "profiler"

    argv = [make() for _ in range(iters)]
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in argv]
    lead = max(LEAD_CYCLES, int(2 * wall * CYCLES_PER_MS))
    torch.cuda.synchronize()
    for args, (a, b) in zip(argv, marks):
        flush()
        torch.cuda._sleep(lead)
        a.record()
        fn(*args)
        b.record()
    torch.cuda.synchronize()
    return (sum(a.elapsed_time(b) for a, b in marks) / iters, wall,
            f"events (trace counts {sorted(counts)} of {iters} calls"
            f"{'' if flushes_whole else ', flush kernels not whole'})")


def held_to_bound(name: str, ms: float, bound_ms: float) -> None:
    """Fail when a kernel's device time reads under its bound: no call
    moves its bytes faster than the memory rate, so such a reading is a
    fault of the measurement."""
    if ms < bound_ms:
        raise AssertionError(f"{name}: {ms} ms reads under its bound of "
                             f"{bound_ms} ms")


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


async def drive(executor, n_barriers_warm: int, out=None):
    """Run ``executor`` to its end; returns (output multiset, seconds after
    the warm-up barrier). The output goes into the Drain ``out`` if one is
    given."""
    from risingwave_tpu_torch.common import StreamChunk
    from risingwave_tpu_torch.stream import Barrier
    out = Drain() if out is None else out
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


@contextlib.contextmanager
def captured_rank_inputs():
    """Every kernel-B1 input of the joins run inside the block, kept as
    (ident, matches) copies in call order in the list it yields."""
    from risingwave_tpu_torch.ops import join_state
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    captured = []

    def capturing(ident, matches):
        captured.append((ident.clone(), matches.clone()))
        return rt_mod.rank_totals(ident, matches)

    join_state.rank_totals = capturing
    try:
        yield captured
    finally:
        join_state.rank_totals = rt_mod.rank_totals


@contextlib.contextmanager
def busiest_rank_input():
    """Kernel B1's input with the most keyed rows (ident >= 0) among the
    joins run inside the block, kept on the card with ``torch.where`` (no
    host sync; the latest of equals). After the block the dict it yields
    holds ``input`` (ident, matches), ``keyed_rows`` and ``calls``."""
    from risingwave_tpu_torch.ops import join_state
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    best: dict = {}     # matches shape -> [keyed count, ident, matches]
    calls = [0]
    found: dict = {}

    def capturing(ident, matches):
        calls[0] += 1
        sig = tuple(matches.shape)
        count = (ident >= 0).sum()
        if sig not in best:
            best[sig] = [count, ident.clone(), matches.clone()]
        else:
            kept = best[sig]
            better = count >= kept[0]
            kept[0] = torch.where(better, count, kept[0])
            kept[1].copy_(torch.where(better, ident, kept[1]))
            kept[2].copy_(torch.where(better, matches, kept[2]))
        return rt_mod.rank_totals(ident, matches)

    join_state.rank_totals = capturing
    try:
        yield found
    finally:
        join_state.rank_totals = rt_mod.rank_totals
    if best:
        count, ident, matches = max(best.values(), key=lambda b: int(b[0]))
        found.update(input=(ident, matches), keyed_rows=int(count),
                     calls=calls[0])


def run_q7_capturing(chunks, device):
    """Drive the q7 executor over ``chunks`` with every kernel-B1 input
    kept: (output multiset, seconds after the warm-up barrier, B1 launches
    in the run, [(ident, matches), ...] in call order). The launch count is
    reset just before the run and read just after."""
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    with captured_rank_inputs() as captured:
        q7 = q7_pipeline(chunks, device)
        rt_mod.rank_totals.launches = 0
        got, secs = asyncio.run(drive(q7, 2))
        launches = rt_mod.rank_totals.launches
    return got, secs, launches, captured


def keyed_rows(captured) -> list[int]:
    """Rows with ident >= 0 in each captured B1 input."""
    return [int((ident >= 0).sum()) for ident, _ in captured]


@contextlib.contextmanager
def captured_probe_inputs(sites: dict):
    """Kernel B3's busiest find-or-insert input at each call site run inside
    the block: ``sites`` maps a label to the module whose
    ``ht_lookup_or_insert`` is watched, or to (module, table) to watch only
    the calls on that table. The dict it yields receives, per label,
    (table, key columns, valid) as they were just before the call with the
    most valid rows (the latest of equals, so the fullest table). Every
    call keeps its candidate on the card with ``torch.where``, so the watch
    makes no host sync; the choice among chunk shapes is read once, after
    the block."""
    from risingwave_tpu_torch.common import Column
    from risingwave_tpu_torch.ops import hash_table as ht
    by_module: dict = {}     # module path -> [(label, table or None)]
    for label, site in sites.items():
        path, only = (site, None) if isinstance(site, str) else site
        by_module.setdefault(path, []).append((label, only))
    mods = {path: importlib.import_module(path) for path in by_module}
    best: dict = {}      # (label, shape signature) -> [count, tensors]
    found: dict = {}

    def watch(entries):
        def capturing(table, cols, valid, *args, **kw):
            label = next((lb for lb, only in entries
                          if only is None or only is table), None)
            if label is not None:
                keep_busiest(label, table, cols, valid)
            return ht.ht_lookup_or_insert(table, cols, valid, *args, **kw)
        return capturing

    def keep_busiest(label, table, cols, valid):
        sig = (label, table.capacity, valid.shape[0],
               tuple(c.data.dtype for c in cols))
        now = ([*table.key_data, *table.key_mask, table.occupied]
               + [t for c in cols for t in (c.data, c.mask)] + [valid])
        count = valid.sum()
        if sig not in best:
            best[sig] = [count, [t.clone() for t in now]]
        else:
            kept = best[sig]
            better = count >= kept[0]
            kept[0] = torch.where(better, count, kept[0])
            for dst, src in zip(kept[1], now):
                dst.copy_(torch.where(better, src, dst))

    for path, mod in mods.items():
        mod.ht_lookup_or_insert = watch(by_module[path])
    try:
        yield found
    finally:
        for mod in mods.values():
            mod.ht_lookup_or_insert = ht.ht_lookup_or_insert
    for label in sites:
        sigs = [k for k in best if k[0] == label]
        if not sigs:
            continue
        sig = max(sigs, key=lambda k: int(best[k][0]))
        ts, k = best[sig][1], len(sig[3])
        table = ht.DeviceHashTable(tuple(ts[:k]), tuple(ts[k:2 * k]),
                                   ts[2 * k])
        cols = [Column(ts[2 * k + 1 + 2 * i], ts[2 * k + 2 + 2 * i])
                for i in range(k)]
        found[label] = (table, cols, ts[-1])


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
    device operations run (kernels and copies), kernel B3's device ms and
    the five operations with the most device time; B3's ms also by kernel
    (``b3_by_kernel``)."""
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    rows = sorted(((e.self_device_time_total, e.key) for e in events),
                  reverse=True)
    busy = sum(us for us, _ in rows) / 1e6
    b3 = {n: sum(us for us, k in rows if n in k) / 1e3 for n in B3_KERNELS}
    return {"rows_in": rows_in, "wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall,
            "device_ops": sum(e.count for e in events),
            "b3_ms": sum(b3.values()), "b3_by_kernel": b3,
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


def epoch_bids(gen, start: int, key, k: int, cols=(0, 2, 5)):
    """Columns ``cols`` (by default auction, price, date_time) on the host
    of the bids an epoch body draws from ``start`` and ``key``."""
    from risingwave_tpu_torch.ops.fused_epoch import epoch_chunks
    ch = epoch_chunks(gen.chunk_fn(), gen.cfg.chunk_capacity, start, key, k)
    return [ch.columns[j].data.reshape(-1).cpu().numpy() for j in cols]


@contextlib.contextmanager
def no_host_sync(on: bool = True):
    """With ``on``, synchronizing CUDA calls inside the block are errors
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    if not on:
        yield
        return
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


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
        with no_host_sync(sync_check):
            (self.state, probe_out, del_m, ins_m, old,
             packed) = self.epoch_fn(self.state, self.start, key, self.k)
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

    def epoch(self, drain: Drain, sync_check: bool = False) -> None:
        """One epoch and the executor's barrier path; with ``sync_check``
        the epoch body runs with synchronizing CUDA calls made errors."""
        key = fused_keys(Q5_FUSED_SEED, self.batch_no, self.device)
        self.bids.append((self.start, key))
        with no_host_sync(sync_check):
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


def sorted_rows(rows: np.ndarray) -> np.ndarray:
    """Rows of a 2-D integer array in lexicographic order."""
    return rows[np.lexsort(rows.T[::-1])] if len(rows) else rows


class FusedQ8:
    """The fused q8 epoch (bench.py measure_q8_fused) on one card: bidder
    session-gap windows, the watermark close at each barrier and the
    closed-session drain."""

    def __init__(self, device, chunk: int, k: int, gap_us: int = Q8_GAP_US,
                 capacity: int = Q8_TABLE_CAP,
                 closed_capacity: int = Q8_CLOSED_CAP):
        from risingwave_tpu_torch.common import INT64, TIMESTAMP, Field, Schema
        from risingwave_tpu_torch.connector import (
            DeviceBidGenerator, NexmarkConfig,
        )
        from risingwave_tpu_torch.expr import col
        from risingwave_tpu_torch.ops.fused_epoch import EPOCH_BUILDERS
        from risingwave_tpu_torch.ops.session_window import SessionWindowCore
        exprs = [col(1, INT64), col(5, TIMESTAMP)]      # bidder, date_time
        schema = Schema((Field("bidder", INT64), Field("ts", TIMESTAMP)))
        self.core = SessionWindowCore(schema, 0, 1, gap_us, capacity,
                                      closed_capacity, device)
        self.cfg = NexmarkConfig(chunk_capacity=chunk)
        self.gen = DeviceBidGenerator(self.cfg, device=device)
        self.epoch_fn = EPOCH_BUILDERS["source_session"](
            self.gen.chunk_fn(), exprs, self.core, chunk)
        self.us_per_event = max(1_000_000 // max(
            self.cfg.events_per_second, 1), 1)
        self.device, self.chunk, self.k, self.gap = device, chunk, k, gap_us
        self.state = self.core.init_state()
        self.start = 0
        self.batch_no = 0
        self.bids = []
        self.watermark = None

    def epoch(self, drain: Drain, sync_check: bool = False) -> None:
        key = fused_keys(Q8_FUSED_SEED, self.batch_no, self.device)
        self.bids.append((self.start, key))
        end = self.start + self.k * self.chunk
        wm = self.cfg.start_time_us + end * self.us_per_event - self.gap
        with no_host_sync(sync_check):
            self.state, snap, packed = self.epoch_fn(
                self.state, self.start, key, self.k, wm)
        self.start = end
        self.batch_no += 1
        self.watermark = wm
        n_closed, ovf, covf, sawdel, ooo = packed.tolist()
        if ovf or covf or sawdel or ooo:
            raise AssertionError(
                f"fused q8 flags: table_overflow={ovf} closed_overflow="
                f"{covf} saw_delete={sawdel} out_of_order={ooo}")
        for lo in range(0, n_closed, self.chunk):
            drain.add(self.core.gather_closed(snap, n_closed, lo,
                                              self.chunk))

    def expected(self) -> np.ndarray:
        """The closed sessions in numpy, sorted: the bids of every epoch so
        far sorted by (bidder, ts) and split where the gap exceeds the
        session gap; a session is closed if its bidder has a later one or
        the last watermark has passed its end by the gap."""
        cols = [epoch_bids(self.gen, start, key, self.k, (1, 5))
                for start, key in self.bids]
        bidder, ts = (np.concatenate(c) for c in zip(*cols))
        return sorted_rows(sessions(bidder, ts, self.gap, self.watermark))

    def check(self, drain: Drain) -> int:
        """Fails unless the drained sessions equal ``expected``; returns
        their number."""
        got = np.concatenate([r for r, _ in drain.parts]) if drain.parts \
            else np.zeros((0, 4), np.int64)
        if drain.parts and not all((s == 1).all() for _, s in drain.parts):
            raise AssertionError("fused q8 emitted a non-insert row")
        want = self.expected()
        if got.shape != want.shape or not np.array_equal(sorted_rows(got),
                                                         want):
            raise AssertionError(f"fused q8 sessions differ from numpy: "
                                 f"{len(got)} emitted, {len(want)} expected")
        return len(want)


def sessions(key: np.ndarray, ts: np.ndarray, gap: int,
             watermark: int) -> np.ndarray:
    """Closed sessions (key, start, end, n_events) of events ``(key, ts)``
    in numpy."""
    order = np.lexsort((ts, key))
    k, t = key[order], ts[order]
    n = len(k)
    first = np.ones(n, bool)
    first[1:] = (k[1:] != k[:-1]) | (t[1:] - t[:-1] > gap)
    starts = np.flatnonzero(first)
    ends = np.append(starts[1:], n) - 1
    later = np.append(k[starts[1:]] == k[starts[:-1]], False)
    closed = later | (t[ends] + gap <= watermark)
    return np.stack([k[starts], t[starts], t[ends], ends - starts + 1],
                    1)[closed]


class FusedQ3:
    """The fused TPC-H q3 epoch (bench.py measure_q3_fused) on one card:
    orders build, lineitem probe, revenue agg and the top-10 churn, applied
    to a host copy of the MV after each epoch."""

    def __init__(self, device, chunk: int, k: int,
                 orders_capacity: int = Q3_ORDERS_CAP,
                 agg_capacity: int = Q3_AGG_CAP):
        from risingwave_tpu_torch.connector import (
            Q3_CUTOFF_DAYS, DeviceQ3Generator, TpchQ3Config,
        )
        from risingwave_tpu_torch.ops.fused_epoch import EPOCH_BUILDERS
        from risingwave_tpu_torch.ops.stream_q3 import Q3Core
        self.gen = DeviceQ3Generator(TpchQ3Config(chunk_capacity=chunk),
                                     device=device)
        self.core = Q3Core(Q3_CUTOFF_DAYS, orders_capacity=orders_capacity,
                           agg_capacity=agg_capacity, device=device)
        self.epoch_fn = EPOCH_BUILDERS["source_q3"](self.gen.chunk_fn(),
                                                    self.core, chunk)
        self.device, self.chunk, self.k = device, chunk, k
        self.state = self.core.init_state()
        self.start = 0
        self.batch_no = 0
        self.mv = collections.Counter()   # the top-10 as emitted
        self.history = []                 # (events so far, the MV's rows)

    def epoch(self, drain: Drain, sync_check: bool = False) -> None:
        key = fused_keys(Q3_FUSED_SEED, self.batch_no, self.device)
        with no_host_sync(sync_check):
            self.state, out, packed = self.epoch_fn(self.state, self.start,
                                                    key, self.k)
        self.start += self.k * self.chunk
        self.batch_no += 1
        _, o_ovf, a_ovf, sawdel = packed.tolist()
        if o_ovf or a_ovf or sawdel:
            raise AssertionError(f"fused q3 flags: orders_overflow={o_ovf} "
                                 f"agg_overflow={a_ovf} saw_delete={sawdel}")
        drain.add(out)
        rows, signs = drain.parts[-1]
        for row, sign in zip(rows.tolist(), signs.tolist()):
            self.mv[tuple(row)] += sign
            if self.mv[tuple(row)] < 0:
                raise AssertionError("fused q3 deletes a row it never "
                                     "emitted")
        self.mv = +self.mv
        self.history.append((self.start, sorted(self.mv.elements())))

    def expected(self, n_events: int) -> list[tuple]:
        """q3 in numpy over the first ``n_events`` events: the top 10 of
        (orderkey, revenue, o_orderdate, o_shippriority) by revenue
        descending, then orderkey."""
        from risingwave_tpu_torch.connector import Q3_CUTOFF_DAYS
        n_chunks = n_events // self.chunk
        starts = torch.arange(n_chunks, dtype=torch.int64,
                              device=self.device) * self.chunk
        ch = self.gen.chunk_fn()(starts)
        kind, okey, odate, prio, mkt, price, disc, ship = (
            c.data.reshape(-1).cpu().numpy() for c in ch.columns)
        cut = Q3_CUTOFF_DAYS
        qual = (kind == 0) & (odate < cut) & (mkt == 0)
        o_date = np.full(okey.max() + 1, -1, np.int64)
        o_prio = np.zeros(okey.max() + 1, np.int64)
        o_date[okey[qual]] = odate[qual]
        o_prio[okey[qual]] = prio[qual]
        li = (kind == 1) & (ship > cut) & (o_date[okey] >= 0)
        rev = np.zeros(okey.max() + 1, np.int64)
        np.add.at(rev, okey[li], price[li] * (10000 - disc[li]) // 10000)
        keys = np.unique(okey[li])
        top = keys[np.lexsort((keys, -rev[keys]))][:self.core.limit]
        return sorted((int(k), int(rev[k]), int(o_date[k]), int(o_prio[k]))
                      for k in top)

    def check(self) -> int:
        """Fails unless, after every epoch so far, the top-10 as emitted
        equalled ``expected`` over the events up to then; returns the
        epochs checked."""
        for b, (n_events, got) in enumerate(self.history):
            want = self.expected(n_events)
            if got != want or len(got) != self.core.limit:
                raise AssertionError(
                    f"fused q3 top-{self.core.limit} differs from numpy "
                    f"after epoch {b}: {got} != {want}")
        return len(self.history)


# ---------------------------------------------------------------------------
# phases 9 to 12: the q5 and q7 executors as bench.py drives them, their
# checkpoint to state tables, watermark cleaning and recovery
# ---------------------------------------------------------------------------

class DeviceBidSource:
    """bench.py's ``_DeviceBidSource``: a barrier, then per epoch one
    ChunkBatch of ``sizes[i]`` chunks from the device generator ``gen`` and
    a barrier. ``watermarks`` maps an epoch to a watermark on ``date_time``
    sent just before its closing barrier; with ``checkpoint`` every
    barrier is a checkpoint."""

    def __init__(self, gen, sizes, first_epoch: int,
                 checkpoint: bool = False, watermarks=None,
                 sync_checked=()):
        from risingwave_tpu_torch.connector import BID_SCHEMA
        self.schema = BID_SCHEMA
        self.gen, self.sizes, self.first_epoch = gen, sizes, first_epoch
        self.checkpoint = checkpoint
        self.watermarks = watermarks or {}
        self.sync_checked = set(sync_checked)

    async def execute(self):
        """A batch listed in ``sync_checked`` (by its index in ``sizes``) is
        yielded with synchronizing CUDA calls made errors, until the next
        message is asked for: the single-input executors downstream ingest
        it inside that window, up to the first that holds it to a
        barrier."""
        from risingwave_tpu_torch.stream import Barrier, Watermark
        epoch = self.first_epoch
        yield Barrier.new(epoch, checkpoint=self.checkpoint)
        for i, k in enumerate(self.sizes):
            batch = self.gen.next_batch(k)
            with no_host_sync(i in self.sync_checked):
                yield batch
            epoch += 1
            if epoch in self.watermarks:
                yield Watermark(5, self.watermarks[epoch])
            yield Barrier.new(epoch, checkpoint=self.checkpoint)


def bench_gen(device):
    """A bid generator as bench.py configures it (seed 42)."""
    from risingwave_tpu_torch.connector import (
        DeviceBidGenerator, NexmarkConfig,
    )
    return DeviceBidGenerator(NexmarkConfig(chunk_capacity=CHUNK),
                              device=device)


def bench_bids(device, sizes, idx=(0, 2, 5)):
    """Columns ``idx`` (by default auction, price, date_time) on the host
    of the batches of ``sizes[i]`` chunks a bench generator draws first,
    drawn again by a generator of the same seed (outside any timed
    window)."""
    gen = bench_gen(device)
    cols = [[] for _ in idx]
    for k in sizes:
        batch = gen.next_batch(k).chunk
        for out, j in zip(cols, idx):
            out.append(batch.columns[j].data.reshape(-1).cpu().numpy())
    return [np.concatenate(c) for c in cols]


def q5_bench_pipeline(src, device, state_table=None):
    """bench.py ``_q5_pipeline``: Project(tumble_start(date_time, 10 s),
    auction) → HashAgg(count(*)), table capacity 1<<21."""
    from risingwave_tpu_torch.common import INT64, TIMESTAMP
    from risingwave_tpu_torch.expr import Literal, call, col, count_star
    from risingwave_tpu_torch.stream import HashAggExecutor, ProjectExecutor
    proj = ProjectExecutor(src, [
        call("tumble_start", col(5, TIMESTAMP), Literal(Q5_WINDOW_US, INT64)),
        col(0, INT64)], names=("window_start", "auction"))
    return HashAggExecutor(proj, [0, 1], [count_star()],
                           state_table=state_table,
                           table_capacity=Q5_TABLE_CAPACITY,
                           out_capacity=CHUNK, device=device)


def q5_state_table(store):
    from risingwave_tpu_torch.common import INT64, TIMESTAMP, Field
    from risingwave_tpu_torch.expr import count_star
    from risingwave_tpu_torch.storage import StateTable
    from risingwave_tpu_torch.stream.hash_agg import agg_state_schema
    schema = agg_state_schema([Field("window_start", TIMESTAMP),
                               Field("auction", INT64)], [count_star()])
    return StateTable(store, 1, schema, [0, 1])


async def drain_into(executor, drain: Drain, store=None) -> None:
    """Run ``executor`` to its end, every output chunk into ``drain``; each
    checkpoint barrier commits ``store``."""
    from risingwave_tpu_torch.common import StreamChunk
    from risingwave_tpu_torch.stream import Barrier
    async for m in executor.execute():
        if isinstance(m, StreamChunk):
            drain.add(m)
        elif isinstance(m, Barrier) and store is not None and m.checkpoint:
            store.commit(m.epoch.curr)


async def sync_free_batch(agg, batch) -> None:
    """One batch through the pipeline's Project and HashAgg batched steps
    (``map_chunk_batch``) with synchronizing CUDA calls made errors."""
    with no_host_sync():
        async for projected in agg.input.map_chunk_batch(batch):
            async for _ in agg.map_chunk_batch(projected):
                pass


def run_q5_bench(device) -> dict:
    """Phase 9: the q5 executor in bench form — one warm-up epoch and
    ``FUSED_TIMED_EPOCHS`` timed epochs of 256 chunks, then one epoch whose
    batched ingest runs under the sync check and the executor's barrier
    flush; the net output equal to a numpy group-by count of the same
    bids."""
    from risingwave_tpu_torch.stream import Barrier
    gen = bench_gen(device)
    sizes = [FUSED_CHUNKS_PER_EPOCH] * (1 + FUSED_TIMED_EPOCHS)
    epochs = len(sizes)
    agg = q5_bench_pipeline(DeviceBidSource(gen, sizes, 1), device)
    drain = Drain()
    b3_launches(reset=True)
    _, secs = asyncio.run(drive(agg, 2, drain))
    launches = b3_launches()
    batch = gen.next_batch(FUSED_CHUNKS_PER_EPOCH)
    asyncio.run(sync_free_batch(agg, batch))

    async def flush():
        async for out in agg.on_barrier(Barrier.new(epochs + 2)):
            drain.add(out)

    asyncio.run(flush())
    got = drain.multiset()
    auction, _, ts = bench_bids(device, sizes + [FUSED_CHUNKS_PER_EPOCH])
    if got != q5_expected_cols(auction, ts):
        raise AssertionError("q5 bench-form output differs from numpy "
                             "group-by count")
    rate = FUSED_TIMED_EPOCHS * FUSED_CHUNKS_PER_EPOCH * CHUNK / secs
    return {"groups": len(got), "source_rows_per_s": rate,
            "b3_launches": launches}


def trace_q5_bench(device) -> dict:
    """Two epochs of a fresh q5 bench-form pipeline under the profiler's
    CUDA trace: as ``trace``."""
    from torch.profiler import ProfilerActivity, profile
    agg = q5_bench_pipeline(DeviceBidSource(
        bench_gen(device), [FUSED_CHUNKS_PER_EPOCH] * 2, 1), device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asyncio.run(drive(agg, 1))
        wall = time.perf_counter() - t0
    return trace_summary(prof, wall, 2 * FUSED_CHUNKS_PER_EPOCH * CHUNK)


class Instrumented:
    """Times an executor's checkpoints and its core's ``compact`` on the
    card, and counts kernel B3's launches inside each compaction; keeps the
    last compaction's B3 input (keys and live mask) for the kernels line."""

    def __init__(self):
        self.ckpt_ms, self.ckpt_rows = [], []
        self.compact_ms, self.compact_b3 = [], 0
        self.compact_input = None

    def attach(self, agg) -> None:
        checkpoint, compact = agg._checkpoint_to_state_table, agg.core.compact

        def timed_checkpoint(epoch):
            rows = int(agg.state.ckpt_dirty.sum())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint(epoch)
            torch.cuda.synchronize()
            self.ckpt_ms.append((time.perf_counter() - t0) * 1e3)
            self.ckpt_rows.append(rows)

        def timed_compact(state):
            from risingwave_tpu_torch.common import Column
            table = state.table
            self.compact_input = (
                [Column(d.clone(), m.clone())
                 for d, m in zip(table.key_data, table.key_mask)],
                table.occupied & (state.lanes[0] > 0))
            torch.cuda.synchronize()
            before = b3_launches()
            t0 = time.perf_counter()
            new = compact(state)
            torch.cuda.synchronize()
            self.compact_ms.append((time.perf_counter() - t0) * 1e3)
            self.compact_b3 += b3_launches() - before
            return new

        agg._checkpoint_to_state_table = timed_checkpoint
        agg.core.compact = timed_compact


def run_q5_recovery(device) -> dict:
    """Phase 10: the q5 bench form over a StateTable, every barrier a
    checkpoint, a watermark on date_time before the checkpoint of epoch 2
    (the first event time of epoch 3, so no later bid falls below it: the
    checkpoint cleans every earlier window and compacts the 1<<21 table on
    the card). After epoch 2 of 4 the executor is dropped and a new one
    recovers from the store through kernel B3. The two halves' net output
    must equal an uninterrupted run's and numpy's; the store's committed
    rows must equal numpy's groups at or above the watermark."""
    from risingwave_tpu_torch.connector import NexmarkConfig
    from risingwave_tpu_torch.native import codec
    from risingwave_tpu_torch.storage import MemoryStateStore
    if codec() is None:
        raise AssertionError("the native row codec did not build")
    k = FUSED_CHUNKS_PER_EPOCH
    cfg = NexmarkConfig(chunk_capacity=CHUNK)
    us_per_event = max(1_000_000 // cfg.events_per_second, 1)
    wm_ts = cfg.start_time_us + 2 * k * CHUNK * us_per_event
    wm = {3: wm_ts}      # the barrier that closes epoch 2 is epoch 3's

    def instrumented(src, store, inst):
        agg = q5_bench_pipeline(src, device, q5_state_table(store))
        inst.attach(agg)
        return agg

    # the uninterrupted run
    whole = Drain()
    store0 = MemoryStateStore()
    asyncio.run(drain_into(instrumented(
        DeviceBidSource(bench_gen(device), [k] * 4, 1, True, wm), store0,
        Instrumented()), whole, store0))
    # the run dropped after epoch 2 and recovered
    inst = Instrumented()
    halves = Drain()
    store = MemoryStateStore()
    gen = bench_gen(device)
    agg = instrumented(DeviceBidSource(gen, [k] * 2, 1, True, wm), store,
                       inst)
    asyncio.run(drain_into(agg, halves, store))
    del agg
    torch.cuda.empty_cache()
    b3_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    agg = instrumented(DeviceBidSource(gen, [k] * 2, 4, True), store, inst)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    recovery_b3 = b3_launches()
    reloaded = int(agg.state.table.occupied.sum())
    asyncio.run(drain_into(agg, halves, store))
    auction, _, ts = bench_bids(device, [k] * 4)
    want = q5_expected_cols(auction, ts)
    got = halves.multiset()
    if got != want or whole.multiset() != want:
        raise AssertionError("q5 recovery: the net output differs from the "
                             "uninterrupted run or from numpy")
    wm_window = wm_ts // Q5_WINDOW_US * Q5_WINDOW_US
    # a stored row: the group key, the row count, the count(*) lane
    stored = collections.Counter(
        {(int(w), int(a)): int(n) for w, a, _, n in
         q5_state_table(store).scan_all()})
    live = collections.Counter({(w, a): n for (w, a, n) in want
                                if w >= wm_window})
    if stored != live:
        raise AssertionError(f"q5 recovery: the store holds {len(stored)} "
                             f"groups, numpy {len(live)} at or above the "
                             "watermark")
    if not inst.compact_ms or inst.compact_b3 <= 0 or recovery_b3 <= 0:
        raise AssertionError("q5 recovery: compaction or reload did not run "
                             "kernel B3")
    keys, live_mask = inst.compact_input
    return {"codec": "native", "groups": len(want),
            "watermark_window": wm_window,
            "stored_groups": len(stored), "reloaded_groups": reloaded,
            "checkpoints": len(inst.ckpt_ms),
            "checkpoint_ms_mean": sum(inst.ckpt_ms) / len(inst.ckpt_ms),
            "checkpoint_ms_max": max(inst.ckpt_ms),
            "rows_written": inst.ckpt_rows,
            "compact_ms": inst.compact_ms, "compact_b3": inst.compact_b3,
            "recovery_s": recovery_s, "recovery_b3": recovery_b3,
            "compact_input": (keys, live_mask)}


def q7_bench_join(probe_src, build_src, device, store=None):
    """bench.py measure_q7's pipeline: Project → HashAgg(max(price)) per 5 ms
    window, capacity 1<<16 → HashJoin(price = max), key capacity 1<<16,
    bucket width 128. With ``store``: state tables on the agg and both join
    sides, and the probe side keeps date_time (unique per bid) so that its
    rows have a primary key (window_start, date_time)."""
    from risingwave_tpu_torch.common import INT64, TIMESTAMP
    from risingwave_tpu_torch.expr import Literal, agg, call, col
    from risingwave_tpu_torch.storage import StateTable
    from risingwave_tpu_torch.stream import (
        HashAggExecutor, HashJoinExecutor, ProjectExecutor,
    )
    from risingwave_tpu_torch.stream.hash_agg import agg_state_schema
    window = call("tumble_start", col(5, TIMESTAMP),
                  Literal(Q7_WINDOW_US, INT64))
    cols = [window, col(0, INT64), col(2, INT64)]
    names = ["window_start", "auction", "price"]
    if store is not None:
        cols.append(col(5, TIMESTAMP))
        names.append("date_time")
    probe = ProjectExecutor(probe_src, cols, names=names)
    build_pre = ProjectExecutor(build_src, [window, col(2, INT64)],
                                names=("window_start", "price"))
    calls = [agg("max", 1, INT64)]
    tables = {}
    agg_table = None
    if store is not None:
        agg_table = StateTable(store, 1, agg_state_schema(
            [build_pre.schema[0]], calls), [0])
    build = HashAggExecutor(build_pre, [0], calls, state_table=agg_table,
                            table_capacity=Q7_AGG_CAPACITY,
                            out_capacity=CHUNK, device=device)
    if store is not None:
        tables = dict(
            left_state_table=StateTable(store, 2, probe.schema, [0, 3]),
            right_state_table=StateTable(store, 3, build.schema, [0]))
    cond = call("equal", col(2, INT64), col(len(cols) + 1, INT64))
    return HashJoinExecutor(probe, build, [0], [0], condition=cond,
                            key_capacity=Q7_KEY_CAPACITY,
                            bucket_width=Q7_BUCKET_WIDTH, out_capacity=CHUNK,
                            device=device, **tables)


def q7_expected_with_ts(auction, price, ts) -> collections.Counter:
    """``q7_expected_cols`` with each row's date_time after its price."""
    ws = ts // Q7_WINDOW_US * Q7_WINDOW_US
    uniq, inverse = np.unique(ws, return_inverse=True)
    win_max = np.full(len(uniq), np.iinfo(np.int64).min)
    np.maximum.at(win_max, inverse, price)
    hit = price == win_max[inverse]
    rows = np.stack([ws[hit], auction[hit], price[hit], ts[hit], ws[hit],
                     price[hit]], 1)
    return counter_of(rows, np.ones(len(rows), np.int64))


def run_q7_bench(device) -> dict:
    """Phase 11: the q7 executor in bench form (two generators of one seed,
    batched on both inputs), bench.py's size: a warm-up epoch of 64 chunks,
    then two timed epochs of 256; the net output equal to numpy q7 over
    the same bids."""
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    join = q7_bench_join(DeviceBidSource(bench_gen(device), Q7_EPOCHS, 1),
                         DeviceBidSource(bench_gen(device), Q7_EPOCHS, 1),
                         device)
    b3_launches(reset=True)
    rt_mod.rank_totals.launches = 0
    got, secs = asyncio.run(drive(join, 2))
    b1, b3 = rt_mod.rank_totals.launches, b3_launches()
    want = q7_expected_cols(*bench_bids(device, Q7_EPOCHS))
    if got != want:
        raise AssertionError(f"q7 bench-form output differs from numpy q7: "
                             f"{sum((got - want).values())} extra, "
                             f"{sum((want - got).values())} missing rows")
    return {"rows_out": sum(got.values()), "multiset": got,
            "source_rows_per_s": sum(Q7_EPOCHS[1:]) * CHUNK / secs,
            "key_capacity": join.core.capacity, "bucket_width": join.core.W,
            "b1_launches": b1, "b3_launches": b3}


def run_q7_recovery(device, uninterrupted: collections.Counter) -> dict:
    """Phase 12: the q7 bench form with state tables on the agg and both
    join sides, every barrier a checkpoint; dropped after epoch 2 of the
    bench's 3 and recovered (the join replays both sides through kernels B1
    and B3). The net output must equal numpy's and, without date_time, the
    uninterrupted bench-form run's over the same bids."""
    from risingwave_tpu_torch.storage import MemoryStateStore
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    store = MemoryStateStore()
    probe_gen, build_gen = bench_gen(device), bench_gen(device)
    drain = Drain()

    def pipeline(sizes, first):
        return q7_bench_join(
            DeviceBidSource(probe_gen, sizes, first, True),
            DeviceBidSource(build_gen, sizes, first, True), device, store)

    join = pipeline(Q7_EPOCHS[:2], 1)
    ckpt_ms = []
    checkpoint = join._checkpoint

    def timed_checkpoint(epoch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint(epoch)
        ckpt_ms.append((time.perf_counter() - t0) * 1e3)

    join._checkpoint = timed_checkpoint
    asyncio.run(drain_into(join, drain, store))
    del join, checkpoint
    torch.cuda.empty_cache()
    replayed = store.table_len(2) + store.table_len(3)
    b3_launches(reset=True)
    rt_mod.rank_totals.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    join = pipeline(Q7_EPOCHS[2:], 4)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    b1, b3 = rt_mod.rank_totals.launches, b3_launches()
    asyncio.run(drain_into(join, drain, store))
    got = drain.multiset()
    auction, price, ts = bench_bids(device, Q7_EPOCHS)
    if got != q7_expected_with_ts(auction, price, ts):
        raise AssertionError("q7 recovery: the net output differs from "
                             "numpy q7")
    no_ts = collections.Counter()
    for row, n in got.items():
        no_ts[row[:3] + row[4:]] += n
    if no_ts != uninterrupted:
        raise AssertionError("q7 recovery: the net output differs from the "
                             "uninterrupted run's")
    if b1 <= 0 or b3 <= 0:
        raise AssertionError("q7 recovery did not run kernels B1 and B3")
    return {"rows_out": sum(got.values()), "rows_replayed": replayed,
            "recovery_s": recovery_s, "b1_launches": b1, "b3_launches": b3,
            "checkpoint_ms": ckpt_ms}


def compact_probe_times(compact_input) -> dict:
    """Kernel B3 on the input of the q5 run's last compaction (every slot
    of the 1<<21 table a row, its live groups valid), into an empty table:
    as ``probe_input_times``."""
    from risingwave_tpu_torch.common import INT64, TIMESTAMP
    from risingwave_tpu_torch.ops.hash_table import ht_new
    keys, live = compact_input
    empty = ht_new((TIMESTAMP, INT64), Q5_TABLE_CAPACITY, live.device)
    return probe_input_times("the compact input", empty, keys, live)


def probe_input_times(name: str, table, cols, valid,
                      paths=("auto",)) -> dict:
    """Kernel B3's find-or-insert on one input a path gave it: slots, table
    and flags equal to the plain version's on each of ``paths``, device
    times of kernel and plain version, and the bound."""
    from risingwave_tpu_torch.ops.hash_table import (
        ht_lookup_or_insert, ht_lookup_or_insert_plain,
    )
    for path in paths:
        err, (s0, f0, o0) = compare_hash_probe(table, cols, valid, "insert",
                                               path)
        if err:
            raise AssertionError(f"hash_probe differs from plain on {name}, "
                                 f"{path} path: {err} differences")
    bound_ms, bound_by = hash_probe_bound(table, cols, valid, s0, f0,
                                          "insert")
    ms, plain_ms, call_ms, timing = probe_times(
        lambda t: ht_lookup_or_insert(t, cols, valid),
        lambda t: ht_lookup_or_insert_plain(t, cols, valid), table)
    held_to_bound(f"hash_probe on {name}", ms, bound_ms)
    return {"n": int(valid.shape[0]), "live": int(valid.sum()),
            "cap": table.capacity, "occupied": int(table.occupied.sum()),
            "new": int(f0.sum()), "overflow": bool(o0),
            "paths": list(paths), "differences": 0, "ms": ms,
            "plain_ms": plain_ms, "call_ms": call_ms, "timing": timing,
            "bound_ms": bound_ms, "bound_by": bound_by}


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


# ---------------------------------------------------------------------------
# phases 13-15: NEXmark q105, q102 and q18 over the device row set
# ---------------------------------------------------------------------------

def nexmark_chunks(table: str, n: int, device, gen=None):
    """``n`` chunks of CHUNK rows from the host generator (seed 42) of one
    source leaf, on the card; returns (chunks, generator)."""
    from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
    if gen is None:
        gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=CHUNK),
                               seed=SEED, device=device)
    fn = {"bid": gen.next_bid_chunk, "auction": gen.next_auction_chunk}
    return [fn[table]() for _ in range(n)], gen


def epoch_source(schema, chunks, first_epoch: int = 1,
                 checkpoint: bool = False):
    """A barrier, then per epoch NEX_CHUNKS_PER_EPOCH chunks and a barrier
    (every barrier a checkpoint with ``checkpoint``)."""
    from risingwave_tpu_torch.stream import Barrier, MockSource
    msgs = [Barrier.new(first_epoch, checkpoint=checkpoint)]
    for i in range(0, len(chunks), NEX_CHUNKS_PER_EPOCH):
        msgs.extend(chunks[i:i + NEX_CHUNKS_PER_EPOCH])
        msgs.append(Barrier.new(first_epoch + 1 + i // NEX_CHUNKS_PER_EPOCH,
                                checkpoint=checkpoint))
    return MockSource(schema, msgs)


def host_cols(chunks, idx) -> list[np.ndarray]:
    """Numpy columns ``idx`` of every visible row of ``chunks``."""
    return [np.concatenate([c.columns[i].data[c.vis].cpu().numpy()
                            for c in chunks]) for i in idx]


def tensor_bytes(obj) -> int:
    """Bytes of every tensor held by a (nested) state dataclass."""
    import dataclasses
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(tensor_bytes(x) for x in obj)
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


def q105_counts(auctions, bids) -> dict:
    """numpy q105/q102 groups: (id, item_name) -> count(b.auction) of the
    inner join, an auction row's bids counted once per auction row."""
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT
    aid, item = host_cols(auctions, (0, 1))
    (bid_auction,) = host_cols(bids, (0,))
    ids, n = np.unique(bid_auction, return_counts=True)
    n_bid = dict(zip(ids.tolist(), n.tolist()))
    counts: dict = collections.Counter()
    for a, it in zip(aid.tolist(), item.tolist()):
        if a in n_bid:
            counts[(a, GLOBAL_STRING_DICT.lookup(it))] += n_bid[a]
    return counts


def run_q105(device, auctions, bids) -> dict:
    """Phase 13: q105 — both sources → RowIdGen → Project → HashJoin → Project
    → HashAgg(count) → Project → TopN(limit 1000) → Materialize, one
    warm-up and three timed epochs of 16 chunks per source; the MV equal to
    numpy's top 1000 under (count desc, id asc, item_name asc by string).
    Kernel B1's busiest input is kept, and kernel B3's busiest input at
    the agg's group table and at the TopN's row set; all are returned."""
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    plan = nexmark_plan("q105", device, auctions, bids)
    arena = tensor_bytes(plan.join.state)
    with busiest_rank_input() as b1_input, captured_probe_inputs({
            "q105 HashAgg groups": "risingwave_tpu_torch.ops.grouped_agg",
            "q105 TopN rows": "risingwave_tpu_torch.ops.row_set",
    }) as b3_inputs:
        b3_launches(reset=True)
        rt_mod.rank_totals.launches = 0
        _, secs = asyncio.run(drive(plan.mv, 2))
        b1, b3 = rt_mod.rank_totals.launches, b3_launches()
    if plan.join.core.W != Q105_BUCKET_WIDTH or \
            plan.join.core.capacity != Q105_KEY_CAPACITY:
        raise AssertionError("the q105 join grew: size it larger")
    counts = q105_counts(auctions, bids)
    want = sorted(sorted(counts.items(),
                         key=lambda kv: (-kv[1], kv[0][0], kv[0][1])
                         )[:Q105_LIMIT])
    got = sorted(((r[0], r[1]), r[2]) for r in plan.mv.rows())
    if got != want:
        raise AssertionError(f"q105 MV differs from numpy's top "
                             f"{Q105_LIMIT}: {len(set(got) - set(want))} "
                             f"extra, {len(set(want) - set(got))} missing")
    timed_rows = 2 * (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"groups": len(counts), "mv_rows": len(got),
            "source_rows_per_s": timed_rows / secs,
            "bids_per_s": timed_rows / 2 / secs,
            "key_capacity": plan.join.core.capacity,
            "bucket_width": plan.join.core.W, "join_arena_bytes": arena,
            "n_fast_flushes": plan.top_n.n_fast_flushes,
            "n_refills": plan.top_n.n_refills, "b1_launches": b1,
            "b3_launches": b3, "b1_calls": b1_input["calls"],
            "b1_busiest_keyed_rows": b1_input["keyed_rows"],
            "b1_input": b1_input["input"], "b3_inputs": b3_inputs}


def run_q102(device, auctions, bids) -> dict:
    """Phase 14: q102 — the q105 join and agg → DynamicFilter(>=) whose RHS
    is bids → MaterializedAgg(count(*), count(DISTINCT auction)) →
    Project(divide); the MV equal to numpy's groups whose count is at least
    floor(bids / distinct auctions). Kernel B3's busiest input at the
    DynamicFilter's row set is returned."""
    from risingwave_tpu_torch.connector import AUCTION_SCHEMA, BID_SCHEMA
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    store = MemoryStateStore()
    plan = plans.q102(
        epoch_source(AUCTION_SCHEMA, auctions), epoch_source(BID_SCHEMA, bids),
        epoch_source(BID_SCHEMA, bids),
        StateTable(store, 1, plans.q105_schema(), [0, 1]),
        key_capacity=Q105_KEY_CAPACITY, bucket_width=Q105_BUCKET_WIDTH,
        agg_capacity=Q105_AGG_CAPACITY, filter_capacity=Q105_AGG_CAPACITY,
        out_capacity=CHUNK, device=device)
    with captured_probe_inputs({
            "q102 DynamicFilter rows": "risingwave_tpu_torch.ops.row_set",
    }) as b3_inputs:
        b3_launches(reset=True)
        rt_mod.rank_totals.launches = 0
        _, secs = asyncio.run(drive(plan.mv, 2))
        b1, b3 = rt_mod.rank_totals.launches, b3_launches()
    counts = q105_counts(auctions, bids)
    (bid_auction,) = host_cols(bids, (0,))
    bound = len(bid_auction) // len(np.unique(bid_auction))
    want = sorted((k, n) for k, n in counts.items() if n >= bound)
    got = sorted(((r[0], r[1]), r[2]) for r in plan.mv.rows())
    if got != want or plan.dynamic_filter.bound != bound:
        raise AssertionError(f"q102 MV differs from numpy's: "
                             f"{len(set(got) - set(want))} extra, "
                             f"{len(set(want) - set(got))} missing (bound "
                             f"{plan.dynamic_filter.bound} vs {bound})")
    timed_rows = 3 * (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"mv_rows": len(got), "bound": bound,
            "source_rows_per_s": timed_rows / secs,
            "bids_per_s": (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
            / secs, "b1_launches": b1, "b3_launches": b3,
            "b3_inputs": b3_inputs}


def q18_expected(bids) -> collections.Counter:
    """numpy q18: per (bidder, auction) every bid at the latest date_time
    (ties kept), as (auction, bidder, price, date_time) rows."""
    auction, bidder, price, ts = host_cols(bids, (0, 1, 2, 5))
    keys = np.stack([bidder, auction], 1)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    latest = np.full(inverse.max() + 1, np.iinfo(np.int64).min)
    np.maximum.at(latest, inverse, ts)
    hit = ts == latest[inverse]
    return collections.Counter(zip(auction[hit].tolist(),
                                   bidder[hit].tolist(),
                                   price[hit].tolist(), ts[hit].tolist()))


def mv_counter(plan) -> collections.Counter:
    """q18's MV rows without the hidden row id."""
    return collections.Counter(r[:4] for r in plan.mv.rows())


def q18_plan(device, src, store, state_table: bool = False,
             row_id_start: int = 0):
    from risingwave_tpu_torch.storage import StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    st = (StateTable(store, 2, plans.q18_schema(), [4]) if state_table
          else None)
    return plans.q18(src, StateTable(store, 1, plans.q18_schema(), [4]),
                     table_capacity=Q18_TABLE_CAPACITY, out_capacity=CHUNK,
                     state_table=st, row_id_start=row_id_start,
                     device=device)


async def q18_sync_free_epoch(plan, batch, epoch: int) -> None:
    """One ChunkBatch through q18's RowIdAppend, RowIdGen, Project and
    GroupTopN batched steps with synchronizing CUDA calls made errors, then
    the GroupTopN's barrier flush into the MV."""
    from risingwave_tpu_torch.stream import Barrier
    top = plan.top_n
    proj = top.input
    rowid = proj.input
    with no_host_sync():
        async for a in rowid.input.map_chunk_batch(batch):
            async for b in rowid.map_chunk_batch(a):
                async for c in proj.map_chunk_batch(b):
                    async for _ in top.map_chunk_batch(c):
                        pass
    named = plan.mv.input
    async for out in top.on_barrier(Barrier.new(epoch)):
        async for row in named.map_chunk(out):
            async for _ in plan.mv.map_chunk(row):
                pass


def run_q18(device) -> dict:
    """Phase 15: q18 — bids → RowIdGen → Project → GroupTopN((bidder,
    auction), date_time desc, limit 1, WITH TIES) → Project → Materialize:
    one warm-up and three timed epochs, the MV equal to numpy's latest bids
    per group; one more epoch whose batched ingest runs under the sync
    check; then the same four epochs over a StateTable with every barrier a
    checkpoint, dropped after epoch 2 and recovered through kernel B3: the
    MV equal to the uninterrupted run's and numpy's. Kernel B3's busiest
    inputs at the GroupTopN's row set and group table are returned."""
    from risingwave_tpu_torch.common import stack_chunks
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.storage import MemoryStateStore
    n = NEX_EPOCHS * NEX_CHUNKS_PER_EPOCH
    bids, gen = nexmark_chunks("bid", n, device)
    store = MemoryStateStore()
    plan = q18_plan(device, epoch_source(BID_SCHEMA, bids), store)
    with captured_probe_inputs({
            "q18 GroupTopN rows": "risingwave_tpu_torch.ops.row_set",
            "q18 GroupTopN groups": "risingwave_tpu_torch.stream.top_n",
    }) as b3_inputs:
        b3_launches(reset=True)
        _, secs = asyncio.run(drive(plan.mv, 2))
        b3 = b3_launches()
    uninterrupted = mv_counter(plan)
    if uninterrupted != q18_expected(bids):
        raise AssertionError("q18 MV differs from numpy's latest bids")
    extra, _ = nexmark_chunks("bid", NEX_CHUNKS_PER_EPOCH, device, gen)
    asyncio.run(q18_sync_free_epoch(plan, stack_chunks(extra),
                                    NEX_EPOCHS + 2))
    if mv_counter(plan) != q18_expected(bids + extra):
        raise AssertionError("q18 MV after the sync-free epoch differs from "
                             "numpy's")
    groups = int(plan.top_n.state.group_table.occupied.sum())

    # the same epochs with a state table, dropped after epoch 2 of 4
    store = MemoryStateStore()
    half = 2 * NEX_CHUNKS_PER_EPOCH
    plan = q18_plan(device, epoch_source(BID_SCHEMA, bids[:half],
                                         checkpoint=True), store, True)
    ckpt_ms = []
    checkpoint = plan.top_n._checkpoint

    def timed_checkpoint(epoch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint(epoch)
        ckpt_ms.append((time.perf_counter() - t0) * 1e3)

    plan.top_n._checkpoint = timed_checkpoint
    asyncio.run(drain_into(plan.mv, Drain(), store))
    rows_stored = store.table_len(2)
    del plan, checkpoint
    torch.cuda.empty_cache()
    b3_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the bids' row ids resume above the first half's
    plan = q18_plan(device, epoch_source(BID_SCHEMA, bids[half:], 3, True),
                    store, True, row_id_start=half * CHUNK)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    recovery_b3 = b3_launches()
    asyncio.run(drain_into(plan.mv, Drain(), store))
    if mv_counter(plan) != uninterrupted:
        raise AssertionError("q18 recovery: the MV differs from the "
                             "uninterrupted run's")
    if recovery_b3 <= 0:
        raise AssertionError("q18 recovery did not run kernel B3")
    timed_rows = (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"groups": groups, "mv_rows": sum(uninterrupted.values()),
            "source_rows_per_s": timed_rows / secs, "b3_launches": b3,
            "rows_stored": rows_stored, "checkpoint_ms": ckpt_ms,
            "recovery_s": recovery_s, "recovery_b3_launches": recovery_b3,
            "b3_inputs": b3_inputs}


# ---------------------------------------------------------------------------
# phases 16-20: q5 over HOP windows, the EOWC running window, q13, the
# dedup stream and the small operators
# ---------------------------------------------------------------------------

async def drive_marks(executor) -> list[float]:
    """Run ``executor`` to its end; the host clock after each barrier it
    emits, the card synchronized first."""
    from risingwave_tpu_torch.stream import Barrier
    marks = []
    async for m in executor.execute():
        if isinstance(m, Barrier):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
    return marks


def q5_hop_plan(device, sources):
    """q5 over HOP(date_time, 2 s, 10 s) at the phase's sizes: both count
    aggs at Q5_TABLE_CAPACITY, the join at Q5_HOP_KEY_CAPACITY keys ×
    Q5_HOP_BUCKET_WIDTH."""
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    mv = StateTable(MemoryStateStore(), 1, plans.q5_hop_schema(), [2, 0, 3])
    return plans.q5_hop(*sources, mv, agg_capacity=Q5_TABLE_CAPACITY,
                        key_capacity=Q5_HOP_KEY_CAPACITY,
                        bucket_width=Q5_HOP_BUCKET_WIDTH,
                        out_capacity=CHUNK, device=device)


def q5_hop_expected(auction, ts) -> collections.Counter:
    """numpy q5 over HOP windows: per window, the auctions with the most
    bids, as (auction, num, window_start)."""
    from risingwave_tpu_torch.stream.nexmark_plans import HOP_SIZE, HOP_SLIDE
    n = HOP_SIZE // HOP_SLIDE
    slot = np.floor_divide(ts, HOP_SLIDE)
    lo = slot.min() - (n - 1)
    span = auction.max() + 1
    # (window, auction) as one int64: the window's slide index, then the
    # auction
    key = np.concatenate([(slot - i - lo) * span + auction
                          for i in range(n)])
    keys, counts = np.unique(key, return_counts=True)
    win, auc = keys // span, keys % span
    top = np.zeros(win.max() + 1, np.int64)
    np.maximum.at(top, win, counts)
    hit = counts == top[win]
    return collections.Counter(zip(
        auc[hit].tolist(), counts[hit].tolist(),
        ((win[hit] + lo) * HOP_SLIDE).tolist()))


def q5_hop_flags(plan) -> list[str]:
    """Names of the sticky flags set in the plan's aggs and join."""
    left, right, _ = plan.aggs
    flags = {"left agg overflow": left.state.overflow,
             "right agg overflow": right.state.overflow}
    for side in ("left", "right"):
        st = getattr(plan.join.state, side)
        for f in ("ht_overflow", "lane_overflow", "inconsistent"):
            flags[f"join {side} {f}"] = getattr(st, f)
    return [k for k, v in flags.items() if bool(v)]


def run_q5_hop(device) -> dict:
    """Phase 16: q5 over HOP windows in bench form — two device generators
    of one seed, one per branch; a warm-up epoch, FUSED_TIMED_EPOCHS timed
    epochs and one more whose ingest (RowIdGen, HopWindow, Project and the
    count aggs) runs under the sync check, each of Q5_HOP_CHUNKS_PER_EPOCH
    chunks per source. The MV equal to numpy's q5 over the same bids,
    every flag clear, no table grown. Kernel B3's busiest input at each
    count agg and B1's at the join are returned."""
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    k = Q5_HOP_CHUNKS_PER_EPOCH
    sizes = [k] * (2 + FUSED_TIMED_EPOCHS)
    checked = {len(sizes) - 1}
    plan = q5_hop_plan(device, [DeviceBidSource(bench_gen(device), sizes, 1,
                                                sync_checked=checked)
                                for _ in range(2)])
    left, right, top = plan.aggs
    mat_rows = [0]
    top_map = top.map_chunk
    top_barrier = top.on_barrier

    async def counting_map(chunk):
        mat_rows[-1] += int(chunk.vis.sum())
        async for out in top_map(chunk):
            yield out

    async def counting_barrier(barrier):
        async for out in top_barrier(barrier):
            yield out
        mat_rows.append(0)

    top.map_chunk, top.on_barrier = counting_map, counting_barrier
    with busiest_rank_input() as b1_input, captured_probe_inputs({
            "q5_hop left count groups": (
                "risingwave_tpu_torch.ops.grouped_agg", left.state.table),
            "q5_hop right count groups": (
                "risingwave_tpu_torch.ops.grouped_agg", right.state.table),
    }) as b3_inputs:
        b3_launches(reset=True)
        rt_mod.rank_totals.launches = 0
        marks = asyncio.run(drive_marks(plan.mv))
        b1, b3 = rt_mod.rank_totals.launches, b3_launches()
    flags = q5_hop_flags(plan)
    if flags:
        raise AssertionError(f"q5_hop flags set: {flags}")
    if (plan.join.core.W, plan.join.core.capacity) != (
            Q5_HOP_BUCKET_WIDTH, Q5_HOP_KEY_CAPACITY) or any(
            a.state.table.capacity != Q5_TABLE_CAPACITY for a in (left, right)):
        raise AssertionError(
            f"a q5_hop table grew (join {plan.join.core.capacity} keys x "
            f"{plan.join.core.W}, aggs "
            f"{[a.state.table.capacity for a in (left, right)]}): size it "
            "larger")
    auction, _, ts = bench_bids(device, sizes)
    want = q5_hop_expected(auction, ts)
    rows = plan.mv.rows()
    got = collections.Counter((r[0], r[1], r[2]) for r in rows)
    if got != want or any(r[2] != r[3] for r in rows):
        raise AssertionError(f"q5_hop MV differs from numpy's q5: "
                             f"{sum((got - want).values())} extra, "
                             f"{sum((want - got).values())} missing")
    timed = marks[1 + FUSED_TIMED_EPOCHS] - marks[1]
    bids = FUSED_TIMED_EPOCHS * k * CHUNK

    def load(table):
        return int(table.occupied.sum()) / table.capacity

    return {"mv_rows": len(rows), "windows": len({w for _, _, w in want}),
            "chunks_per_epoch": k, "source_rows_per_s": 2 * bids / timed,
            "bids_per_s": bids / timed, "epoch_s": [
                marks[i + 1] - marks[i] for i in range(len(marks) - 1)],
            "b1_launches": b1, "b3_launches": b3,
            "materialized_agg_rows_per_epoch": mat_rows[1:len(sizes) + 1],
            "agg_loads": [load(a.state.table) for a in (left, right)],
            "join_key_loads": [load(plan.join.state.left.ht),
                               load(plan.join.state.right.ht)],
            "join_max_bucket_rows": [
                int(plan.join.state.left.occupied.sum(1).max()),
                int(plan.join.state.right.occupied.sum(1).max())],
            "bucket_width": plan.join.core.W, "sync_free_epoch": "ok",
            "b1_input": b1_input, "b3_inputs": b3_inputs}


def eowc_plan(device, src, store, state_tables: bool = False,
              row_id_start: int = 0):
    from risingwave_tpu_torch.storage import StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    return plans.eowc_running(
        src, StateTable(store, 1, plans.eowc_running_schema(), [5]),
        sort_capacity=EOWC_SORT_CAPACITY,
        out_capacity=CHUNK,
        state_tables=(plans.eowc_running_state_tables(store)
                      if state_tables else None),
        row_id_start=row_id_start, device=device)


def eowc_expected(bids) -> tuple[list, int]:
    """numpy's EOWC running window and final watermark ``wm`` (the largest
    max - delay over the chunks): the bids the WatermarkFilter keeps (each
    chunk against max - delay of the chunks before it; row ids are given
    before the filter), those below ``wm``, per auction by (date_time, row
    id): (auction, price, date_time, running sum of price with peers
    included, row number)."""
    from risingwave_tpu_torch.stream.nexmark_plans import EOWC_DELAY
    auction, price, ts = host_cols(bids, (0, 2, 5))
    sizes = [int(c.vis.sum()) for c in bids]
    rid = np.arange(len(ts))
    chunk_of = np.repeat(np.arange(len(bids)), sizes)
    chunk_max = np.array([t.max() for t in np.split(ts, np.cumsum(
        sizes)[:-1])]) - EOWC_DELAY
    after = np.maximum.accumulate(chunk_max)
    before = np.concatenate([[np.iinfo(np.int64).min], after[:-1]])
    wm = int(after[-1])
    keep = (ts >= before[chunk_of]) & (ts < wm)
    a, p, t, r = auction[keep], price[keep], ts[keep], rid[keep]
    order = np.lexsort((r, t, a))
    a, p, t = a[order], p[order], t[order]
    n = len(a)
    idx = np.arange(n)
    new_part = np.r_[True, a[1:] != a[:-1]]
    start = np.maximum.accumulate(np.where(new_part, idx, 0))
    cum = np.cumsum(p)
    part_cum = cum - np.r_[0, cum][start]
    new_peer = new_part | np.r_[True, t[1:] != t[:-1]]
    peer = np.cumsum(new_peer) - 1
    peer_end = np.r_[np.nonzero(new_peer)[0][1:] - 1, n - 1]
    rs = part_cum[peer_end[peer]]
    return sorted(zip(a.tolist(), p.tolist(), t.tolist(), rs.tolist(),
                      (idx - start + 1).tolist())), wm


def run_eowc(device, bids) -> dict:
    """Phase 17: the EOWC running window over the host generator's bids
    (NEX_EPOCHS × NEX_CHUNKS_PER_EPOCH chunks, one warm-up epoch): RowIdGen
    → WatermarkFilter(date_time - 4 s) → Sort (row set on the card, B3) →
    EowcOverWindow(sum(price), row_number() per auction by date_time) →
    Project → Materialize; the MV equal to numpy's. Then the same run over
    state tables, every barrier a checkpoint, dropped after epoch 2 and
    recovered: the MV equal to the uninterrupted run's. Kernel B3's
    busiest input at the Sort's row set is returned."""
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.storage import MemoryStateStore
    from risingwave_tpu_torch.stream import eowc as eowc_mod
    plan = eowc_plan(device, epoch_source(BID_SCHEMA, bids),
                     MemoryStateStore())
    with captured_probe_inputs({
            "eowc Sort rows": "risingwave_tpu_torch.ops.row_set",
    }) as b3_inputs:
        b3_launches(reset=True)
        _, secs = asyncio.run(drive(plan.mv, 2))
        b3 = b3_launches()
    want, wm = eowc_expected(bids)
    if plan.watermark_filter.announced != wm:
        raise AssertionError(f"eowc_running: the final watermark "
                             f"{plan.watermark_filter.announced} differs "
                             f"from numpy's {wm}")
    got = sorted(r[:5] for r in plan.mv.rows())
    if got != want:
        raise AssertionError("eowc_running MV differs from numpy's running "
                             "sum and row number")
    uninterrupted = sorted(plan.mv.rows())
    max_live = plan.sort.max_live
    del plan

    store = MemoryStateStore()
    half = 2 * NEX_CHUNKS_PER_EPOCH
    plan = eowc_plan(device, epoch_source(BID_SCHEMA, bids[:half],
                                          checkpoint=True), store, True)
    ckpt_ms = []
    checkpoint = eowc_mod.rs_checkpoint

    def timed_checkpoint(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = checkpoint(*args)
        ckpt_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eowc_mod.rs_checkpoint = timed_checkpoint
    try:
        asyncio.run(drain_into(plan.mv, Drain(), store))
    finally:
        eowc_mod.rs_checkpoint = checkpoint
    del plan
    torch.cuda.empty_cache()
    b3_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = eowc_plan(device, epoch_source(BID_SCHEMA, bids[half:], 3, True),
                     store, True, row_id_start=half * CHUNK)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    recovery_b3 = b3_launches()
    asyncio.run(drain_into(plan.mv, Drain(), store))
    if sorted(plan.mv.rows()) != uninterrupted:
        raise AssertionError("eowc_running recovery: the MV differs from "
                             "the uninterrupted run's")
    timed_rows = (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"mv_rows": len(got), "final_watermark": wm,
            "source_rows_per_s": timed_rows / secs, "b3_launches": b3,
            "sort_capacity": EOWC_SORT_CAPACITY, "sort_max_live": max_live,
            "sort_checkpoint_ms": ckpt_ms, "recovery_s": recovery_s,
            "recovery_b3_launches": recovery_b3, "b3_inputs": b3_inputs}


def side_input_rows() -> list:
    """q13's side table: key 0..SIDE_INPUT_KEYS-1, a value drawn from the
    seed (the benchmark's side-input file is not in the repo)."""
    from risingwave_tpu_torch.stream.nexmark_plans import SIDE_INPUT_KEYS
    rng = np.random.default_rng(SEED)
    return [(k, f"side-{int(v)}") for k, v in
            enumerate(rng.integers(0, 1 << 30, SIDE_INPUT_KEYS))]


def run_q13(device, bids) -> dict:
    """Phase 18: q13 — the side table loaded through Values → Materialize
    into its StateTable, then bids → RowIdGen → Project(auction % 10000) →
    TemporalJoin → Project → Materialize over the host generator's bids;
    the MV equal to numpy's lookup."""
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import (
        Barrier, MaterializeExecutor, MockSource, ValuesExecutor,
    )
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    store = MemoryStateStore()
    side = side_input_rows()
    schema = plans.side_input_schema()
    table = StateTable(store, 2, schema, [0])
    load = MaterializeExecutor(ValuesExecutor(
        schema, side, MockSource(schema, [Barrier.new(1),
                                          Barrier.new(2, checkpoint=True)]),
        capacity=CHUNK, device=device), table)
    asyncio.run(drain_into(load, Drain(), store))
    plan = plans.q13(epoch_source(BID_SCHEMA, bids, first_epoch=3), table,
                     StateTable(store, 1, plans.q13_schema(), [5]),
                     out_capacity=CHUNK, device=device)
    _, secs = asyncio.run(drive(plan.mv, 2))
    auction, bidder, price, ts = host_cols(bids, (0, 1, 2, 5))
    values = [side[a % len(side)][1] for a in auction.tolist()]
    want = sorted(zip(auction.tolist(), bidder.tolist(), price.tolist(),
                      ts.tolist(), values))
    got = sorted(r[:5] for r in plan.mv.rows())
    if got != want:
        raise AssertionError("q13 MV differs from numpy's side-input lookup")
    timed_rows = (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"side_rows": len(side), "mv_rows": len(got),
            "source_rows_per_s": timed_rows / secs}


def dedup_plan(device, src, store, state_table: bool = False):
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.storage import StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    st = (StateTable(store, 2, plans.dedup_state_schema(), [0, 1])
          if state_table else None)
    return plans.dedup(src, StateTable(store, 1, BID_SCHEMA, [0, 1]),
                       table_capacity=DEDUP_TABLE_CAPACITY, state_table=st,
                       device=device)


def dedup_mv(plan) -> list:
    """(auction, bidder, price, date_time) of every MV row, sorted (the
    stored physical values: none of them is a string)."""
    return sorted((r[0], r[1], r[2], r[5])
                  for r in plan.mv.table.scan_all())


def check_first_wins(device) -> dict:
    """One chunk of CHUNK rows with many rows per key (300 keys of two
    columns, a tenth of the rows invalid, half the keys already in the
    table) through kernel B3 on each of its paths: ``is_new`` must fall on
    the lowest valid row of each absent key, and slots, flags and table
    must equal the plain version's."""
    from risingwave_tpu_torch.common import INT64
    from risingwave_tpu_torch.ops.hash_table import (
        ht_lookup_or_insert, ht_new,
    )
    rng = np.random.default_rng(SEED)
    keys = rng.integers(0, 300, CHUNK)
    valid = rng.random(CHUNK) < 0.9
    arrays = [(keys, np.ones(CHUNK, bool)), (keys % 7, keys % 5 != 0)]
    cols = _key_cols(arrays, device)
    table = ht_new((INT64, INT64), 1 << 12, device)
    old = np.arange(0, 300, 2)
    ht_lookup_or_insert(table, _key_cols(
        [(old, np.ones(len(old), bool)), (old % 7, old % 5 != 0)], device),
        torch.ones(len(old), dtype=torch.bool, device=device))
    first = np.zeros(CHUNK, bool)
    seen = set()
    for i in np.nonzero(valid)[0]:
        if keys[i] % 2 and keys[i] not in seen:
            first[i] = True
        seen.add(keys[i])
    valid_t = torch.as_tensor(valid, device=device)
    out = {}
    for path in B3_PATHS:
        err, _ = compare_hash_probe(table, cols, valid_t, "insert", path)
        _, _, is_new, _ = ht_lookup_or_insert(table.clone(), cols, valid_t,
                                              path=path)
        wrong = int((is_new.cpu().numpy() != first).sum())
        if err or wrong:
            raise AssertionError(f"B3 {path}: is_new off the lowest row on "
                                 f"{wrong} rows, {err} differences")
        out[path] = {"new_keys": int(first.sum()), "differences": 0}
    return out


def run_dedup(device) -> dict:
    """Phase 19: bids → AppendOnlyDedup(auction, bidder) → Materialize in
    bench form (the phase-9 device bids, DEDUP_TABLE_CAPACITY slots, one
    warm-up and FUSED_TIMED_EPOCHS timed epochs): the MV equal to numpy's
    first bid per pair; in-chunk duplicates through both B3 paths; then the
    same epochs over a state table, dropped after epoch 2 and recovered
    through B3: the same MV. Kernel B3's busiest input is returned."""
    from risingwave_tpu_torch.storage import MemoryStateStore
    sizes = [FUSED_CHUNKS_PER_EPOCH] * (1 + FUSED_TIMED_EPOCHS)
    plan = dedup_plan(device, DeviceBidSource(bench_gen(device), sizes, 1),
                      MemoryStateStore())
    with captured_probe_inputs({
            "dedup table": "risingwave_tpu_torch.stream.dedup",
    }) as b3_inputs:
        b3_launches(reset=True)
        _, secs = asyncio.run(drive(plan.mv, 2))
        b3 = b3_launches()
    auction, bidder, price, ts = bench_bids(device, sizes, (0, 1, 2, 5))
    _, first = np.unique(auction * (bidder.max() + 1) + bidder,
                         return_index=True)
    want = sorted(zip(auction[first].tolist(), bidder[first].tolist(),
                      price[first].tolist(), ts[first].tolist()))
    uninterrupted = dedup_mv(plan)
    if uninterrupted != want:
        raise AssertionError("dedup MV differs from numpy's first bid per "
                             "(auction, bidder)")
    load = int(plan.dedup.table.occupied.sum()) / DEDUP_TABLE_CAPACITY
    del plan
    first_wins = check_first_wins(device)

    store = MemoryStateStore()
    gen = bench_gen(device)
    plan = dedup_plan(device, DeviceBidSource(gen, sizes[:2], 1, True), store,
                      True)
    asyncio.run(drain_into(plan.mv, Drain(), store))
    del plan
    torch.cuda.empty_cache()
    b3_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = dedup_plan(device, DeviceBidSource(gen, sizes[2:], 3, True), store,
                      True)
    torch.cuda.synchronize()
    recovery_s = time.perf_counter() - t0
    recovery_b3 = b3_launches()
    asyncio.run(drain_into(plan.mv, Drain(), store))
    if dedup_mv(plan) != uninterrupted:
        raise AssertionError("dedup recovery: the MV differs from the "
                             "uninterrupted run's")
    timed_rows = FUSED_TIMED_EPOCHS * FUSED_CHUNKS_PER_EPOCH * CHUNK
    return {"mv_rows": len(want), "table_load": load,
            "source_rows_per_s": timed_rows / secs, "b3_launches": b3,
            "first_wins": first_wins, "recovery_s": recovery_s,
            "recovery_b3_launches": recovery_b3, "b3_inputs": b3_inputs}


async def collect(executor) -> list:
    """Every message ``executor`` emits, in order."""
    return [m async for m in executor.execute()]


def run_small_ops(device, bids) -> dict:
    """Phase 20: Expand (two subsets), ProjectSet(generate_series(1, price
    % 4)), Union of two bid sources with watermarks, Values and Now over
    ``bids`` (NEX_CHUNKS_PER_EPOCH chunks); each equal to numpy's."""
    from risingwave_tpu_torch.common import (
        INT64, StreamChunk, chunk_to_rows,
    )
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.expr import Literal, call, col
    from risingwave_tpu_torch.stream import (
        Barrier, ExpandExecutor, MockSource, NowExecutor, ProjectSetExecutor,
        TableFuncCall, UnionExecutor, ValuesExecutor, Watermark,
    )
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    out = {}
    # Expand: per chunk one chunk per subset, other columns nulled
    subsets = [(0, 2), (1, 5)]
    msgs = asyncio.run(collect(ExpandExecutor(
        MockSource(BID_SCHEMA, scripted(bids, len(bids))), subsets)))
    chunks = [m for m in msgs if isinstance(m, StreamChunk)]
    ok = torch.ones((), dtype=torch.bool, device=device)
    for j, src in enumerate(bids):
        for flag, subset in enumerate(subsets):
            got = chunks[2 * j + flag]
            ok &= (got.vis == src.vis).all() & (
                got.columns[-1].data == flag).all()
            for ci, c in enumerate(src.columns):
                g = got.columns[ci]
                keep = c.mask if ci in subset else torch.zeros_like(c.mask)
                ok &= (g.mask == keep).all() & (
                    ~keep | (g.data == c.data)).all()
    if len(chunks) != 2 * len(bids) or not bool(ok):
        raise AssertionError("Expand differs from its subsets")
    out["expand_chunks"] = len(chunks)
    # ProjectSet: generate_series(1, price % 4) per bid, element index kept
    ps = ProjectSetExecutor(
        MockSource(BID_SCHEMA, scripted(bids, len(bids))),
        [col(0, INT64), TableFuncCall("generate_series", (
            Literal(1, INT64), call("modulus", col(2, INT64),
                                    Literal(4, INT64)))),
         Literal(0, INT64)], ("auction", "g", "_pidx"), out_capacity=CHUNK,
        device=device)
    t0 = time.perf_counter()
    drain = Drain()
    for m in asyncio.run(collect(ps)):
        if isinstance(m, StreamChunk):
            drain.add(m)
    ps_s = time.perf_counter() - t0
    auction, price = host_cols(bids, (0, 2))
    m = price % 4
    g = np.concatenate([np.arange(1, k + 1) for k in m.tolist()])
    rows = np.stack([np.repeat(auction, m), g, g - 1], 1)
    if drain.multiset() != counter_of(rows, np.ones(len(rows), np.int64)):
        raise AssertionError("ProjectSet differs from numpy's series")
    out["project_set_rows"] = len(rows)
    out["project_set_rows_per_s"] = len(auction) / ps_s
    # Union: two bid sources with watermarks; the minimum goes on
    half = len(bids) // 2
    srcs, last = [], []
    for part, lag in ((bids[:half], 1_000_000), (bids[half:], 3_000_000)):
        msgs, wm = [Barrier.new(1)], None
        for i, c in enumerate(part):
            wm = int(c.columns[5].data.max()) - lag
            msgs += [c, Watermark(5, wm), Barrier.new(i + 2)]
        srcs.append(MockSource(BID_SCHEMA, msgs))
        last.append(wm)
    drain = Drain()
    wms = []
    for m in asyncio.run(collect(UnionExecutor(srcs))):
        if isinstance(m, StreamChunk):
            drain.add(m)
        elif isinstance(m, Watermark):
            wms.append(m.value)
    whole = Drain()
    for c in bids:
        whole.add(c)
    if drain.multiset() != whole.multiset() or wms != sorted(set(wms)) \
            or wms[-1] != min(last):
        raise AssertionError("Union differs from its inputs or watermarks")
    out["union_watermarks"] = len(wms)
    # Values and Now
    side = side_input_rows()[:CHUNK]
    barriers = MockSource(BID_SCHEMA, [Barrier.new(e) for e in (1, 2, 3)])
    vals = [r for m in asyncio.run(collect(ValuesExecutor(
        plans.side_input_schema(), side, barriers, capacity=CHUNK,
        device=device))) if isinstance(m, StreamChunk)
        for r in chunk_to_rows(m, plans.side_input_schema())]
    now_ex = NowExecutor(MockSource(BID_SCHEMA, [
        Barrier.new(e) for e in (1, 2, 3)]), device=device)
    now = asyncio.run(collect(now_ex))
    now_rows = [chunk_to_rows(m, now_ex.schema, with_ops=True, physical=True)
                for m in now if isinstance(m, StreamChunk)]
    if vals != side or [m.value for m in now if isinstance(m, Watermark)] \
            != [1_000_000, 2_000_000, 3_000_000] or now_rows[1] != [
                (2, (1_000_000,)), (3, (2_000_000,))]:
        raise AssertionError("Values or Now differ from their rows")
    out["values_rows"] = len(vals)
    return out


# ---------------------------------------------------------------------------
# phase 21: TPC-H q3 and q10 as streaming MVs over tables, under TPC-H's
# refresh functions
# ---------------------------------------------------------------------------

#: the scale factor: on an H100 SF 0.25 takes about 70 s, so SF 1 would
#: take about 280 s, more than the phase's ~4 minutes; halved once
#: (PERF.md section 4)
TPCH_SF = 0.25
TPCH_SEED = 7
TPCH_LOAD_CHUNKS_PER_EPOCH = 64      # DML chunks of CHUNK rows per epoch
TPCH_REFRESH_PAIRS = 2               # RF1 epochs, then as many RF2 epochs
TPCH_NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT",
                "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA",
                "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO",
                "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
                "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES")
TPCH_SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                 "HOUSEHOLD")
TPCH_START, TPCH_END = 8035, 10440   # 1992-01-01, 1998-08-02 (o_orderdate)
TPCH_CURRENT = 9298                  # 1995-06-17: R/A or N by receipt date


def tpch_text(rng, n: int, lo: int, hi: int, alphabet: bytes) -> list:
    """n random strings of lengths in [lo, hi] over ``alphabet``."""
    lens = rng.integers(lo, hi + 1, n)
    chars = np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), (n, hi))]
    return [bytes(row[:k]).decode() for row, k in zip(chars, lens)]


def tpch_orders(rng, keys: np.ndarray, n_cust: int) -> dict:
    """Orders with these keys and their lineitems (TPC-H 3.0.1 4.2.3):
    o_custkey uniform over the customers, never a multiple of 3;
    o_orderdate uniform in [1992-01-01, 1998-08-02]; 1-7 lineitems, each
    l_quantity 1-50 of part l_partkey at its retail price, l_discount
    0.00-0.10, l_shipdate o_orderdate + 1-121 days, receipt l_shipdate +
    1-30 days, l_returnflag R or A if received by 1995-06-17, else N.
    DECIMAL columns are their scaled int64 (cents); VARCHAR ids."""
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT as sd
    n = len(keys)
    cust = rng.integers(1, n_cust + 1, n)
    cust = np.where(cust % 3 == 0, np.maximum(cust - 1, 1), cust)
    date = rng.integers(TPCH_START, TPCH_END + 1, n).astype(np.int32)
    per = rng.integers(1, 8, n)
    o_idx = np.repeat(np.arange(n), per)
    m = len(o_idx)
    line = np.arange(m) - np.repeat(np.cumsum(per) - per, per) + 1
    part = rng.integers(1, max(int(200_000 * n_cust / 150_000), 1) + 1, m)
    retail = 90000 + (part // 10) % 20001 + 100 * (part % 1000)
    price = rng.integers(1, 51, m) * retail
    disc = rng.integers(0, 11, m)
    ship = date[o_idx] + rng.integers(1, 122, m).astype(np.int32)
    receipt = ship + rng.integers(1, 31, m)
    ra = np.array([sd.intern("R"), sd.intern("A")], np.int32)
    flag = np.where(receipt <= TPCH_CURRENT, ra[rng.integers(0, 2, m)],
                    sd.intern("N")).astype(np.int32)
    return {"orders": [keys, cust, date, np.zeros(n, np.int64)],
            "lineitem": [keys[o_idx], line, price, disc, ship, flag]}


def tpch_tables(sf: float, seed: int) -> dict:
    """The four tables at scale factor ``sf`` as numpy columns in their
    schemas' order (``stream/tpch_plans.TABLES``): customer SF x 150,000,
    orders SF x 1,500,000 (keys sparse, 8 of every 32), lineitem 1-7 per
    order, nation 25. c_address, c_phone and c_comment are random text of
    the specified lengths (the comment not from the grammar)."""
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT as sd
    rng = np.random.default_rng(seed)
    n_cust, n_ord = int(150_000 * sf), int(1_500_000 * sf)
    ck = np.arange(1, n_cust + 1, dtype=np.int64)
    nation = rng.integers(0, 25, n_cust)
    alnum = b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    ids = lambda strs: np.fromiter(map(sd.intern, strs), np.int32,
                                   len(strs))
    phone = [f"{c + 10:02d}-{a:03d}-{b:03d}-{d:04d}" for c, a, b, d in zip(
        nation, rng.integers(100, 1000, n_cust),
        rng.integers(100, 1000, n_cust), rng.integers(1000, 10000, n_cust))]
    seg = np.array([sd.intern(s) for s in TPCH_SEGMENTS], np.int32)
    tables = {
        "customer": [ck, ids([f"Customer#{k:09d}" for k in ck]),
                     ids(tpch_text(rng, n_cust, 10, 40, alnum)),
                     nation.astype(np.int64), ids(phone),
                     rng.integers(-99999, 1_000_000, n_cust),
                     seg[rng.integers(0, 5, n_cust)],
                     ids(tpch_text(rng, n_cust, 29, 116,
                                   b"abcdefghijklmnopqrstuvwxyz     "))],
        "nation": [np.arange(25, dtype=np.int64),
                   np.array([sd.intern(s) for s in TPCH_NATIONS], np.int32)],
    }
    j = np.arange(n_ord, dtype=np.int64)
    tables.update(tpch_orders(rng, (j // 8) * 32 + j % 8 + 1, n_cust))
    return tables


def tpch_refresh(rng, k: int, sf: float, tables: dict,
                 n: int = None) -> tuple:
    """Refresh pair ``k``: RF1's ``n`` (SF x 1,500) new orders (keys from
    slots 8-15 of every 32, unused by the load) with their lineitems, and
    the orders RF2 deletes (the k-th ``n`` loaded orders in key order) with
    theirs."""
    n = n or int(1500 * sf)
    j = np.arange(k * n, (k + 1) * n, dtype=np.int64)
    new = tpch_orders(rng, (j // 8) * 32 + 8 + j % 8 + 1,
                      int(150_000 * sf))
    gone = tables["orders"][0][k * n:(k + 1) * n]
    return new, gone


def tpch_revenue(keys: np.ndarray, revenue: np.ndarray) -> dict:
    """{key: summed revenue}, exactly in int64."""
    uniq, inv = np.unique(keys, return_inverse=True)
    sums = np.zeros(len(uniq), np.int64)
    np.add.at(sums, inv.reshape(-1), revenue)
    return dict(zip(uniq.tolist(), sums.tolist()))


def tpch_q3(t: dict) -> dict:
    """numpy q3 over the live tables: {(o_orderkey, o_orderdate,
    o_shippriority): revenue at scale 4}."""
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT as sd
    from risingwave_tpu_torch.stream.tpch_plans import Q3_DATE
    c, o, l = t["customer"], t["orders"], t["lineitem"]
    om = (o[2] < Q3_DATE) & np.isin(o[1], c[0][c[6] == sd.intern("BUILDING")])
    lm = (l[4] > Q3_DATE) & np.isin(l[0], o[0][om])
    date = dict(zip(o[0][om].tolist(), o[2][om].tolist()))
    prio = dict(zip(o[0][om].tolist(), o[3][om].tolist()))
    return {(k, date[k], prio[k]): v for k, v in tpch_revenue(
        l[0][lm], l[2][lm] * (100 - l[3][lm])).items()}


def tpch_q10(t: dict) -> dict:
    """numpy q10 over the live tables: {(c_custkey, c_name id, n_name id):
    revenue at scale 4}."""
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT as sd
    from risingwave_tpu_torch.stream.tpch_plans import Q10_FROM, Q10_TO
    c, o, l, nat = (t[k] for k in ("customer", "orders", "lineitem",
                                   "nation"))
    om = (o[2] >= Q10_FROM) & (o[2] < Q10_TO)
    lm = (l[5] == sd.intern("R")) & np.isin(l[0], o[0][om])
    cust = dict(zip(o[0][om].tolist(), o[1][om].tolist()))
    name = dict(zip(c[0].tolist(), c[1].tolist()))
    nkey = dict(zip(c[0].tolist(), c[3].tolist()))
    nname = dict(zip(nat[0].tolist(), nat[1].tolist()))
    lc = np.array([cust[k] for k in l[0][lm].tolist()], np.int64)
    return {(k, name[k], nname[nkey[k]]): v for k, v in tpch_revenue(
        lc, l[2][lm] * (100 - l[3][lm])).items()}


def tpch_mv(cl, name: str) -> dict:
    """An MV's rows as {group: revenue} in ``tpch_q3``'s or ``tpch_q10``'s
    form, from its state table's physical rows."""
    rows = cl.jobs[name].table.scan_all()
    if name == "q3":
        return {(r[0], r[2], r[3]): r[1] for r in rows}
    return {(r[0], r[1], r[3]): r[2] for r in rows}


def tpch_gate(cl, live: dict, when: str) -> dict:
    """Both MVs against numpy over ``live``; their group counts."""
    out = {}
    for name, fn in (("q3", tpch_q3), ("q10", tpch_q10)):
        got, want = tpch_mv(cl, name), fn(live)
        if got != want:
            bad = sorted(set(got.items()) ^ set(want.items()))[:3]
            raise AssertionError(
                f"TPC-H {name} after {when} differs from numpy: "
                f"{len(got)} groups against {len(want)}; e.g. {bad}")
        if not want:
            raise AssertionError(f"TPC-H {name} after {when} is empty")
        out[name] = len(want)
    return out


def tpch_chunks(schema, cols, op: int, device, capacity: int = None) -> list:
    """DML chunks of ``capacity`` (CHUNK) rows from numpy columns of
    physical values, every row with op ``op``."""
    from risingwave_tpu_torch.common import Column, StreamChunk
    cap = capacity or CHUNK
    n = len(cols[0])
    out = []
    for lo in range(0, n, cap):
        k = min(cap, n - lo)
        vis = torch.zeros(cap, dtype=torch.bool)
        vis[:k] = True
        data = []
        for f, c in zip(schema, cols):
            d = torch.zeros(cap, dtype=f.type.dtype)
            d[:k] = torch.from_numpy(np.ascontiguousarray(
                c[lo:lo + k]).astype(f.type.np_dtype))
            data.append(Column(d.to(device), vis.to(device)))
        out.append(StreamChunk(torch.full((cap,), op, dtype=torch.int8,
                                          device=device),
                               vis.to(device), tuple(data)))
    return out


def tpch_sizes(sf: float):
    """The q3 and q10 capacities at scale factor ``sf``, sized so that no
    join and no agg grows (load at most ~0.5): keys of each join and its
    bucket width (the largest group of rows of one key on either side)."""
    from risingwave_tpu_torch.stream.tpch_plans import Sizes

    def pow2(n):
        return 1 << max(int(np.ceil(np.log2(max(n, 16)))), 4)

    cust, orders = 150_000 * sf, 1_500_000 * sf
    q3 = Sizes(joins=((pow2(2 * cust), 64), (pow2(orders), 8)),
               agg_capacity=pow2(2 * 0.05 * orders), out_capacity=CHUNK)
    # q10's last join: 25 nation keys, each with ~0.08 x orders / 25 rows
    # on the left
    q10 = Sizes(joins=((pow2(2 * cust), 16), (pow2(orders), 8),
                       (64, pow2(1.5 * 0.08 * orders / 25))),
                agg_capacity=pow2(2 * 0.5 * cust), out_capacity=CHUNK)
    return q3, q10


def run_tpch(device, sf: float = None, seed: int = TPCH_SEED,
             refresh_pairs: int = TPCH_REFRESH_PAIRS) -> dict:
    """Load the four tables through DML, create and backfill q3 and q10,
    run the refresh functions (RF1s, then RF2s; one per epoch, every
    barrier a checkpoint); both MVs gated against numpy after the backfill,
    the RF1s and the RF2s. Kernel B1's and B3's launches counted from the
    load to the last refresh, their busiest inputs kept."""
    from risingwave_tpu_torch.frontend.runtime import Cluster
    from risingwave_tpu_torch.stream import tpch_plans as tp
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    sf = TPCH_SF if sf is None else sf
    t0 = time.perf_counter()
    live = tpch_tables(sf, seed)
    gen_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 1)
    refresh = [tpch_refresh(rng, k, sf, live) for k in range(refresh_pairs)]
    q3_sizes, q10_sizes = tpch_sizes(sf)
    cl = Cluster(device=device, chunk_capacity=CHUNK)
    tp.create_tables(cl)
    out = {"sf": sf, "seed": seed, "generate_s": gen_s,
           "rows": {k: len(v[0]) for k, v in live.items()},
           "batch_rows": cl.batch_rows}
    torch.cuda.reset_peak_memory_stats()
    with busiest_rank_input() as b1_input, captured_probe_inputs({
            "TPC-H join keys": "risingwave_tpu_torch.ops.join_state",
            "TPC-H HashAgg groups": "risingwave_tpu_torch.ops.grouped_agg",
    }) as b3_inputs:
        b3_launches(reset=True)
        rt_mod.rank_totals.launches = 0
        # load: DML chunks of CHUNK rows, TPCH_LOAD_CHUNKS_PER_EPOCH each
        # epoch, every barrier a checkpoint
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for name, cols in live.items():
            schema = tp.TABLES[name][0]
            chunks = tpch_chunks(schema, cols, 0, device)
            for i, ch in enumerate(chunks):
                cl.write(name, ch)
                if (i + 1) % TPCH_LOAD_CHUNKS_PER_EPOCH == 0:
                    cl.tick()
            cl.tick()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_rows = sum(out["rows"].values())
        out.update(load_s=load_s, load_rows_per_s=n_rows / load_s)
        # backfill each MV to its end, one after the other
        out["backfill"] = {}
        for name, create in (("q3", tp.create_q3), ("q10", tp.create_q10)):
            t0 = time.perf_counter()
            create(cl, q3_sizes if name == "q3" else q10_sizes)
            barriers = 0
            while not cl.backfill_done(name):
                cl.tick()
                barriers += 1
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            read = sum(bf.rows_done for bf in cl.backfills[name])
            out["backfill"][name] = {"rows": read, "s": secs,
                                     "rows_per_s": read / secs,
                                     "barriers": barriers}
        out["gate_backfill"] = tpch_gate(cl, live, "the backfill")
        # the refresh functions, one per epoch: staleness is the time from
        # the DML push to the barrier after it completing on both MVs. The
        # refresh's chunks are built, and the gate's numpy mirror of the
        # tables updated, before the clock starts.
        out["refresh"] = []
        for kind in ("RF1", "RF2"):
            for k, (new, gone) in enumerate(refresh):
                staged = []
                if kind == "RF1":
                    for name in ("orders", "lineitem"):
                        staged.append((name, tpch_chunks(
                            tp.TABLES[name][0], new[name], 0, device)))
                        live[name] = [np.concatenate([a, b]) for a, b in
                                      zip(live[name], new[name])]
                    rows = sum(len(new[n][0]) for n in new)
                else:
                    rows = 0
                    for name, key in (("orders", live["orders"][0]),
                                      ("lineitem", live["lineitem"][0])):
                        sel = np.isin(key, gone)
                        staged.append((name, tpch_chunks(
                            tp.TABLES[name][0],
                            [c[sel] for c in live[name]], 1, device)))
                        live[name] = [c[~sel] for c in live[name]]
                        rows += int(sel.sum())
                if kind == "RF1" and k == 0:
                    prof_ctx = profiled()
                else:
                    prof_ctx = contextlib.nullcontext()
                with prof_ctx as prof:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for name, chunks in staged:
                        for ch in chunks:
                            cl.write(name, ch)
                    t1 = time.perf_counter()
                    cl.tick()
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                epoch_s = t2 - t1
                ms = (t2 - t0) * 1e3
                out["refresh"].append({"kind": kind, "rows": rows,
                                       "staleness_ms": ms,
                                       "checkpoint_ms": cl.last_commit_s
                                       * 1e3, "profiled": prof is not None})
                if prof is not None:
                    out["refresh_epoch_trace"] = trace_summary(
                        prof, epoch_s, rows)
            out[f"gate_{kind}"] = tpch_gate(cl, live, f"the {kind}s")
        torch.cuda.synchronize()
        out["b1_launches"] = rt_mod.rank_totals.launches
        out["b3_launches"] = b3_launches()
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["b1_busiest_keyed_rows"] = b1_input.get("keyed_rows")
    out["b1_input"] = b1_input
    out["b3_inputs"] = dict(b3_inputs)
    cl.close()
    return out


# ---------------------------------------------------------------------------
# phase 22: the rest of the NEXmark suite, q17 as a multi-fragment job into
# a sink, and q20's join as a fragmented join
# ---------------------------------------------------------------------------

EXT_QUERIES = ("q0", "q9", "q10", "q14", "q15", "q16", "q17", "q20", "q21",
               "q22", "q101", "q103", "q104", "q106")
EXT_JOINS = ("q9", "q20", "q101", "q103", "q104", "q106")
#: MV pks that are not the hidden ``_pk`` columns
EXT_PK = {"q15": [0], "q16": [0, 1], "q17": [0, 1], "q106": []}
# q17 as a multi-fragment job: 4 agg actors, recovered at 2; the sink
# degrades after two failed epochs (a fast retry: 2 attempts, 0.5 ms)
Q17_PARALLELISM = 4
Q17_RECOVERY_PARALLELISM = 2
SINK_DEGRADE_AFTER = 2
# q9's GroupTopN holds every join row inside its auction's window (3.67M
# over the phase's chunks), so its row set is larger than q105's TopN: at
# 1<<22 (load 0.88) linear probing ran past its 128 rounds
Q9_TOPN_CAPACITY = 1 << 23
# q20's join as 4 actors: each holds a quarter of the 1<<16 keys, at the
# single join's bucket width. Every actor gets every chunk (masked to its
# shard), and a join stages ``emit_batch`` passes of N x (2W + 1) output
# lanes (~1.5 GB each here) before its one read: at the default 16, four
# actors ran the card out of its 80 GB, so each stages 4
Q20_PARALLELISM = 4
Q20_EMIT_BATCH = 4
USECS_PER_MIN = 60_000_000
USECS_PER_DAY = 86_400_000_000


def decode(ids: np.ndarray) -> np.ndarray:
    """Dictionary ids as an object array of their strings."""
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT
    uniq, inv = np.unique(ids, return_inverse=True)
    strs = np.array([GLOBAL_STRING_DICT.lookup(int(u)) for u in uniq]
                    + [""], dtype=object)[:-1]
    return strs[inv.reshape(-1)]


def civil(ts: np.ndarray, unit: int, fmt) -> np.ndarray:
    """``fmt(datetime)`` of each timestamp floored to ``unit``, formatted
    once per distinct value."""
    import datetime
    epoch = datetime.datetime(1970, 1, 1)
    floors = ts // unit
    uniq, inv = np.unique(floors, return_inverse=True)
    strs = np.array([fmt(epoch + datetime.timedelta(microseconds=int(u)
                                                     * unit)) for u in uniq]
                    + [""], dtype=object)[:-1]
    return strs[inv.reshape(-1)]


class ExtData:
    """Both sources' generated rows on the host, and the numpy and Python
    recomputations of the extended queries over them (MV rows as python
    values, the hidden pk columns left out)."""

    def __init__(self, auctions, bids):
        (self.b_auction, self.b_bidder, self.b_price, ch, url,
         self.b_ts) = host_cols(bids, (0, 1, 2, 3, 4, 5))
        (self.a_id, item, self.a_ts, self.a_exp, self.a_seller,
         self.a_cat) = host_cols(auctions, (0, 1, 5, 6, 7, 8))
        self.b_channel, self.b_url = decode(ch), decode(url)
        self.a_item = decode(item)
        self.day = civil(self.b_ts, USECS_PER_DAY,
                         lambda d: f"{d.year:04d}-{d.month:02d}-{d.day:02d}")
        self.hhmi = civil(self.b_ts, USECS_PER_MIN,
                          lambda d: f"{(d.hour % 12) or 12:02d}:"
                                    f"{d.minute:02d}")
        self._pairs = None
        self._expected: dict = {}

    def pairs(self):
        """(auction row, bid row) index pairs of auction.id = bid.auction."""
        if self._pairs is None:
            order = np.argsort(self.b_auction, kind="stable")
            keys = self.b_auction[order]
            lo = np.searchsorted(keys, self.a_id, "left")
            counts = np.searchsorted(keys, self.a_id, "right") - lo
            a_idx = np.repeat(np.arange(len(self.a_id)), counts)
            first = np.cumsum(counts) - counts
            pos = np.arange(counts.sum()) - first[a_idx] + lo[a_idx]
            self._pairs = (a_idx, order[pos])
        return self._pairs

    def windowed(self):
        """The pairs whose bid lies in its auction row's [date_time,
        expires]."""
        a, b = self.pairs()
        keep = (self.b_ts[b] >= self.a_ts[a]) & (self.b_ts[b] <= self.a_exp[a])
        return a[keep], b[keep]

    def n_bids(self) -> dict:
        ids, n = np.unique(self.b_auction, return_counts=True)
        return dict(zip(ids.tolist(), n.tolist()))

    @staticmethod
    def rows(*cols) -> collections.Counter:
        return collections.Counter(zip(*(
            c.tolist() if isinstance(c, np.ndarray) and c.dtype != object
            else list(c) for c in cols)))

    def expected(self, name: str):
        """The MV rows of query ``name``, computed once."""
        if name not in self._expected:
            self._expected[name] = self.recompute(name)
        return self._expected[name]

    def recompute(self, name: str):
        b = (self.b_auction, self.b_bidder, self.b_price)
        if name == "q0":
            return self.rows(*b, self.b_ts)
        if name == "q10":
            return self.rows(*b, self.b_ts, self.day, self.hhmi)
        if name == "q14":
            p = 908 * self.b_price // 1000
            k = p > 1000
            hour = (self.b_ts[k] // 3_600_000_000) % 24
            kind = np.where((hour >= 8) & (hour <= 18), "dayTime",
                            np.where((hour <= 6) | (hour >= 20),
                                     "nightTime", "otherTime")).astype(object)
            return self.rows(self.b_auction[k], self.b_bidder[k], p[k], kind,
                             self.b_ts[k])
        if name == "q15":
            return self.q15()
        if name == "q16":
            return self.q16()
        if name == "q17":
            return self.q17()
        if name == "q20":
            a, bi = self.pairs()
            k = self.a_cat[a] == 10
            a, bi = a[k], bi[k]
            return self.rows(self.b_auction[bi], self.b_bidder[bi],
                             self.b_price[bi], self.b_channel[bi],
                             self.a_item[a], self.a_seller[a], self.a_cat[a])
        if name == "q21":
            return self.q21()
        if name == "q22":
            def part(u, n):
                ps = u.split("/")
                return ps[n - 1] if n - 1 < len(ps) else ""
            uniq, inv = np.unique(self.b_url, return_inverse=True)
            dirs = [np.array([part(u, n) for u in uniq] + [""],
                             dtype=object)[:-1][inv.reshape(-1)]
                    for n in (4, 5, 6)]
            return self.rows(*b, self.b_channel, *dirs)
        if name == "q101":
            best: dict = {}
            order = np.lexsort((self.b_price, self.b_auction))
            last = np.r_[self.b_auction[order][1:] != self.b_auction[order][:-1],
                         True]
            best = dict(zip(self.b_auction[order][last].tolist(),
                            self.b_price[order][last].tolist()))
            return collections.Counter(
                (i, it, best.get(i)) for i, it in zip(self.a_id.tolist(),
                                                      self.a_item))
        if name in ("q103", "q104"):
            n = self.n_bids()
            keep = ((lambda c: c >= 2) if name == "q103"
                    else (lambda c: not 0 < c < 2))
            return collections.Counter(
                (i, it) for i, it in zip(self.a_id.tolist(), self.a_item)
                if keep(n.get(i, 0)))
        if name == "q106":
            a, bi = self.windowed()
            ids = self.a_id[a]
            final = {}
            for i, p in zip(ids.tolist(), self.b_price[bi].tolist()):
                if p > final.get(i, -1):
                    final[i] = p
            return collections.Counter({(min(final.values()),): 1})
        raise KeyError(name)

    def q9(self) -> dict:
        """id -> (price, date_time, tied bidders, item names of the id)."""
        a, bi = self.windowed()
        order = np.lexsort((self.b_ts[bi], -self.b_price[bi], self.a_id[a]))
        ids = self.a_id[a][order]
        price, ts = self.b_price[bi][order], self.b_ts[bi][order]
        bidder = self.b_bidder[bi][order]
        first = np.r_[True, ids[1:] != ids[:-1]]
        head = np.cumsum(first) - 1
        starts = np.nonzero(first)[0]
        tied = ((price == price[starts][head]) & (ts == ts[starts][head]))
        names: dict = {}
        for i, it in zip(self.a_id.tolist(), self.a_item):
            names.setdefault(i, set()).add(it)
        win = {int(ids[j]): [(int(price[j]), int(ts[j])), set(),
                             names[int(ids[j])]] for j in starts.tolist()}
        for i, b in zip(ids[tied].tolist(), bidder[tied].tolist()):
            win[i][1].add(b)
        return win

    def q15(self):
        out = collections.Counter()
        p = self.b_price
        for day in np.unique(self.day):
            m = self.day == day
            r1, r3 = m & (p < 10_000), m & (p >= 1_000_000)
            r2 = m & (p >= 10_000) & (p < 1_000_000)
            out[(day, int(m.sum()), int(r1.sum()), int(r2.sum()),
                 int(r3.sum()), len(np.unique(self.b_bidder[m])),
                 len(np.unique(self.b_bidder[r1])),
                 len(np.unique(self.b_auction[m])),
                 len(np.unique(self.b_auction[r3])))] += 1
        return out

    def q16(self):
        out = collections.Counter()
        keys = np.char.add(self.b_channel.astype(str),
                           np.char.add("\t", self.day.astype(str)))
        for key in np.unique(keys):
            m = keys == key
            ch, day = str(key).split("\t")
            out[(ch, day, max(self.hhmi[m]), int(m.sum()),
                 int((m & (self.b_price < 10_000)).sum()),
                 len(np.unique(self.b_bidder[m])),
                 len(np.unique(self.b_auction[m])))] += 1
        return out

    def q17(self):
        days = self.b_ts // USECS_PER_DAY
        keys = np.stack([self.b_auction, days], 1)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        g = len(uniq)
        n = np.bincount(inv, minlength=g)
        rank1 = np.bincount(inv, weights=self.b_price < 10_000,
                            minlength=g).astype(np.int64)
        lo = np.full(g, np.iinfo(np.int64).max)
        hi = np.full(g, np.iinfo(np.int64).min)
        total = np.zeros(g, np.int64)
        np.minimum.at(lo, inv, self.b_price)
        np.maximum.at(hi, inv, self.b_price)
        np.add.at(total, inv, self.b_price)
        day_of = {}
        for d, s in zip(days.tolist(), self.day):
            day_of[d] = s
        return collections.Counter(
            (int(a), day_of[int(d)], int(c), int(r), int(mn), int(mx),
             int(s) / int(c), int(s))
            for (a, d), c, r, mn, mx, s in zip(uniq, n, rank1, lo, hi,
                                               total))

    def q21(self):
        import re
        rx = re.compile(r"(&|^)channel_id=([^&]*)")
        known = {"apple": "0", "google": "1", "facebook": "2",
                 "baidu": "3"}
        uniq, inv = np.unique(self.b_url, return_inverse=True)
        ids = []
        for u in uniq:
            m = rx.search(u)
            ids.append(None if m is None else m.group(2))
        from_url = np.array(ids + [None], dtype=object)[:-1][
            inv.reshape(-1)]
        out = collections.Counter()
        for row in zip(self.b_auction.tolist(), self.b_bidder.tolist(),
                       self.b_price.tolist(), self.b_channel, from_url):
            cid = known.get(row[3].lower(), row[4])
            if cid is not None:
                out[row[:4] + (cid,)] += 1
        return out


def ext_plan(name: str, device, auctions, bids, store=None):
    """A fresh plan of one extended query over these chunks at q105's
    capacities (join 1<<16 keys × bucket width 2048, agg 1<<19; q9's
    GroupTopN Q9_TOPN_CAPACITY)."""
    from risingwave_tpu_torch.connector import AUCTION_SCHEMA, BID_SCHEMA
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    store = MemoryStateStore() if store is None else store
    schema = getattr(plans, f"{name}_schema")()
    pk = EXT_PK.get(name, [i for i, f in enumerate(schema)
                           if f.name.startswith("_pk")])
    mv = StateTable(store, 1, schema, pk)
    bid = epoch_source(BID_SCHEMA, bids)
    join = dict(key_capacity=Q105_KEY_CAPACITY,
                bucket_width=Q105_BUCKET_WIDTH, out_capacity=CHUNK,
                device=device)
    build = getattr(plans, name)
    if name in ("q0", "q10", "q14", "q21", "q22"):
        return build(bid, mv, device=device)
    if name in ("q15", "q16"):
        return build(bid, mv, out_capacity=CHUNK, device=device)
    if name == "q17":
        return build(bid, mv, agg_capacity=Q105_AGG_CAPACITY,
                     out_capacity=CHUNK, device=device)
    auction = epoch_source(AUCTION_SCHEMA, auctions)
    if name == "q9":
        return build(auction, bid, mv, topn_capacity=Q9_TOPN_CAPACITY,
                     **join)
    if name == "q20":
        return build(bid, auction, mv, **join)
    return build(auction, bid, mv, agg_capacity=Q105_AGG_CAPACITY, **join)


async def drive_timed(executor) -> float:
    """Run ``executor`` to its end; seconds after its second barrier (the
    warm-up epoch's end), the card synchronized at both ends."""
    from risingwave_tpu_torch.stream import Barrier
    seen, t0 = 0, None
    async for m in executor.execute():
        if isinstance(m, Barrier):
            seen += 1
            if seen == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mv_visible(mv) -> collections.Counter:
    """An MV's rows without the hidden ``_pk`` columns."""
    width = sum(not f.name.startswith("_pk") for f in mv.schema)
    return collections.Counter(r[:width] for r in mv.rows())


def check_q9(got: collections.Counter, want: dict) -> None:
    """q9: one row per auction id, its winning bid's (price, date_time)
    exact, its bidder among the bids tied on both, its item_name among the
    id's auction rows' (item_name is not determined by the order)."""
    if sum(got.values()) != len(want) or len(got) != len(want):
        raise AssertionError(f"q9 holds {sum(got.values())} rows, numpy "
                             f"{len(want)} auction ids")
    for (i, item, auction, bidder, price, ts), n in got.items():
        key, bidders, names = want[i]
        if (n != 1 or auction != i or (price, ts) != key
                or bidder not in bidders or item not in names):
            raise AssertionError(f"q9 row of id {i} differs from numpy's "
                                 f"winning bid {key}")


def run_nexmark_extended(device, auctions, bids, data: ExtData) -> dict:
    """Phase 22 (a): the fourteen queries, each a fresh plan over the
    phase-13 chunks (one warm-up and three timed epochs of 16 chunks per
    source leaf), each MV gated against ``data``'s recomputation. Kernel
    B1's busiest input over q9 and q20 and B3's busiest input at q17's
    group table are returned under ``b1_input`` and ``b3_inputs``."""
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    out = {}
    b3_inputs = {}
    b1_input = None
    for name in EXT_QUERIES:
        torch.cuda.empty_cache()
        plan = ext_plan(name, device, auctions, bids)
        with contextlib.ExitStack() as watch:
            b1 = (watch.enter_context(busiest_rank_input())
                  if name in ("q9", "q20") else None)
            b3 = (watch.enter_context(captured_probe_inputs({
                "q17 HashAgg groups":
                    "risingwave_tpu_torch.ops.grouped_agg"}))
                  if name == "q17" else None)
            b3_launches(reset=True)
            rt_mod.rank_totals.launches = 0
            t0 = time.perf_counter()
            secs = asyncio.run(drive_timed(plan.mv))
            wall = time.perf_counter() - t0
            launches = (rt_mod.rank_totals.launches, b3_launches())
        if b3 is not None:
            b3_inputs.update(b3)
        if b1 is not None and (b1_input is None
                               or b1["keyed_rows"] > b1_input["keyed_rows"]):
            b1_input = dict(b1, query=name)
        if plan.join is not None and (
                plan.join.core.W != Q105_BUCKET_WIDTH
                or plan.join.core.capacity != Q105_KEY_CAPACITY):
            raise AssertionError(f"the {name} join grew: size it larger")
        t1 = time.perf_counter()
        got = mv_visible(plan.mv)
        if name == "q9":
            check_q9(got, data.q9())
        else:
            want = data.expected(name)
            if got != want:
                raise AssertionError(
                    f"{name} MV differs from numpy's: "
                    f"{sum((got - want).values())} extra, "
                    f"{sum((want - got).values())} missing rows")
        leaves = 2 if name in EXT_JOINS else 1
        timed_rows = leaves * (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
        out[name] = {"source_rows_per_s": timed_rows / secs,
                     "rows_out": sum(got.values()),
                     "b1_launches": launches[0], "b3_launches": launches[1],
                     "run_s": wall, "gate_s": time.perf_counter() - t1}
        del plan
    return {"queries": out, "b1_input": b1_input, "b3_inputs": b3_inputs}


def q17_batches(bids) -> list:
    """The bids as one ChunkBatch per epoch."""
    from risingwave_tpu_torch.common import stack_chunks
    return [stack_chunks(bids[i:i + NEX_CHUNKS_PER_EPOCH])
            for i in range(0, len(bids), NEX_CHUNKS_PER_EPOCH)]


def batch_source(batches, first_epoch: int = 1):
    """A checkpoint barrier, then per epoch its batch and a checkpoint
    barrier."""
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.stream import Barrier, MockSource
    msgs = [Barrier.new(first_epoch, checkpoint=True)]
    for i, b in enumerate(batches):
        msgs += [b, Barrier.new(first_epoch + 1 + i, checkpoint=True)]
    return MockSource(BID_SCHEMA, msgs)


def q17_job(device, src, parallelism: int, store=None):
    """q17 as a multi-fragment job: bids → RowIdGen → Project(to_char) →
    HashDispatcher over (auction, day) → ``parallelism`` HashAgg actors
    sharing one state table (id 2 of ``store``) → Merge → Project.
    Returns (the fragment graph, its root)."""
    from risingwave_tpu_torch.frontend.fragments import build_fragmented_agg
    from risingwave_tpu_torch.storage import StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    from risingwave_tpu_torch.stream.hash_agg import agg_state_schema
    inp = plans.q17_input(src, device)
    st = None
    if store is not None:
        st = StateTable(store, 2, agg_state_schema(
            [inp.schema[0], inp.schema[1]], plans.q17_calls()), [0, 1])
    graph = build_fragmented_agg(
        inp, [0, 1], plans.q17_calls(), state_table=st,
        parallelism=parallelism, table_capacity=Q105_AGG_CAPACITY,
        out_capacity=CHUNK, device=device)
    return graph, plans.q17_output(graph)


def timed_sink(out, path, store, **kw):
    """A SinkExecutor into a jsonl FileSink whose barrier work is timed
    (``barrier_ms``), its log and progress tables ids 10 and 11."""
    from risingwave_tpu_torch.common.config import FaultConfig
    from risingwave_tpu_torch.connector.sinks import FileSink
    from risingwave_tpu_torch.storage import StateTable
    from risingwave_tpu_torch.stream.sink import (
        PROGRESS_SCHEMA, SinkExecutor, log_table_schema,
    )

    class TimedSink(SinkExecutor):
        async def on_barrier(self, barrier):
            t0 = time.perf_counter()
            async for m in super().on_barrier(barrier):
                yield m
            self.barrier_ms.append((time.perf_counter() - t0) * 1e3)

    policy = FaultConfig(sink_retry_attempts=2, sink_retry_base_ms=0.5,
                         sink_retry_deadline_ms=50.0).sink_retry_policy()
    sink = TimedSink(out, FileSink(path, out.schema),
                     StateTable(store, 10, log_table_schema(out.schema),
                                [0, 1]),
                     StateTable(store, 11, PROGRESS_SCHEMA, [0]),
                     retry_policy=policy, degrade_after=SINK_DEGRADE_AFTER,
                     **kw)
    sink.barrier_ms = []
    return sink


async def drive_sink(sink, store, actions: dict, stop_after=None):
    """Run ``sink`` (each checkpoint barrier commits ``store``, then
    ``actions[epoch]()`` runs); stop at epoch ``stop_after`` (a drop: the
    job is abandoned there)."""
    from risingwave_tpu_torch.stream import Barrier
    async for m in sink.execute():
        if isinstance(m, Barrier):
            if m.checkpoint:
                store.commit(m.epoch.curr)
            if m.epoch.curr in actions:
                actions[m.epoch.curr]()
            if m.epoch.curr == stop_after:
                return


def replay_changelog(path: str) -> collections.Counter:
    """The rows a jsonl changelog folds to."""
    rows = collections.Counter()
    with open(path, encoding="utf-8") as f:
        for line in f:
            obj = json.loads(line)
            op = obj.pop("__op")
            row = tuple(obj.values())
            rows[row] += 1 if op in ("insert", "update_insert") else -1
    if any(n < 0 for n in rows.values()):
        raise AssertionError("the sink's changelog deletes a row it never "
                             "inserted")
    return +rows


async def dispatch_sync_free_epoch(device, batch) -> None:
    """One epoch's ChunkBatch, projected outside the check, through a
    HashDispatcher over (auction, day) into 4 channels and each agg
    actor's batched ingest, with synchronizing CUDA calls made errors."""
    from risingwave_tpu_torch.stream import (
        Barrier, HashAggExecutor, MockSource, nexmark_plans as plans,
    )
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.stream.dispatch import (
        ChannelSource, HashDispatcher, open_channel,
    )
    inp = plans.q17_input(MockSource(BID_SCHEMA, [Barrier.new(1), batch]),
                          device)
    projected = [m async for m in inp.execute()][-1]
    chans = [open_channel() for _ in range(Q17_PARALLELISM)]
    dispatcher = HashDispatcher(chans, [0, 1], inp.schema, device)
    aggs = [HashAggExecutor(ChannelSource(ch, inp.schema), [0, 1],
                            plans.q17_calls(),
                            table_capacity=Q105_AGG_CAPACITY,
                            out_capacity=CHUNK, device=device)
            for ch in chans]
    with no_host_sync():
        await dispatcher.dispatch(projected)
        for ch, agg in zip(chans, aggs):
            async for _ in agg.map_chunk_batch(await ch.recv()):
                pass
    torch.cuda.synchronize()


def run_q17_fragmented(device, bids, want: collections.Counter) -> dict:
    """Phase 22 (b): q17 as a multi-fragment job. Its rows/s at
    parallelism 1 and 4 on the same batches (each MV gated; phase 22 (a)'s
    q17 is no stand-in for 1: it ingests chunks under the B3 watch); one
    epoch of the dispatcher's split and the actors' batched ingest under
    the sync check; then at parallelism 4 into a SinkExecutor over a jsonl
    FileSink, every barrier a checkpoint: ``sink.deliver`` fails for the
    first SINK_DEGRADE_AFTER epochs (the sink degrades, the log takes the
    changes), ``resume()`` after them, the next epoch drains the log; the
    job is dropped after that epoch and recovered at parallelism 2 from
    the store; its last epoch delivered. The file's changelog must fold to
    numpy's q17 and hold exactly the rows logged."""
    import shutil
    import tempfile
    from risingwave_tpu_torch.common.failpoint import arm, disarm
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import MaterializeExecutor
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    batches = q17_batches(bids)
    result = {}
    for p in (1, Q17_PARALLELISM):
        torch.cuda.empty_cache()
        _, out = q17_job(device, batch_source(batches), p)
        mv = MaterializeExecutor(out, StateTable(MemoryStateStore(), 1,
                                                 plans.q17_schema(), [0, 1]))
        b3_launches(reset=True)
        secs = asyncio.run(drive_timed(mv))
        if mv_visible(mv) != want:
            raise AssertionError(f"q17 at parallelism {p} differs from "
                                 "numpy's")
        timed_rows = (len(batches) - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
        result[f"p{p}_source_rows_per_s"] = timed_rows / secs
        result[f"p{p}_b3_launches"] = b3_launches()
    asyncio.run(dispatch_sync_free_epoch(device, batches[-1]))
    result["sync_free_dispatch"] = "ok"

    tmp = tempfile.mkdtemp(prefix="q17_sink_")
    try:
        path = f"{tmp}/q17.jsonl"
        store = MemoryStateStore()
        drop_at = SINK_DEGRADE_AFTER + 2        # epochs 1.. are barriers 2..
        graph, out = q17_job(device, batch_source(batches[:drop_at - 1]),
                             Q17_PARALLELISM, store)
        sink = timed_sink(out, path, store)
        health = {}

        def degraded():
            health.update(sink.sink_health())
            disarm()
            sink.resume()

        b3_launches(reset=True)
        try:
            asyncio.run(drive_sink(sink, store, {
                1: lambda: arm("sink.deliver", OSError),
                SINK_DEGRADE_AFTER + 1: degraded}, stop_after=drop_at))
        finally:
            disarm()
        if not health.get("degraded") or health["pending_rows"] <= 0:
            raise AssertionError(f"the q17 sink did not degrade: {health}")
        if sink.sink_health()["pending_rows"] != 0:
            raise AssertionError("resume() left rows in the sink's log")
        first = sink
        sink_b3 = b3_launches()
        t0 = time.perf_counter()
        graph2, out2 = q17_job(
            device, batch_source(batches[drop_at - 1:], store.committed_epoch
                                 + 1), Q17_RECOVERY_PARALLELISM, store)
        second = timed_sink(out2, path, store, recovering=True)
        torch.cuda.synchronize()
        recovery_s = time.perf_counter() - t0
        loaded = [int(a.core.live_mask(a.state).sum()) for a in graph2.actors]
        b3_launches(reset=True)
        asyncio.run(drive_sink(second, store, {}))
        recovery_b3 = b3_launches()
        got = replay_changelog(path)
        with open(path, encoding="utf-8") as f:
            lines = sum(1 for _ in f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    delivered = first.rows_delivered + second.rows_delivered
    logged = first.rows_logged + second.rows_logged
    if got != want:
        raise AssertionError(f"the q17 sink's changelog differs from numpy's "
                             f"q17: {sum((got - want).values())} extra, "
                             f"{sum((want - got).values())} missing")
    if not lines == delivered == logged:
        raise AssertionError(f"q17 sink: {lines} lines, {delivered} rows "
                             f"delivered, {logged} logged")
    ms = first.barrier_ms + second.barrier_ms
    result.update(
        rows_delivered=delivered, rows_logged=logged, file_lines=lines,
        degraded_health=health, sink_ms_per_barrier=ms,
        recovery_s=recovery_s, recovered_groups_per_actor=loaded,
        sink_b3_launches=sink_b3, recovery_b3_launches=recovery_b3,
        groups=len(want))
    return result


def run_q20_fragmented(device, auctions, bids, want) -> dict:
    """Phase 22 (c): q20's join as Q20_PARALLELISM actors (each a HashJoin
    of a quarter of the 1<<16 keys at bucket width 2048; kernels B1 and
    B3 in each), both sides hash-dispatched on the auction id; the MV
    equal to numpy's q20."""
    from risingwave_tpu_torch.connector import AUCTION_SCHEMA, BID_SCHEMA
    from risingwave_tpu_torch.frontend.fragments import build_fragmented_join
    from risingwave_tpu_torch.ops.join_state import JoinType
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import MaterializeExecutor
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    torch.cuda.empty_cache()
    b, a = plans.q20_sides(epoch_source(BID_SCHEMA, bids),
                           epoch_source(AUCTION_SCHEMA, auctions), device)
    graph = build_fragmented_join(
        b, a, [0], [0], JoinType.INNER, parallelism=Q20_PARALLELISM,
        key_capacity=Q105_KEY_CAPACITY // Q20_PARALLELISM,
        bucket_width=Q105_BUCKET_WIDTH, out_capacity=CHUNK, device=device)
    for join in graph.actors:
        join.emit_batch = Q20_EMIT_BATCH
    mv = MaterializeExecutor(plans.q20_output(graph), StateTable(
        MemoryStateStore(), 1, plans.q20_schema(), [7, 8]))
    torch.cuda.reset_peak_memory_stats()
    b3_launches(reset=True)
    rt_mod.rank_totals.launches = 0
    secs = asyncio.run(drive_timed(mv))
    b1, b3 = rt_mod.rank_totals.launches, b3_launches()
    for j in graph.actors:
        if j.core.W != Q105_BUCKET_WIDTH or \
                j.core.capacity != Q105_KEY_CAPACITY // Q20_PARALLELISM:
            raise AssertionError("a q20 join actor grew: size it larger")
    got = mv_visible(mv)
    if got != want:
        raise AssertionError(f"fragmented q20 differs from numpy's: "
                             f"{sum((got - want).values())} extra, "
                             f"{sum((want - got).values())} missing rows")
    timed_rows = 2 * (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"parallelism": Q20_PARALLELISM, "rows_out": sum(got.values()),
            "source_rows_per_s": timed_rows / secs, "b1_launches": b1,
            "b3_launches": b3, "emit_batch": Q20_EMIT_BATCH,
            "peak_device_bytes": torch.cuda.max_memory_allocated()}


# ---------------------------------------------------------------------------
# phase 23: approx_count_distinct's HLL lanes, array_agg and JSON events
# over phase 13's bids
# ---------------------------------------------------------------------------

HLL_M = 16
HLL_AGG_CAPACITY = Q105_AGG_CAPACITY
_U64 = np.uint64


def np_splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 over uint64, as the reference mixes."""
    with np.errstate(over="ignore"):
        x = x + _U64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> _U64(27))) * _U64(0x94D049BB133111EB)
        return x ^ (x >> _U64(31))


def np_bit_length(w: np.ndarray) -> np.ndarray:
    """Bits of each uint64, exactly (a binary search over shifts)."""
    n = np.zeros(w.shape, np.int64)
    x = w.copy()
    for s in (32, 16, 8, 4, 2, 1):
        hi = x >> _U64(s)
        big = hi != 0
        n += np.where(big, s, 0)
        x = np.where(big, hi, x)
    return n + x.astype(np.int64)


def hll_registers(groups: np.ndarray, n_groups: int,
                  values: np.ndarray) -> np.ndarray:
    """int64[n_groups, 16]: the reference's HLL rule in numpy — a float
    hashed as its float64 bits, anything else as its int64 value; register
    ``h & 15``, rank ``clz64(h >> 4) - 3``, the max per register."""
    vi = (values.astype(np.float64).view(np.int64)
          if values.dtype.kind == "f" else values.astype(np.int64))
    h = np_splitmix64(vi.view(_U64))
    reg = (h & _U64(HLL_M - 1)).astype(np.int64)
    rho = 64 - np_bit_length(h >> _U64(4)) - 3
    regs = np.zeros((n_groups, HLL_M), np.int64)
    np.maximum.at(regs, (groups, reg), rho)
    return regs


def hll_estimates(regs: np.ndarray) -> np.ndarray:
    """The reference's estimate from int64[G, 16] registers: the 16 terms
    summed in register order, half to even."""
    m = float(HLL_M)
    s = np.zeros(regs.shape[0])
    for j in range(HLL_M):
        s = s + 2.0 ** (-regs[:, j].astype(np.float64))
    raw = 0.673 * m * m / s
    zeros = (regs == 0).sum(1)
    small = m * np.log(m / np.maximum(zeros, 1))
    est = np.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
    return np.round(est).astype(np.int64)


def agg_registers(agg, call_idx: int) -> dict:
    """A HashAgg's live groups (single key) -> int64[16] registers of its
    ``call_idx``-th call, read from the card once."""
    st, core = agg.state, agg.core
    ofs = core.call_lane_ofs[call_idx]
    live = st.table.occupied & (st.lanes[0] > 0)
    idx = live.nonzero().squeeze(1)
    keys = st.table.key_data[0][idx].cpu().numpy()
    regs = torch.stack([st.lanes[ofs + j][idx]
                        for j in range(HLL_M)], 1).cpu().numpy()
    return dict(zip(keys.tolist(), regs))


def check_registers(label: str, got: dict, keys: np.ndarray,
                    regs: np.ndarray) -> None:
    """Every group's registers equal numpy's, bit for bit."""
    if sorted(got) != keys.tolist():
        raise AssertionError(f"{label}: the groups differ from numpy's")
    pos = {k: i for i, k in enumerate(keys.tolist())}
    bad = sum(not np.array_equal(r, regs[pos[k]]) for k, r in got.items())
    if bad:
        raise AssertionError(f"{label}: {bad} groups' registers differ "
                             f"from numpy's")


def relative_errors(est: np.ndarray, exact: np.ndarray) -> dict:
    rel = np.abs(est - exact) / exact
    return {"median": float(np.median(rel)), "max": float(rel.max())}


def hll_plans(device, bids):
    """Phase 23 (a)'s trees over one ChunkBatch of bids per epoch: Project
    → HashAgg(GROUP BY auction: count(*), approx_count_distinct(bidder),
    approx_count_distinct(price)) → Materialize; and SimpleAgg(
    approx_count_distinct(bidder), approx_count_distinct(channel))."""
    from risingwave_tpu_torch.common import INT64, VARCHAR
    from risingwave_tpu_torch.expr import agg, col, count_star
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import (
        HashAggExecutor, MaterializeExecutor, ProjectExecutor,
        SimpleAggExecutor,
    )
    batches = q17_batches(bids)
    proj = ProjectExecutor(batch_source(batches),
                           [col(0, INT64), col(1, INT64), col(2, INT64),
                            col(3, VARCHAR)],
                           names=["auction", "bidder", "price", "channel"])
    stats = HashAggExecutor(
        proj, [0], [count_star(), agg("approx_count_distinct", 1, INT64),
                    agg("approx_count_distinct", 2, INT64)],
        table_capacity=HLL_AGG_CAPACITY, out_capacity=CHUNK, device=device)
    mv = MaterializeExecutor(stats, StateTable(MemoryStateStore(), 1,
                                               stats.schema, [0]))
    total = SimpleAggExecutor(
        batch_source(batches), [agg("approx_count_distinct", 1, INT64),
                                agg("approx_count_distinct", 3, VARCHAR)],
        device=device)
    return stats, mv, total


def run_hll(device, bids, extra) -> dict:
    """Phase 23 (a): HLL per auction and overall (the "uv" counts of
    NEXmark q15, approximate), one warm-up and three timed epochs. Every
    group's registers equal numpy's mirror of the reference's rule, the
    MV's estimates numpy's from them; then ``extra`` (one more epoch) goes
    through the HashAgg's batched ingest under the sync check and the
    registers are gated again. The relative errors against the exact
    distinct counts are records. Kernel B3's busiest input at the group
    table is kept."""
    from risingwave_tpu_torch.common import stack_chunks
    stats, mv, total = hll_plans(device, bids)
    with captured_probe_inputs({
            "hll HashAgg groups": "risingwave_tpu_torch.ops.grouped_agg",
    }) as b3_inputs:
        b3_launches(reset=True)
        secs = asyncio.run(drive_timed(mv))
        b3 = b3_launches()
    secs_total = asyncio.run(drive_timed(total))
    auction, bidder, price, channel = host_cols(bids, (0, 1, 2, 3))
    keys, inv = np.unique(auction, return_inverse=True)
    inv = inv.reshape(-1)
    regs_b = hll_registers(inv, len(keys), bidder)
    regs_p = hll_registers(inv, len(keys), price)
    check_registers("hll bidder", agg_registers(stats, 1), keys, regs_b)
    check_registers("hll price", agg_registers(stats, 2), keys, regs_p)
    want = set(zip(keys.tolist(), np.bincount(inv).tolist(),
                   hll_estimates(regs_b).tolist(),
                   hll_estimates(regs_p).tolist()))
    got = set(mv.rows())
    if got != want:
        raise AssertionError(f"hll MV differs from numpy's estimates: "
                             f"{len(got - want)} rows differ")
    zero = np.zeros(len(bidder), np.int64)
    overall = [hll_registers(zero, 1, v) for v in (bidder, channel)]
    lanes = total.state.lanes
    for i, regs in enumerate(overall):
        ofs = total.lanes_def.call_lane_ofs[i]
        mine = torch.stack(lanes[ofs:ofs + HLL_M]).cpu().numpy()
        if not np.array_equal(mine, regs[0]):
            raise AssertionError("SimpleAgg registers differ from numpy's")
    outs = [int(d) for d, _ in total.lanes_def.outputs(lanes)]
    if outs != [int(hll_estimates(r)[0]) for r in overall]:
        raise AssertionError("SimpleAgg estimates differ from numpy's")
    exact_b = distinct_counts(inv, bidder, len(keys))
    exact_p = distinct_counts(inv, price, len(keys))
    errors = {"bidder": relative_errors(hll_estimates(regs_b), exact_b),
              "price": relative_errors(hll_estimates(regs_p), exact_p),
              "overall_bidder": relative_errors(
                  np.array(outs[:1]), np.array([len(np.unique(bidder))])),
              "overall_channel": relative_errors(
                  np.array(outs[1:]), np.array([len(np.unique(channel))]))}
    # one more epoch's batched ingest with synchronizing calls made errors
    asyncio.run(sync_free_batch(stats, stack_chunks(extra)))
    x_auction, x_bidder = host_cols(extra, (0, 1))
    all_auction = np.concatenate([auction, x_auction])
    keys2, inv2 = np.unique(all_auction, return_inverse=True)
    check_registers("hll bidder after the sync-free epoch",
                    agg_registers(stats, 1), keys2,
                    hll_registers(inv2.reshape(-1), len(keys2),
                                  np.concatenate([bidder, x_bidder])))
    timed_rows = (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"groups": len(keys), "source_rows_per_s": timed_rows / secs,
            "simple_agg_source_rows_per_s": timed_rows / secs_total,
            "estimates": outs, "relative_error": errors,
            "lanes": len(stats.core.lane_dtypes), "b3_launches": b3,
            "sync_free_batch": "ok", "b3_inputs": b3_inputs}


def distinct_counts(inv: np.ndarray, values: np.ndarray,
                    n_groups: int) -> np.ndarray:
    """The exact count of distinct values in each group."""
    pairs = np.unique(np.stack([inv, values.astype(np.int64)], 1), axis=0)
    return np.bincount(pairs[:, 0], minlength=n_groups)



def run_array_agg(device, bids) -> dict:
    """Phase 23 (b): bids → MaterializedAgg(GROUP BY bidder:
    array_agg(auction), count(*)) → Project(bidder, array_length(vs),
    vs[1]) → Materialize, one warm-up and three timed epochs; the MV and
    the agg's arrays equal Python's sorted lists per bidder."""
    from risingwave_tpu_torch.common import GLOBAL_LIST_DICT, INT64
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.expr import Literal, agg, call, col, count_star
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import (
        MaterializeExecutor, MaterializedAggExecutor, ProjectExecutor,
    )
    arrays = MaterializedAggExecutor(
        epoch_source(BID_SCHEMA, bids), [1],
        [agg("array_agg", 0, INT64), count_star()], out_capacity=CHUNK,
        device=device)
    vs = col(1, arrays.schema[1].type)
    proj = ProjectExecutor(arrays, [col(0, INT64), call("array_length", vs),
                                    call("array_access", vs,
                                         Literal(1, INT64))],
                           names=["bidder", "n", "first"])
    mv = MaterializeExecutor(proj, StateTable(MemoryStateStore(), 1,
                                              proj.schema, [0]))
    b3_launches(reset=True)
    secs = asyncio.run(drive_timed(mv))
    b3 = b3_launches()
    auction, bidder = host_cols(bids, (0, 1))
    lists: dict = collections.defaultdict(list)
    for a, b in zip(auction.tolist(), bidder.tolist()):
        lists[b].append(a)
    want = {b: sorted(v) for b, v in lists.items()}
    got = {r[0]: r for r in mv.rows()}
    if got != {b: (b, len(v), v[0]) for b, v in want.items()}:
        raise AssertionError("array_agg MV differs from Python's sorted "
                             "lists")
    held = {k[0]: list(GLOBAL_LIST_DICT.lookup(row[1]))
            for k, row in arrays._out.items()}
    if held != want:
        raise AssertionError("array_agg arrays differ from Python's sorted "
                             "lists")
    timed_rows = (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"groups": len(want), "source_rows_per_s": timed_rows / secs,
            "longest_array": max(len(v) for v in want.values()),
            "b3_launches": b3}


def json_events(bids) -> list:
    """The bids as JSON lines, one object per bid, in chunks of CHUNK
    lines: auction, who {bidder, channel}, payload {price, channel, url,
    date_time}."""
    auction, bidder, price, ch, url, ts = host_cols(bids,
                                                   (0, 1, 2, 3, 4, 5))
    channel, url = decode(ch), decode(url)
    lines = [json.dumps({"auction": a, "who": {"bidder": b, "channel": c},
                         "payload": {"price": p, "channel": c, "url": u,
                                     "date_time": t}})
             for a, b, p, c, u, t in zip(auction.tolist(), bidder.tolist(),
                                         price.tolist(), channel, url,
                                         ts.tolist())]
    return [lines[i:i + CHUNK] for i in range(0, len(lines), CHUNK)]


class JsonLineSource:
    """A message-bus source of JSON lines: a barrier, then per epoch
    NEX_CHUNKS_PER_EPOCH chunks, each parsed by ``parse_json_lines`` and
    put on the card when it is reached, and a barrier."""

    def __init__(self, schema, chunks_of_lines, device):
        self.schema = schema
        self.chunks, self.device = chunks_of_lines, device

    async def execute(self):
        from risingwave_tpu_torch.common import make_chunk
        from risingwave_tpu_torch.connector.parsers import parse_json_lines
        from risingwave_tpu_torch.stream import Barrier
        yield Barrier.new(1)
        for i, lines in enumerate(self.chunks):
            rows = parse_json_lines("\n".join(lines), self.schema)
            yield make_chunk(self.schema, rows, capacity=CHUNK,
                             device=self.device)
            if (i + 1) % NEX_CHUNKS_PER_EPOCH == 0:
                yield Barrier.new(2 + i // NEX_CHUNKS_PER_EPOCH)


def run_json_events(device, bids) -> dict:
    """Phase 23 (c): the bids as JSON lines from a message bus, parsed
    inside the timed window under (auction BIGINT, who STRUCT<bidder
    BIGINT, channel VARCHAR>, payload JSONB) → Project(payload ->>
    'channel', CAST(payload ->> 'price' AS BIGINT), (who).bidder) →
    HashAgg(GROUP BY channel: count(*), sum(price),
    approx_count_distinct(bidder)) → Materialize, equal to numpy's."""
    from risingwave_tpu_torch.common import (
        INT64, JSONB, VARCHAR, Schema, struct_of,
    )
    from risingwave_tpu_torch.expr import (
        Cast, Literal, agg, call, col, count_star,
    )
    from risingwave_tpu_torch.expr.expr import struct_field
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import (
        HashAggExecutor, MaterializeExecutor, ProjectExecutor,
    )
    who = struct_of(("bidder", INT64), ("channel", VARCHAR))
    schema = Schema.of(("auction", INT64), ("who", who),
                       ("payload", JSONB))
    chunks = json_events(bids)
    payload = col(2, JSONB)

    def text(key):
        return call("jsonb_get_field_text", payload, Literal(key, VARCHAR))

    proj = ProjectExecutor(
        JsonLineSource(schema, chunks, device),
        [text("channel"), Cast(text("price"), INT64),
         struct_field(col(1, who), "bidder")],
        names=["channel", "price", "bidder"])
    stats = HashAggExecutor(
        proj, [0], [count_star(), agg("sum", 1, INT64),
                    agg("approx_count_distinct", 2, INT64)],
        table_capacity=1 << 10, out_capacity=CHUNK, device=device)
    mv = MaterializeExecutor(stats, StateTable(MemoryStateStore(), 1,
                                               stats.schema, [0]))
    b3_launches(reset=True)
    secs = asyncio.run(drive_timed(mv))
    b3 = b3_launches()
    bidder, price, ch = host_cols(bids, (1, 2, 3))
    keys, inv = np.unique(decode(ch).astype(str), return_inverse=True)
    inv = inv.reshape(-1)
    est = hll_estimates(hll_registers(inv, len(keys), bidder))
    sums = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, price)
    want = set(zip(keys.tolist(), np.bincount(inv).tolist(), sums.tolist(),
                   est.tolist()))
    if set(mv.rows()) != want:
        raise AssertionError("JSON events MV differs from numpy's")
    timed_rows = (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return {"groups": len(keys), "source_rows_per_s": timed_rows / secs,
            "json_bytes": sum(len(ln) + 1 for c in chunks for ln in c),
            "b3_launches": b3}


# ---------------------------------------------------------------------------
# phase 24: SQL end to end through the port's Session
# ---------------------------------------------------------------------------

# tests/test_nexmark_queries.py's DDL of the three NEXmark sources
SQL_NEXMARK_DDL = """
CREATE SOURCE bid (auction BIGINT, bidder BIGINT, price BIGINT,
  channel VARCHAR, url VARCHAR, date_time TIMESTAMP, extra VARCHAR)
WITH (connector = 'nexmark', nexmark_table = 'bid');
CREATE SOURCE auction (id BIGINT, item_name VARCHAR, description VARCHAR,
  initial_bid BIGINT, reserve BIGINT, date_time TIMESTAMP,
  expires TIMESTAMP, seller BIGINT, category BIGINT, extra VARCHAR)
WITH (connector = 'nexmark', nexmark_table = 'auction');
CREATE SOURCE person (id BIGINT, name VARCHAR, email_address VARCHAR,
  credit_card VARCHAR, city VARCHAR, state VARCHAR, date_time TIMESTAMP,
  extra VARCHAR)
WITH (connector = 'nexmark', nexmark_table = 'person')
"""

# the MVs' SQL, as tests/test_nexmark_extended.py and
# tests/test_torch_nexmark_sql.py write them
SQL_MVS = {
    "q105": """CREATE MATERIALIZED VIEW q105 AS
        SELECT a.id AS auction_id, a.item_name, COUNT(b.auction)
          AS bid_count
        FROM auction a JOIN bid b ON a.id = b.auction
        GROUP BY a.id, a.item_name
        ORDER BY bid_count DESC LIMIT 1000""",
    # q105 without its TopN: every group of the join's output is gated
    "q105_join": """CREATE MATERIALIZED VIEW q105_join AS
        SELECT a.id AS auction_id, a.item_name, COUNT(b.auction)
          AS bid_count
        FROM auction a JOIN bid b ON a.id = b.auction
        GROUP BY a.id, a.item_name""",
    "q7": """CREATE MATERIALIZED VIEW q7 AS
        SELECT B.auction, B.price, B.bidder, B.date_time
        FROM bid B
        JOIN (
            SELECT MAX(price) AS maxprice, window_end as date_time
            FROM TUMBLE(bid, date_time, INTERVAL '10' SECOND)
            GROUP BY window_end
        ) B1 ON B.price = B1.maxprice
        WHERE B.date_time BETWEEN B1.date_time - INTERVAL '10' SECOND
              AND B1.date_time""",
    "q17": """CREATE MATERIALIZED VIEW q17 AS
        SELECT auction, to_char(date_time, 'YYYY-MM-DD') AS day,
          count(*) AS total_bids,
          count(*) filter (where price < 10000) AS rank1_bids,
          min(price) AS min_price, max(price) AS max_price,
          avg(price) AS avg_price, sum(price) AS sum_price
        FROM bid GROUP BY auction, to_char(date_time, 'YYYY-MM-DD')""",
    "q18": """CREATE MATERIALIZED VIEW q18 AS
        SELECT auction, bidder, price, date_time
        FROM (SELECT *, RANK() OVER (PARTITION BY bidder, auction
                  ORDER BY date_time DESC) AS rank_number
              FROM bid) WHERE rank_number <= 1""",
}
SQL_NEXMARK_ORDER = ("q105", "q105_join", "q17", "q18", "q7")

# tests/test_tpch.py's DDL and MVs
SQL_TPCH_DDL = {
    "customer": """CREATE TABLE customer (
        c_custkey BIGINT PRIMARY KEY, c_name VARCHAR, c_address VARCHAR,
        c_nationkey BIGINT, c_phone VARCHAR, c_acctbal DECIMAL,
        c_mktsegment VARCHAR, c_comment VARCHAR)""",
    "orders": """CREATE TABLE orders (
        o_orderkey BIGINT PRIMARY KEY, o_custkey BIGINT,
        o_orderdate DATE, o_shippriority BIGINT)""",
    "lineitem": """CREATE TABLE lineitem (
        l_orderkey BIGINT, l_linenumber BIGINT, l_extendedprice DECIMAL,
        l_discount DECIMAL, l_shipdate DATE, l_returnflag VARCHAR,
        PRIMARY KEY (l_orderkey, l_linenumber))""",
    "nation": """CREATE TABLE nation (
        n_nationkey BIGINT PRIMARY KEY, n_name VARCHAR)""",
}
SQL_TPCH_MVS = {
    "q3": """CREATE MATERIALIZED VIEW q3 AS
            SELECT o_orderkey, sum(l_extendedprice * (1 - l_discount))
                       AS revenue,
                   o_orderdate, o_shippriority
            FROM customer, orders, lineitem
            WHERE c_mktsegment = 'BUILDING'
              AND c_custkey = o_custkey
              AND l_orderkey = o_orderkey
              AND o_orderdate < DATE '1995-03-15'
              AND l_shipdate > DATE '1995-03-15'
            GROUP BY o_orderkey, o_orderdate, o_shippriority""",
    "q10": """CREATE MATERIALIZED VIEW q10 AS
            SELECT c_custkey, c_name,
                   sum(l_extendedprice * (1 - l_discount)) AS revenue,
                   n_name
            FROM customer, orders, lineitem, nation
            WHERE c_custkey = o_custkey
              AND l_orderkey = o_orderkey
              AND o_orderdate >= DATE '1993-10-01'
              AND o_orderdate < DATE '1994-01-01'
              AND l_returnflag = 'R'
              AND c_nationkey = n_nationkey
            GROUP BY c_custkey, c_name, n_name""",
}
# each column's literal form: i integer, s text, d DECIMAL at scale 2,
# t DATE
SQL_TPCH_KINDS = {"customer": "issisdss", "orders": "iiti",
                  "lineitem": "iiddts", "nation": "is"}
SQL_TPCH_SF = 0.01          # cut for the parser's rate (~9K rows/s)
SQL_INSERT_ROWS = 4096      # rows per INSERT statement


def pow2_at_least(n: float, floor: int = 16) -> int:
    return 1 << max(int(np.ceil(np.log2(max(n, floor)))), 4)


def sql_session(device, **cfg):
    """A Session at phase 13's capacities (``cfg`` overrides them), the
    NEXmark sources declared, one chunk of CHUNK rows per source leaf and
    NEX_CHUNKS_PER_EPOCH per tick."""
    from risingwave_tpu_torch.frontend import BuildConfig, Session
    conf = dict(chunk_capacity=CHUNK, agg_table_capacity=Q105_AGG_CAPACITY,
                join_key_capacity=Q105_KEY_CAPACITY,
                join_bucket_width=Q105_BUCKET_WIDTH,
                topn_table_capacity=Q105_TOPN_CAPACITY)
    conf.update(cfg)
    s = Session(source_chunk_capacity=CHUNK,
                chunks_per_tick=NEX_CHUNKS_PER_EPOCH,
                config=BuildConfig(**conf), device=device)
    s.run_sql(SQL_NEXMARK_DDL)
    return s


def job_executors(s, name: str) -> list:
    """Every executor of MV ``name``'s job, root first."""
    out, todo = [], [s.jobs[name].pipeline]
    while todo:
        ex = todo.pop()
        out.append(ex)
        todo += [getattr(ex, f) for f in ("input", "left", "right", "inner")
                 if getattr(ex, f, None) is not None]
        todo += list(getattr(ex, "inputs", ()))
    return out


def check_not_grown(s, name: str) -> list:
    """Each join of MV ``name`` at the Session's key capacity and bucket
    width; returns their (capacity, width)."""
    cfg = s.config
    sizes = []
    for ex in job_executors(s, name):
        if type(ex).__name__ == "HashJoinExecutor":
            sizes.append([ex.core.capacity, ex.core.W])
            if sizes[-1] != [cfg.join_key_capacity, cfg.join_bucket_width]:
                raise AssertionError(f"the SQL {name} join grew to "
                                     f"{sizes[-1]}: size it larger")
    return sizes


def q7_sql_sizes(bids) -> tuple:
    """q7's join sizes from the bids: twice the distinct prices (the join
    key) and the most bids of one price, as powers of two."""
    (price,) = host_cols(bids, (2,))
    _, n = np.unique(price, return_counts=True)
    return pow2_at_least(2 * len(n), 1 << 10), pow2_at_least(n.max())


def q7_sql_expected(bids) -> collections.Counter:
    """numpy q7 as its SQL reads: each bid whose price is the max of a
    10 s tumble window whose [end - 10 s, end] holds its date_time (its
    own window, and the one before when it lies on that window's end)."""
    auction, bidder, price, ts = host_cols(bids, (0, 1, 2, 5))
    size = 10 * 1_000_000
    end = (ts // size) * size + size
    wins, inv = np.unique(end, return_inverse=True)
    top = np.full(len(wins), np.iinfo(np.int64).min)
    np.maximum.at(top, inv.reshape(-1), price)
    out = collections.Counter()
    for cand in (end, end - size):
        at = np.clip(np.searchsorted(wins, cand), 0, len(wins) - 1)
        hit = (wins[at] == cand) & (top[at] == price) & (ts <= cand) & \
            (ts >= cand - size)
        out.update(zip(auction[hit].tolist(), price[hit].tolist(),
                       bidder[hit].tolist(), ts[hit].tolist()))
    return out


def run_sql_mv(device, name: str, cfg: dict) -> tuple:
    """A Session running MV ``name`` alone: the CREATE, one warm-up and
    NEX_EPOCHS - 1 timed ticks. Returns (session, report)."""
    from risingwave_tpu_torch.frontend.parser import parse_one
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = sql_session(device, **cfg)
    t0 = time.perf_counter()
    s._plan(parse_one(SQL_MVS[name]).query)
    plan_ms = (time.perf_counter() - t0) * 1e3
    b3_launches(reset=True)
    rt_mod.rank_totals.launches = 0
    t0 = time.perf_counter()
    s.run_sql(SQL_MVS[name])
    create_ms = (time.perf_counter() - t0) * 1e3
    s.tick()                                  # the warm-up tick
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(NEX_EPOCHS - 1):
        s.tick()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    b1, b3 = rt_mod.rank_totals.launches, b3_launches()
    leaves = len(s.feeds)
    timed_rows = leaves * (NEX_EPOCHS - 1) * NEX_CHUNKS_PER_EPOCH * CHUNK
    return s, {"source_leaves": leaves,
               "source_rows_per_s": timed_rows / secs,
               "plan_ms": plan_ms, "create_ms": create_ms,
               "joins": check_not_grown(s, name),
               "b1_launches": b1, "b3_launches": b3,
               "peak_device_bytes": torch.cuda.max_memory_allocated()}


def gate_counter(name: str, got: collections.Counter,
                 want: collections.Counter) -> int:
    if got != want:
        raise AssertionError(f"SQL {name} differs from numpy's: "
                             f"{sum((got - want).values())} extra, "
                             f"{sum((want - got).values())} missing rows")
    if not want:
        raise AssertionError(f"SQL {name} is empty")
    return sum(want.values())


def timed_select(s, sql: str, want, lowered: str = None) -> dict:
    """One SELECT through the Session, its rows equal to ``want`` (a list
    in order for ORDER BY, else compared as multisets); ``lowered``: the
    batch executor its plan must lower to, or None for the stream fold.
    Returns its ms and B3 launches."""
    from risingwave_tpu_torch.batch.lower import lower_plan
    from risingwave_tpu_torch.frontend.parser import parse_one
    chain = lower_plan(s._plan(parse_one(sql).select), s.store,
                       catalog=s.catalog, device=s.device)
    kinds, todo = set(), [chain]
    while todo:
        ex = todo.pop()
        if ex is not None:
            kinds.add(type(ex).__name__)
            todo += [getattr(ex, f, None) for f in ("input", "left",
                                                    "right")]
    if (lowered is None) != (chain is None) or \
            (lowered is not None and lowered not in kinds):
        raise AssertionError(f"SELECT lowers to {sorted(kinds)}, not "
                             f"{lowered or 'the stream fold'}: {sql}")
    folds = []
    fold = s._query_stream_fold
    s._query_stream_fold = lambda *a: folds.append(1) or fold(*a)
    b3_launches(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        got = s.run_sql(sql)
    finally:
        del s._query_stream_fold
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if bool(folds) != (lowered is None):
        raise AssertionError(f"SELECT took the {'fold' if folds else 'batch'}"
                             f" path: {sql}")
    ok = (got == want if "ORDER BY" in sql.split("FROM")[-1]
          else collections.Counter(got) == collections.Counter(want))
    if not ok or not want:
        raise AssertionError(f"SELECT differs from numpy ({len(got)} rows "
                             f"against {len(want)}): {sql}")
    return {"ms": ms, "rows": len(got), "path": lowered or "stream fold",
            "b3_launches": b3_launches()}


def sql_selects(s, q17: collections.Counter) -> dict:
    """Phase 24 (a)'s SELECTs, in the q17 Session: a grouped aggregate
    (BatchHashAgg), a join of q17 with an MV over it (BatchHashJoin), an
    ORDER BY ... LIMIT (BatchSort and BatchLimit) and a window function
    (the stream fold), each equal to numpy over q17's numpy rows."""
    rows = list(q17.elements())
    out = {}
    # grouped by auction: the batch agg's find-or-insert decides one
    # group per auction of q17 (12,825 at the smoke's size)
    per_auction = collections.defaultdict(lambda: [0, 0, 0])
    for r in rows:
        d = per_auction[r[0]]
        d[0], d[1], d[2] = d[0] + 1, d[1] + r[2], max(d[2], r[5])
    out["grouped_agg"] = timed_select(
        s, "SELECT auction, count(*) AS n, sum(total_bids) AS bids, "
           "max(max_price) AS top FROM q17 GROUP BY auction",
        [(k, *v) for k, v in per_auction.items()], "BatchHashAgg")
    # an MV over q17, backfilled from its table
    s.run_sql("CREATE MATERIALIZED VIEW q17_days AS SELECT auction, "
              "count(*) AS days, sum(total_bids) AS bids FROM q17 "
              "GROUP BY auction")
    while not s.backfill_done("q17_days"):
        s.tick(generate=False)
    per = collections.defaultdict(lambda: [0, 0])
    for r in rows:
        per[r[0]][0] += 1
        per[r[0]][1] += r[2]
    out["join"] = timed_select(
        s, "SELECT q17.auction, q17.day, q17.total_bids, d.days, d.bids "
           "FROM q17 JOIN q17_days AS d ON q17.auction = d.auction "
           "WHERE q17.total_bids > 2",
        [(r[0], r[1], r[2], *per[r[0]]) for r in rows if r[2] > 2],
        "BatchHashJoin")
    top = sorted(rows, key=lambda r: (-r[2], r[0], r[1]))[:10]
    out["order_by_limit"] = timed_select(
        s, "SELECT auction, day, total_bids FROM q17 "
           "ORDER BY total_bids DESC, auction, day LIMIT 10",
        [(r[0], r[1], r[2]) for r in top], "BatchLimit")
    hot = [r for r in rows if r[2] > 2]
    by_day = collections.defaultdict(list)
    for r in hot:
        by_day[r[1]].append(r[2])
    out["window_fold"] = timed_select(
        s, "SELECT auction, day, rank() OVER (PARTITION BY day ORDER BY "
           "total_bids DESC) AS r FROM q17 WHERE total_bids > 2",
        [(r[0], r[1], 1 + sum(t > r[2] for t in by_day[r[1]]))
         for r in hot])
    return out


def run_sql_nexmark(device, auctions, bids, data) -> dict:
    """Phase 24 (a): q105, q105 without its TopN (every group of the join's
    output), q17, q18 and q7 by CREATE MATERIALIZED VIEW, each in a Session
    of its own (one join arena live at a time), each MV equal to numpy
    over the rows its source leaves emitted (the chunks of phase
    13: a fresh host generator per leaf, seed 42); then the SELECTs in the
    q17 Session."""
    out = {}
    q7_keys, q7_width = q7_sql_sizes(bids)
    for name in SQL_NEXMARK_ORDER:
        cfg = ({"join_key_capacity": q7_keys, "join_bucket_width": q7_width}
               if name == "q7" else {})
        s, r = run_sql_mv(device, name, cfg)
        rows = s.mv_rows(name)
        if name == "q105":
            counts = q105_counts(auctions, bids)
            want = sorted(sorted(counts.items(), key=lambda kv: (
                -kv[1], kv[0][0], kv[0][1]))[:Q105_LIMIT])
            got = sorted(((g[0], g[1]), g[2]) for g in rows)
            if got != want:
                raise AssertionError(
                    f"SQL q105 differs from numpy's top {Q105_LIMIT}: "
                    f"{len(set(got) - set(want))} extra, "
                    f"{len(set(want) - set(got))} missing")
            r["rows_out"] = len(got)
        elif name == "q105_join":
            counts = q105_counts(auctions, bids)
            r["rows_out"] = gate_counter(name, collections.Counter(rows),
                                         collections.Counter(
                (k[0], k[1], n) for k, n in counts.items()))
            r["join_rows"] = sum(counts.values())
        else:
            want = {"q17": lambda: data.expected("q17"),
                    "q18": lambda: q18_expected(bids),
                    "q7": lambda: q7_sql_expected(bids)}[name]()
            r["rows_out"] = gate_counter(name, collections.Counter(rows),
                                         want)
        if name == "q17":
            r["selects"] = sql_selects(s, want)
        s.close()
        del s
        out[name] = r
    return out


def sql_literals(kinds: str, cols, i: int) -> str:
    """Row ``i`` of numpy columns of physical values as a VALUES tuple."""
    import datetime as dt
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT as sd
    vals = []
    for kind, c in zip(kinds, cols):
        v = int(c[i])
        if kind == "i":
            vals.append(str(v))
        elif kind == "s":
            vals.append("'" + sd.lookup(v).replace("'", "''") + "'")
        elif kind == "d":
            vals.append(f"{'-' if v < 0 else ''}{abs(v) // 100}."
                        f"{abs(v) % 100:02d}")
        else:
            vals.append("DATE '" + (dt.date(1970, 1, 1) + dt.timedelta(
                days=v)).isoformat() + "'")
    return "(" + ", ".join(vals) + ")"


def insert_sql(name: str, cols) -> list:
    """Multi-row INSERT statements of SQL_INSERT_ROWS rows each."""
    kinds, n = SQL_TPCH_KINDS[name], len(cols[0])
    return [f"INSERT INTO {name} VALUES " + ", ".join(
        sql_literals(kinds, cols, i)
        for i in range(lo, min(lo + SQL_INSERT_ROWS, n)))
        for lo in range(0, n, SQL_INSERT_ROWS)]


def run_sql_tpch(device, sf: float = None, seed: int = TPCH_SEED) -> dict:
    """Phase 24 (b): tests/test_tpch.py's tables, loaded from phase 21's
    generator by INSERT statements, q3 and q10 created over them by SQL and
    backfilled, then one RF1 by INSERT, one RF2 by DELETE ... WHERE ... IN
    (...) and one UPDATE of a customer's c_mktsegment; both MVs equal to
    numpy after the backfill and after each refresh (revenue as a scaled
    int64); load rows/s, the staleness of each refresh (its statements to
    the end of the FLUSH after them), B1 and B3 launches."""
    from risingwave_tpu_torch.common import GLOBAL_STRING_DICT as sd
    from risingwave_tpu_torch.frontend import BuildConfig, Session
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    sf = SQL_TPCH_SF if sf is None else sf
    live = tpch_tables(sf, seed)
    new, gone = tpch_refresh(np.random.default_rng(seed + 1), 0, sf, live)
    n_cust, n_ord = len(live["customer"][0]), len(live["orders"][0])
    # keys of the largest join (orders), twice over; the most rows of one
    # key on either side of any join: a nation's customers' orders
    width = pow2_at_least(1.5 * 0.08 * n_ord / 25 * 4)
    cfg = BuildConfig(chunk_capacity=CHUNK,
                      agg_table_capacity=pow2_at_least(2 * n_cust, 1 << 10),
                      join_key_capacity=pow2_at_least(2 * n_ord, 1 << 10),
                      join_bucket_width=width)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = Session(source_chunk_capacity=CHUNK, config=cfg, device=device)
    out = {"sf": sf, "rows": {k: len(v[0]) for k, v in live.items()},
           "key_capacity": cfg.join_key_capacity, "bucket_width": width}
    for ddl in SQL_TPCH_DDL.values():
        s.run_sql(ddl)
    stmts = [st for name, cols in live.items()
             for st in insert_sql(name, cols)]
    b3_launches(reset=True)
    rt_mod.rank_totals.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for st in stmts:
        s.run_sql(st)
    s.flush()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_rows = sum(out["rows"].values())
    out.update(statements=len(stmts), load_s=load_s,
               load_rows_per_s=n_rows / load_s)
    out["create"] = {}
    for name, sql in SQL_TPCH_MVS.items():
        t0 = time.perf_counter()
        s.run_sql(sql)
        barriers = 0
        while not s.backfill_done(name):
            s.tick()
            barriers += 1
        torch.cuda.synchronize()
        out["create"][name] = {"s": time.perf_counter() - t0,
                               "barriers": barriers,
                               "joins": check_not_grown(s, name)}
    out["gate_backfill"] = tpch_gate(s, live, "the backfill")

    def refresh(kind: str, statements: list, rows: int) -> None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for st in statements:
            s.run_sql(st)
        s.flush()
        torch.cuda.synchronize()
        out.setdefault("refresh", []).append({
            "kind": kind, "rows": rows, "statements": len(statements),
            "staleness_ms": (time.perf_counter() - t0) * 1e3})
        out[f"gate_{kind}"] = tpch_gate(s, live, f"the {kind}")

    # RF1: new orders and their lineitems
    for name in ("orders", "lineitem"):
        live[name] = [np.concatenate([a, b])
                      for a, b in zip(live[name], new[name])]
    refresh("RF1", insert_sql("orders", new["orders"])
            + insert_sql("lineitem", new["lineitem"]),
            sum(len(new[n][0]) for n in new))
    # RF2: the first loaded orders, by key
    keys = ", ".join(str(int(k)) for k in gone)
    rows = 0
    for name, col in (("orders", "o_orderkey"), ("lineitem", "l_orderkey")):
        sel = np.isin(live[name][0], gone)
        rows += int(sel.sum())
        live[name] = [c[~sel] for c in live[name]]
    refresh("RF2", [f"DELETE FROM lineitem WHERE l_orderkey IN ({keys})",
                    f"DELETE FROM orders WHERE o_orderkey IN ({keys})"],
            rows)
    # UPDATE: the customer outside BUILDING with the most q3-eligible
    # revenue moves into it, so q3 changes
    c = live["customer"]
    building = sd.intern("BUILDING")
    with_all = dict(live, customer=[*c[:6], np.full_like(c[6], building),
                                    c[7]])
    o = live["orders"]
    cust_of = dict(zip(o[0].tolist(), o[1].tolist()))
    gain = collections.Counter()
    for (okey, _, _), v in tpch_q3(with_all).items():
        gain[cust_of[okey]] += v
    seg = dict(zip(c[0].tolist(), c[6].tolist()))
    who = max((k for k in gain if seg[k] != building), key=gain.get)
    c[6] = np.where(c[0] == who, building, c[6])
    refresh("UPDATE", [f"UPDATE customer SET c_mktsegment = 'BUILDING' "
                       f"WHERE c_custkey = {who}"], 1)
    torch.cuda.synchronize()
    out["b1_launches"] = rt_mod.rank_totals.launches
    out["b3_launches"] = b3_launches()
    out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    s.close()
    return out


@contextlib.contextmanager
def profiled():
    """A CUDA profiler session around the block; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def nexmark_plan(name: str, device, auctions, bids):
    """A fresh q105 or q18 plan at the phase's sizes over these chunks."""
    from risingwave_tpu_torch.connector import AUCTION_SCHEMA, BID_SCHEMA
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    store = MemoryStateStore()
    if name == "q18":
        return q18_plan(device, epoch_source(BID_SCHEMA, bids), store)
    return plans.q105(
        epoch_source(AUCTION_SCHEMA, auctions), epoch_source(BID_SCHEMA, bids),
        StateTable(store, 1, plans.q105_schema(), [0, 1]),
        limit=Q105_LIMIT, key_capacity=Q105_KEY_CAPACITY,
        bucket_width=Q105_BUCKET_WIDTH, agg_capacity=Q105_AGG_CAPACITY,
        topn_capacity=Q105_TOPN_CAPACITY, out_capacity=CHUNK, device=device)


def trace_plan(build, n_chunks: int) -> dict:
    """A fresh plan driven to its end (every epoch of its sources, the
    first included) under the profiler's CUDA trace, as
    ``trace_summary``."""
    from torch.profiler import ProfilerActivity, profile
    plan = build()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asyncio.run(drive(plan.mv, 1))
        wall = time.perf_counter() - t0
    return trace_summary(prof, wall, n_chunks * CHUNK)


def kernel_times(kernel, plain, args):
    """(ms, plain_ms, call_ms, plain_call_ms, timing) of a kernel and its
    plain version on ``args``, as ``time_cuda`` reads them."""
    ms, call_ms, timing = time_cuda(lambda: kernel(*args))
    plain_ms, plain_call_ms, plain_timing = time_cuda(lambda: plain(*args))
    return (ms, plain_ms, call_ms, plain_call_ms,
            timing_label(timing, plain_timing))


def b3_launches(reset: bool = False) -> int:
    """Kernel B3's launches (find-or-insert and find) since the last reset;
    with ``reset``, set both counts to 0 after reading them."""
    from risingwave_tpu_torch.ops import hash_table as ht
    n = ht.ht_lookup_or_insert.launches + ht.ht_lookup.launches
    if reset:
        ht.ht_lookup_or_insert.launches = ht.ht_lookup.launches = 0
    return n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 2
    from risingwave_tpu_torch import kernels
    from risingwave_tpu_torch.connector import BID_SCHEMA
    from risingwave_tpu_torch.ops import interval_join
    from risingwave_tpu_torch.storage import MemoryStateStore
    rt_mod = importlib.import_module("risingwave_tpu_torch.ops.rank_totals")
    im_fn = interval_join.interval_match
    device = "cuda"
    phase_s = {}        # wall seconds of each phase
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    # -- phase 1: card and build
    card = card_line()
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"nvcc {name}:\n{log.strip()}")
    print(f"build_s={build_s:.3f}")
    lap("phase 1")

    # -- phase 2: kernels against their plain versions
    max_err = check_rank_totals(device)
    lap("phase 2 rank_totals")
    match_err = check_interval_match(device)
    lap("phase 2 interval_match")
    b3_timing = check_hash_probe(device)
    b3_paths = {}       # B3 launches of each path's run
    lap("phase 2 hash_probe")

    # -- phase 3: q7 core; capture the kernel's busiest real input
    n_chunks = EPOCHS * CHUNKS_PER_EPOCH
    chunks = bid_chunks(n_chunks, device)
    b3_launches(reset=True)
    got, secs, q7_launches, captured = run_q7_capturing(chunks, device)
    b3_paths["q7 executor"] = b3_launches()
    want = q7_expected(chunks)
    if got != want:
        raise AssertionError(f"q7 output differs from numpy q7: "
                             f"{sum((got - want).values())} extra, "
                             f"{sum((want - got).values())} missing rows")
    timed_rows = (n_chunks - CHUNKS_PER_EPOCH) * CHUNK
    print(f"q7: rows_out={sum(got.values())} source_rows/s="
          f"{timed_rows / secs:.1f} rank_totals.launches={q7_launches} "
          f"hash_probe.launches={b3_paths['q7 executor']}")
    if q7_launches <= 0:
        raise AssertionError("the q7 run never launched rank_totals")
    lap("phase 3")

    # -- phase 4: q5 core
    q5 = q5_pipeline(chunks, device)
    b3_launches(reset=True)
    got5, secs5 = asyncio.run(drive(q5, 2))
    b3_paths["q5 executor"] = b3_launches()
    if got5 != q5_expected(chunks):
        raise AssertionError("q5 output differs from numpy group-by count")
    print(f"q5: groups={len(got5)} source_rows/s={timed_rows / secs5:.1f} "
          f"hash_probe.launches={b3_paths['q5 executor']}")
    lap("phase 4")

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
    lap("phase 5")

    # -- phase 6: fused q5 at full width; then one epoch whose body runs
    # with synchronizing calls made errors
    fq5 = FusedQ5(device, Q5_TABLE_CAPACITY, CHUNK, FUSED_CHUNKS_PER_EPOCH)
    b3_launches(reset=True)
    drain5, rate5 = run_fused(fq5, FUSED_TIMED_EPOCHS)
    b3_paths["fused q5"] = b3_launches()
    fq5.epoch(drain5, sync_check=True)
    got5f = drain5.multiset()
    if got5f != fq5.expected():
        raise AssertionError("fused q5 output differs from numpy group-by "
                             "count")
    print(f"q5_fused: epochs={fq5.batch_no} groups={len(got5f)} "
          f"source_rows/s={rate5:.1f} hash_probe.launches="
          f"{b3_paths['fused q5']} sync_free_epoch=ok")
    lap("phase 6")

    # -- phase 7: fused q8 at the bench's shape; then one epoch whose body
    # runs with synchronizing calls made errors
    fq8 = FusedQ8(device, CHUNK, FUSED_CHUNKS_PER_EPOCH)
    b3_launches(reset=True)
    drain8, rate8 = run_fused(fq8, Q8_Q3_TIMED_EPOCHS)
    b3_paths["fused q8"] = b3_launches()
    fq8.epoch(drain8, sync_check=True)
    n_sessions = fq8.check(drain8)
    print(f"q8_fused: epochs={fq8.batch_no} sessions={n_sessions} "
          f"source_rows/s={rate8:.1f} hash_probe.launches="
          f"{b3_paths['fused q8']} flags=clear sync_free_epoch=ok")
    lap("phase 7")

    # -- phase 8: fused q3 at the bench's shape, the top-10 checked after
    # every epoch; a second run (fresh state, so the orders table stays at
    # the bench's load) takes the epoch under the sync check and the trace
    fq3 = FusedQ3(device, CHUNK, FUSED_CHUNKS_PER_EPOCH)
    b3_launches(reset=True)
    _, rate3 = run_fused(fq3, Q8_Q3_TIMED_EPOCHS)
    b3_paths["fused q3"] = b3_launches()
    fq3.check()
    fq3b = FusedQ3(device, CHUNK, FUSED_CHUNKS_PER_EPOCH)
    fq3b.epoch(Drain(), sync_check=True)
    print(f"q3_fused: epochs={fq3.batch_no} top={fq3.history[-1][1]} "
          f"source_rows/s={rate3:.1f} hash_probe.launches="
          f"{b3_paths['fused q3']} flags=clear sync_free_epoch=ok")
    for path, n in b3_paths.items():
        if n <= 0:
            raise AssertionError(f"the {path} run never launched hash_probe")
    lap("phase 8")

    # -- phase 9: the q5 executor in bench form (ChunkBatch ingest from the
    # device generator), one epoch's batched ingest under the sync check
    q5b = run_q5_bench(device)
    b3_paths["q5 executor (bench form)"] = q5b["b3_launches"]
    q5b_trace = trace_q5_bench(device)
    print(f"q5_bench: groups={q5b['groups']} source_rows/s="
          f"{q5b['source_rows_per_s']:.1f} busy_share="
          f"{q5b_trace['busy_share']} hash_probe.launches="
          f"{q5b['b3_launches']} sync_free_batch=ok [{card}]")
    lap("phase 9")

    # -- phase 10: q5 checkpoint to a StateTable, watermark cleaning and
    # compaction of the 1<<21 table, drop and recovery
    q5r = run_q5_recovery(device)
    b3_paths["q5 recovery"] = q5r["recovery_b3"]
    b3_paths["q5 compact"] = q5r["compact_b3"]
    print("q5_recovery: " + json.dumps(
        {k: v for k, v in q5r.items() if k != "compact_input"})
        + f" [{card}]")
    lap("phase 10")

    # -- phase 11: the q7 executor in bench form, batched on both inputs
    q7b = run_q7_bench(device)
    b3_paths["q7 executor (bench form)"] = q7b["b3_launches"]
    b1_paths = {"q7 executor": q7_launches,
                "q7 executor (bench form)": q7b["b1_launches"]}
    print(f"q7_bench: rows_out={q7b['rows_out']} source_rows/s="
          f"{q7b['source_rows_per_s']:.1f} key_capacity="
          f"{q7b['key_capacity']} bucket_width={q7b['bucket_width']} "
          f"rank_totals.launches={q7b['b1_launches']} hash_probe.launches="
          f"{q7b['b3_launches']} [{card}]")
    lap("phase 11")

    # -- phase 12: q7 checkpoint to state tables, drop and recovery
    q7r = run_q7_recovery(device, q7b.pop("multiset"))
    b3_paths["q7 recovery"] = q7r["b3_launches"]
    b1_paths["q7 recovery"] = q7r["b1_launches"]
    print("q7_recovery: " + json.dumps(q7r) + f" [{card}]")
    lap("phase 12")

    # -- phases 13-15: q105 (TopN), q102 (DynamicFilter over a
    # MaterializedAgg bound) and q18 (GroupTopN WITH TIES, batched ingest
    # under the sync check, checkpoint and recovery)
    n_nex = NEX_EPOCHS * NEX_CHUNKS_PER_EPOCH
    auctions, _ = nexmark_chunks("auction", n_nex, device)
    nbids, _ = nexmark_chunks("bid", n_nex, device)
    q105r = run_q105(device, auctions, nbids)
    q105_input = q105r.pop("b1_input")
    b3_inputs = q105r.pop("b3_inputs")
    b1_paths["q105"], b3_paths["q105"] = (q105r["b1_launches"],
                                          q105r["b3_launches"])
    print("q105: " + json.dumps(q105r) + f" [{card}]")
    torch.cuda.empty_cache()
    q102r = run_q102(device, auctions, nbids)
    b3_inputs.update(q102r.pop("b3_inputs"))
    b1_paths["q102"], b3_paths["q102"] = (q102r["b1_launches"],
                                          q102r["b3_launches"])
    print("q102: " + json.dumps(q102r) + f" [{card}]")
    torch.cuda.empty_cache()
    q18r = run_q18(device)
    b3_inputs.update(q18r.pop("b3_inputs"))
    b3_paths["q18"] = q18r["b3_launches"]
    b3_paths["q18 recovery"] = q18r["recovery_b3_launches"]
    print("q18: " + json.dumps(q18r) + f" [{card}]")
    lap("phases 13-15")

    # -- phases 16-20: q5 over HOP windows (one epoch's ingest under the
    # sync check), the EOWC running window and its recovery, q13, the
    # dedup stream and its recovery, the small operators
    torch.cuda.empty_cache()
    q5h = run_q5_hop(device)
    q5h_b1 = q5h.pop("b1_input")
    b3_inputs.update(q5h.pop("b3_inputs"))
    b1_paths["q5_hop"] = q5h["b1_launches"]
    b3_paths["q5_hop"] = q5h["b3_launches"]
    print("q5_hop: " + json.dumps(q5h) + f" [{card}]")
    lap("phase 16")
    torch.cuda.empty_cache()
    eowc = run_eowc(device, nbids)
    b3_inputs.update(eowc.pop("b3_inputs"))
    b3_paths["eowc_running"] = eowc["b3_launches"]
    b3_paths["eowc recovery"] = eowc["recovery_b3_launches"]
    print("eowc_running: " + json.dumps(eowc) + f" [{card}]")
    lap("phase 17")
    print("q13: " + json.dumps(run_q13(device, nbids)) + f" [{card}]")
    lap("phase 18")
    torch.cuda.empty_cache()
    dedup = run_dedup(device)
    b3_inputs.update(dedup.pop("b3_inputs"))
    b3_paths["dedup"] = dedup["b3_launches"]
    b3_paths["dedup recovery"] = dedup["recovery_b3_launches"]
    print("dedup: " + json.dumps(dedup) + f" [{card}]")
    lap("phase 19")
    print("small_ops: " + json.dumps(run_small_ops(
        device, nbids[:NEX_CHUNKS_PER_EPOCH])) + f" [{card}]")
    lap("phase 20")

    # -- phase 21: TPC-H q3 and q10 over tables: DML load, backfill, the
    # refresh functions, each MV gated against numpy three times
    torch.cuda.empty_cache()
    tpch = run_tpch(device)
    tpch_b1 = tpch.pop("b1_input")
    b3_inputs.update(tpch.pop("b3_inputs"))
    b1_paths["tpch"] = tpch["b1_launches"]
    b3_paths["tpch"] = tpch["b3_launches"]
    print("tpch: " + json.dumps(tpch) + f" [{card}]")
    lap("phase 21")

    # -- phase 22: the rest of the NEXmark suite over the phase-13 chunks,
    # each MV gated against numpy; q17 as a multi-fragment job (rows/s at
    # parallelism 1 and 4, the dispatcher's epoch under the sync check,
    # into a sink that degrades, resumes, is dropped and recovered at
    # parallelism 2); q20's join as 4 actors
    torch.cuda.empty_cache()
    ext_data = ExtData(auctions, nbids)
    ext = run_nexmark_extended(device, auctions, nbids, ext_data)
    ext_b1 = ext.pop("b1_input")
    b3_inputs.update(ext.pop("b3_inputs"))
    for name, r in ext["queries"].items():
        if name in EXT_JOINS:
            b1_paths[name] = r["b1_launches"]
        if r["b3_launches"] or name in EXT_JOINS or name == "q17":
            b3_paths[name] = r["b3_launches"]
        print(f"{name}: " + json.dumps(r) + f" [{card}]")
    lap("phase 22 (a) queries")
    q17f = run_q17_fragmented(device, nbids, ext_data.expected("q17"))
    for key in ("p1_b3_launches", f"p{Q17_PARALLELISM}_b3_launches",
                "sink_b3_launches", "recovery_b3_launches"):
        b3_paths[f"q17 fragmented {key[:-12]}"] = q17f[key]
    print("q17_fragmented: " + json.dumps(q17f) + f" [{card}]")
    lap("phase 22 (b) q17 fragmented")
    q20f = run_q20_fragmented(device, auctions, nbids,
                              ext_data.expected("q20"))
    b1_paths["q20 fragmented"] = q20f["b1_launches"]
    b3_paths["q20 fragmented"] = q20f["b3_launches"]
    print("q20_fragmented: " + json.dumps(q20f) + f" [{card}]")
    lap("phase 22 (c) q20 fragmented")

    # -- phase 23: approx_count_distinct's HLL lanes per auction and
    # overall (one more epoch under the sync check), array_agg per bidder,
    # and the bids as JSON events parsed inside the timed window
    torch.cuda.empty_cache()
    from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
    extra, _ = nexmark_chunks("bid", NEX_CHUNKS_PER_EPOCH, device,
                              NexmarkGenerator(NexmarkConfig(
                                  chunk_capacity=CHUNK), seed=SEED + 1,
                                  device=device))
    hll = run_hll(device, nbids, extra)
    del extra
    b3_inputs.update(hll.pop("b3_inputs"))
    b3_paths["hll"] = hll["b3_launches"]
    print("hll: " + json.dumps(hll) + f" [{card}]")
    lap("phase 23 (a) hll")
    arrays = run_array_agg(device, nbids)
    print("array_agg: " + json.dumps(arrays) + f" [{card}]")
    lap("phase 23 (b) array_agg")
    events = run_json_events(device, nbids)
    b3_paths["json events"] = events["b3_launches"]
    print("json_events: " + json.dumps(events) + f" [{card}]")
    lap("phase 23 (c) json events")
    # -- phase 24: SQL end to end through the port's Session: NEXmark
    # q105 (also without its TopN), q17, q18 and q7 by CREATE MATERIALIZED
    # VIEW (a Session each), the SELECTs over q17, then TPC-H q3 and q10
    # over tables loaded by INSERT, through an RF1, an RF2 and an UPDATE
    torch.cuda.empty_cache()
    sql_nex = run_sql_nexmark(device, auctions, nbids, ext_data)
    del ext_data
    for name, r in sql_nex.items():
        b3_paths[f"sql_{name}"] = r["b3_launches"]
        if r["joins"]:
            b1_paths[f"sql_{name}"] = r["b1_launches"]
        print(f"sql_{name}: " + json.dumps(r) + f" [{card}]")
    lap("phase 24 (a) sql nexmark")
    sql_tpch = run_sql_tpch(device)
    b1_paths["sql_tpch"] = sql_tpch["b1_launches"]
    b3_paths["sql_tpch"] = sql_tpch["b3_launches"]
    print("sql_tpch: " + json.dumps(sql_tpch) + f" [{card}]")
    lap("phase 24 (b) sql tpch")
    if len(b3_inputs) != 13:
        raise AssertionError(f"kernel B3 inputs kept only at "
                             f"{sorted(b3_inputs)}")
    for path, n in list(b3_paths.items()) + list(b1_paths.items()):
        if n <= 0:
            raise AssertionError(f"the {path} run never launched its "
                                 "kernel")

    # -- phase 25: kernel times on the inputs their path gave them: B1 on
    # the q7 run's input with the most keyed rows and the busiest inputs of
    # q105, q5_hop and the TPC-H joins, B2 on the fused q7 run's last
    # flush, B3 on the q5 input of HASH_CASES, the q5 compaction's input
    # and the busiest input of each row set, group table and join key
    # table of phases 13-23. They come before
    # the traces: after a trace of ~140,000 device ops later profiler
    # sessions came back short of kernels.
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
    held_to_bound("rank_totals on q7's input", ms, bound_ms)
    # B1 on q105's busiest input (its join at bucket width 2048)
    for kern, plain in zip(rt_mod.rank_totals(*q105_input),
                           rt_mod.rank_totals_plain(*q105_input)):
        max_err = max(max_err, int((kern - plain).abs().max()))
    if max_err:
        raise AssertionError("rank_totals differs from plain on q105's "
                             "input")
    q105_b1 = dict(zip(("ms", "plain_ms", "call_ms", "plain_call_ms",
                        "timing"),
                       kernel_times(rt_mod.rank_totals,
                                    rt_mod.rank_totals_plain, q105_input)))
    q105_b1.update(shape=list(q105_input[1].shape),
                   keyed_rows=q105r["b1_busiest_keyed_rows"],
                   bound_ms=rank_totals_bound(*q105_input)[0])
    held_to_bound("rank_totals on q105's input", q105_b1["ms"],
                  q105_b1["bound_ms"])
    print("rank_totals q105 input: " + json.dumps(q105_b1))
    # B1 on q5_hop's busiest input (its join at bucket width 4096)
    q5h_input = q5h_b1["input"]
    for kern, plain in zip(rt_mod.rank_totals(*q5h_input),
                           rt_mod.rank_totals_plain(*q5h_input)):
        max_err = max(max_err, int((kern - plain).abs().max()))
    if max_err:
        raise AssertionError("rank_totals differs from plain on q5_hop's "
                             "input")
    q5h_b1_t = dict(zip(("ms", "plain_ms", "call_ms", "plain_call_ms",
                         "timing"),
                        kernel_times(rt_mod.rank_totals,
                                     rt_mod.rank_totals_plain, q5h_input)))
    q5h_b1_t.update(shape=list(q5h_input[1].shape),
                    keyed_rows=q5h_b1["keyed_rows"], calls=q5h_b1["calls"],
                    bound_ms=rank_totals_bound(*q5h_input)[0])
    held_to_bound("rank_totals on q5_hop's input", q5h_b1_t["ms"],
                  q5h_b1_t["bound_ms"])
    print("rank_totals q5_hop input: " + json.dumps(q5h_b1_t))
    # B1 on the TPC-H joins' busiest input
    tpch_input = tpch_b1["input"]
    for kern, plain in zip(rt_mod.rank_totals(*tpch_input),
                           rt_mod.rank_totals_plain(*tpch_input)):
        max_err = max(max_err, int((kern - plain).abs().max()))
    if max_err:
        raise AssertionError("rank_totals differs from plain on the TPC-H "
                             "joins' input")
    tpch_b1_t = dict(zip(("ms", "plain_ms", "call_ms", "plain_call_ms",
                          "timing"),
                         kernel_times(rt_mod.rank_totals,
                                      rt_mod.rank_totals_plain, tpch_input)))
    tpch_b1_t.update(shape=list(tpch_input[1].shape),
                     keyed_rows=tpch_b1["keyed_rows"],
                     calls=tpch_b1["calls"],
                     bound_ms=rank_totals_bound(*tpch_input)[0])
    held_to_bound("rank_totals on the TPC-H input", tpch_b1_t["ms"],
                  tpch_b1_t["bound_ms"])
    print("rank_totals tpch input: " + json.dumps(tpch_b1_t))
    # B1 on the busiest input of the extended queries' joins (q9, q20)
    ext_input = ext_b1["input"]
    for kern, plain in zip(rt_mod.rank_totals(*ext_input),
                           rt_mod.rank_totals_plain(*ext_input)):
        max_err = max(max_err, int((kern - plain).abs().max()))
    if max_err:
        raise AssertionError(f"rank_totals differs from plain on "
                             f"{ext_b1['query']}'s input")
    ext_b1_t = dict(zip(("ms", "plain_ms", "call_ms", "plain_call_ms",
                         "timing"),
                        kernel_times(rt_mod.rank_totals,
                                     rt_mod.rank_totals_plain, ext_input)))
    ext_b1_t.update(query=ext_b1["query"], shape=list(ext_input[1].shape),
                    keyed_rows=ext_b1["keyed_rows"], calls=ext_b1["calls"],
                    bound_ms=rank_totals_bound(*ext_input)[0])
    held_to_bound(f"rank_totals on {ext_b1['query']}'s input",
                  ext_b1_t["ms"], ext_b1_t["bound_ms"])
    print("rank_totals nexmark_ext input: " + json.dumps(ext_b1_t))
    # B1 over every input of the q7 run, one call each: its device time on
    # the path, and the bound summed the same way
    path_ms, _, path_timing = time_cuda(
        lambda: [rt_mod.rank_totals(*im) for im in captured], iters=10)
    path_bound_ms = sum(rank_totals_bound(*im)[0] for im in captured)
    held_to_bound("rank_totals over q7's inputs", path_ms, path_bound_ms)
    keyed = keyed_rows(captured)
    print(f"rank_totals q7 inputs: calls={len(captured)} "
          f"path_ms={path_ms} path_bound_ms={path_bound_ms} "
          f"timing={path_timing} keyed_rows={keyed}")
    match_err += mask_errors(im_fn(*match_input),
                             interval_join.interval_match_plain(*match_input))
    if match_err:
        raise AssertionError("interval_match differs from plain on the "
                             "fused q7 flush input")
    nb, lanes = match_input[0].shape
    m_ms, m_plain_ms, m_call_ms, m_plain_call_ms, m_timing = kernel_times(
        im_fn, interval_join.interval_match_plain, match_input)
    m_bound_ms, m_bound_by = interval_match_bound(nb, lanes)
    held_to_bound("interval_match on the fused q7 flush input", m_ms,
                  m_bound_ms)
    ins, find = b3_timing["insert"], b3_timing["find"]
    compact_b3 = compact_probe_times(q5r["compact_input"])
    print("hash_probe compact input: " + json.dumps(compact_b3))
    # B3 on the busiest input of each row set and group table of the new
    # paths, on both of its find-or-insert paths
    path_b3 = {label: probe_input_times(label, *inp, paths=B3_PATHS)
               for label, inp in b3_inputs.items()}
    del b3_inputs
    print("hash_probe path inputs: " + json.dumps(path_b3))
    epochs = {"fused q5": FUSED_TIMED_EPOCHS + 1,
              "fused q8": Q8_Q3_TIMED_EPOCHS + 1,
              "fused q3": Q8_Q3_TIMED_EPOCHS + 1}
    lap("phase 25 kernel times")

    # -- phase 25, continued: where the time goes (device busy share)
    head = chunks[:2 * CHUNKS_PER_EPOCH]
    print("q7_trace: " + json.dumps(trace(q7_pipeline, head, device)))
    print("q5_trace: " + json.dumps(trace(q5_pipeline, head, device)))
    two = 2 * NEX_CHUNKS_PER_EPOCH
    print("q105_trace: " + json.dumps(trace_plan(lambda: nexmark_plan(
        "q105", device, auctions[:two], nbids[:two]), 2 * two)))
    print("q18_trace: " + json.dumps(trace_plan(lambda: nexmark_plan(
        "q18", device, None, nbids[:two]), two)))
    print("eowc_running_trace: " + json.dumps(trace_plan(lambda: eowc_plan(
        device, epoch_source(BID_SCHEMA, nbids[:two]), MemoryStateStore()),
        two)))
    torch.cuda.empty_cache()
    # one epoch of each source: the trace holds ~145,000 device ops
    k = Q5_HOP_CHUNKS_PER_EPOCH
    print("q5_hop_trace: " + json.dumps(trace_plan(lambda: q5_hop_plan(
        device, [DeviceBidSource(bench_gen(device), [k], 1)
                 for _ in range(2)]), 2 * k)))
    del auctions, nbids
    torch.cuda.empty_cache()
    print("q7_fused_trace: " + json.dumps(trace_fused(fq7)))
    b3_epoch_ms = {}    # B3's device ms in one fused epoch of each path
    for path, runner in (("q5", fq5), ("q8", fq8), ("q3", fq3b)):
        summary = trace_fused(runner)
        b3_epoch_ms[f"fused {path}"] = summary["b3_ms"]
        print(f"{path}_fused_trace: " + json.dumps(summary))
    fq3b.check()

    lap("phase 25 traces")
    print("phase_seconds: " + json.dumps(phase_s))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "rank_totals", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/rank_totals.cu",
        "replaces": "risingwave_tpu/ops/pallas_rank.py:85",
        "tpu_counterpart": "risingwave_tpu/ops/pallas_rank.py::_kernel",
        "path": "q7 executor; q7 executor (bench form); q7 recovery; "
                "q105; q102; q5_hop; tpch; q9; q20; q101; q103; q104; "
                "q106; q20 fragmented; sql_q105; sql_q7; sql_tpch",
        "launches": q7_launches, "path_launches": b1_paths,
        "q105_input": q105_b1, "q5_hop_input": q5h_b1_t,
        "tpch_input": tpch_b1_t, "nexmark_ext_input": ext_b1_t,
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
        "bound_by": m_bound_by, "library_ms": None}, {
        "name": "hash_probe", "route": "cuda",
        "source": "risingwave_tpu_torch/csrc/hash_probe.cu",
        "replaces": "risingwave_tpu/ops/hash_table.py:77",
        "tpu_counterpart": "risingwave_tpu/ops/hash_table.py::"
            "ht_lookup_or_insert (:77) and ::ht_lookup (:154), a "
            "lax.while_loop with no Pallas kernel",
        "path": "q7 and q5 executors, fused q5, q8 and q3, q5 and q7 "
                "executors in bench form, q5 recovery, q5 compact, q7 "
                "recovery, q105, q102, q18, q18 recovery, q5_hop, "
                "eowc_running, eowc recovery, dedup, dedup recovery, tpch, "
                "q9, q17, q20, q101, q103, q104, q106, q17 fragmented "
                "(parallelism 1 and 4, the sink run, its recovery), q20 "
                "fragmented, hll, json events, sql_q105, sql_q17, sql_q18, "
                "sql_q7, sql_tpch",
        "launches": sum(b3_paths.values()), "path_launches": b3_paths,
        "launches_per_epoch": {p: b3_paths[p] / e
                               for p, e in epochs.items()},
        "equal": True, "max_abs_err": 0,
        "shape": [CHUNK, Q5_TABLE_CAPACITY], "input": ins["case"],
        "ms": ins["ms"], "kernel_ms": ins["ms"], "plain_ms": ins["plain_ms"],
        "call_ms": ins["call_ms"], "timing": ins["timing"],
        "bound_ms": ins["bound_ms"], "bound_us": ins["bound_ms"] * 1e3,
        "bound_by": ins["bound_by"], "sector_floor_ms": ins["floor_ms"],
        "claim_rounds": ins["claim_rounds"],
        "find_input": find["case"], "find_ms": find["ms"],
        "find_plain_ms": find["plain_ms"],
        "find_bound_ms": find["bound_ms"],
        "find_sector_floor_ms": find["floor_ms"],
        "epoch_ms": b3_epoch_ms, "compact_input": compact_b3,
        "path_inputs": path_b3, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
