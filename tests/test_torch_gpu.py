"""Tests of the PyTorch port that need a CUDA card: the hand-written kernels
against their plain versions on the card (kernel B3 on every
``chip_smoke.HASH_CASES`` input, find-or-insert on both of its paths), the
q7 pipeline and the fused q7, q8 and q3 epochs on the card against the same
runs on the CPU, the fused q5, q7, q8 and q3 epoch bodies and the batched
(ChunkBatch) ingest of HashAgg and HashJoin with synchronizing CUDA calls
made errors, eviction with fault-in on the card against the CPU, a
non-integer float64 sum lane on the card against the CPU, TopN and
GroupTopN (a VARCHAR order whose dictionary grows mid-run included), a
DynamicFilter under a SimpleAgg(max) bound and MIN/MAX over VARCHAR on the
card against the CPU, and the row set's and TopN's apply
with synchronizing calls made errors; HopWindow's batch, q5 over HOP
windows, the EOWC running window (the Sort's row set rebuilt, and its
recovery) on the card against the CPU, kernel B3's lowest-row winner among
in-chunk duplicates on both of its paths, and the new executors' batched
ingest with synchronizing calls made errors; TPC-H q3 and q10 over table
jobs (load, backfill, one RF1 and one RF2) and the DECIMAL/DATE
expressions, string functions and DECIMAL aggs on the card against the
CPU, and the Backfill's ChunkBatch filter with synchronizing calls made
errors; HLL register lanes (the rank's edge values, -0.0, NaN and the
INT64 extremes), integer division by -1 and the saturating float casts,
and the JSONB, array and struct functions on the card against the CPU,
and an HLL HashAgg's batched ingest with synchronizing calls made
errors. They skip where no card is present;
run them on the card
with ``python -m pytest tests/test_torch_gpu.py -m gpu``.
"""

import asyncio

import numpy as np
import pytest
import torch

import chip_smoke as cs

from risingwave_tpu_torch.ops import interval_join as ij
from risingwave_tpu_torch.ops import rank_totals as rt_mod
from risingwave_tpu_torch.ops.rank_totals import (
    rank_totals, rank_totals_plain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n,w,pattern", [
    (4096, 128, "clustered"), (4000, 128, "clustered"), (4096, 128, "none"),
    (4096, 128, "one_hot_key"), (4096, 16, "clustered"), (33, 300, "random"),
    (1, 1, "random"), (4096, 128, "interleaved"), (4000, 128, "one_hot_key"),
    (4096, 129, "clustered"), (4096, 128, "wide"), (5000, 7, "clustered"),
    (32768, 128, "clustered"), (4096, 128, "probe_256"),
    (4096, 129, "few_257")])
def test_rank_totals_kernel_equals_plain(cuda, n, w, pattern):
    """Exact on the card for grouped chunks (no sort pass), chunks sorted
    in one pass (interleaved, random) or two (wide: about 1,000 keys), W
    not a multiple of 4, N beyond one block's shared-memory sort, and
    chunks whose rows mostly have ident < 0 (a probe chunk whose first
    rows find one key; a few rows at random over 8 keys)."""
    rng = np.random.default_rng(n + w)
    if pattern == "clustered":
        ident = (np.arange(n) // 50).astype(np.int32)
        ident[rng.random(n) < 0.1] = -1
    elif pattern == "none":
        ident = np.full(n, -1, np.int32)
    elif pattern == "one_hot_key":
        ident = np.zeros(n, np.int32)
    elif pattern == "interleaved":
        ident = (np.arange(n) % 64).astype(np.int32)
    elif pattern == "wide":
        ident = rng.integers(-1, 1000, n).astype(np.int32)
    elif pattern.startswith("probe_"):   # the first k rows find one key
        ident = np.full(n, -1, np.int32)
        ident[:int(pattern[6:])] = 3
    elif pattern.startswith("few_"):     # k rows at random over 8 keys
        k = int(pattern[4:])
        ident = np.full(n, -1, np.int32)
        ident[rng.choice(n, k, replace=False)] = rng.integers(0, 8, k)
    else:
        ident = rng.integers(-1, 5, n).astype(np.int32)
    matches = torch.as_tensor(rng.random((n, w)) < 0.3, device=cuda)
    ident = torch.as_tensor(ident, device=cuda)
    before = rt_mod.rank_totals.launches
    r, t = rank_totals(ident, matches)
    r0, t0 = rank_totals_plain(ident, matches)
    torch.cuda.synchronize()
    assert rt_mod.rank_totals.launches == before + 1
    assert torch.equal(r, r0) and torch.equal(t, t0)


def _bids(device, n_chunks=6):
    from risingwave_tpu_torch.connector import (
        NexmarkConfig, NexmarkGenerator,
    )
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=512), device=device)
    return [gen.next_bid_chunk() for _ in range(n_chunks)]


def _ordered_output(executor):
    from risingwave_tpu_torch.common import StreamChunk, chunk_to_rows

    async def drive():
        out = []
        async for m in executor.execute():
            if isinstance(m, StreamChunk):
                out.extend(chunk_to_rows(m, executor.schema, with_ops=True))
        return out

    return asyncio.run(drive())


def test_q7_on_card_equals_cpu(cuda):
    """The same bids through the q7 pipeline on the card and on the CPU
    give the same output, row for row and in order."""
    import chip_smoke as cs
    on_card = _ordered_output(cs.q7_pipeline(_bids("cuda"), "cuda"))
    on_cpu = _ordered_output(cs.q7_pipeline(_bids("cpu"), "cpu"))
    assert on_card == on_cpu and on_card


def test_chip_smoke_pipelines_small(cuda):
    import chip_smoke as cs
    chunks = _bids("cuda")
    got, _ = asyncio.run(cs.drive(cs.q7_pipeline(chunks, "cuda"), 2))
    assert got == cs.q7_expected(chunks)
    got5, _ = asyncio.run(cs.drive(cs.q5_pipeline(chunks, "cuda"), 2))
    assert got5 == cs.q5_expected(chunks)


@pytest.mark.parametrize("nb,w,pattern", [
    (1 << 15, 128, "random"), (1000, 128, "random"), (777, 100, "random"),
    (512, 128, "all_occupied"), (512, 128, "none_occupied"),
    (4096, 128, "high_words"), (1, 1, "random"), (17, 3, "high_words")])
def test_interval_match_kernel_equals_plain(cuda, nb, w, pattern):
    import chip_smoke as cs
    args = cs.b2_case_inputs(nb, w, pattern, nb + w, cuda)
    before = ij.interval_match.launches
    got = ij.interval_match(*args)
    want = ij.interval_match_plain(*args)
    torch.cuda.synchronize()
    assert ij.interval_match.launches == before + 1
    assert all(g.dtype == torch.bool for g in got)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


def _fused_q7_rows(device):
    """Every drained output row of a small fused q7 run, in order."""
    import chip_smoke as cs
    from risingwave_tpu_torch.common import chunk_to_rows

    class Rows:
        def __init__(self):
            self.rows = []

        def add(self, chunk):
            self.rows += chunk_to_rows(chunk, run.core.out_schema,
                                       with_ops=True)

    run = cs.FusedQ7(device, n_buckets=1024, lanes=64, chunk=512, k=8)
    out = Rows()
    for _ in range(3):
        run.epoch(out)
    return out.rows


def test_fused_q7_on_card_equals_cpu(cuda):
    on_card = _fused_q7_rows("cuda")
    assert on_card == _fused_q7_rows("cpu") and on_card


def test_fused_q7_epoch_body_makes_no_host_sync(cuda):
    import chip_smoke as cs
    run = cs.FusedQ7("cuda", n_buckets=1024, lanes=64, chunk=512, k=8)
    drain, _ = cs.run_fused(run, 1)
    run.epoch(drain, sync_check=True)
    assert drain.multiset() == run.expected()


def _float_sum_lanes(device):
    """A float64 sum over non-integer values into few groups: many rows
    add into each group's lane, in no fixed order on the card."""
    from risingwave_tpu_torch.common import FLOAT64, INT64, Schema, \
        make_chunk
    from risingwave_tpu_torch.expr import agg
    from risingwave_tpu_torch.ops.grouped_agg import AggCore
    rng = np.random.default_rng(11)
    schema = Schema.of(("k", INT64), ("v", FLOAT64))
    core = AggCore((INT64,), (0,), [agg("sum", 1, FLOAT64)],
                   table_capacity=64, out_capacity=64, device=device)
    state = core.init_state()
    for _ in range(4):
        rows = [(int(rng.integers(0, 5)), float(rng.random() * 1e3 - 300))
                for _ in range(4096)]
        state = core.apply_chunk(state, make_chunk(schema, rows,
                                                   capacity=4096,
                                                   device=device))
    return [lane.cpu() for lane in state.lanes]


def test_float64_sum_on_card_within_bound_of_cpu(cuda):
    """Atomic adds on the card sum in an unspecified order; over 16K
    non-integer addends per run the float64 lane stays within a relative
    1e-12 of the CPU's sequential sum (about 16K roundings of 2**-53)."""
    card, cpu = _float_sum_lanes("cuda"), _float_sum_lanes("cpu")
    assert torch.equal(card[0], cpu[0])          # row counts are exact
    sums_card, sums_cpu = card[1], cpu[1]
    live = cpu[0] > 0
    assert int(live.sum()) == 5
    assert torch.allclose(sums_card[live], sums_cpu[live], rtol=1e-12,
                          atol=0)


@pytest.mark.parametrize("name,op,path", [
    (name, op, path) for name, op in cs.HASH_CASES
    for path in (cs.B3_PATHS if op == "insert" else ("auto",))])
def test_hash_probe_kernel_equals_plain(cuda, name, op, path):
    """B3 equals its plain version slot for slot (slots, is_new or found,
    overflow and the final table) on each listed input, and with a float64
    key also the plain version on CPU copies; every find-or-insert input on
    the phased and on the cooperative grid path."""
    from risingwave_tpu_torch.ops import hash_table as ht
    table, cols, valid = cs.hash_case(name, cuda)
    before = ht.ht_lookup_or_insert.launches + ht.ht_lookup.launches
    err, _ = cs.compare_hash_probe(table, cols, valid, op, path)
    torch.cuda.synchronize()
    assert ht.ht_lookup_or_insert.launches + ht.ht_lookup.launches \
        == before + 1
    assert err == 0


def _small_runner(kind, device):
    if kind == "q5":
        return cs.FusedQ5(device, 1 << 12, 512, 8)
    if kind == "q7":
        return cs.FusedQ7(device, n_buckets=1024, lanes=64, chunk=512, k=8)
    if kind == "q8":
        return cs.FusedQ8(device, 512, 8, gap_us=5_000, capacity=1 << 12,
                          closed_capacity=1 << 13)
    return cs.FusedQ3(device, 512, 8, orders_capacity=1 << 12,
                      agg_capacity=1 << 12)


@pytest.mark.parametrize("kind", ["q5", "q8", "q3"])
def test_fused_epoch_bodies_make_no_host_sync(cuda, kind):
    run = _small_runner(kind, "cuda")
    drain, _ = cs.run_fused(run, 1)
    run.epoch(drain, sync_check=True)
    if kind == "q5":
        assert drain.multiset() == run.expected()
    elif kind == "q8":
        assert run.check(drain) > 0
    else:
        assert run.check() == 3


@pytest.mark.parametrize("kind", ["q8", "q3"])
def test_small_fused_runs_on_card_equal_cpu(cuda, kind):
    """Three epochs of the fused q8 or q3 run give the same rows, in the
    same order, and the same final state on the card as on the CPU."""
    def rows(device):
        run = _small_runner(kind, device)
        drain = cs.Drain()
        for _ in range(3):
            run.epoch(drain)
        return [r.tolist() for r, _ in drain.parts], run

    on_card, card_run = rows("cuda")
    on_cpu, cpu_run = rows("cpu")
    assert on_card == on_cpu and on_card
    _assert_payload_equal(card_run.core.export_host(card_run.state),
                          cpu_run.core.export_host(cpu_run.state))


def _assert_payload_equal(a, b):
    """Two ``export_host`` payloads hold equal arrays under equal names."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_payload_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_payload_equal(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_batched_ingest_makes_no_host_sync(cuda):
    """The batched steps read nothing back to the host: one epoch of bids
    through the q5 pipeline's Project and HashAgg ``map_chunk_batch``, and
    one sub-batch of probe chunks applied by the q7 join (its passes read
    beforehand for the whole batch, its stats after); the join's output
    then equals numpy q7 over the same bids."""
    from risingwave_tpu_torch.common import make_chunk
    from risingwave_tpu_torch.ops.join_state import pass_flags
    k = 8
    gen = cs.bench_gen(cuda)
    agg = cs.q5_bench_pipeline(cs.DeviceBidSource(gen, [], 1), cuda)
    batch = gen.next_batch(k)
    asyncio.run(cs.sync_free_batch(agg, batch))
    assert int(agg.state.lanes[0].sum()) == k * cs.CHUNK

    join = cs.q7_bench_join(cs.DeviceBidSource(gen, [], 1),
                            cs.DeviceBidSource(gen, [], 1), cuda)
    probe = asyncio.run(_first(join.left.map_chunk_batch(batch)))
    auction, price, ts = (batch.chunk.columns[j].data.reshape(-1).cpu()
                          .numpy() for j in (0, 2, 5))
    ws = ts // cs.Q7_WINDOW_US * cs.Q7_WINDOW_US
    maxes = {}
    for w, p in zip(ws.tolist(), price.tolist()):
        maxes[w] = max(maxes.get(w, p), p)
    build = make_chunk(join.right.schema, sorted(maxes.items()),
                       capacity=len(maxes), device=cuda)
    join._stage("right", build, None)
    passes = pass_flags(probe.chunk)
    with cs.no_host_sync():
        for i in range(k):
            join._stage("left", probe.at(i), None, passes[i])
    drain = cs.Drain()
    for out in join._flush_pending():
        drain.add(out)
    assert drain.multiset() == cs.q7_expected_cols(auction, price, ts)


async def _first(agen):
    async for x in agen:
        return x


def _eviction_run(device):
    """An agg and a join under memory budgets (eviction at checkpoints,
    fault-in of revisited keys) on ``device``: their output rows in order
    and their evicted key sets."""
    from risingwave_tpu_torch.common import INT64, Schema, make_chunk
    from risingwave_tpu_torch.expr import agg, count_star
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import (
        Barrier, HashAggExecutor, HashJoinExecutor, MockSource,
    )
    from risingwave_tpu_torch.stream.hash_agg import agg_state_schema
    schema = Schema.of(("k", INT64), ("g", INT64), ("v", INT64))
    store = MemoryStateStore()
    msgs, rows_r, k = [Barrier.new(1)], [], 0
    for b in range(8):
        rows = [(k + i, b * 16 + i, i) for i in range(16)]
        if b % 3 == 2:
            rows += [(k + 16 + g, g, 7) for g in range(4)]
        k += len(rows)
        msgs += [make_chunk(schema, rows, capacity=32, device=device),
                 Barrier.new(b + 2, checkpoint=b % 2 == 0)]
        rows_r.append(rows[::2])
    calls = [count_star(), agg("sum", 2, INT64), agg("min", 2, INT64)]
    hagg = HashAggExecutor(
        MockSource(schema, msgs), [1], calls,
        state_table=StateTable(store, 1, agg_state_schema([schema[1]], calls),
                               [0]),
        table_capacity=256, out_capacity=64, hbm_group_budget=30,
        device=device)
    right = [msgs[0]]
    for b, rows in enumerate(rows_r):
        right += [make_chunk(schema, rows, capacity=32, device=device),
                  msgs[2 + 2 * b]]
    join = HashJoinExecutor(
        MockSource(schema, msgs), MockSource(schema, right), [1], [1],
        left_state_table=StateTable(store, 2, schema, [1, 0]),
        right_state_table=StateTable(store, 3, schema, [1, 0]),
        key_capacity=64, bucket_width=4, out_capacity=64, hbm_key_budget=16,
        device=device)
    return (_ordered_output(hagg), hagg._evicted, _ordered_output(join),
            join._evicted)


def test_eviction_with_fault_in_on_card_equals_cpu(cuda):
    on_card = _eviction_run("cuda")
    on_cpu = _eviction_run("cpu")
    assert on_card == on_cpu
    assert on_card[1] and on_card[3] and on_card[0] and on_card[2]


def _kv_messages(device, epochs, seed, strings=False):
    """Scripted (k, v) epochs on ``device``: inserts, then deletes and
    updates of earlier keys; v is a VARCHAR with ``strings``."""
    from risingwave_tpu_torch.common import (
        INT64, OP_DELETE, OP_INSERT, VARCHAR, Schema, make_chunk,
    )
    from risingwave_tpu_torch.stream import Barrier
    rng = np.random.default_rng(seed)
    schema = Schema.of(("k", INT64), ("v", VARCHAR if strings else INT64))
    live, msgs = {}, [Barrier.new(1)]
    for e in range(epochs):
        rows, ops = [], []
        for _ in range(48):
            if live and rng.random() < 0.3:
                k = int(rng.choice(sorted(live)))
                rows.append((k, live.pop(k)))
                ops.append(OP_DELETE)
            else:
                k = int(rng.integers(0, 500))
                if k in live:
                    continue
                v = (f"s{int(rng.integers(0, 60)):02d}-{e}" if strings
                     else int(rng.integers(-50, 50)))
                live[k] = v
                rows.append((k, v))
                ops.append(OP_INSERT)
        msgs += [make_chunk(schema, rows, ops, capacity=64, device=device),
                 Barrier.new(e + 2)]
    return schema, msgs


def _topn_run(device, group: bool):
    from risingwave_tpu_torch.ops.topn import OrderSpec
    from risingwave_tpu_torch.stream import MockSource, TopNExecutor
    schema, msgs = _kv_messages(device, 6, 11)
    top = TopNExecutor(MockSource(schema, msgs), [OrderSpec(1, desc=True)],
                       0, 3, pk_indices=[0], group_by=[1] if group else [],
                       with_ties=group, table_capacity=1 << 10,
                       out_capacity=64, device=device)
    return _ordered_output(top)


@pytest.mark.parametrize("group", [False, True])
def test_topn_on_card_equals_cpu(cuda, group):
    assert _topn_run("cuda", group) == _topn_run("cpu", group)


def _topn_growth_run(device):
    """A TopN ordered by a VARCHAR column whose chunks are made only when
    the executor reaches them: strings new to the dictionary (tagged by
    device, so each run grows it) arrive mid-run and force refills, and an
    epoch of known strings takes the fast path. Returns (rows with the tag
    stripped, fast flushes, refills)."""
    from risingwave_tpu_torch.common import (
        INT64, OP_INSERT, VARCHAR, Schema, make_chunk,
    )
    from risingwave_tpu_torch.ops.topn import OrderSpec
    from risingwave_tpu_torch.stream import Barrier, MockSource, TopNExecutor
    schema = Schema.of(("k", INT64), ("s", VARCHAR))
    tag = f"growth-{device}-"
    epochs = [[(1, "m"), (2, "c"), (3, "x"), (4, "f")], [(5, "a")],
              [(6, "c")], [(7, "b")]]

    class Lazy(MockSource):
        async def execute(self):
            yield Barrier.new(1)
            for e, rows in enumerate(epochs):
                yield make_chunk(schema, [(k, tag + v) for k, v in rows],
                                 [OP_INSERT] * len(rows), capacity=64,
                                 device=device)
                yield Barrier.new(e + 2)

    top = TopNExecutor(Lazy(schema, []), [OrderSpec(1, is_string=True)], 0,
                       3, pk_indices=[0], table_capacity=1 << 10,
                       out_capacity=64, device=device)
    rows = [(op, (k, v[len(tag):])) for op, (k, v) in _ordered_output(top)]
    return rows, top.n_fast_flushes, top.n_refills


def test_topn_refill_forced_by_dictionary_growth_on_card(cuda):
    """The dictionary grows mid-run: the flushes after growth refill on the
    card as on the CPU, the one without growth is a fast flush, and the
    rows are equal."""
    on_card = _topn_growth_run("cuda")
    assert on_card == _topn_growth_run("cpu")
    assert on_card[1:] == (1, 3)


def test_row_set_and_topn_apply_make_no_host_sync(cuda):
    """The row set's apply and TopN's batched apply (group table through
    kernel B3) read nothing back to the host; the flush after them equals
    the per-chunk run on the CPU."""
    from risingwave_tpu_torch.common import stack_chunks
    from risingwave_tpu_torch.ops.row_set import rs_apply_chunk, rs_new
    from risingwave_tpu_torch.ops.topn import OrderSpec
    from risingwave_tpu_torch.stream import Barrier, MockSource, TopNExecutor
    schema, msgs = _kv_messages("cuda", 4, 5)
    chunks = [m for m in msgs if not isinstance(m, Barrier)]
    rows = rs_new([schema[0].type], schema.types, 1 << 10, "cuda")
    with cs.no_host_sync():
        for c in chunks:
            rs_apply_chunk(rows, c, [0])
    assert int(rows.live.sum()) > 0

    def topn(device, source_msgs):
        return TopNExecutor(MockSource(schema, source_msgs),
                            [OrderSpec(1)], 0, 4, pk_indices=[0],
                            group_by=[1], table_capacity=1 << 10,
                            out_capacity=64, device=device)

    top = topn("cuda", [])
    batch = stack_chunks(chunks)

    async def ingest():
        with cs.no_host_sync():
            async for _ in top.map_chunk_batch(batch):
                pass
        from risingwave_tpu_torch.common import chunk_to_rows
        out = []
        async for c in top.on_barrier(Barrier.new(2)):
            out.extend(chunk_to_rows(c, schema, with_ops=True))
        return out

    on_card = asyncio.run(ingest())
    _, cpu_msgs = _kv_messages("cpu", 4, 5)
    cpu_chunks = [m for m in cpu_msgs if not isinstance(m, Barrier)]
    on_cpu = _ordered_output(topn("cpu", [Barrier.new(1)] + cpu_chunks
                                  + [Barrier.new(2)]))
    assert on_card == on_cpu and on_card


def _dynamic_filter_max_run(device):
    """``v >= (SELECT max(v) FROM t)``: a DynamicFilter whose RHS is a
    SimpleAgg(max) over the same stream (tests/test_frontend.py's plan)."""
    from risingwave_tpu_torch.common import INT64, Schema, make_chunk
    from risingwave_tpu_torch.expr import agg
    from risingwave_tpu_torch.stream import (
        Barrier, DynamicFilterExecutor, MockSource, SimpleAggExecutor,
    )
    rng = np.random.default_rng(8)
    schema = Schema.of(("k", INT64), ("v", INT64))
    msgs = [Barrier.new(1)]
    for e in range(5):
        rows = [(e * 40 + i, int(rng.integers(0, 1000))) for i in range(40)]
        msgs += [make_chunk(schema, rows, capacity=64, device=device),
                 Barrier.new(e + 2)]
    rhs = SimpleAggExecutor(MockSource(schema, msgs),
                            [agg("max", 1, INT64)], device=device)
    dyn = DynamicFilterExecutor(MockSource(schema, msgs), rhs, key_col=1,
                                cmp="greater_than_or_equal", pk_indices=[0],
                                table_capacity=1 << 10, out_capacity=64,
                                device=device)
    return _ordered_output(dyn)


def test_dynamic_filter_fed_by_simple_agg_max_on_card_equals_cpu(cuda):
    on_card = _dynamic_filter_max_run("cuda")
    assert on_card == _dynamic_filter_max_run("cpu") and on_card


def _varchar_minmax_run(device):
    from risingwave_tpu_torch.common import VARCHAR
    from risingwave_tpu_torch.expr import agg, count_star
    from risingwave_tpu_torch.stream import HashAggExecutor, MockSource
    schema, msgs = _kv_messages(device, 5, 3, strings=True)
    calls = [agg("min", 1, VARCHAR), agg("max", 1, VARCHAR), count_star()]
    hagg = HashAggExecutor(MockSource(schema, msgs), [0], calls,
                           table_capacity=1 << 10, out_capacity=64,
                           device=device)
    return _ordered_output(hagg)


def test_min_max_varchar_on_card_equals_cpu(cuda):
    """MIN/MAX over VARCHAR (lanes reduced in rank << 32 | id space, the
    rank table fetched per update as the dictionary grows) on the card
    equals the CPU, row for row."""
    on_card = _varchar_minmax_run("cuda")
    assert on_card == _varchar_minmax_run("cpu") and on_card


def _hop_batch(device):
    """A ChunkBatch of device-generated bids through HopWindow(2 s, 10 s):
    every output tensor on the host."""
    from risingwave_tpu_torch.connector import (
        BID_SCHEMA, DeviceBidGenerator, NexmarkConfig,
    )
    from risingwave_tpu_torch.stream import HopWindowExecutor, MockSource
    gen = DeviceBidGenerator(NexmarkConfig(chunk_capacity=256), device=device)
    hop = HopWindowExecutor(MockSource(BID_SCHEMA, []), 5, 2_000_000,
                            10_000_000)

    async def first():
        async for out in hop.map_chunk_batch(gen.next_batch(4)):
            return out

    c = asyncio.run(first()).chunk
    return [t.cpu() for t in [c.ops, c.vis] + [
        x for col in c.columns for x in (col.data, col.mask)]]


def test_hop_window_batch_on_card_equals_cpu(cuda):
    on_card, on_cpu = _hop_batch("cuda"), _hop_batch("cpu")
    assert on_card[0].shape == (20, 256)
    assert all(torch.equal(a, b) for a, b in zip(on_card, on_cpu))


def _nexmark_source(device, ticks, cfg, batch=False, first_epoch=1,
                    checkpoint=False, skip=0):
    """The host generator's bids (seed 42) after its first ``skip`` chunks:
    a chunk (or a one-chunk batch), then a barrier, per tick."""
    from risingwave_tpu_torch.common import stack_chunks
    from risingwave_tpu_torch.connector import BID_SCHEMA, NexmarkGenerator
    from risingwave_tpu_torch.stream import Barrier, MockSource
    gen = NexmarkGenerator(cfg, seed=42, device=device)
    chunks = [gen.next_bid_chunk() for _ in range(skip + ticks)][skip:]
    msgs = [Barrier.new(first_epoch, checkpoint=checkpoint)]
    for i, c in enumerate(chunks):
        msgs += [stack_chunks([c]) if batch else c,
                 Barrier.new(first_epoch + 1 + i, checkpoint=checkpoint)]
    return MockSource(BID_SCHEMA, msgs)


def _mv_rows(plan, store) -> list:
    from risingwave_tpu_torch.stream import Barrier

    async def run():
        async for m in plan.mv.execute():
            if isinstance(m, Barrier) and m.checkpoint:
                store.commit(m.epoch.curr)

    asyncio.run(run())
    return sorted(plan.mv.rows())


def test_q5_hop_small_on_card_equals_cpu(cuda):
    """q5 over HOP windows (the HashAggs and the join on kernels B3 and
    B1) on bids spread over ~8 slides, per chunk and batched."""
    from risingwave_tpu_torch.connector import NexmarkConfig
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    cfg = NexmarkConfig(chunk_capacity=64, events_per_second=50)
    for batch in (False, True):
        rows = []
        for d in ("cuda", "cpu"):
            store = MemoryStateStore()
            plan = plans.q5_hop(
                _nexmark_source(d, 12, cfg, batch),
                _nexmark_source(d, 12, cfg, batch),
                StateTable(store, 1, plans.q5_hop_schema(), [2, 0, 3]),
                agg_capacity=1 << 10, key_capacity=1 << 8, bucket_width=64,
                out_capacity=64, device=d)
            rows.append(_mv_rows(plan, store))
        assert rows[0] == rows[1] and rows[0]


def test_eowc_running_with_sort_compaction_on_card_equals_cpu(cuda):
    """WatermarkFilter, the Sort's row set (kernel B3, rebuilt once half
    its 1<<9 slots hold keys) and EowcOverWindow on the card as on the
    CPU, and recovered from state tables."""
    from risingwave_tpu_torch.connector import NexmarkConfig
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import nexmark_plans as plans
    cfg = NexmarkConfig(chunk_capacity=64, events_per_second=50)

    def run(d, store, ticks, skip=0, tables=False):
        src = _nexmark_source(d, ticks, cfg, first_epoch=1 + skip,
                              checkpoint=tables, skip=skip)
        plan = plans.eowc_running(
            src, StateTable(store, 1, plans.eowc_running_schema(), [5]),
            sort_capacity=1 << 9, out_capacity=64,
            state_tables=(plans.eowc_running_state_tables(store)
                          if tables else None),
            row_id_start=skip * 64, device=d)
        return _mv_rows(plan, store)

    rows = []
    for d in ("cuda", "cpu"):
        whole = run(d, MemoryStateStore(), 8)
        store = MemoryStateStore()
        run(d, store, 4, tables=True)
        assert run(d, store, 4, skip=4, tables=True) == whole
        rows.append(whole)
    assert rows[0] == rows[1] and rows[0]


def test_dedup_first_row_wins_on_both_b3_paths(cuda):
    """In-chunk duplicates: kernel B3's is_new falls on each new key's
    lowest valid row on its phased and its grid path, and equals the plain
    version slot for slot."""
    import chip_smoke as cs
    got = cs.check_first_wins("cuda")
    assert set(got) == set(cs.B3_PATHS)


def test_new_batched_ingest_makes_no_host_sync(cuda):
    """WatermarkFilter, HopWindow, Project, HashAgg, Sort, AppendOnlyDedup
    and Expand take a ChunkBatch with synchronizing CUDA calls made
    errors."""
    import chip_smoke as cs
    from risingwave_tpu_torch.common import INT64, TIMESTAMP
    from risingwave_tpu_torch.connector import (
        BID_SCHEMA, DeviceBidGenerator, NexmarkConfig,
    )
    from risingwave_tpu_torch.expr import col, count_star
    from risingwave_tpu_torch.stream import (
        AppendOnlyDedupExecutor, ExpandExecutor, HashAggExecutor,
        HopWindowExecutor, MockSource, ProjectExecutor, SortExecutor,
        WatermarkFilterExecutor,
    )
    src = MockSource(BID_SCHEMA, [])
    wf = WatermarkFilterExecutor(src, 5, 4_000_000, device="cuda")
    hop = HopWindowExecutor(wf, 5, 2_000_000, 10_000_000)
    proj = ProjectExecutor(hop, [col(7, TIMESTAMP), col(0, INT64)],
                           ("window_start", "auction"))
    agg = HashAggExecutor(proj, [0, 1], [count_star()],
                          table_capacity=1 << 14, out_capacity=256,
                          device="cuda")
    sort = SortExecutor(src, 5, [0, 1], table_capacity=1 << 12,
                        device="cuda")
    dedup = AppendOnlyDedupExecutor(src, [0, 1], table_capacity=1 << 12,
                                    device="cuda")
    expand = ExpandExecutor(src, [[0], [1, 2]])
    gen = DeviceBidGenerator(NexmarkConfig(chunk_capacity=256),
                             device="cuda")
    batch = gen.next_batch(4)

    async def run():
        async for a in wf.map_chunk_batch(batch):
            async for b in hop.map_chunk_batch(a):
                async for c in proj.map_chunk_batch(b):
                    async for _ in agg.map_chunk_batch(c):
                        pass
        for ex in (sort, dedup, expand):
            async for _ in ex.map_chunk_batch(batch):
                pass

    with cs.no_host_sync():
        asyncio.run(run())
    torch.cuda.synchronize()
    assert int(agg.state.table.occupied.sum()) > 0


def _tpch_mvs(device):
    """TPC-H q3 and q10 over tables loaded through DML from the smoke's
    generator (SF 0.002), backfilled, then one RF1 and one RF2 of 300
    orders each: the MVs' physical rows after the backfill and after each
    refresh."""
    import numpy as np
    from risingwave_tpu_torch.frontend.runtime import Cluster
    from risingwave_tpu_torch.stream import tpch_plans as tp
    live = cs.tpch_tables(0.002, 3)
    new, gone = cs.tpch_refresh(np.random.default_rng(4), 0, 0.002, live,
                                n=300)
    cl = Cluster(device=device, chunk_capacity=256)
    tp.create_tables(cl)
    for name, cols in live.items():
        for ch in cs.tpch_chunks(tp.TABLES[name][0], cols, 0, device, 256):
            cl.write(name, ch)
        cl.tick()
    q3s, q10s = cs.tpch_sizes(0.002)
    tp.create_q3(cl, q3s)
    tp.create_q10(cl, q10s)
    while not (cl.backfill_done("q3") and cl.backfill_done("q10")):
        cl.tick()
    out = []

    def snap():
        out.append({n: sorted(cl.jobs[n].table.scan_all())
                    for n in ("q3", "q10")})

    snap()
    for name in ("orders", "lineitem"):
        for ch in cs.tpch_chunks(tp.TABLES[name][0], new[name], 0, device,
                                 256):
            cl.write(name, ch)
    cl.tick()
    snap()
    for name in ("orders", "lineitem"):
        sel = np.isin(live[name][0], gone)
        for ch in cs.tpch_chunks(tp.TABLES[name][0],
                                 [c[sel] for c in live[name]], 1, device,
                                 256):
            cl.write(name, ch)
    cl.tick()
    snap()
    cl.close()
    return out


def test_tpch_q3_q10_on_card_equal_cpu(cuda):
    card = _tpch_mvs("cuda")
    assert card == _tpch_mvs("cpu")
    assert all(len(s["q3"]) > 0 and len(s["q10"]) > 0 for s in card)
    assert card[0] != card[1] != card[2]


def _decimal_date_run(device):
    """DECIMAL and DATE expressions, string functions and DECIMAL aggs over
    one chunk: each result as host lists."""
    from risingwave_tpu_torch.common import (
        DATE, INT64, VARCHAR, Schema, chunk_to_rows, decimal, make_chunk,
    )
    from risingwave_tpu_torch.expr import AggCall, Literal, call, col
    from risingwave_tpu_torch.expr.expr import cast, make_extract
    from risingwave_tpu_torch.stream import (
        Barrier, HashAggExecutor, MockSource,
    )
    d2 = decimal(2)
    sch = Schema.of(("d", DATE), ("p", d2), ("q", d2), ("s", VARCHAR))
    rows = [(9204, 100.5, 0.1, "hello"), (-1, -9.99, None, "HELLO"),
            (-719468, 2.5, 9.99, "a%b"), (9204, None, 0.0, "spark")] * 16
    chunk = make_chunk(sch, rows, capacity=64, device=device)
    p, q, d, s = col(1, d2), col(2, d2), col(0, DATE), col(3, VARCHAR)
    exprs = [call("multiply", p, call("subtract", Literal(1, INT64), q)),
             call("add", p, q), cast(p, INT64), cast(p, decimal(0)),
             call("case", call("greater_than", p, Literal(2, INT64)), p,
                  Literal(1, INT64)),
             call("less_than", d, Literal(9204, DATE)),
             make_extract("year", d), make_extract("doy", d),
             call("upper", s), call("like", s, Literal("h%", VARCHAR))]
    out = [[c.data.cpu().tolist(), c.mask.cpu().tolist()]
           for c in (e.eval(chunk) for e in exprs)]
    calls = [AggCall(k, 1, d2) for k in ("sum", "min", "max", "avg")]
    agg = HashAggExecutor(MockSource(sch, [Barrier.new(1), chunk,
                                           Barrier.new(2)]), [0], calls,
                          table_capacity=64, out_capacity=64,
                          device=device)

    async def drain():
        got = []
        async for m in agg.execute():
            if not isinstance(m, Barrier):
                got.extend(chunk_to_rows(m, agg.schema, with_ops=True))
        return sorted(got)

    out.append(asyncio.run(drain()))
    return out


def test_decimal_date_expressions_and_aggs_on_card_equal_cpu(cuda):
    assert _decimal_date_run("cuda") == _decimal_date_run("cpu")


def test_backfill_batched_ingest_makes_no_host_sync(cuda):
    """A Backfill mid-way (its cursor set by one snapshot batch) filters a
    ChunkBatch of live deltas on a (VARCHAR, BIGINT) pk with synchronizing
    CUDA calls made errors; the rows it keeps are those at or before the
    cursor."""
    from risingwave_tpu_torch.common import (
        GLOBAL_STRING_DICT, INT64, VARCHAR, Schema, chunk_to_rows,
        flatten_shards, make_chunk, stack_chunks,
    )
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import Barrier, MockSource
    from risingwave_tpu_torch.stream.backfill import BackfillExecutor
    sch = Schema.of(("s", VARCHAR), ("k", INT64), ("v", INT64))
    keys = [(f"{(k * 7919) % 1000:03d}", k) for k in range(200)]
    store = MemoryStateStore()
    table = StateTable(store, 1, sch, [0, 1])
    for s, k in keys:
        table.insert((VARCHAR.to_physical(s), k, k))
    table.commit(1)
    store.commit(1)
    batch = stack_chunks([make_chunk(sch, [(s, k, -k) for s, k in
                                           keys[i::4]], capacity=64,
                                     device="cuda") for i in range(4)])
    bf = BackfillExecutor(MockSource(sch, [Barrier.new(2), batch]), table,
                          batch_rows=50, chunk_capacity=64, device="cuda")
    gen = bf.execute()

    async def step():
        return await gen.__anext__()

    loop = asyncio.new_event_loop()
    while not isinstance(loop.run_until_complete(step()), Barrier):
        pass
    GLOBAL_STRING_DICT.device_ranks("cuda")      # the rank table, cached
    with cs.no_host_sync():
        out = loop.run_until_complete(step())
    loop.close()
    kept = sorted(r[:2] for r in chunk_to_rows(flatten_shards(out.chunk),
                                               sch))
    first = sorted(keys)[:50]
    assert kept == sorted(first) and len(kept) == 50


def _split_rows(device):
    """A hash split of a batch of three chunks (update pairs, NULL keys,
    invisible rows) into 4 outputs: each output's (op, row) per chunk."""
    from risingwave_tpu_torch.common import (
        INT32, INT64, Schema, chunk_to_rows, make_chunk, stack_chunks,
    )
    from risingwave_tpu_torch.stream.dispatch import hash_split
    sch = Schema.of(("k", INT64), ("j", INT32))
    rng = np.random.default_rng(5)
    chunks = []
    for _ in range(3):
        rows = [(None if rng.random() < 0.05 else int(rng.integers(0, 99)),
                 int(rng.integers(0, 4))) for _ in range(60)]
        ops = [int(o) for o in rng.choice([0, 1, 2, 3], 60)]
        chunks.append(make_chunk(sch, rows, ops=ops, capacity=64,
                                 device=device))
    batch = stack_chunks(chunks).chunk
    outs = torch.arange(4, dtype=torch.int32, device=device)
    if device != "cpu":
        torch.cuda.synchronize()
    with cs.no_host_sync(device != "cpu"):
        new_ops, masks = hash_split(batch.ops, batch.vis,
                                    list(batch.columns), outs)
    out = []
    for o in range(4):
        for i in range(3):
            c = chunks[i].replace(ops=new_ops[i], vis=masks[o][i])
            out.append(chunk_to_rows(c, sch, with_ops=True))
    return out


def test_hash_split_makes_no_host_sync_and_equals_cpu(cuda):
    """The dispatcher's split of a ChunkBatch on the card, with
    synchronizing CUDA calls made errors, gives each output the rows and
    ops the CPU's split gives it."""
    assert _split_rows("cuda") == _split_rows("cpu")


def _q17_fragmented_rows(device):
    """q17 as 4 HashAgg actors behind a HashDispatcher over (auction, day),
    over ChunkBatch epochs of the host generator's bids."""
    from risingwave_tpu_torch.common import stack_chunks
    from risingwave_tpu_torch.connector import (
        BID_SCHEMA, NexmarkConfig, NexmarkGenerator,
    )
    from risingwave_tpu_torch.frontend.fragments import build_fragmented_agg
    from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
    from risingwave_tpu_torch.stream import (
        Barrier, MaterializeExecutor, MockSource, nexmark_plans as plans,
    )
    gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=256), seed=42,
                           device=device)
    msgs = [Barrier.new(1)]
    for e in range(3):
        msgs += [stack_chunks([gen.next_bid_chunk() for _ in range(4)]),
                 Barrier.new(e + 2)]
    inp = plans.q17_input(MockSource(BID_SCHEMA, msgs), device)
    graph = build_fragmented_agg(inp, [0, 1], plans.q17_calls(),
                                 parallelism=4, table_capacity=1 << 12,
                                 out_capacity=256, device=device)
    store = MemoryStateStore()
    mv = MaterializeExecutor(plans.q17_output(graph), StateTable(
        store, 1, plans.q17_schema(), [0, 1]))

    async def run():
        async for _ in mv.execute():
            pass

    asyncio.run(run())
    return sorted(mv.rows())


def test_fragmented_q17_on_card_equals_cpu(cuda):
    got = _q17_fragmented_rows("cuda")
    assert got == _q17_fragmented_rows("cpu") and len(got) > 0


def _string_fns(device):
    """regexp_*, split_part and to_char over one chunk (NULLs included)."""
    from risingwave_tpu_torch.common import (
        INT64, TIMESTAMP, VARCHAR, Schema, make_chunk,
    )
    from risingwave_tpu_torch.expr import Literal, call, col
    sch = Schema.of(("s", VARCHAR), ("t", TIMESTAMP), ("n", INT64))
    rng = np.random.default_rng(11)
    words = ["https://x.y/a/b?channel_id=12&id=3", "a/b/c/d/e/f", "",
             "Apple", "abcabc", "channel_id=77", "x&y"]
    rows = [(None if rng.random() < 0.1 else str(rng.choice(words)),
             int(rng.integers(-10**15, 4 * 10**15)),
             int(rng.choice([-2, -1, 1, 2, 4, 5]))) for _ in range(200)]
    chunk = make_chunk(sch, rows, capacity=256, device=device)
    s, t, n = col(0, VARCHAR), col(1, TIMESTAMP), col(2, INT64)

    def lit(v):
        return Literal(v, VARCHAR)

    exprs = [call("regexp_like", s, lit("[ab]c")),
             call("regexp_count", s, lit("a")),
             call("regexp_replace", s, lit("(a)(b)?"), lit("<\\2\\1>"),
                  lit("g")),
             call("regexp_match", s, lit("(\\d+)")),
             call("regexp_match_group", s, lit("(&|^)channel_id=([^&]*)"),
                  Literal(2, INT64)),
             call("split_part", s, lit("/"), n),
             call("to_char", t, lit("YYYY-MM-DD HH24:MI:SS.MS")),
             call("to_char", t, lit("hh:mi pm"))]
    out = []
    for e in exprs:
        c = e.eval(chunk)
        mask = c.mask.cpu().numpy()[:200]
        data = c.data.cpu().numpy()[:200]
        out.append([e.type.to_python(d) if m else None
                    for d, m in zip(data, mask)])
    return out


def test_regexp_and_to_char_on_card_equal_cpu(cuda):
    assert _string_fns("cuda") == _string_fns("cpu")


def _hll_lanes(device):
    """HLL register contributions and ranks of seeded and edge values:
    the rho edges, -0.0, NaN, ±inf and the INT64 extremes."""
    from risingwave_tpu_torch.common import FLOAT64, INT64
    from risingwave_tpu_torch.expr import agg
    from risingwave_tpu_torch.expr.agg import hll_rho
    rng = np.random.default_rng(5)
    edges = [0, 1, 2 ** 53 - 1, 2 ** 53, 2 ** 59, 2 ** 60 - 1]
    ints = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 500,
                                        dtype=np.int64),
                           [-2 ** 63, 2 ** 63 - 1, 0, -1]])
    floats = np.concatenate([rng.normal(0, 1e6, 500),
                             [-0.0, 0.0, np.nan, np.inf, -np.inf]])
    out = [hll_rho(torch.tensor(edges, device=device)).cpu()]
    for vals, t in ((ints, INT64), (floats, FLOAT64)):
        v = torch.from_numpy(vals).to(device)
        on = torch.ones(v.shape, dtype=torch.bool, device=device)
        call = agg("approx_count_distinct", 0, t)
        regs = [c.amax() for c in call.hll_contributions(v, on)]
        out.append(torch.stack(call.hll_contributions(v, on)).cpu())
        out.append(torch.stack(regs).cpu())
    return out


def test_hll_registers_on_card_equal_cpu(cuda):
    for a, b in zip(_hll_lanes("cuda"), _hll_lanes("cpu")):
        assert torch.equal(a, b)


def _overflow_casts(device):
    """C9 and C10: the minimum over -1 per integer width, and NaN, ±inf and
    out-of-range floats cast into every integer kind and DECIMAL(2)."""
    from risingwave_tpu_torch.common import (
        DATE, FLOAT64, INT16, INT32, INT64, TIMESTAMP, Schema, decimal,
        make_chunk,
    )
    from risingwave_tpu_torch.expr import Cast, call, col
    out = []
    for t in (INT16, INT32, INT64):
        lo = -(2 ** (8 * t.np_dtype.itemsize - 1))
        sch = Schema.of(("a", t), ("b", t))
        ch = make_chunk(sch, [(lo, -1), (lo, 2), (7, -1), (5, 0)],
                        capacity=8, device=device)
        for fn in ("divide", "modulus"):
            c = call(fn, col(0, t), col(1, t)).eval(ch)
            out.append((c.data.cpu(), c.mask.cpu()))
    sch = Schema.of(("f", FLOAT64))
    vals = [float("nan"), float("inf"), float("-inf"), 1e10, -1e10, 1e19,
            -1e19, 3.7, 2.5, -2.5]
    ch = make_chunk(sch, [(v,) for v in vals], capacity=16, device=device)
    for t in (INT16, INT32, INT64, TIMESTAMP, DATE, decimal(2)):
        out.append((Cast(col(0, FLOAT64), t).eval(ch).data.cpu(),))
    return out


def test_overflow_division_and_saturating_casts_on_card_equal_cpu(cuda):
    for a, b in zip(_overflow_casts("cuda"), _overflow_casts("cpu")):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_hll_hash_agg_batched_ingest_makes_no_host_sync(cuda):
    """One epoch of bids through Project and a HashAgg with two
    approx_count_distinct calls (``map_chunk_batch``) with synchronizing
    calls made errors; its registers then equal a CPU run's."""
    from risingwave_tpu_torch.common import INT64
    from risingwave_tpu_torch.expr import agg, col, count_star
    from risingwave_tpu_torch.stream import HashAggExecutor, ProjectExecutor

    def run(device, checked):
        gen = cs.bench_gen(device)
        src = cs.DeviceBidSource(gen, [], 1)
        proj = ProjectExecutor(src, [col(0, INT64), col(1, INT64),
                                     col(2, INT64)],
                               names=["auction", "bidder", "price"])
        ex = HashAggExecutor(
            proj, [0], [count_star(), agg("approx_count_distinct", 1, INT64),
                        agg("approx_count_distinct", 2, INT64)],
            table_capacity=1 << 16, device=device)
        batch = gen.next_batch(4)
        if checked:
            asyncio.run(cs.sync_free_batch(ex, batch))
        else:
            async def ingest():
                async for p in proj.map_chunk_batch(batch):
                    async for _ in ex.map_chunk_batch(p):
                        pass
            asyncio.run(ingest())
        return [lane.cpu() for lane in ex.state.lanes] + [
            ex.state.table.occupied.cpu()]

    for a, b in zip(run("cuda", True), run("cpu", False)):
        assert torch.equal(a, b)


def _nested_fns(device):
    """The JSONB, array and struct functions over one chunk."""
    import json
    from risingwave_tpu_torch.common import (
        INT64, JSONB, VARCHAR, Schema, list_of, make_chunk, struct_of,
    )
    from risingwave_tpu_torch.expr import Literal, call, col
    from risingwave_tpu_torch.expr.expr import struct_field
    rng = np.random.default_rng(3)
    st = struct_of(("who", VARCHAR), ("n", INT64))
    sch = Schema.of(("j", JSONB), ("l", list_of(INT64)), ("s", st))
    rows = []
    for i in range(200):
        obj = {"user": {"name": str(rng.choice(["ada", "bob", "eve"]))},
               "n": int(rng.integers(0, 9)), "tags": list(range(i % 4))}
        rows.append((json.dumps(obj, separators=(",", ":"), sort_keys=True)
                     if rng.random() > 0.1 else None,
                     tuple(int(x) for x in rng.integers(0, 5, i % 5)),
                     (str(rng.choice(["x", "y"])), i)))
    ch = make_chunk(sch, rows, capacity=256, device=device)
    j, lst, s = col(0, JSONB), col(1, list_of(INT64)), col(2, st)
    exprs = [call("jsonb_get_field_text", call("jsonb_get_field", j,
                                               Literal("user", VARCHAR)),
                  Literal("name", VARCHAR)),
             call("jsonb_get_field", j, Literal("tags", VARCHAR)),
             call("jsonb_array_length", call("jsonb_get_field", j,
                                             Literal("tags", VARCHAR))),
             call("jsonb_typeof", j),
             call("array_length", lst),
             call("array_access", lst, Literal(2, INT64)),
             struct_field(s, "who"), struct_field(s, "n")]
    out = []
    for e in exprs:
        c = e.eval(ch)
        data, mask = c.data.cpu().numpy()[:200], c.mask.cpu().numpy()[:200]
        out.append([e.type.to_python(d) if m else None
                    for d, m in zip(data, mask)])
    return out


def test_nested_type_functions_on_card_equal_cpu(cuda):
    assert _nested_fns("cuda") == _nested_fns("cpu")
