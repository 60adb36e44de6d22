"""WatermarkFilter, Sort (emit on window close) and Now, and the
``eowc_running`` tree, through both packages on the CPU.

The same scripted messages go to the reference's executors (op by op, under
``jax.disable_jit``) and the port's (``device="cpu"``). The port sends a
watermark once per barrier, the reference after every chunk that advances
it, so the watermarks compared are the last of each epoch. ``eowc_running``
(``stream/nexmark_plans.py``) is held to the reference Session's EMIT ON
WINDOW CLOSE MV for the same SQL over the same bids, and to numpy.
Tolerance: exact (integer data).
"""

import asyncio
import collections

import numpy as np
import pytest

import risingwave_tpu.common as J
import risingwave_tpu_torch.stream.nexmark_plans as plans
from risingwave_tpu.connector.nexmark import NexmarkConfig as JConfig
from risingwave_tpu.connector.nexmark import NexmarkGenerator as JGenerator
from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.common import ChunkBatch
from risingwave_tpu_torch.connector import NexmarkConfig, NexmarkGenerator
from risingwave_tpu_torch.connector.nexmark import BID_SCHEMA
from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
from risingwave_tpu_torch.stream import Barrier, MockSource
from test_torch_recovery import BOTH, JAX, TORCH

SEC = 1_000_000
KT = (("k", "INT64"), ("ts", "TIMESTAMP"))


def events(pkg, ex, store=None) -> list:
    """Rows (op, row), the last watermark before each barrier, and
    barriers, in order; each checkpoint barrier commits ``store``."""
    async def run():
        out, wm = [], None
        async for m in ex.execute():
            if isinstance(m, pkg.stream.Barrier):
                if wm is not None:
                    out.append(("wm", wm.col_idx, wm.value))
                    wm = None
                out.append(("barrier", m.epoch.curr))
                if store is not None and m.checkpoint:
                    store.commit(m.epoch.curr)
            elif isinstance(m, pkg.stream.Watermark):
                wm = m
            else:
                chunks = ([m.at(i) for i in range(m.num_chunks)]
                          if isinstance(m, ChunkBatch) else [m])
                for c in chunks:
                    out.extend(pkg.common.chunk_to_rows(c, ex.schema,
                                                        with_ops=True))
        return out

    with pkg.eager():
        return asyncio.run(run())


def build(pkg, spec, make, capacity=8):
    schema = pkg.schema(*KT)
    src = pkg.stream.MockSource(schema, pkg.messages(schema, spec, capacity))
    with pkg.eager():
        return make(pkg, src)


LATE = [("b", 1, False), ("c", [(1, 100), (2, 90), (3, 120)], None),
        ("c", [(4, 105), (5, 110), (6, 125), (7, None)], None),
        ("b", 2, False), ("c", [(8, 99), (9, 140), (10, 118)], None),
        ("b", 3, False), ("b", 4, False),
        ("c", [(11, 119), (12, 121)], None), ("b", 5, False)]


def watermark_filter(pkg, src, **kw):
    return pkg.stream.WatermarkFilterExecutor(src, 1, 10, **pkg.kw(**kw))


def test_watermark_filter_drops_late_rows_as_reference():
    """Rows below the watermark of the chunks before them are dropped; a
    row never falls below the watermark its own chunk advances; a NULL
    time is dropped."""
    got = [events(pkg, build(pkg, LATE, watermark_filter)) for pkg in BOTH]
    assert got[1] == got[0]
    kept = [r[1][0] for r in got[0] if r[0] == J.OP_INSERT]
    assert kept == [1, 2, 3, 5, 6, 9, 10]
    assert [e[2] for e in got[0] if e[0] == "wm"] == [115, 130]


def test_watermark_filter_batch_equals_chunk_path():
    per_chunk = [("b", 1, False)] + [("c", r, None) for r in (
        [(1, 100), (2, 90)], [(3, 95), (4, 130)], [(5, 119), (6, 121)])] + [
        ("b", 2, False)]
    batched = [("b", 1, False), ("k", [(r, None) for _, r, _ in
                                       per_chunk[1:-1]]), ("b", 2, False)]
    assert (events(TORCH, build(TORCH, batched, watermark_filter))
            == events(TORCH, build(TORCH, per_chunk, watermark_filter)))


def test_watermark_filter_chunk_without_time_keeps_watermark():
    """A chunk with no row holding a time leaves the watermark where it
    is. (The reference takes max - delay of an empty chunk as INT64_MIN -
    delay, which wraps to a huge watermark and drops every later row:
    ROADMAP Queue C6; not copied.)"""
    spec = [("b", 1, False), ("c", [(1, 100)], None),
            ("c", [(2, None)], None), ("c", [(3, 95)], None),
            ("b", 2, False)]
    got = events(TORCH, build(TORCH, spec, watermark_filter))
    assert [r[1][0] for r in got if r[0] == J.OP_INSERT] == [1, 3]
    assert ("wm", 1, 90) in got
    ref = events(JAX, build(JAX, spec, watermark_filter))
    assert [r[1][0] for r in ref if r[0] == J.OP_INSERT] == [1]


def test_watermark_filter_state_table_recovery():
    first = LATE[:3] + [("b", 2, True)] + LATE[4:5] + [("b", 3, True)]
    second = [("b", 4, False), ("c", [(20, 114), (21, 131)], None),
              ("b", 5, True)]
    outs = {}
    for pkg in BOTH:
        store = pkg.store_cls()

        def table():
            return pkg.table_cls(store, 3, pkg.schema(
                ("id", "INT64"), ("wm", "TIMESTAMP")), [0])

        a = events(pkg, build(pkg, first, lambda p, s: watermark_filter(
                                  p, s, state_table=table())), store)
        b = events(pkg, build(pkg, second, lambda p, s: watermark_filter(
            p, s, state_table=table())), store)
        outs[pkg.device] = (a, b, store.snapshot())
    assert outs["cpu"] == outs[None]
    assert [r[1][0] for r in outs["cpu"][1] if r[0] == J.OP_INSERT] == [21]


def sort(pkg, src, **kw):
    kw.setdefault("table_capacity", 64)
    kw.setdefault("out_capacity", 4)
    return pkg.stream.SortExecutor(src, time_col=1, pk_indices=[0],
                                   **pkg.kw(**kw))


SORT = [("b", 1, False), ("c", [(5, 50), (1, 30), (3, 30), (2, 70)], None),
        ("w", 1, 40), ("b", 2, False),
        ("c", [(7, 45), (4, 60), (6, 45), (9, None)], None),
        ("b", 3, False), ("w", 1, 60), ("c", [(8, 61)], None),
        ("b", 4, False), ("w", 1, 100), ("b", 5, False)]


def test_sort_emits_ripe_rows_in_order_as_reference():
    """At each barrier after a watermark: the rows at or below it, by (ts,
    pk), in windows of out_capacity; a NULL time never ripens."""
    got = [events(pkg, build(pkg, SORT, sort)) for pkg in BOTH]
    assert got[1] == got[0]
    rows = [r[1] for r in got[0] if r[0] == J.OP_INSERT]
    assert rows == [(1, 30), (3, 30), (6, 45), (7, 45), (5, 50), (4, 60),
                    (8, 61), (2, 70)]


def test_sort_checkpoint_and_recovery_as_reference():
    first = SORT[:5] + [("b", 3, True)]
    second = [("b", 4, False), ("c", [(10, 55)], None), ("w", 1, 100),
              ("b", 5, True)]
    outs = {}
    for pkg in BOTH:
        store = pkg.store_cls()

        def table():
            return pkg.table_cls(store, 4, pkg.schema(*KT), [0])

        a = events(pkg, build(pkg, first, lambda p, s: sort(
            p, s, state_table=table())), store)
        snap = store.snapshot()
        b = events(pkg, build(pkg, second, lambda p, s: sort(
            p, s, state_table=table())), store)
        outs[pkg.device] = (a, snap, b, store.snapshot())
    assert outs["cpu"] == outs[None]
    rows = [r[1] for r in outs["cpu"][2] if r[0] == J.OP_INSERT]
    assert rows == [(6, 45), (7, 45), (5, 50), (10, 55), (4, 60), (2, 70)]


def test_sort_frees_slots_of_emitted_rows():
    """48 rows through a Sort of 16 slots (at most 8 held at a barrier):
    the port rebuilds its row set once half its slots hold keys, so it
    emits, and checkpoints, what the reference's emits with 64 slots. The
    reference keeps a slot per row ever seen and overflows at 16 (ROADMAP
    Queue C7; not copied)."""
    spec = [("b", 1, True)]
    for e in range(6):
        rows = [(e * 8 + j, e * 100 + (j * 37) % 50) for j in range(8)]
        spec += [("c", rows, None), ("w", 1, e * 100 - 1),
                 ("b", e + 2, True)]
    outs = {}
    for pkg, cap in ((JAX, 64), (TORCH, 16)):
        store = pkg.store_cls()
        table = pkg.table_cls(store, 4, pkg.schema(*KT), [0])
        outs[pkg.device] = (events(pkg, build(pkg, spec, lambda p, s: sort(
            p, s, table_capacity=cap, state_table=table)), store),
            store.snapshot())
    assert outs["cpu"] == outs[None]
    assert sum(r[0] == J.OP_INSERT for r in outs["cpu"][0]) == 40
    with pytest.raises(RuntimeError, match="overflow"):
        events(JAX, build(JAX, spec, lambda p, s: sort(
            p, s, table_capacity=16)))


def test_sort_state_carried_by_interop():
    """The reference's Sort buffers two epochs; its row set goes to the
    port's Sort (``interop.row_set_state_from_jax``) with the pending
    watermark, and both release the same rows in the same order."""
    import jax

    from risingwave_tpu_torch.interop import row_set_state_from_jax
    first = SORT[:6] + [("w", 1, 60)]
    rest = [("c", [(8, 61)], None), ("b", 4, False), ("w", 1, 100),
            ("b", 5, False)]
    ref = build(JAX, first, sort)
    events(JAX, ref)
    port = build(TORCH, rest, sort)
    port.rows = row_set_state_from_jax(
        jax.tree_util.tree_map(np.asarray, ref.rows), "cpu")
    port._pending_wm = ref._pending_wm
    ref_next = build(JAX, rest, sort)
    ref_next.rows, ref_next._pending_wm = ref.rows, ref._pending_wm
    got = events(TORCH, port)
    assert got == events(JAX, ref_next)
    assert [r[1] for r in got if r[0] == J.OP_INSERT] == [
        (6, 45), (7, 45), (5, 50), (4, 60), (8, 61), (2, 70)]


def test_now_executor_as_reference():
    def run(pkg):
        src = pkg.stream.MockSource(pkg.schema(*KT), pkg.messages(
            pkg.schema(*KT), [("b", 1, False), ("b", 2, False),
                              ("b", 3, False)]))
        with pkg.eager():
            return events(pkg, pkg.stream.NowExecutor(src, **pkg.kw()))

    got = [run(pkg) for pkg in BOTH]
    assert got[1] == got[0]
    assert got[0][:2] == [(J.OP_INSERT, (1 * SEC,)), ("wm", 0, 1 * SEC)]


# ---------------------------------------------------------------------------
# eowc_running against the reference Session's EOWC MV
# ---------------------------------------------------------------------------

CAP = 64
TICKS = 8
EOWC_DDL = """CREATE SOURCE bid (auction BIGINT, bidder BIGINT,
  price BIGINT, channel VARCHAR, url VARCHAR, date_time TIMESTAMP,
  extra VARCHAR, WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND)"""
EOWC_SQL = """CREATE MATERIALIZED VIEW w AS
    SELECT auction, price, date_time,
      sum(price) OVER (PARTITION BY auction ORDER BY date_time) AS rs,
      row_number() OVER (PARTITION BY auction ORDER BY date_time) AS rn
    FROM bid EMIT ON WINDOW CLOSE"""


def bid_config(pkg_config):
    # bids 20 ms apart: 8 ticks of 64 span ~10 s of event time
    return pkg_config(chunk_capacity=CAP, events_per_second=50)


def session_rows() -> list:
    """The reference Session's MV over the reference generator's bids,
    one chunk per tick."""
    s = Session()
    s.run_sql(EOWC_DDL)
    s.run_sql(EOWC_SQL)
    gen = JGenerator(bid_config(JConfig), seed=42)
    for _ in range(TICKS):
        s.feeds[0].queue.push(gen.next_bid_chunk())
        s.tick(generate=False)
    rows = sorted(s.mv_rows("w"))
    s.close()
    return rows


def port_source(chunks, first_epoch=1, checkpoint=False):
    """A barrier, then each chunk and a barrier."""
    msgs = [Barrier.new(first_epoch, checkpoint=checkpoint)]
    for i, c in enumerate(chunks):
        msgs += [c, Barrier.new(first_epoch + 1 + i, checkpoint=checkpoint)]
    return MockSource(BID_SCHEMA, msgs)


def run_eowc(chunks, store, state_tables=None, first_epoch=1,
             row_id_start=0, device="cpu", sort_capacity=1 << 10):
    plan = plans.eowc_running(
        port_source(chunks, first_epoch, state_tables is not None),
        StateTable(store, 1, plans.eowc_running_schema(), [5]),
        sort_capacity=sort_capacity, out_capacity=CAP,
        state_tables=state_tables, row_id_start=row_id_start, device=device)
    events(TORCH, plan.mv, store)
    return plan


def running_numpy(chunks, wm):
    """Per auction, by (date_time, arrival): the running sum of price over
    peers included and the row number, of every bid below ``wm``."""
    rows = [(int(a), int(p), int(t)) for c in chunks for a, p, t, v in zip(
        c.columns[0].data, c.columns[2].data, c.columns[5].data, c.vis) if v]
    out = []
    by_auction = collections.defaultdict(list)
    for i, (a, p, t) in enumerate(rows):
        by_auction[a].append((t, i, p))
    for a, items in by_auction.items():
        items.sort()
        ts = np.array([t for t, _, _ in items])
        cum = np.cumsum([p for _, _, p in items])
        last_peer = np.searchsorted(ts, ts, side="right") - 1
        for j, (t, _, p) in enumerate(items):
            if t < wm:
                out.append((a, p, t, int(cum[last_peer[j]]), j + 1))
    return sorted(out)


def port_chunks(device="cpu"):
    gen = NexmarkGenerator(bid_config(NexmarkConfig), seed=42, device=device)
    return [gen.next_bid_chunk() for _ in range(TICKS)]


def test_eowc_running_equals_reference_session_and_numpy():
    chunks = port_chunks()
    plan = run_eowc(chunks, MemoryStateStore())
    got = sorted(r[:5] for r in plan.mv.rows())
    assert got == session_rows()
    wm = max(int(c.columns[5].data[c.vis].max())
             for c in chunks) - plans.EOWC_DELAY
    assert plan.watermark_filter.announced == wm
    assert got == running_numpy(chunks, wm) and len(got) > 100


def test_eowc_running_recovers_from_state_tables():
    """Every barrier a checkpoint; dropped after 4 of 8 epochs and rebuilt
    from the store (watermark, Sort, accumulator and buffer tables): the
    MV equals the uninterrupted run's."""
    chunks = port_chunks()
    whole = sorted(run_eowc(chunks, MemoryStateStore()).mv.rows())
    store = MemoryStateStore()
    half = TICKS // 2
    run_eowc(chunks[:half], store, plans.eowc_running_state_tables(store))
    plan = run_eowc(chunks[half:], store,
                    plans.eowc_running_state_tables(store),
                    first_epoch=half + 1, row_id_start=half * CAP)
    assert sorted(plan.mv.rows()) == whole
