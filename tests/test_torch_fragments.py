"""Multi-fragment jobs (``frontend/fragments.py``) through both packages on
the CPU, mirroring tests/test_fragments.py.

A grouped agg over the bids and an auction LEFT JOIN bid run as the port's
fragment graphs (upstream → HashDispatcher → N actors sharing one logical
state table → Merge) at parallelism 1, 2 and 4, against the reference's
``Session`` built with ``BuildConfig(fragment_parallelism=n)`` on the same
SQL; parallelism 1 also runs the plain executor. Recovery from 4 to 2, of
the agg and of the join, starts from the store snapshot the reference's
4-actor job committed: the port's 2 actors reload their shards of the
reference's state tables and go on to the rows the reference reaches (and,
for the join, to the reference's side tables). Sources: the host
generator, seed 42, one chunk of 64 rows per source leaf per tick.
Tolerance: exact.
"""

import asyncio
import contextlib

import jax
import pytest

import risingwave_tpu_torch.stream.nexmark_plans as plans
from risingwave_tpu.frontend.build import BuildConfig
from risingwave_tpu.frontend.session import Session
from risingwave_tpu_torch.common.types import INT64, Schema
from risingwave_tpu_torch.expr import agg, count_star
from risingwave_tpu_torch.frontend.fragments import (
    FragmentGraph, build_fragmented_agg, build_fragmented_join,
)
from risingwave_tpu_torch.ops.join_state import JoinType
from risingwave_tpu_torch.storage import MemoryStateStore, StateTable
from risingwave_tpu_torch.stream import Barrier, HashAggExecutor
from risingwave_tpu_torch.stream.hash_agg import agg_state_schema
from test_nexmark_queries import CAP, DDL
from test_torch_nexmark_extended import source

AGG_SQL = """CREATE MATERIALIZED VIEW m AS SELECT auction, count(*) AS n,
    sum(price) AS s, max(price) AS p FROM bid GROUP BY auction"""
JOIN_SQL = """CREATE MATERIALIZED VIEW j AS SELECT a.id, a.item_name,
    b.price FROM auction a LEFT JOIN bid b ON a.id = b.auction"""
AGG_TICKS = 5
JOIN_TICKS = 2
AGG_CAPACITY = 1 << 10
# no join grows in the reference (a growth widens and recompiles)
JOIN_CAPACITY = dict(key_capacity=1 << 8, bucket_width=1 << 7)
AGG_SCHEMA = Schema.of(("auction", INT64), ("n", INT64), ("s", INT64),
                       ("p", INT64))
#: the reference numbers a job's second source actor's row ids from 1 << 48
BID_ROW_IDS = 1 << 48
JOIN_SCHEMA = Schema.of(("id", INT64), ("item_name", plans.VARCHAR),
                        ("price", INT64), ("_pk0", plans.SERIAL),
                        ("_pk1", plans.SERIAL))


def config(n: int) -> BuildConfig:
    return BuildConfig(chunk_capacity=CAP, agg_table_capacity=AGG_CAPACITY,
                       join_key_capacity=JOIN_CAPACITY["key_capacity"],
                       join_bucket_width=JOIN_CAPACITY["bucket_width"],
                       fragment_parallelism=n)


def session(n: int, sql: str, ticks: int, eager: bool = False):
    """The reference Session's MV rows, its store snapshots after each
    tick, and the MV's (state table ids, table id)."""
    with jax.disable_jit() if eager else contextlib.nullcontext():
        s = Session(source_chunk_capacity=CAP, chunks_per_tick=1,
                    config=config(n), checkpoint_frequency=1)
        s.run_sql(DDL)
        s.run_sql(sql)
        snaps = []
        for _ in range(ticks):
            s.tick()
            snaps.append(s.store.snapshot())
        name = "m" if sql is AGG_SQL else "j"
        rows = sorted(s.mv_rows(name), key=repr)
        mv = s.catalog.mvs[name]
        ids = (mv.state_table_ids, mv.table_id)
        s.close()
    return rows, snaps, ids


def agg_input(bid):
    return plans._project(plans.with_row_id(bid, 0, "cpu"), (0, 2, 2),
                          ("k0", "a0", "a1"))


CALLS = [count_star(), agg("sum", 1, INT64), agg("max", 2, INT64)]


def agg_root(n: int, bid, store=None, state_table_id=None):
    """The agg MV's root at parallelism ``n`` (0: the plain HashAgg)."""
    inp = agg_input(bid)
    st = None
    if store is not None:
        st = StateTable(store, state_table_id, agg_state_schema(
            [inp.schema[0]], CALLS), [0])
    if n == 0:
        root = HashAggExecutor(inp, [0], CALLS, state_table=st,
                               table_capacity=AGG_CAPACITY,
                               out_capacity=CAP, device="cpu")
    else:
        root = build_fragmented_agg(inp, [0], CALLS, state_table=st,
                                    parallelism=n,
                                    table_capacity=AGG_CAPACITY,
                                    out_capacity=CAP, device="cpu")
    return plans._project(root, range(4), AGG_SCHEMA.names)


def join_root(n: int, auction, bid, store=None, state_table_ids=None,
              row_ids=(0, BID_ROW_IDS)):
    """The join MV's root at parallelism ``n`` (0: the plain HashJoin);
    ``row_ids``: where each side's ``_row_id`` numbering starts."""
    a = plans._project(plans.with_row_id(auction, row_ids[0], "cpu"),
                       (0, 1, 10), ("id", "item_name", "_row_id"))
    b = plans._project(plans.with_row_id(bid, row_ids[1], "cpu"),
                       (0, 2, 7), ("auction", "price", "_row_id"))
    tables = {}
    if store is not None:
        # each side's own schema, pk the join key then its _row_id
        tables = {f"{side}_state_table": StateTable(store, tid, up.schema,
                                                    [0, 2])
                  for side, tid, up in zip(("left", "right"),
                                           state_table_ids, (a, b))}
    if n == 0:
        join = plans.HashJoinExecutor(a, b, [0], [0], JoinType.LEFT_OUTER,
                                      out_capacity=CAP, device="cpu",
                                      **tables, **JOIN_CAPACITY)
    else:
        join = build_fragmented_join(a, b, [0], [0], JoinType.LEFT_OUTER,
                                     parallelism=n, out_capacity=CAP,
                                     device="cpu", **tables, **JOIN_CAPACITY)
    return plans._project(join, (0, 1, 4, 2, 5), JOIN_SCHEMA.names)


def mv_rows(root, schema, pk, store=None, table_id=1) -> list:
    """The visible MV rows of ``root`` materialized into ``table_id``;
    every checkpoint barrier commits ``store``."""
    store = store if store is not None else MemoryStateStore()
    mv = plans.MaterializeExecutor(root, StateTable(store, table_id, schema,
                                                    pk))

    async def run():
        async for m in mv.execute():
            if isinstance(m, Barrier) and m.checkpoint:
                store.commit(m.epoch.curr)

    asyncio.run(run())
    width = sum(not f.name.startswith("_") for f in schema)
    return sorted((r[:width] for r in mv.rows()), key=repr)


@pytest.fixture(scope="module")
def agg_sessions():
    return {n: session(n, AGG_SQL, AGG_TICKS) for n in (2, 4)}


@pytest.mark.parametrize("n", [0, 1, 2, 4])
def test_fragmented_agg_equals_reference(agg_sessions, n):
    want = agg_sessions[4][0]
    assert agg_sessions[2][0] == want and len(want) > 0
    got = mv_rows(agg_root(n, source("bid", AGG_TICKS)), AGG_SCHEMA, [0])
    assert got == want


@pytest.fixture(scope="module")
def join_sessions():
    return {n: session(n, JOIN_SQL, JOIN_TICKS, eager=True) for n in (2, 4)}


def resumed(source_leaf, resume_at: int, first: int):
    """``source_leaf``'s chunks after tick ``resume_at``, one per epoch
    from ``first``, every barrier a checkpoint."""
    chunks = [m for m in source_leaf._messages if not isinstance(m, Barrier)]
    msgs = [Barrier.new(first)]
    for i, c in enumerate(chunks[resume_at:]):
        msgs += [c, Barrier.new(first + 1 + i, checkpoint=True)]
    source_leaf.reset(msgs)
    return source_leaf


@pytest.mark.parametrize("n", [2, 4])
def test_fragmented_outer_join_equals_reference(join_sessions, n):
    want = join_sessions[n][0]
    assert any(r[2] is None for r in want)
    for m in {0, 1, n}:
        got = mv_rows(join_root(m, source("auction", JOIN_TICKS),
                                source("bid", JOIN_TICKS)),
                      JOIN_SCHEMA, [3, 4])
        assert got == want


def test_recovery_from_4_to_2_over_reference_snapshot(agg_sessions):
    """The reference's 4-actor job checkpoints after each tick; the port
    recovers its snapshot after tick 3 with 2 actors (each reloads the
    groups of its shard from the one shared table), ingests ticks 4-5 and
    reaches the reference's MV."""
    want, snaps, (state_ids, mv_id) = agg_sessions[4]
    (agg_id,) = state_ids
    resume_at = 3
    store = MemoryStateStore()
    store.restore(snaps[resume_at - 1])
    bids = resumed(source("bid", AGG_TICKS), resume_at,
                   store.committed_epoch + 1)
    root = agg_root(2, bids, store, agg_id)
    graph = root.input
    assert isinstance(graph, FragmentGraph) and len(graph.actors) == 2
    loaded = [a.core.live_mask(a.state).sum().item() for a in graph.actors]
    recovered = mv_rows(root, AGG_SCHEMA, [0], store, mv_id)
    assert sum(loaded) > 0 and min(loaded) > 0
    assert recovered == want


def test_join_recovery_from_4_to_2_over_reference_snapshot(join_sessions):
    """The reference's 4-actor LEFT JOIN checkpoints after each tick; the
    port recovers its snapshot after tick 1 with 2 actors (each reloads the
    keys of its shard from both shared side tables, so a bid of tick 2
    retracts its auction's NULL-padded row), numbers the new rows where
    the reference does, ingests tick 2 and reaches the reference's MV."""
    want, snaps, (state_ids, mv_id) = join_sessions[4]
    resume_at = 1
    store = MemoryStateStore()
    store.restore(snaps[resume_at - 1])
    first = store.committed_epoch + 1
    leaves = [resumed(source(t, JOIN_TICKS), resume_at, first)
              for t in ("auction", "bid")]
    done = resume_at * CAP
    root = join_root(2, *leaves, store, state_ids,
                     (done, BID_ROW_IDS + done))
    graph = root.input
    assert isinstance(graph, FragmentGraph) and len(graph.actors) == 2
    loaded = [[int(side.occupied.sum()) for side in (a.state.left,
                                                     a.state.right)]
              for a in graph.actors]
    recovered = mv_rows(root, JOIN_SCHEMA, [3, 4], store, mv_id)
    assert min(min(k) for k in loaded) > 0
    assert recovered == want
    # the actors' writes leave both side tables as the reference's
    ref = MemoryStateStore()
    ref.restore(snaps[-1])
    for tid, up in zip(state_ids, (graph.actors[0].left,
                                   graph.actors[0].right)):
        port, reference = (list(StateTable(st, tid, up.schema,
                                           [0, 2]).scan_all())
                           for st in (store, ref))
        assert port == reference and len(port) > 0
