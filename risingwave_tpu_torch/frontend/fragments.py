"""Multi-fragment jobs over the dispatch fabric.

Counterpart of ``risingwave_tpu/frontend/fragments.py``. A grouped agg (or
an equi-join) runs as fragments joined by exchange edges:

    upstream fragment
        └─ HashDispatcher over the group (join) keys
             ├─ PermitChannel → actor 0 ─┐
             ├─ PermitChannel → actor 1 ─┤  SimpleDispatcher each,
             └─ ...          → actor N-1─┘  then MergeExecutor

These functions take what the reference reads off the plan node: the
upstream executors, the keys, the agg calls or the join type and
condition, and the state tables (``frontend/build.py`` passes them). The
N actors share one logical state table (one per join side): each writes
only its own keys, and on recovery each keeps the stored rows whose key
hashes to its shard (``load_shard``), so a job recovers at any
parallelism.

``FragmentGraph`` is the job's root executor: its ``execute`` runs the
actors as tasks beside the merge (the reference's StreamJob spawns the
build context's actors), raises an actor's failure, and cancels the
actors when it is closed. When an upstream ends without a STOP barrier its
actor closes the channels it feeds, so the job ends with it.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Optional, Sequence

from .. import DEFAULT_DEVICE
from ..common.chunk import DEFAULT_CHUNK_CAPACITY
from ..ops.join_state import JoinType
from ..storage.state_table import StateTable
from ..stream.dispatch import (
    EXCHANGE_PERMITS, ChannelSource, HashDispatcher, MergeExecutor,
    SimpleDispatcher, open_channel,
)
from ..stream.executor import Executor
from ..stream.hash_agg import HashAggExecutor
from ..stream.hash_join import HashJoinExecutor
from ..stream.message import Message

#: the reference planner's default (``BuildConfig.fragment_parallelism``)
FRAGMENT_PARALLELISM = 1


def _pump(source: Executor, dispatcher, outputs):
    """An actor: ``source``'s messages through ``dispatcher``."""
    async def run():
        async for msg in source.execute():
            await dispatcher.dispatch(msg)
        for ch in outputs:
            ch.close()
    return run


def _shared(table: Optional[StateTable]) -> Optional[StateTable]:
    """An actor's own handle on a shared logical state table."""
    if table is None:
        return None
    return StateTable(table.store, table.table_id, table.schema,
                      list(table.pk_indices))


class FragmentGraph(Executor):
    """The merge of a multi-fragment job, with the actors that feed it
    (``runs``, coroutine functions). ``actors`` holds the stateful
    executors (agg or join), one per shard."""

    identity = "FragmentGraph"

    def __init__(self, merge: MergeExecutor, runs: Sequence,
                 actors: Sequence[Executor]):
        self.merge = merge
        self.schema = merge.schema
        self.runs = list(runs)
        self.actors = list(actors)

    @staticmethod
    def _raise_failed(tasks) -> None:
        for t in tasks:
            if t.done() and not t.cancelled() and t.exception() is not None:
                raise t.exception()

    async def execute(self) -> AsyncIterator[Message]:
        tasks = [asyncio.ensure_future(run()) for run in self.runs]
        it = self.merge.execute().__aiter__()
        nxt = None
        try:
            while True:
                if nxt is None:
                    nxt = asyncio.ensure_future(it.__anext__())
                live = [t for t in tasks if not t.done()]
                await asyncio.wait([nxt, *live],
                                   return_when=asyncio.FIRST_COMPLETED)
                self._raise_failed(tasks)
                if not nxt.done():
                    continue
                try:
                    msg = nxt.result()
                except StopAsyncIteration:
                    nxt = None
                    break
                nxt = None
                yield msg
            await asyncio.gather(*tasks)
        finally:
            if nxt is not None:
                nxt.cancel()
            for t in tasks:
                t.cancel()


def build_fragmented_agg(
    upstream: Executor, group_keys: Sequence[int], agg_calls, *,
    state_table: Optional[StateTable] = None,
    parallelism: int = FRAGMENT_PARALLELISM,
    exchange_permits: int = EXCHANGE_PERMITS,
    table_capacity: int = 1 << 16,
    out_capacity: int = DEFAULT_CHUNK_CAPACITY,
    hbm_group_budget: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> FragmentGraph:
    """A grouped agg as upstream fragment → N HashAgg actors → merge.
    ``state_table``: the agg's logical state table (schema
    ``hash_agg.agg_state_schema``, pk the group keys), shared by the
    actors; None for none. ``hbm_group_budget``: each actor's cap on live
    groups (``HashAggExecutor``)."""
    n = parallelism
    in_chans = [open_channel(exchange_permits) for _ in range(n)]
    out_chans = [open_channel(exchange_permits) for _ in range(n)]
    dispatcher = HashDispatcher(in_chans, group_keys, upstream.schema,
                                device)
    aggs = [HashAggExecutor(
        ChannelSource(in_chans[i], upstream.schema), list(group_keys),
        list(agg_calls), state_table=_shared(state_table),
        table_capacity=table_capacity, out_capacity=out_capacity,
        load_shard=(i, n), hbm_group_budget=hbm_group_budget,
        device=device) for i in range(n)]
    runs = [_pump(upstream, dispatcher, in_chans)]
    runs += [_pump(aggs[i], SimpleDispatcher(out_chans[i]), [out_chans[i]])
             for i in range(n)]
    return FragmentGraph(MergeExecutor(out_chans, aggs[0].schema), runs,
                         aggs)


def build_fragmented_join(
    left: Executor, right: Executor, left_keys: Sequence[int],
    right_keys: Sequence[int], join_type: JoinType = JoinType.INNER, *,
    condition=None,
    left_state_table: Optional[StateTable] = None,
    right_state_table: Optional[StateTable] = None,
    parallelism: int = FRAGMENT_PARALLELISM,
    exchange_permits: int = EXCHANGE_PERMITS,
    key_capacity: int = 1 << 13, bucket_width: int = 16,
    out_capacity: int = DEFAULT_CHUNK_CAPACITY,
    hbm_key_budget: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> FragmentGraph:
    """An equi-join as two upstream fragments → N HashJoin actors → merge.
    Both sides hash-dispatch by their join keys with the same vnode hash,
    so matching keys meet on one actor. The state tables (pk: the join
    keys, then the side's stream pk) are shared by the actors.
    ``condition``: the residual non-equi predicate; ``hbm_key_budget``:
    each actor's cap on live join keys (``HashJoinExecutor``)."""
    n = parallelism
    l_chans = [open_channel(exchange_permits) for _ in range(n)]
    r_chans = [open_channel(exchange_permits) for _ in range(n)]
    out_chans = [open_channel(exchange_permits) for _ in range(n)]
    l_disp = HashDispatcher(l_chans, left_keys, left.schema, device)
    r_disp = HashDispatcher(r_chans, right_keys, right.schema, device)
    joins = [HashJoinExecutor(
        ChannelSource(l_chans[i], left.schema),
        ChannelSource(r_chans[i], right.schema),
        list(left_keys), list(right_keys), join_type=join_type,
        condition=condition,
        left_state_table=_shared(left_state_table),
        right_state_table=_shared(right_state_table),
        key_capacity=key_capacity, bucket_width=bucket_width,
        out_capacity=out_capacity, load_shard=(i, n),
        hbm_key_budget=hbm_key_budget, device=device)
        for i in range(n)]
    runs = [_pump(left, l_disp, l_chans), _pump(right, r_disp, r_chans)]
    runs += [_pump(joins[i], SimpleDispatcher(out_chans[i]), [out_chans[i]])
             for i in range(n)]
    return FragmentGraph(MergeExecutor(out_chans, joins[0].schema), runs,
                         joins)
