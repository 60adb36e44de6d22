"""Single-process streaming runtime: jobs, queue sources, changelog buses.

Counterpart of ``risingwave_tpu/frontend/runtime.py`` (``QueueSource``,
``ChangelogBus``, ``StreamJob``): a job is an asyncio task draining an
executor pipeline that ends in a ``MaterializeExecutor``. The epoch
conductor pushes chunks and barriers into the jobs' queue sources and
awaits each job's barrier. Every job republishes what leaves its
Materialize on a ``ChangelogBus``: a job that scans it subscribes a
``QueueSource`` there and backfills from its state table
(``stream/backfill.py``), so a table is itself a job (DML queue →
Materialize) and an MV over tables is a job of Backfill leaves.
``JobRuntime`` holds tables and MVs in one process and conducts their
epochs; ``Cluster`` drives hand-built trees over it.
"""

from __future__ import annotations

import asyncio
import time
from typing import AsyncIterator, Optional, Sequence

from .. import DEFAULT_DEVICE
from ..common.chunk import DEFAULT_CHUNK_CAPACITY, StreamChunk
from ..common.types import Schema
from ..storage.state_store import MemoryStateStore
from ..storage.state_table import StateTable
from ..stream.backfill import PROGRESS_SCHEMA, BackfillExecutor
from ..stream.dispatch import MsgQueue
from ..stream.dml import DmlManager, TableDmlHandle
from ..stream.executor import Executor
from ..stream.materialize import MaterializeExecutor
from ..stream.message import Barrier, Message


class QueueSource(Executor):
    """An executor fed from outside through a queue."""

    identity = "QueueSource"

    def __init__(self, schema: Schema):
        self.schema = schema
        self.queue = MsgQueue()

    def push(self, msg: Message) -> None:
        self.queue.put_nowait(msg)

    async def execute(self) -> AsyncIterator[Message]:
        while True:
            msg = await self.queue.get()
            if msg is None:      # hard shutdown
                return
            yield msg
            if isinstance(msg, Barrier) and msg.is_stop():
                return


class ChangelogBus:
    """Fan-out of a job's output messages to subscriber queues."""

    def __init__(self) -> None:
        self.subscribers: list[QueueSource] = []

    def publish(self, msg: Message) -> None:
        for q in self.subscribers:
            q.push(msg)

    def subscribe(self, q: QueueSource) -> None:
        self.subscribers.append(q)

    def unsubscribe(self, q: QueueSource) -> None:
        if q in self.subscribers:
            self.subscribers.remove(q)


class StreamJob:
    """One job: executor pipeline → Materialize → bus."""

    def __init__(self, name: str, pipeline: MaterializeExecutor,
                 sources: list[QueueSource]):
        self.name = name
        self.pipeline = pipeline
        self.sources = sources
        self.bus = ChangelogBus()
        self.table: StateTable = pipeline.table
        self._barrier_events: dict[int, asyncio.Event] = {}
        self._task: Optional[asyncio.Task] = None
        self._failure: Optional[BaseException] = None

    def start(self, loop: Optional[asyncio.AbstractEventLoop] = None) -> None:
        self._task = asyncio.ensure_future(self._run(), loop=loop)

    async def _run(self) -> None:
        try:
            async for msg in self.pipeline.execute():
                self.bus.publish(msg)
                if isinstance(msg, Barrier):
                    self._barrier_events.setdefault(
                        msg.epoch.curr, asyncio.Event()).set()
        except BaseException as e:   # noqa: BLE001 - raised by wait_barrier
            self._failure = e
            for ev in self._barrier_events.values():
                ev.set()
            raise

    async def wait_barrier(self, epoch: int) -> None:
        if self._failure is not None:
            raise RuntimeError(
                f"stream job {self.name!r} failed") from self._failure
        ev = self._barrier_events.setdefault(epoch, asyncio.Event())
        await ev.wait()
        self._barrier_events.pop(epoch, None)
        if self._failure is not None:
            raise RuntimeError(
                f"stream job {self.name!r} failed") from self._failure

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass


class JobRuntime:
    """What a single-process cluster of stream jobs shares: the store, the
    DML manager, the event loop, the jobs with their table queues and
    Backfill leaves, and the two halves of an epoch: ``inject`` a barrier
    into the table queues (after the staged DML) and ``complete`` it on
    every job, committing the store on a checkpoint. ``Cluster`` conducts
    hand-built trees over it, ``frontend.session.Session`` SQL.
    ``next_table_id`` is the subclass's (its own counter, or a catalog's)."""

    def __init__(self, device=DEFAULT_DEVICE,
                 chunk_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 batch_rows: Optional[int] = None):
        self.device = device
        self.chunk_capacity = chunk_capacity
        # the reference's default: 4 chunks of the source capacity, and at
        # least 4096 rows
        self.batch_rows = batch_rows or max(chunk_capacity * 4, 4096)
        self.store = MemoryStateStore()
        self.dml = DmlManager()
        self.loop = asyncio.new_event_loop()
        self.epoch = 1              # the last completed epoch
        self.jobs: dict[str, StreamJob] = {}
        self.table_queues: list[QueueSource] = []
        self.backfills: dict[str, list[BackfillExecutor]] = {}
        self._pending: list[BackfillExecutor] = []
        self.last_commit_s = 0.0   # the last checkpoint's store commit

    def next_table_id(self) -> int:
        raise NotImplementedError

    def _await(self, coro):
        return self.loop.run_until_complete(coro)

    def start_job(self, job: StreamJob,
                  inits: Sequence[tuple[QueueSource, Sequence[Message]]]
                  ) -> StreamJob:
        """Start ``job`` and cut it in at the current epoch: each queue of
        ``inits`` takes its messages and the epoch's barrier (a scan leaf
        then sends its first batch), and the barrier is awaited."""
        self.jobs[job.name] = job
        job.start(self.loop)
        for q, msgs in inits:
            for m in msgs:
                q.push(m)
            q.push(Barrier.new(self.epoch))
        self._await(job.wait_barrier(self.epoch))
        return job

    def start_table_job(self, name: str, table_id: int, queue: QueueSource,
                        source: Executor, schema: Schema,
                        pk: Sequence[int]) -> StreamJob:
        """A table as a job: its DML ``queue`` (read through ``source``,
        which may add columns) into a Materialize of table ``table_id``."""
        mat = MaterializeExecutor(
            source, StateTable(self.store, table_id, schema, list(pk)))
        self.dml.register(table_id, TableDmlHandle(queue.push))
        self.table_queues.append(queue)
        return self.start_job(StreamJob(name, mat, [queue]), [(queue, ())])

    def scan(self, name: str) -> BackfillExecutor:
        """A TableScan leaf over table or MV ``name``: a Backfill over its
        state table, fed its live deltas."""
        up = self.jobs[name]
        q = QueueSource(up.table.schema)
        up.bus.subscribe(q)
        prog = StateTable(self.store, self.next_table_id(), PROGRESS_SCHEMA,
                          [0])
        bf = BackfillExecutor(q, up.table, batch_rows=self.batch_rows,
                              chunk_capacity=self.chunk_capacity,
                              progress_table=prog, device=self.device)
        self._pending.append(bf)
        return bf

    def backfill_done(self, name: str) -> bool:
        return all(bf.done for bf in self.backfills[name])

    def inject(self, barrier: Barrier) -> None:
        """The staged DML, then ``barrier``, into every table's queue (MV
        jobs get it through the buses)."""
        self.dml.drain_into_epoch()
        for q in self.table_queues:
            q.push(barrier)

    def complete(self, epoch: int, checkpoint: bool) -> None:
        """Await ``epoch``'s barrier on every job; commit on a checkpoint."""
        async def collect():
            await asyncio.gather(*(job.wait_barrier(epoch)
                                   for job in self.jobs.values()))

        self._await(collect())
        if checkpoint:
            t0 = time.perf_counter()
            self.commit(epoch)
            self.last_commit_s = time.perf_counter() - t0
        self.epoch = epoch

    def commit(self, epoch: int) -> None:
        self.store.commit(epoch)

    def close(self) -> None:
        for job in self.jobs.values():
            self._await(job.stop())

        async def cancel_rest():
            # what the jobs left pending (the joins' input pumps)
            rest = [t for t in asyncio.all_tasks()
                    if t is not asyncio.current_task()]
            for t in rest:
                t.cancel()
            await asyncio.gather(*rest, return_exceptions=True)

        self._await(cancel_rest())
        self.loop.close()


class Cluster(JobRuntime):
    """Hand-built tables and MVs (the reference Session's table jobs,
    TableScan leaves and ``tick``, with no SQL).

    ``create_table`` starts a table's job and registers its DML handle;
    ``write`` stages a DML chunk; ``tick`` drains the staged DML into the
    tables' queues, injects one barrier, awaits it on every job and, for a
    checkpoint, commits the store. ``create_mv`` builds an MV over
    ``scan`` leaves, pushes their init barrier and awaits it: the first
    backfill batch flows then, the rest one batch per later barrier."""

    def __init__(self, device=DEFAULT_DEVICE,
                 chunk_capacity: int = DEFAULT_CHUNK_CAPACITY,
                 batch_rows: Optional[int] = None):
        super().__init__(device, chunk_capacity, batch_rows)
        self.table_ids: dict[str, int] = {}
        self._next_id = 1

    def next_table_id(self) -> int:
        """A table id of the cluster's store no table uses yet."""
        self._next_id += 1
        return self._next_id - 1

    def create_table(self, name: str, schema: Schema,
                     pk: Sequence[int]) -> StreamJob:
        tid = self.next_table_id()
        q = QueueSource(schema)
        self.table_ids[name] = tid
        return self.start_table_job(name, tid, q, q, schema, pk)

    def write(self, name: str, chunk: StreamChunk) -> None:
        """Stage a DML chunk (inserts, deletes, updates) for ``name``."""
        self.dml.stage(self.table_ids[name], chunk)

    def create_mv(self, name: str, mv: MaterializeExecutor) -> StreamJob:
        """Start the job of the tree ``mv``, built over leaves from
        ``scan``."""
        leaves, self._pending = self._pending, []
        self.backfills[name] = leaves
        return self.start_job(StreamJob(name, mv, [bf.input for bf in leaves]),
                              [(bf.input, ()) for bf in leaves])

    def tick(self, checkpoint: bool = True) -> int:
        """One barrier through every job; returns its epoch."""
        epoch = self.epoch + 1
        self.inject(Barrier.new(epoch, checkpoint=checkpoint))
        self.complete(epoch, checkpoint)
        return epoch

    def mv_rows(self, name: str) -> list:
        return self.jobs[name].pipeline.rows()
