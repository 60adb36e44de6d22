"""SinkExecutor and its log store: exactly-once changelog delivery,
decoupled from the barrier path.

Counterpart of ``risingwave_tpu/stream/sink.py``. The log lives in a
StateTable keyed (epoch, seq), so it shares the state store's atomic epoch
commit:

  on chunk     — buffer the rows (one host copy: a sink is host IO);
  on barrier e — append the buffered rows to the log table (always, in
                 epoch e), then try to deliver the log rows up to e with
                 bounded retry and backoff; on success record
                 (delivered_epoch, sink position) in the progress table and
                 delete the delivered rows from the log, in the same epoch
                 commit.

A failed delivery never fails the epoch: the log keeps the rows, and after
``degrade_after`` consecutive failed epochs the sink degrades (no more
attempts; the log keeps absorbing changes) until ``resume()``. The log cap
(``log_cap_rows``) is the one hard failure while degraded.

Every attempt first rolls the sink back to the last committed position, so
a half-delivered failed attempt is overwritten by the retry; after a crash
the undelivered log rows (their truncation never committed) are delivered
again on top of the committed position, and a recovery with no progress
row rolls the sink back to empty (anything there is phantom output).
"""

from __future__ import annotations

from typing import Optional

from ..common.chunk import StreamChunk, chunk_to_rows
from ..common.config import FaultConfig
from ..common.failpoint import fail_point
from ..common.types import INT64, Field, Schema
from ..connector.sinks import Sink
from ..storage.state_table import StateTable
from .executor import Executor, SingleInputExecutor
from .message import Barrier


def log_table_schema(value_schema: Schema) -> Schema:
    """(epoch, seq, op) ⧺ row values; pk (epoch, seq), so iteration order
    is delivery order."""
    head = (Field("_epoch", INT64), Field("_seq", INT64), Field("_op", INT64))
    return Schema(head + tuple(value_schema))


PROGRESS_SCHEMA = Schema((Field("_id", INT64), Field("_delivered_epoch", INT64),
                          Field("_position", INT64)))


class SinkExecutor(SingleInputExecutor):
    identity = "Sink"

    def __init__(self, input: Executor, sink: Sink,
                 log_table: StateTable, progress_table: StateTable,
                 n_visible: Optional[int] = None, recovering: bool = False,
                 retry_policy=None, degrade_after: Optional[int] = None,
                 log_cap_rows: Optional[int] = None):
        """``n_visible``: the leading columns delivered (the rest are
        hidden pk columns). ``recovering``: built over a store that may
        hold this sink's state (a recovery). ``retry_policy``,
        ``degrade_after`` and ``log_cap_rows`` default to ``FaultConfig``'s."""
        super().__init__(input)
        self.schema = input.schema
        self.n_visible = len(self.schema) if n_visible is None else n_visible
        self._recovering = recovering
        self.sink = sink
        self.log = log_table
        self.progress = progress_table
        fault = FaultConfig()
        if retry_policy is None:
            retry_policy = fault.sink_retry_policy()
        if degrade_after is None:
            degrade_after = fault.sink_degrade_after
        if log_cap_rows is None:
            log_cap_rows = fault.sink_log_cap_rows
        self._policy = retry_policy
        self.degrade_after = max(1, int(degrade_after))
        self.log_cap_rows = int(log_cap_rows)
        self.table = progress_table
        self._pending: list[tuple[int, tuple]] = []
        self._seq = 0
        self.delivered_epoch = 0
        #: the last successful sink position, where every attempt starts
        self._position = 0
        self.degraded = False
        self.delivery_failures = 0
        self.consecutive_failures = 0
        self.rows_delivered = 0
        #: rows this executor appended to the log
        self.rows_logged = 0
        self.last_error: Optional[str] = None
        self._recover()

    def _recover(self) -> None:
        row = self.progress.get_row((0,))
        if row is not None:
            self.delivered_epoch = int(row[1])
            self._position = int(row[2])
            self.sink.truncate_to(self._position)
        elif self._recovering:
            # no progress row committed: anything delivered is phantom
            self.sink.truncate_to(0)
        seqs = [int(r[1]) for r in self.log.scan_all()]
        self._seq = max(seqs) + 1 if seqs else 0

    def resume(self) -> None:
        """Re-arm delivery on a degraded sink; the backlog drains at the
        next barrier."""
        self.degraded = False
        self.consecutive_failures = 0
        self.last_error = None

    def sink_health(self) -> dict:
        return {
            "degraded": self.degraded,
            "delivered_epoch": self.delivered_epoch,
            "pending_rows": len(self.log),
            "delivery_failures": self.delivery_failures,
            "consecutive_failures": self.consecutive_failures,
            "rows_delivered": self.rows_delivered,
            "last_error": self.last_error,
        }

    def _deliver_once(self, typed: list) -> None:
        """One attempt, idempotent under retry: roll back to the last
        committed position, then write and flush."""
        fail_point("sink.deliver")
        self.sink.truncate_to(self._position)
        self.sink.write_rows(typed)
        self.sink.flush()

    def _try_deliver(self, epoch: int) -> None:
        to_deliver = [row for row in self.log.scan_all()
                      if int(row[0]) <= epoch]
        if not to_deliver and self.delivered_epoch >= epoch:
            return
        typed = [(int(r[2]), tuple(
            None if v is None else self.schema[i].type.to_python(v)
            for i, v in enumerate(r[3:3 + self.n_visible])))
            for r in to_deliver]
        try:
            self._policy.run("sink.deliver", self._deliver_once, typed)
        except Exception as e:  # noqa: BLE001 - degrade, don't fail the epoch
            self.delivery_failures += 1
            self.consecutive_failures += 1
            self.last_error = f"{type(e).__name__}: {e}"
            if self.consecutive_failures >= self.degrade_after:
                self.degraded = True
            return
        # truncate the delivered rows and record the progress, in the same
        # epoch commit
        for r in to_deliver:
            self.log.delete(r)
        self.delivered_epoch = epoch
        self._position = int(self.sink.position())
        self.rows_delivered += len(typed)
        self.consecutive_failures = 0
        self.last_error = None
        old = self.progress.get_row((0,))
        new = (0, epoch, self._position)
        if old is not None:
            self.progress.update(old, new)
        else:
            self.progress.insert(new)

    async def on_barrier(self, barrier: Barrier):
        epoch = barrier.epoch.curr
        for op, values in self._pending:
            self.log.insert((epoch, self._seq, int(op)) + tuple(values))
            self._seq += 1
        self.rows_logged += len(self._pending)
        self._pending.clear()
        if not self.degraded:
            self._try_deliver(epoch)
        else:
            n_logged = len(self.log)
            if n_logged > self.log_cap_rows:
                raise RuntimeError(
                    f"sink log exceeded log_cap_rows={self.log_cap_rows} "
                    f"({n_logged} undelivered rows) while degraded; "
                    "resume the sink or raise the cap")
        self.log.commit(epoch)
        self.progress.commit(epoch)
        if False:  # pragma: no cover - async generator shape
            yield

    async def map_chunk(self, chunk: StreamChunk):
        self._pending.extend(
            chunk_to_rows(chunk, self.schema, with_ops=True, physical=True))
        yield chunk
