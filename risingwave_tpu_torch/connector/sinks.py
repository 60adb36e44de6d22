"""Sinks: where changelogs leave the system.

Counterpart of ``risingwave_tpu/connector/sinks.py``. Only host IO lives
here; the delivery protocol (the log, epoch tracking, exactly-once
truncation) is the SinkExecutor's (``stream/sink.py``).

``FileSink`` is the durable local sink: JSONL or CSV appended per epoch at
a byte offset, so the executor can truncate an uncommitted tail after a
crash. The broker sink waits for the broker connector, which is not ported.
"""

from __future__ import annotations

import csv
import io
import json
import os
from typing import Sequence, Tuple

from ..common.types import Schema

Row = Tuple[int, tuple]          # (op, values)

_OP_NAMES = {0: "insert", 1: "delete", 2: "update_delete", 3: "update_insert"}


class Sink:
    def write_rows(self, rows: Sequence[Row]) -> None:
        raise NotImplementedError

    def flush(self) -> None:
        """Make previous writes durable."""

    def position(self) -> int:
        """Opaque monotone delivery position (bytes or rows delivered)."""
        return 0

    def truncate_to(self, position: int) -> None:
        """Recovery: discard deliveries past ``position`` when possible."""

    def close(self) -> None:
        pass


class BlackHoleSink(Sink):
    """Swallows everything; counts rows."""

    def __init__(self) -> None:
        self.rows_written = 0

    def write_rows(self, rows: Sequence[Row]) -> None:
        self.rows_written += len(rows)

    def position(self) -> int:
        return self.rows_written

    def truncate_to(self, position: int) -> None:
        self.rows_written = position


class FileSink(Sink):
    def __init__(self, path: str, schema: Schema, fmt: str = "jsonl"):
        self.path = path
        self.schema = schema
        self.fmt = fmt.lower()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a+", encoding="utf-8")

    def _encode(self, op: int, values: tuple) -> str:
        if self.fmt == "csv":
            buf = io.StringIO()
            csv.writer(buf, lineterminator="\n").writerow(
                [_OP_NAMES[op]] + ["" if v is None else v for v in values])
            return buf.getvalue()
        obj = {f.name: v for f, v in zip(self.schema, values)}
        obj["__op"] = _OP_NAMES[op]
        return json.dumps(obj, default=str) + "\n"

    def write_rows(self, rows: Sequence[Row]) -> None:
        for op, values in rows:
            self._f.write(self._encode(op, values))

    def flush(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def position(self) -> int:
        self._f.flush()
        return self._f.tell()

    def truncate_to(self, position: int) -> None:
        self._f.flush()
        self._f.truncate(position)
        self._f.seek(position)

    def close(self) -> None:
        self._f.close()


def build_sink(connector: str, options: dict, schema: Schema) -> Sink:
    """The sink registry: ``blackhole`` and ``file``."""
    c = connector.lower()
    if c in ("blackhole", ""):
        return BlackHoleSink()
    if c == "file":
        path = options.get("path")
        if not path:
            raise ValueError("file sink requires path option")
        return FileSink(str(path), schema,
                        fmt=str(options.get("format", "jsonl")))
    if c in ("broker", "kafka"):
        raise NotImplementedError(
            "BrokerSink is not ported: it needs connector/broker.py")
    raise ValueError(f"unsupported sink connector {connector!r}")
