"""Connector reader factory.

Counterpart of ``risingwave_tpu/connector/factory.py``: one construction
point per connector. ``nexmark`` and the declared-schema source with no
connector are here; ``datagen``, ``file`` and ``broker``/``kafka`` readers
are ROADMAP A6 part 2.
"""

from __future__ import annotations

from typing import Optional

from .. import DEFAULT_DEVICE


class ConnectorError(ValueError):
    pass


DEBEZIUM_NEEDS_PK = (
    "format 'debezium_json' requires a source PRIMARY KEY, which "
    "sources do not support yet; the parser is available via "
    "connector.parsers")

_LATER = {"datagen": "datagen", "file": "file", "posix_fs": "file",
          "fs": "file", "broker": "broker", "kafka": "broker"}


def make_reader(connector: str, options: dict, schema,
                chunk_capacity: int, seed: int = 42,
                device=DEFAULT_DEVICE) -> Optional[object]:
    """A connector's SplitReader; None for a declared-schema source fed
    only from outside (empty connector string)."""
    if connector == "nexmark":
        from .nexmark_split import NexmarkReader
        table = str(options.get("nexmark_table",
                                options.get("table", "bid"))).lower()
        rate = options.get("rows_per_chunk")
        cap = int(rate) if rate else chunk_capacity
        return NexmarkReader(table, chunk_capacity=cap, seed=seed,
                             device=device)
    if connector in _LATER:
        raise ConnectorError(
            f"the {_LATER[connector]} connector is not ported yet "
            "(ROADMAP A6 part 2)")
    if connector == "":
        return None
    raise ConnectorError(f"unsupported connector {connector!r}")
