"""Source connector framework: splits, readers, offset state.

Counterpart of ``risingwave_tpu/connector/base.py``. A *split* is the unit
of seekable ingest; its *offset* is the checkpointable read position. The
Session persists ``{split_id: offset}`` per source into a split-state table
on checkpoint barriers; seeking readers there on recovery (``seek``,
``rows_emitted``) is ROADMAP A6 part 2.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..common.chunk import StreamChunk


class SplitReader:
    """One source instance: a set of splits read round-robin.

    Offsets are next-to-read positions: after ``next_chunk`` returns rows
    ``[o, o+n)`` of split s, ``offsets[s] == o+n``."""

    @property
    def offsets(self) -> Dict[str, int]:
        raise NotImplementedError

    def next_chunk(self) -> Optional[StreamChunk]:
        """Next chunk, or None when (currently) exhausted."""
        raise NotImplementedError
