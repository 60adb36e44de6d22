"""NEXmark as a split source.

Counterpart of ``risingwave_tpu/connector/nexmark_split.py``: the host
generator (``connector/nexmark.py``) is deterministic given (seed, chunk
index), so one split whose offset is the number of chunks emitted
suffices. Seeking to an offset on recovery is ROADMAP A6 part 2.
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import DEFAULT_DEVICE
from ..common.chunk import StreamChunk
from .base import SplitReader
from .nexmark import NexmarkConfig, NexmarkGenerator


class NexmarkReader(SplitReader):
    def __init__(self, table: str, chunk_capacity: int = 1024,
                 seed: int = 42, device=DEFAULT_DEVICE):
        gen = NexmarkGenerator(NexmarkConfig(chunk_capacity=chunk_capacity),
                               seed=seed, device=device)
        self._next = {"bid": gen.next_bid_chunk,
                      "auction": gen.next_auction_chunk,
                      "person": gen.next_person_chunk}[table.lower()]
        self._n = 0

    @property
    def offsets(self) -> Dict[str, int]:
        return {"0": self._n}

    def next_chunk(self) -> Optional[StreamChunk]:
        chunk = self._next()
        if chunk is not None:
            self._n += 1
        return chunk
