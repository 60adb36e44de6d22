"""Cold-tier cache helpers shared by HashAgg and HashJoin.

Counterpart of ``risingwave_tpu/stream/cache.py``. Under a memory budget the
device state is an LRU cache over the durable StateTable; the two pieces the
executors must agree on live here:

  * ``canonical_key`` — the host identity of an evicted key: float keys stay
    floats (2.3 and 2.7 must not collide through ``int()``), integers stay
    integers (no precision loss through ``float()``);
  * ``LruClock`` — the monotone touch stamp, None when no budget is set so
    the steps skip stamping.
"""

from __future__ import annotations

from typing import Optional

import torch


def canonical_key(values, types) -> tuple:
    """Key scalars → canonical python values (identity-preserving)."""
    return tuple(float(v) if t.is_float else int(v)
                 for v, t in zip(values, types))


class LruClock:
    """Monotone int32 stamps; without a budget (``enabled`` False) every
    call returns None."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.device = device
        self._step = 0

    def next(self) -> Optional[int]:
        """The stamp of one chunk, as a Python int (a kernel argument, so
        stamping it copies nothing to the card)."""
        if not self.enabled:
            return None
        self._step += 1
        return self._step

    def advance(self, k: int) -> Optional[torch.Tensor]:
        """``k`` consecutive stamps at once, int32[k] made on the device,
        for the chunks of one batch; None when disabled."""
        if not self.enabled:
            return None
        arr = torch.arange(self._step + 1, self._step + k + 1,
                           dtype=torch.int32, device=self.device)
        self._step += k
        return arr
