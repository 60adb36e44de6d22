"""Fault-tolerance knobs of the sink.

The sink's fields of ``risingwave_tpu/common/config.py``'s ``FaultConfig``
and its ``sink_retry_policy``: past ``sink_degrade_after`` consecutive
failed epochs a sink degrades (its log keeps the changes, barriers keep
committing) instead of failing the epoch; past ``sink_log_cap_rows``
logged, undelivered rows it fails loudly.
"""

from __future__ import annotations

import dataclasses

from .retry import RetryPolicy


@dataclasses.dataclass
class FaultConfig:
    sink_retry_attempts: int = 3
    sink_retry_base_ms: float = 20.0
    sink_retry_deadline_ms: float = 2000.0
    sink_degrade_after: int = 3
    sink_log_cap_rows: int = 1_000_000

    def sink_retry_policy(self) -> RetryPolicy:
        return RetryPolicy(
            max_attempts=self.sink_retry_attempts,
            base_delay_ms=self.sink_retry_base_ms,
            max_delay_ms=max(self.sink_retry_base_ms * 8, 250.0),
            deadline_ms=self.sink_retry_deadline_ms,
            retryable=(Exception,))
