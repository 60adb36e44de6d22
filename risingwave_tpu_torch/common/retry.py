"""RetryPolicy: bounded retry with exponential backoff and full jitter.

Counterpart of ``risingwave_tpu/common/retry.py``. A call across a boundary
that can fail on its own (here: a sink's delivery) goes through one policy
object, so the backoff, the attempt cap, the wall-clock deadline and the
classification of errors are the same everywhere. Every ``run`` counts its
attempts, retries, successes, give-ups and non-retryable errors per site
in a process-wide registry. Jitter draws from an injectable RNG and sleeps
through an injectable function, so tests pin both.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Callable, Optional, Tuple, Type


class RetryError(RuntimeError):
    """Retry budget exhausted; ``__cause__`` is the last real error."""


class _RetryMetrics:
    """Per-site retry counters (process-wide, thread-safe)."""

    _FIELDS = ("attempts", "retries", "successes", "give_ups",
               "non_retryable")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sites: dict[str, dict] = {}

    def bump(self, site: str, field: str, n: int = 1) -> None:
        with self._lock:
            s = self._sites.get(site)
            if s is None:
                s = self._sites[site] = {f: 0 for f in self._FIELDS}
            s[field] += n

    def snapshot(self) -> dict:
        with self._lock:
            return {site: dict(c) for site, c in sorted(self._sites.items())}

    def reset(self) -> None:
        with self._lock:
            self._sites.clear()


GLOBAL_RETRY_METRICS = _RetryMetrics()


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with full jitter: after failed attempt k
    (1-based) sleep uniform(0, min(max_delay, base * 2**(k-1))).

    ``deadline_ms`` bounds the wall clock across all attempts: once it has
    passed, the next failure gives up even with attempts left.
    ``non_retryable`` wins over ``retryable``."""

    max_attempts: int = 5
    base_delay_ms: float = 10.0
    max_delay_ms: float = 2000.0
    deadline_ms: Optional[float] = None
    retryable: Tuple[Type[BaseException], ...] = (
        OSError, ConnectionError, TimeoutError)
    non_retryable: Tuple[Type[BaseException], ...] = ()

    def classify(self, exc: BaseException) -> bool:
        """True iff ``exc`` is worth another attempt."""
        if isinstance(exc, self.non_retryable):
            return False
        return isinstance(exc, self.retryable)

    def backoff_ms(self, attempt: int, rng=None) -> float:
        cap = min(self.max_delay_ms,
                  self.base_delay_ms * (2 ** max(0, attempt - 1)))
        return (rng or random).uniform(0.0, cap)

    def run(self, site: str, fn: Callable, *args,
            rng=None, sleep: Callable[[float], None] = time.sleep,
            metrics: Optional[_RetryMetrics] = None, **kwargs):
        """``fn(*args, **kwargs)`` under this policy; ``site`` names the
        boundary in the counters. Raises ``RetryError`` (the last error as
        its cause) past the budget; a non-retryable error passes through."""
        m = metrics if metrics is not None else GLOBAL_RETRY_METRICS
        deadline = (None if self.deadline_ms is None
                    else time.monotonic() + self.deadline_ms / 1e3)
        attempt = 0
        while True:
            attempt += 1
            m.bump(site, "attempts")
            try:
                out = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 - classified below
                if not self.classify(e):
                    m.bump(site, "non_retryable")
                    raise
                out_of_time = (deadline is not None
                               and time.monotonic() >= deadline)
                if attempt >= self.max_attempts or out_of_time:
                    m.bump(site, "give_ups")
                    raise RetryError(
                        f"{site}: gave up after {attempt} attempt(s)"
                        + (" (deadline exceeded)" if out_of_time else "")
                    ) from e
                m.bump(site, "retries")
                delay_s = self.backoff_ms(attempt, rng) / 1e3
                if deadline is not None:
                    delay_s = max(0.0, min(delay_s,
                                           deadline - time.monotonic()))
                if delay_s > 0:
                    sleep(delay_s)
                continue
            m.bump(site, "successes")
            return out
