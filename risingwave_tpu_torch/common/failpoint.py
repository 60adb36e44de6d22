"""Failpoints: named fault-injection sites on IO paths.

Counterpart of ``risingwave_tpu/common/failpoint.py``. A site costs one
dict lookup when nothing is armed; a test arms it with an exception (raised
once or every time) or a callable, to show that a contract holds when the
IO behind the site misbehaves. This package has one site, the sink's
delivery.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

_ARMED: Dict[str, Any] = {}

#: every failpoint site of the package, declared up front
DECLARED_SITES: "frozenset[str]" = frozenset({
    "sink.deliver",             # stream/sink.py
})

#: the declared sites and any that ran since
KNOWN_SITES: "set[str]" = set(DECLARED_SITES)


def fail_point(name: str) -> None:
    """Call at an IO site; raises, or runs, whatever was armed there."""
    KNOWN_SITES.add(name)
    action = _ARMED.get(name)
    if action is None:
        return
    if isinstance(action, tuple) and action[0] == "once":
        _ARMED.pop(name, None)
        action = action[1]
    if isinstance(action, BaseException) or (
            isinstance(action, type) and issubclass(action, BaseException)):
        raise action if not isinstance(action, type) else action(name)
    if callable(action):
        action()


def arm(name: str, action: Any, once: bool = False) -> None:
    """Arm a site. The site must be known (declared, or run before): an
    unknown name would never fire, and a test of it would prove nothing."""
    if name not in KNOWN_SITES:
        raise ValueError(
            f"failpoint {name!r} is not a declared site: add it to "
            "common/failpoint.py DECLARED_SITES")
    _ARMED[name] = ("once", action) if once else action


def disarm(name: Optional[str] = None) -> None:
    if name is None:
        _ARMED.clear()
    else:
        _ARMED.pop(name, None)


@contextlib.contextmanager
def failpoints(**points: Any):
    """``with failpoints(**{"sink.deliver": OSError}): ...``"""
    for n, a in points.items():
        arm(n, a)
    try:
        yield
    finally:
        for n in points:
            disarm(n)
