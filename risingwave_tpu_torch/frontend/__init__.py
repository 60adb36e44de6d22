"""The SQL frontend: parser → binder → planner → optimizer → the port's
stream executors (``build.py``) and batch engine, under a ``Session``
(``session.py``); the runtime plumbing (queue sources, changelog buses,
stream jobs, the ``JobRuntime`` epoch conductor that ``Session`` and the
hand-tree ``Cluster`` share) is ``runtime.py``."""

from .build import BuildConfig  # noqa: F401
from .session import Session, SqlError  # noqa: F401
