"""The frontend's runtime plumbing: queue sources, changelog buses and
stream jobs, and the epoch conductor over tables and MVs
(``frontend/runtime.py``). The SQL frontend itself is not ported yet."""
