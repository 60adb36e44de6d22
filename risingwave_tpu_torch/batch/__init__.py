"""The batch engine: one-shot query operators over state-table snapshots
(``executors.py``) and the lowering of a plan onto them (``lower.py``)."""
