from .state_store import MemoryStateStore  # noqa: F401
from .state_table import StateTable  # noqa: F401
