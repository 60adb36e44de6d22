from .types import (  # noqa: F401
    BOOL, FLOAT64, INT32, INT64, TIMESTAMP, VARCHAR, DataType, Field, Schema,
    TypeKind,
)
from .chunk import (  # noqa: F401
    DEFAULT_CHUNK_CAPACITY, OP_DELETE, OP_INSERT, OP_UPDATE_DELETE,
    OP_UPDATE_INSERT, Column, StreamChunk, chunk_to_rows, count_units,
    flatten_shards, gather_units_window, make_chunk, map_tensors,
)
from .hashing import VNODE_COUNT, hash_columns, vnode_of  # noqa: F401
