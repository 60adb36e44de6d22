from .types import (  # noqa: F401
    BOOL, BYTEA, DATE, FLOAT32, FLOAT64, GLOBAL_LIST_DICT, GLOBAL_STRING_DICT,
    INT16, INT32, INT64, INTERVAL, JSONB, SERIAL, TIME, TIMESTAMP, VARCHAR,
    DataType, Field, ListDict, Schema, StringDict, TypeKind, decimal,
    list_of, struct_of,
)
from .chunk import (  # noqa: F401
    DEFAULT_CHUNK_CAPACITY, OP_DELETE, OP_INSERT, OP_UPDATE_DELETE,
    OP_UPDATE_INSERT, ChunkBatch, Column, StreamChunk, chunk_to_rows,
    count_units, flatten_shards, gather_units_window, interleave_chunks,
    make_chunk, map_tensors, physical_chunk, stack_chunks,
)
from .hashing import VNODE_COUNT, hash_columns, vnode_of  # noqa: F401
