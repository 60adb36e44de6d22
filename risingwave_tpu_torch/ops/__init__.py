from .hash_table import (  # noqa: F401
    DeviceHashTable, ht_lookup, ht_lookup_or_insert, ht_new, scatter_reduce,
)
from .grouped_agg import AggCore, AggState  # noqa: F401
from .join_state import (  # noqa: F401
    JoinCore, JoinSideState, JoinState, JoinType, import_state,
)
from .interval_join import (  # noqa: F401
    IntervalJoinCore, IntervalJoinState, interval_match, interval_match_plain,
)
from .session_window import (  # noqa: F401
    SessionWindowCore, SessionWindowState,
)
from .stream_q3 import Q3Core, Q3State  # noqa: F401
from .row_set import (  # noqa: F401
    RowSetState, rs_apply_chunk, rs_changed, rs_checkpoint, rs_finish_flush,
    rs_gather_delta, rs_new,
)
from .topn import (  # noqa: F401
    OrderSpec, key0_dtype, topn_candidate_flush, topn_in_set, topn_order,
    topn_refill,
)
