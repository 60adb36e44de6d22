from .message import (  # noqa: F401
    Barrier, EpochPair, Message, Mutation, MutationKind, Watermark,
)
from .executor import Executor, SingleInputExecutor  # noqa: F401
from .source import MockSource  # noqa: F401
from .barrier_align import align_streams, barrier_align  # noqa: F401
from .project import FilterExecutor, ProjectExecutor  # noqa: F401
from .hash_agg import HashAggExecutor  # noqa: F401
from .hash_join import HashJoinExecutor  # noqa: F401
from .row_id_gen import RowIdGenExecutor  # noqa: F401
from .top_n import TopNExecutor  # noqa: F401
from .simple_agg import (  # noqa: F401
    SimpleAggExecutor, StatelessSimpleAggExecutor,
)
from .materialized_agg import MaterializedAggExecutor  # noqa: F401
from .dynamic_filter import DynamicFilterExecutor  # noqa: F401
from .materialize import MaterializeExecutor  # noqa: F401
from .hop_window import HopWindowExecutor  # noqa: F401
from .eowc import (  # noqa: F401
    NowExecutor, SortExecutor, WatermarkFilterExecutor,
)
from .dedup import AppendOnlyDedupExecutor  # noqa: F401
from .expand import ExpandExecutor  # noqa: F401
from .project_set import ProjectSetExecutor, TableFuncCall  # noqa: F401
from .over_window import (  # noqa: F401
    EowcOverWindowExecutor, OverWindowExecutor, WindowCall,
)
from .union import UnionExecutor, ValuesExecutor  # noqa: F401
from .temporal_join import TemporalJoinExecutor  # noqa: F401
