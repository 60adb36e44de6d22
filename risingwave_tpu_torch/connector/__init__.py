from .nexmark import (  # noqa: F401
    AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA, NexmarkConfig,
    DeviceBidGenerator, NexmarkGenerator,
)
from .tpch import (  # noqa: F401
    Q3_CUTOFF_DAYS, Q3_EVENT_SCHEMA, DeviceQ3Generator, TpchQ3Config,
)
