from .nexmark import (  # noqa: F401
    AUCTION_SCHEMA, BID_SCHEMA, PERSON_SCHEMA, NexmarkConfig,
    DeviceBidGenerator, NexmarkGenerator,
)
