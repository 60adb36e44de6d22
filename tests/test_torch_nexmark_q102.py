"""NEXmark q102 as the port's executor tree on the CPU, against the
reference's ``Session`` running the same SQL and against the recomputation
of tests/test_nexmark_extended.py: the q105 join and agg under a
DynamicFilter whose bound is a MaterializedAgg over a second bid source.
Sources, tolerance and the Session's sizing as tests/test_torch_nexmark_mv.py.
"""

import risingwave_tpu_torch.stream.nexmark_plans as plans
from risingwave_tpu_torch.storage import MemoryStateStore
from test_torch_nexmark_mv import (
    SMALL, bid_counts, drive, mv_table, nexmark_source, session_rows,
)


def test_q102_bid_count_above_average():
    store = MemoryStateStore()
    plan = plans.q102(nexmark_source("auction", 6), nexmark_source("bid", 6),
                      nexmark_source("bid", 6),
                      mv_table(store, plans.q105_schema(), [0, 1]),
                      key_capacity=64, agg_capacity=256,
                      filter_capacity=256, **SMALL)
    got = drive(plan, store)
    auctions, n_bid = bid_counts(6)
    avg = sum(n_bid.values()) // len(n_bid)
    want = sorted((a[0], a[1], n_bid[a[0]]) for a in auctions
                  if n_bid[a[0]] >= avg)
    assert got == want and len(got) > 0
    assert got == session_rows("q102", 6)
