"""Watermark state cleaning through both packages, on the CPU: the five
scenarios of tests/test_state_cleaning.py (grouped agg and interval join,
bounded state across windows, deletes persisted, lookups after compaction).
Output rows in order, committed store bytes and the compacted tables slot
for slot must be equal; tolerance: exact."""

import pytest

from test_torch_recovery import (
    JAX, TORCH, agg_executor, assert_agg_states_equal,
    assert_join_sides_equal,
)

# ---------------------------------------------------------------------------
# watermark state cleaning (tests/test_state_cleaning.py's five scenarios)
# ---------------------------------------------------------------------------

S_WIN = (("w", "TIMESTAMP"), ("k", "INT64"), ("v", "INT64"))
S_TIME = (("k", "INT64"), ("t", "TIMESTAMP"))


def _agg_bounded(pkg):
    spec = [("b", 1, False)]
    # 10 windows of 8 groups pass through a 32-slot table: only
    # compaction keeps it from overflowing
    for w in range(10):
        spec += [("c", [(w * 1000, k, 1) for k in range(8)], None),
                 ("w", 0, w * 1000), ("b", w + 2, True)]
    ex = agg_executor(pkg, spec, schema=S_WIN, keys=(0, 1),
                      calls=lambda c, e: [e.count_star()],
                      table_capacity=32, out_capacity=64)
    return pkg.drain(ex), ex, None


def _agg_persists_deletes(pkg):
    store = pkg.store_cls()
    spec = [("b", 1, False), ("c", [(0, 1, 1), (0, 2, 1)], None),
            ("b", 2, True), ("c", [(1000, 1, 1)], None), ("w", 0, 1000),
            ("b", 3, True)]
    kw = dict(schema=S_WIN, keys=(0, 1), calls=lambda c, e: [e.count_star()],
              table_id=3, table_capacity=64, out_capacity=16)
    out = pkg.drain(agg_executor(pkg, spec, store, **kw), store)
    rec = agg_executor(pkg, [("b", 4, False)], store, **kw)
    return out, rec, store.snapshot()


def _agg_compact_lookups(pkg):
    spec = [("b", 1, False),
            ("c", [(g, g % 4, 1) for g in range(50)], None), ("w", 0, 40),
            ("b", 2, True), ("c", [(45, 1, 1), (10, 2, 1)], None),
            ("b", 3, False)]
    ex = agg_executor(pkg, spec, schema=S_WIN, keys=(0, 1),
                      calls=lambda c, e: [e.count_star()],
                      table_capacity=128, out_capacity=64)
    return pkg.drain(ex), ex, None


def _interval_cond(pkg, width):
    e, c = pkg.expr, pkg.common
    lt, rt, w = e.col(1, c.TIMESTAMP), e.col(3, c.TIMESTAMP), \
        e.Literal(width, c.INT64)
    return e.call("and",
                  e.call("less_than_or_equal", e.call("subtract", lt, rt), w),
                  e.call("less_than_or_equal", e.call("subtract", rt, lt), w))


def _join_bounded(pkg):
    width = 100
    left, right = [("b", 1, False)], [("b", 1, False)]
    for w in range(6):
        t = w * 1000
        left += [("c", [(k, t + k) for k in range(4)], None), ("w", 1, t),
                 ("b", w + 2, True)]
        right += [("c", [(k, t + k + 10) for k in range(2)], None),
                  ("w", 1, t), ("b", w + 2, True)]
    ex = _time_join(pkg, left, right, condition=_interval_cond(pkg, width),
                    key_capacity=64, bucket_width=8, out_capacity=64,
                    interval_clean=(("left", 1, "right", 1, width),
                                    ("right", 1, "left", 1, width)))
    return pkg.drain(ex), ex, None


def _time_join(pkg, left, right, stores=None, **kw):
    ls = pkg.schema(*S_TIME)
    tables = {}
    if stores is not None:
        tables = dict(left_state_table=pkg.table_cls(stores, 1, ls, [0, 1]),
                      right_state_table=pkg.table_cls(stores, 2, ls, [0, 1]))
    with pkg.eager():
        return pkg.stream.HashJoinExecutor(
            pkg.stream.MockSource(ls, pkg.messages(ls, left, 8)),
            pkg.stream.MockSource(ls, pkg.messages(ls, right, 8)),
            [0], [0], pkg.ops.JoinType.INNER, **tables, **pkg.kw(**kw))


def _join_persists_deletes(pkg):
    store = pkg.store_cls()
    left = [("b", 1, False), ("c", [(1, 10), (2, 20)], None),
            ("b", 2, True), ("w", 1, 1000), ("b", 3, True)]
    right = [("b", 1, False), ("b", 2, True), ("b", 3, True)]
    ex = _time_join(pkg, left, right, store, key_capacity=64,
                    bucket_width=4,
                    interval_clean=(("left", 1, "left", 1, 0),))
    return pkg.drain(ex, store), ex, store.snapshot()


CLEANING = {"agg_state_bounded_across_windows": _agg_bounded,
            "agg_cleaning_persists_deletes": _agg_persists_deletes,
            "compact_preserves_lookups": _agg_compact_lookups,
            "interval_join_bounded_state": _join_bounded,
            "interval_join_cleaning_persists_deletes":
                _join_persists_deletes}


@pytest.mark.parametrize("name", list(CLEANING))
def test_state_cleaning_matches_reference(name):
    want_out, jex, want_snap = CLEANING[name](JAX)
    got_out, tex, got_snap = CLEANING[name](TORCH)
    assert got_out == want_out
    assert got_snap == want_snap
    if "join" in name:
        assert_join_sides_equal(jex.state, tex.state)
        assert int(tex.state.left.occupied.sum()) <= 8
    else:
        assert_agg_states_equal(jex.state, tex.state)
        assert int(tex.state.table.occupied.sum()) <= 50
