"""Incremental TopN (tests/test_topn_incremental.py) through both packages
on the CPU: random churn, the fast path, an offset window, idle barriers and
a delete drain that forces a refill — the same rows and the same fast-flush
and refill counts in both. Helpers and tolerance as tests/test_torch_topn.py.
"""

import random

import pytest

from test_torch_topn import D, _churn, _topn, both, fold


def test_topn_incremental_churn():
    spec, live = _churn(7, 30)

    def run(pkg):
        ex = _topn(pkg, spec, 7)
        rows = pkg.drain(ex)
        return rows, ex.n_fast_flushes, ex.n_refills

    rows, fast, _ = both(run)
    want = sorted(sorted(live.items(), key=lambda kv: (kv[1], kv[0]))[:7])
    assert fold(rows) == want and fast > 0


def _incremental_spec(name: str):
    rng = random.Random(3)
    if name == "fast_path":
        spec = [("b", 1, False)]
        for e in range(2, 8):
            spec += [("c", [(e * 100 + i, rng.randint(0, 1000))
                            for i in range(20)], None), ("b", e, False)]
        return spec, 0, 5
    if name == "offset_window":
        return ([("b", 1, False), ("c", [(i, i * 10) for i in range(50)],
                                    None), ("b", 2, False)], 5, 3)
    # idle barriers: no flush work at all
    return ([("b", 1, False), ("c", [(i, i) for i in range(100)], None)]
            + [("b", e, False) for e in (2, 3, 4)], 0, 5)


@pytest.mark.parametrize("name", ["fast_path", "offset_window",
                                  "idle_barriers"])
def test_topn_incremental_cases(name):
    """tests/test_topn_incremental.py's remaining cases: the same rows and
    the same fast-flush / refill counts in both packages."""
    spec, offset, limit = _incremental_spec(name)

    def run(pkg):
        ex = _topn(pkg, spec, limit, offset=offset)
        return pkg.drain(ex), ex.n_fast_flushes, ex.n_refills

    rows, fast, refills = both(run)
    if name == "fast_path":
        assert fast >= 4
    elif name == "offset_window":
        assert fold(rows) == [(5, 50), (6, 60), (7, 70)]
    else:
        assert fast + refills == 1
        assert fold(rows) == [(i, i) for i in range(5)]


def test_topn_delete_drain_forces_refill():
    rows = [(i, i) for i in range(600)]
    spec = [("b", 1, False), ("c", rows[:512], None), ("b", 2, False),
            ("c", rows[512:], None), ("b", 3, False)]
    for n, lo in enumerate(range(0, 300, 50)):
        spec += [("c", [(i, i) for i in range(lo, lo + 50)], [D] * 50),
                 ("b", 4 + n, False)]

    def run(pkg):
        ex = _topn(pkg, spec, 3)
        return pkg.drain(ex), ex.n_fast_flushes, ex.n_refills

    out, _, refills = both(run)
    assert fold(out) == [(i, i) for i in range(300, 303)] and refills >= 1
