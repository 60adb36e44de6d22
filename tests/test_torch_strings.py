"""VARCHAR ordering through both packages on the CPU: the dictionary's rank
table, the four ordering comparisons, MIN/MAX over VARCHAR in HashAgg and
SimpleAgg, and casts to and from VARCHAR.

Dictionary ids differ between the packages (each interns in its own
order), so ranks are compared by string and outputs are compared decoded.
The reference's ``Cast`` between VARCHAR and another type reinterprets the
raw dictionary id; the port's formats and parses text instead, so casts are
held against the reference's text forms (``frontend/pgwire._fmt_value`` for
output, ``frontend/binder._parse_timestamp`` for timestamp input).
Tolerance: exact.
"""

import datetime

import numpy as np
import pytest
import torch

import risingwave_tpu_torch.common as T
import risingwave_tpu_torch.expr as TE
from risingwave_tpu.frontend.binder import _parse_timestamp
from risingwave_tpu.frontend.pgwire import _fmt_value
from risingwave_tpu.common import types as JT
from test_torch_topn import both, source

WORDS = ["pear", "apple", "Zebra", "", "apple pie", "äpfel", "b", "a",
         "zz", "Apple"]


def test_rank_table_orders_by_string():
    """``ranks()`` and ``device_ranks`` order every interned string by
    codepoints, as the reference's table does; the device table is padded
    to a power of two with ``version``; a new string refreshes both."""
    td = T.StringDict()
    jd = JT.StringDict()
    for w in WORDS[:6]:
        td.intern(w)
        jd.intern(w)
    before = td.device_ranks("cpu")
    for w in WORDS[6:]:
        td.intern(w)
        jd.intern(w)
    for d in (td, jd):
        assert d.version == len(WORDS) + 1 - WORDS.count("")
    ranks = td.ranks()
    by_rank = [td.lookup(i) for i in np.argsort(ranks)]
    assert by_rank == sorted(by_rank)
    jranks = jd.ranks()
    assert sorted(range(len(ranks)), key=lambda i: ranks[i]) == \
        sorted(range(len(jranks)), key=lambda i: jranks[i])
    dev = td.device_ranks("cpu")
    assert dev.shape[0] == 16 and dev.dtype == torch.int64
    assert dev[:td.version].tolist() == ranks.tolist()
    assert (dev[td.version:] == td.version).all()
    assert before.shape[0] == 8 and dev is td.device_ranks("cpu")


@pytest.mark.parametrize("name", ["less_than", "less_than_or_equal",
                                  "greater_than", "greater_than_or_equal",
                                  "equal", "not_equal"])
def test_varchar_comparisons(name):
    rng = np.random.default_rng(3)
    rows = [(None if rng.random() < 0.1 else str(rng.choice(WORDS)),
             None if rng.random() < 0.1 else str(rng.choice(WORDS)))
            for _ in range(40)]

    def run(pkg):
        c, e = pkg.common, pkg.expr
        schema = c.Schema.of(("a", c.VARCHAR), ("b", c.VARCHAR))
        chunk = pkg.chunk(schema, rows, capacity=64)
        out = []
        for rhs in (e.col(1, c.VARCHAR), e.Literal("apple", c.VARCHAR)):
            col = e.call(name, e.col(0, c.VARCHAR), rhs).eval(chunk)
            data = np.asarray(col.data)[:40]
            mask = np.asarray(col.mask)[:40]
            out.append([bool(d) if m else None for d, m in zip(data, mask)])
        return out

    got = both(run)
    py = {"less_than": str.__lt__, "less_than_or_equal": str.__le__,
          "greater_than": str.__gt__, "greater_than_or_equal": str.__ge__,
          "equal": str.__eq__, "not_equal": str.__ne__}[name]
    assert got[0] == [None if a is None or b is None else py(a, b)
                      for a, b in rows]


def test_str_rank_function():
    schema = T.Schema.of(("a", T.VARCHAR))
    chunk = T.make_chunk(schema, [(w,) for w in WORDS], capacity=16,
                         device="cpu")
    r = TE.call("str_rank", TE.col(0, T.VARCHAR)).eval(chunk)
    got = r.data[:len(WORDS)].tolist()
    assert sorted(WORDS, key=lambda w: got[WORDS.index(w)]) == sorted(WORDS)


# ---------------------------------------------------------------------------
# MIN/MAX over VARCHAR
# ---------------------------------------------------------------------------

KS = (("k", "INT64"), ("s", "VARCHAR"))


def _minmax_spec(seed: int):
    """Append-only epochs; each interns strings unseen before, so the rank
    table grows between updates (new strings rank below and above)."""
    rng = np.random.default_rng(seed)
    spec = [("b", 1, False)]
    for epoch in range(2, 6):
        fresh = [f"{ch}{seed}{epoch}" for ch in "Aam~"]
        pool = WORDS + fresh
        rows = [(int(rng.integers(0, 5)),
                 None if rng.random() < 0.1 else str(rng.choice(pool)))
                for _ in range(20)]
        spec += [("c", rows, None), ("b", epoch, False)]
    return spec


def test_hash_agg_min_max_varchar():
    spec = _minmax_spec(1)

    def run(pkg):
        c, e = pkg.common, pkg.expr
        calls = [e.agg("min", 1, c.VARCHAR), e.agg("max", 1, c.VARCHAR),
                 e.count_star()]
        ex = pkg.stream.HashAggExecutor(
            source(pkg, pkg.schema(*KS), spec), [0], calls,
            table_capacity=64, **pkg.kw())
        return pkg.drain(ex)

    rows = both(run)
    final: dict = {}
    for op, row in rows:
        if op in (0, 3):
            final[row[0]] = row
    every = [r for item in spec if item[0] == "c" for r in item[1]]
    for k, (_, lo, hi, n) in final.items():
        vals = [s for kk, s in every if kk == k and s is not None]
        assert (lo, hi, n) == (min(vals), max(vals),
                               sum(1 for kk, _ in every if kk == k))


def test_hash_agg_min_max_varchar_batched():
    """The batched ingest (one rank table for the K chunks) gives the
    per-chunk rows."""
    spec = _minmax_spec(2)
    chunks = [(item[1], None) for item in spec if item[0] == "c"]
    batched = [("b", 1, False), ("k", chunks), ("b", 2, False)]
    per_chunk = [("b", 1, False)] + [("c", r, o) for r, o in chunks] + [
        ("b", 2, False)]

    def run(pkg, s):
        c, e = pkg.common, pkg.expr
        ex = pkg.stream.HashAggExecutor(
            source(pkg, pkg.schema(*KS), s), [0],
            [e.agg("min", 1, c.VARCHAR), e.agg("max", 1, c.VARCHAR)],
            table_capacity=64, **pkg.kw())
        return pkg.drain(ex)

    assert both(lambda p: run(p, batched)) == both(
        lambda p: run(p, per_chunk))


def test_simple_agg_min_max_varchar():
    spec = _minmax_spec(3)

    def run(pkg):
        c, e = pkg.common, pkg.expr
        ex = pkg.stream.SimpleAggExecutor(
            source(pkg, pkg.schema(*KS), spec),
            [e.agg("min", 1, c.VARCHAR), e.agg("max", 1, c.VARCHAR)],
            **pkg.kw())
        return pkg.drain(ex)

    rows = both(run)
    every = [r[1] for item in spec if item[0] == "c" for r in item[1]
             if r[1] is not None]
    assert rows[-1] == (3, (min(every), max(every)))


# ---------------------------------------------------------------------------
# casts to and from VARCHAR
# ---------------------------------------------------------------------------

TS0 = 1_600_000_000_123_456


@pytest.mark.parametrize("kind,values", [
    ("INT64", [0, -7, 1 << 40, None]),
    ("INT32", [5, -1, None, 2 ** 31 - 1]),
    ("FLOAT64", [2.5, -0.0, 1e20, None, 3.0]),
    ("BOOL", [True, False, None]),
    ("TIMESTAMP", [TS0, 0, None, TS0 + 1_000_000 - 123_456]),
])
def test_cast_to_varchar_and_back(kind, values):
    t = getattr(T, kind)
    jt = getattr(JT, kind)
    schema = T.Schema.of(("x", t))
    chunk = T.make_chunk(schema, [(v,) for v in values], capacity=8,
                         device="cpu")
    as_text = TE.cast(TE.col(0, t), T.VARCHAR)
    text = as_text.eval(chunk)
    got = T.chunk_to_rows(chunk.with_columns([text]),
                          T.Schema.of(("s", T.VARCHAR)))
    want = [(None if v is None else _fmt_value(
        jt.to_physical(v) if kind == "TIMESTAMP" else v, jt),)
        for v in values]
    assert got == want
    back = TE.cast(as_text, t).eval(chunk)
    assert T.chunk_to_rows(chunk.with_columns([back]), schema) == [
        (v,) for v in values]


def test_cast_from_varchar_parses_text():
    schema = T.Schema.of(("s", T.VARCHAR))
    texts = [" 42", "-7 ", None, "2020-09-13 12:26:40.5", "yes", "3.25"]
    chunk = T.make_chunk(schema, [(s,) for s in texts], capacity=8,
                         device="cpu")
    col = TE.col(0, T.VARCHAR)

    def cast_rows(t, idx):
        sub = T.make_chunk(schema, [(texts[i],) for i in idx], capacity=8,
                           device="cpu")
        out = TE.cast(col, t).eval(sub)
        return T.chunk_to_rows(sub.with_columns([out]),
                               T.Schema.of(("v", t)))

    assert cast_rows(T.INT64, [0, 1, 2]) == [(42,), (-7,), (None,)]
    assert cast_rows(T.FLOAT64, [5, 0]) == [(3.25,), (42.0,)]
    assert cast_rows(T.BOOL, [4]) == [(True,)]
    assert cast_rows(T.TIMESTAMP, [3]) == [
        (_parse_timestamp(texts[3]),)]
    with pytest.raises(ValueError):
        TE.cast(col, T.INT64).eval(chunk)
    assert datetime.datetime(1970, 1, 1) + datetime.timedelta(
        microseconds=_parse_timestamp(texts[3])) == datetime.datetime(
        2020, 9, 13, 12, 26, 40, 500000)
