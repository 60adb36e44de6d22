"""The regexp functions, split_part and to_char through both packages on
the CPU: the port's host tier (``risingwave_tpu_torch/expr/expr.py``)
against the reference's registry functions on the same chunks.

Inputs are random strings made from a seed (URL-like ones with
``channel_id`` parameters and '/' paths, and plain words), NULLs among
them; patterns with and without groups, PostgreSQL flags and replacement
templates (``\\1``, ``\\&``); split_part fields from -5 to 7; timestamps
from 1900 to 2100, negative ones among them, through every to_char
pattern, in upper and lower case. VARCHAR results are compared decoded
(dictionary ids differ between the packages). Tolerance: exact.
"""

import numpy as np
import pytest

from test_torch_recovery import BOTH

N = 96
WORDS = ["apple", "Google", "channel_id", "a/b/c", "", "x&y", "Baidu",
         "FaceBook", "abcabc", "ABC", "a.b.c", "line\nbreak"]
PATTERNS = ["(&|^)channel_id=([^&]*)", "a(b)(c)?", "[aeiou]", "^a",
            "b", "(x)|(y)", "c$", "."]


def _url(rng) -> str:
    host = rng.choice(["https://www.nexmark.com", "http://a.b", ""])
    path = "/".join(str(rng.choice(["item", "dir", "x", "", "y"]))
                    for _ in range(int(rng.integers(0, 6))))
    params = "&".join(f"{k}={rng.integers(0, 100)}" for k in
                      rng.choice(["channel_id", "other", "id"],
                                 int(rng.integers(0, 3))))
    return f"{host}/{path}" + (f"?{params}" if params else "")


def strings(seed: int, n: int = N) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        r = rng.random()
        out.append(None if r < 0.1 else _url(rng) if r < 0.55
                   else str(rng.choice(WORDS)) + str(rng.choice(WORDS)))
    return out


def evaluate(pkg, rows, build, types):
    """``build(expr, common)`` over the chunk of ``rows`` (columns of
    ``types``): the result decoded per row (None for NULL)."""
    c, e = pkg.common, pkg.expr
    schema = c.Schema.of(*((f"c{i}", getattr(c, t))
                           for i, t in enumerate(types)))
    chunk = pkg.chunk(schema, rows, capacity=len(rows))
    expr = build(e, c)
    with pkg.eager():
        col = expr.eval(chunk)
    data = np.asarray(col.data)
    mask = np.asarray(col.mask)
    conv = expr.type.to_python
    return [conv(d) if m else None for d, m in zip(data, mask)]


def both(rows, build, types=("VARCHAR",)):
    got = [evaluate(pkg, rows, build, types) for pkg in BOTH]
    assert got[1] == got[0]
    return got[0]


def lit(e, c, v, t="VARCHAR"):
    return e.Literal(v, getattr(c, t))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_regexp_like_count_match(pattern):
    rows = [(s,) for s in strings(1)]
    for fn in ("regexp_like", "regexp_count", "regexp_match"):
        got = both(rows, lambda e, c, fn=fn: e.call(
            fn, e.col(0, c.VARCHAR), lit(e, c, pattern)))
        assert got.count(None) >= rows.count((None,))


@pytest.mark.parametrize("flags", ["", "i", "g", "gi", "s", "n", "x", "c"])
def test_regexp_replace_flags_and_templates(flags):
    rows = [(s,) for s in strings(2)]
    for pattern, repl in (("(a)(b)?", "<\\2\\1>"), ("[AB]", "\\&\\&"),
                          ("b", "\\\\"), ("(c)", "\\q\\1"),
                          ("a . b", "X")):
        got = both(rows, lambda e, c: e.call(
            "regexp_replace", e.col(0, c.VARCHAR), lit(e, c, pattern),
            lit(e, c, repl), lit(e, c, flags)))
        assert any(g is not None for g in got)
    # the three-argument form replaces the first match only
    got = both([("abab",), ("xyz",), (None,)], lambda e, c: e.call(
        "regexp_replace", e.col(0, c.VARCHAR), lit(e, c, "b"),
        lit(e, c, "!")))
    assert got == ["a!ab", "xyz", None]


def test_regexp_match_flags_and_column_pattern():
    rows = [(s, p) for s, p in zip(strings(3), strings(4, N))]
    rows = [(s, None if p is None else PATTERNS[i % len(PATTERNS)])
            for i, (s, p) in enumerate(rows)]
    both(rows, lambda e, c: e.call("regexp_match", e.col(0, c.VARCHAR),
                                   e.col(1, c.VARCHAR), lit(e, c, "i")),
         ("VARCHAR", "VARCHAR"))
    both(rows, lambda e, c: e.call("regexp_like", e.col(0, c.VARCHAR),
                                   e.col(1, c.VARCHAR)),
         ("VARCHAR", "VARCHAR"))


@pytest.mark.parametrize("group", [0, 1, 2, 3])
def test_regexp_match_group(group):
    """q21's ``(regexp_match(url, p))[n]``: NULL on no match, out of range
    or a group that took no part in the match."""
    rows = [(s,) for s in strings(5)] + [("xy",), ("y",), ("channel_id=",)]
    for pattern in ("(&|^)channel_id=([^&]*)", "(x)|(y)", "[ab]+"):
        got = both(rows, lambda e, c: e.call(
            "regexp_match_group", e.col(0, c.VARCHAR), lit(e, c, pattern),
            lit(e, c, group, "INT32")))
        if group == 0:
            assert set(got) == {None}
    assert both([("y",)], lambda e, c: e.call(
        "regexp_match_group", e.col(0, c.VARCHAR), lit(e, c, "(x)|(y)"),
        lit(e, c, 1, "INT32"))) == [None]


@pytest.mark.parametrize("field", [-5, -2, -1, 1, 2, 4, 5, 6, 7])
def test_split_part(field):
    rows = [(s,) for s in strings(6)]
    for delim in ("/", "&", "", "//"):
        both(rows, lambda e, c: e.call(
            "split_part", e.col(0, c.VARCHAR), lit(e, c, delim),
            lit(e, c, field, "INT32")))
    # a column field operand, NULLs among the fields
    rng = np.random.default_rng(7)
    rows = [(s, None if rng.random() < 0.1 else int(rng.choice(
        [-3, -1, 1, 2, 3, 9]))) for s in strings(8)]
    both(rows, lambda e, c: e.call("split_part", e.col(0, c.VARCHAR),
                                   lit(e, c, "/"), e.col(1, c.INT64)),
         ("VARCHAR", "INT64"))


def test_split_part_zero_field_raises():
    for pkg in BOTH:
        with pytest.raises(ValueError):
            evaluate(pkg, [("a/b",)], lambda e, c: e.call(
                "split_part", e.col(0, c.VARCHAR), lit(e, c, "/"),
                lit(e, c, 0, "INT32")), ("VARCHAR",))


FORMATS = ["YYYY-MM-DD", "yyyy-MM-dd", "HH:MI", "HH24:MI:SS", "hh12 am",
           "YY/MM/DD HH PM", "MS", "SS.MS", "Day DD", "YYYYMMDDHH24MISSMS",
           "plain text", "pm HH12:mi"]


@pytest.mark.parametrize("fmt", FORMATS)
def test_to_char(fmt):
    rng = np.random.default_rng(9)
    lo, hi = -2_208_988_800_000_000, 4_102_444_800_000_000   # 1900, 2100
    ts = rng.integers(lo, hi, N)
    ts[:8] = [0, -1, 1, 43_200_000_000, -43_200_000_001, 999,
              -86_400_000_000, 86_399_999_999]
    rows = [(None if i % 11 == 5 else int(t),) for i, t in enumerate(ts)]
    got = both(rows, lambda e, c: e.call("to_char", e.col(0, c.TIMESTAMP),
                                         lit(e, c, fmt)), ("TIMESTAMP",))
    assert got[0] == both([(0,)], lambda e, c: e.call(
        "to_char", e.col(0, c.TIMESTAMP), lit(e, c, fmt)), ("TIMESTAMP",))[0]
    assert got[5] is None and sum(g is None for g in got) == N // 11 + 1


def test_to_char_q10_strings():
    """q10's day and time strings: HH is the 12-hour clock."""
    rows = [(43_200_000_000 + 60_000_000,), (0,), (-1,)]
    assert both(rows, lambda e, c: e.call(
        "to_char", e.col(0, c.TIMESTAMP), lit(e, c, "HH:MI")),
        ("TIMESTAMP",)) == ["12:01", "12:00", "11:59"]
    assert both(rows, lambda e, c: e.call(
        "to_char", e.col(0, c.TIMESTAMP), lit(e, c, "YYYY-MM-DD")),
        ("TIMESTAMP",)) == ["1970-01-01", "1970-01-01", "1969-12-31"]
