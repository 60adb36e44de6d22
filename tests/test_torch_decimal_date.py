"""DECIMAL, DATE and the other scalar kinds of the port (INT16, FLOAT32,
TIME, INTERVAL) against the reference on the CPU: value round trips, key
and value encodings byte for byte (negative decimals, dates before 1970,
NULLs; the native row codec's too), key order, chunk round trips, and the
expressions over them through both packages on the same chunks: decimal
scale alignment, casts, CASE, COALESCE, EXTRACT, DATE comparisons and the
string functions of tests/test_tpch.py::TestExprSurface. Exact
everywhere: decimals compare as scaled integers, strings by text.
"""

import numpy as np
import pytest

import risingwave_tpu.common.chunk as JC
import risingwave_tpu.common.row as JR
import risingwave_tpu.common.types as JT
import risingwave_tpu.expr.expr as JX
import risingwave_tpu_torch.common.chunk as TC
import risingwave_tpu_torch.common.row as TR
import risingwave_tpu_torch.common.types as TT
import risingwave_tpu_torch.expr.expr as TX
from risingwave_tpu_torch import native

PKGS = {"jax": (JT, JC, JX, JR), "torch": (TT, TC, TX, TR)}
KINDS = ["INT16", "INT32", "INT64", "FLOAT32", "FLOAT64", "DATE", "TIME",
         "TIMESTAMP", "INTERVAL", "dec0", "dec2", "dec4"]
VALUES = {
    "INT16": [-32768, -1, 0, 7, 32767],
    "INT32": [-(2**31), -5, 0, 3, 2**31 - 1],
    "INT64": [-(2**63), -9, 0, 11, 2**63 - 1],
    "FLOAT32": [-1.5, -0.0, 0.0, 0.25, 3.0e38],
    "FLOAT64": [-1e300, -2.5, 0.0, 1e-300, 7.25],
    "DATE": [-719468, -1, 0, 9204, 2932896],
    "TIME": [0, 1, 3_600_000_000, 86_399_999_999],
    "TIMESTAMP": [-(2**62), -1, 0, 795_225_600_000_000],
    "INTERVAL": [-86_400_000_000, 0, 1, 10_000_000],
    "dec0": [-123, -1, 0, 5, 99999],
    "dec2": [-9.99, -0.01, 0.0, 0.1, 100.5, 99.99],
    "dec4": [-123.4567, -0.0001, 0.0, 90.45, 1234.5678],
}


def dtype(mod, kind):
    if kind.startswith("dec"):
        return mod.decimal(int(kind[3:]))
    return getattr(mod, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip_and_encodings_equal(kind):
    """to_physical/to_python, memcomparable keys and value rows: equal
    between the packages, NULL included; key order is the values' order."""
    jt, tt = dtype(JT, kind), dtype(TT, kind)
    vals = VALUES[kind]
    jp = [jt.to_physical(v) for v in vals]
    tp = [tt.to_physical(v) for v in vals]
    assert tp == jp
    assert [tt.to_python(p) for p in tp] == [jt.to_python(p) for p in jp]
    for p in tp + [None]:
        assert TR.encode_value(p, tt) == JR.encode_value(p, jt)
    row = tp + [None]
    assert TR.encode_value_row(row, [tt] * len(row)) == \
        JR.encode_value_row(row, [jt] * len(row))
    assert TR.decode_value_row(TR.encode_value_row(row, [tt] * len(row)),
                               [tt] * len(row)) == tuple(row)
    keys = [TR.encode_key([p], [tt]) for p in tp]
    assert sorted(range(len(tp)), key=lambda i: keys[i]) == \
        sorted(range(len(tp)), key=lambda i: (tp[i], i))


def test_native_codec_bytes_equal_python():
    """The C++ row codec over every new kind, NULLs included, gives the
    Python encoders' bytes."""
    codec = native.codec()
    if codec is None:
        pytest.skip("no C++ compiler to build the native row codec")
    types = [dtype(TT, k) for k in KINDS]
    n = 5
    datas, masks = [], []
    for k, t in zip(KINDS, types):
        phys = [t.to_physical(v) for v in VALUES[k]][:n]
        phys += [phys[0]] * (n - len(phys))
        datas.append(np.asarray(phys, t.np_dtype))
        masks.append(np.array([1, 0, 1, 1, 1], bool))
    idx = np.arange(n)
    rows = [[None if not masks[c][i] else datas[c][i].item()
             for c in range(len(types))] for i in range(n)]
    assert codec.encode_keys(datas, masks, types, idx) == \
        [TR.encode_key(r, types) for r in rows]
    assert codec.encode_value_rows(datas, masks, types, idx) == \
        [TR.encode_value_row(r, types) for r in rows]


def rows_of(pkg, kinds, rows):
    t, c, _, _ = PKGS[pkg]
    schema = t.Schema.of(*((f"c{i}", dtype(t, k))
                           for i, k in enumerate(kinds)))
    kw = {"device": "cpu"} if pkg == "torch" else {}
    chunk = c.make_chunk(schema, rows, capacity=8, **kw)
    return schema, chunk


EXPR_KINDS = ["INT64", "dec2", "dec2", "DATE", "TIMESTAMP", "VARCHAR",
              "FLOAT64"]
EXPR_ROWS = [
    (1, 100.50, 0.10, 9204, 795_275_130_000_000, "hello world", 2.5),
    (2, 99.99, 0.0, -1, -1, "HELLO", -0.5),
    (3, -9.99, None, -719468, -62_135_596_800_000_001, "a%b", None),
    (4, 2.50, 9.99, 0, 0, "h_x", 10.0),
    (5, None, -0.01, 2932896, 86_399_999_999, "spark", 1.0),
]


def exprs(pkg):
    """The same expressions built with one package's ``call``."""
    t, _, x, _ = PKGS[pkg]
    d2, i64, date, ts = dtype(t, "dec2"), t.INT64, t.DATE, t.TIMESTAMP
    p, dsc, k = x.col(1, d2), x.col(2, d2), x.col(0, i64)
    dd, tsc, s = x.col(3, date), x.col(4, ts), x.col(5, t.VARCHAR)
    f = x.col(6, t.FLOAT64)

    def lit(v, ty):
        return x.Literal(v, ty)

    out = {
        "revenue": x.call("multiply", p, x.call("subtract", lit(1, i64),
                                                  dsc)),
        "add": x.call("add", p, dsc),
        "add_int": x.call("add", p, k),
        "mod": x.call("modulus", p, lit(3, i64)),
        "gt_int": x.call("greater_than", p, lit(100, i64)),
        "eq_dec": x.call("equal", p, dsc),
        "divide": x.call("divide", p, dsc),
        "mul_float": x.call("multiply", p, f),
        "case": x.call("case", x.call("greater_than", p, lit(2, i64)), p,
                       lit(1, i64)),
        "coalesce": x.call("coalesce", dsc, lit(5, i64)),
        "date_lt": x.call("less_than", dd, lit(9204, date)),
        "date_ge": x.call("greater_than_or_equal", dd, lit(-1, date)),
        "cast_bigint": x.cast(p, i64),
        "cast_dec0": x.cast(p, t.decimal(0)),
        "cast_dec4": x.cast(p, t.decimal(4)),
        "cast_float": x.cast(p, t.FLOAT64),
        "cast_float32": x.cast(p, t.FLOAT32),
        "cast_from_int": x.cast(k, d2),
        "cast_from_float": x.cast(f, d2),
        "date_to_ts": x.cast(dd, ts),
        "ts_to_date": x.cast(tsc, date),
        "lower_like": x.call("like", x.call("lower", s),
                             lit("hello%", t.VARCHAR)),
        "like": x.call("like", s, lit("h%", t.VARCHAR)),
        "not_like": x.call("not_like", s, lit("%o%", t.VARCHAR)),
        "like_escape": x.call("like", s, lit("a\\%b", t.VARCHAR)),
        "upper": x.call("upper", s),
        "concat": x.call("concat_op", s, lit("!", t.VARCHAR)),
        "length": x.call("length", s),
        "substr": x.call("substr", s, lit(1, i64), lit(5, i64)),
        "substr_0": x.call("substr", s, lit(0, i64), lit(3, i64)),
        "substr_from": x.call("substr", s, lit(3, i64)),
    }
    for field in ("year", "month", "day", "quarter", "dow", "doy",
                  "epoch"):
        out[f"extract_{field}_date"] = x.make_extract(field, dd)
    for field in ("year", "month", "day", "hour", "minute", "second",
                  "dow", "doy", "epoch"):
        out[f"extract_{field}_ts"] = x.make_extract(field, tsc)
    return out


@pytest.fixture(scope="module")
def evaluated():
    """name -> (result type, [python value or None per row]) per package."""
    out = {}
    for pkg in PKGS:
        t = PKGS[pkg][0]
        schema, chunk = rows_of(pkg, EXPR_KINDS, EXPR_ROWS)
        res = {}
        for name, e in exprs(pkg).items():
            c = e.eval(chunk)
            data = np.asarray(c.data)[:len(EXPR_ROWS)]
            mask = np.asarray(c.mask)[:len(EXPR_ROWS)]
            res[name] = (e.type.kind.name, e.type.scale, [
                (t.GLOBAL_STRING_DICT.lookup(int(v)) if e.type.is_string
                 else v.item()) if m else None
                for v, m in zip(data, mask)])
        out[pkg] = res
    return out


@pytest.mark.parametrize("name", sorted(exprs("torch")))
def test_expression_equal_to_reference(evaluated, name):
    assert evaluated["torch"][name] == evaluated["jax"][name]


def test_expression_surface_values(evaluated):
    """tests/test_tpch.py::TestExprSurface's expectations, on the port."""
    r = {k: v[2] for k, v in evaluated["torch"].items()}
    assert r["revenue"][:2] == [904500, 999900]          # 90.45, 99.99
    assert r["cast_bigint"][:3] == [101, 100, -10]       # rounds half away
    assert r["upper"][0] == "HELLO WORLD" and r["concat"][1] == "HELLO!"
    assert r["length"][0] == 11 and r["substr"][0] == "hello"
    assert r["substr_0"][0] == "he"
    assert r["like"] == [True, False, False, True, False]
    assert r["not_like"] == [False, True, True, True, True]
    assert r["lower_like"] == [True, True, False, False, False]
    assert r["like_escape"] == [False, False, True, False, False]
    assert [r[f"extract_{f}_date"][0] for f in
            ("year", "month", "day", "quarter", "dow")] == [1995, 3, 15, 1, 3]
    assert [r[f"extract_{f}_ts"][0] for f in ("hour", "minute", "second")] \
        == [13, 45, 30]
    assert r["extract_year_date"][2] == 0 and r["extract_day_date"][1] == 31


def test_string_functions_reject_other_types():
    k = TX.col(0, TT.INT64)
    for name, args in (("like", (k, TX.Literal("1%", TT.VARCHAR))),
                       ("concat_op", (k, TX.Literal("x", TT.VARCHAR))),
                       ("upper", (k,))):
        with pytest.raises(TypeError, match="varchar"):
            TX.call(name, *args)


@pytest.mark.parametrize("name,extra", [
    ("concat_op", ("x",)), ("upper", ()), ("substr", (2,)),
    ("length", ()), ("like", ("a%",))])
def test_string_function_over_chunks_keeps_dictionary_bounded(name, extra):
    """A string function evaluated on chunk after chunk interns at most one
    result per distinct input: ``s || 'x'`` over the same strings adds them
    once, and never feeds its own results back in ('ax', 'axx', ...)."""
    rng = np.random.default_rng(7)
    words = [f"a{int(v)}" for v in rng.integers(0, 50, 64)]
    sch = TT.Schema.of(("s", TT.VARCHAR))
    chunk = TC.make_chunk(sch, [(w,) for w in words], capacity=64,
                          device="cpu")
    lits = [TX.Literal(v, TT.VARCHAR if isinstance(v, str) else TT.INT64)
            for v in extra]
    e = TX.call(name, TX.col(0, TT.VARCHAR), *lits)
    first = e.eval(chunk).data.clone()
    after_one = len(TT.GLOBAL_STRING_DICT)
    for _ in range(5):
        assert np.array_equal(e.eval(chunk).data.numpy(), first.numpy())
        assert len(TT.GLOBAL_STRING_DICT) == after_one


@pytest.mark.parametrize("kind", KINDS)
def test_chunk_round_trip_equal(kind):
    """make_chunk → chunk_to_rows, logical and physical, as the reference
    gives them (a DECIMAL as its Python value)."""
    rows = [(v,) for v in VALUES[kind]] + [(None,)]
    got = [rows_of(p, [kind], rows) for p in PKGS]
    for physical in (False, True):
        a, b = (PKGS[p][1].chunk_to_rows(ch, sch, physical=physical)
                for p, (sch, ch) in zip(PKGS, got))
        assert b == a


def test_decimal_aggregates_equal_reference():
    """sum, min and max over DECIMAL (int64 lanes at the argument's scale,
    exact) and avg (float64 of the scaled-down values), grouped by a DATE,
    with retractions, through both packages' HashAgg."""
    from risingwave_tpu.expr.agg import AggCall as JAggCall
    from risingwave_tpu_torch.expr.agg import AggCall as TAggCall
    from test_torch_recovery import BOTH, JAX
    rows = [(9204, 100.50), (9204, -9.99), (-1, 0.01), (9204, 2.5),
            (-1, None), (-719468, 12345.67)]
    out = []
    for pkg in BOTH:
        t = PKGS["jax" if pkg is JAX else "torch"][0]
        call = JAggCall if pkg is JAX else TAggCall
        sch = t.Schema.of(("d", t.DATE), ("p", t.decimal(2)))
        calls = [call(k, 1, t.decimal(2)) for k in
                 ("sum", "min", "max", "avg")]
        msgs = [pkg.stream.Barrier.new(1),
                pkg.chunk(sch, rows, capacity=8),
                pkg.stream.Barrier.new(2, checkpoint=True),
                pkg.chunk(sch, [rows[3]], [1], capacity=8),
                pkg.stream.Barrier.new(3, checkpoint=True)]
        agg = pkg.stream.HashAggExecutor(
            pkg.stream.MockSource(sch, msgs), [0], calls,
            table_capacity=64, **pkg.kw(out_capacity=16))
        out.append(pkg.drain(agg))
    assert out[1] == out[0] and len(out[0]) > 0
