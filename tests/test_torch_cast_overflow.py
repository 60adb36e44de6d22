"""Integer division overflow, saturating float casts and the rounding
float-to-integer cast of the port against the reference on the CPU.

The same chunks go through both packages' expressions. Tolerance: exact
(integer results and masks). One result is a divergence by name, not
parity: the port rounds a float cast to an integer (PostgreSQL's rint,
ties to even) where the reference truncates (ROADMAP C3).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import risingwave_tpu.common.chunk as JC
import risingwave_tpu.common.types as JT
import risingwave_tpu.expr.expr as JX
import risingwave_tpu_torch.common.chunk as TC
import risingwave_tpu_torch.common.types as TT
import risingwave_tpu_torch.expr.expr as TX

PKGS = {"jax": (JT, JC, JX), "torch": (TT, TC, TX)}
CAP = 16
INT_KINDS = {"INT16": 16, "INT32": 32, "INT64": 64}


def evaluate(pkg, schema_of, rows, expr_of):
    """(data, mask) of ``expr_of(types, expr)`` over a chunk of ``rows``,
    as numpy arrays of the visible rows."""
    t, c, x = PKGS[pkg]
    schema = schema_of(t)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    chunk = c.make_chunk(schema, rows, capacity=CAP, **kw)
    col = expr_of(t, x).eval(chunk)
    n = len(rows)
    return np.asarray(col.data)[:n], np.asarray(col.mask)[:n]


def both(schema_of, rows, expr_of):
    got = evaluate("torch", schema_of, rows, expr_of)
    want = evaluate("jax", schema_of, rows, expr_of)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(np.where(got[1], got[0], 0),
                                  np.where(want[1], want[0], 0))
    return got


@pytest.mark.parametrize("kind", list(INT_KINDS))
@pytest.mark.parametrize("fn", ["divide", "modulus"])
def test_minimum_over_minus_one_matches_reference(kind, fn):
    """min / -1 is the minimum (wrapped), min % -1 is 0; a zero divisor is
    NULL; the other rows divide as usual."""
    lo = -(2 ** (INT_KINDS[kind] - 1))
    rows = [(lo, -1), (lo + 1, -1), (7, -1), (-7, 2), (lo, 1), (5, 0),
            (lo, 2), (-(lo + 1), -1), (0, -1)]

    def schema_of(t):
        return t.Schema.of(("a", getattr(t, kind)), ("b", getattr(t, kind)))

    data, mask = both(schema_of, rows, lambda t, x: x.call(
        fn, x.col(0, getattr(t, kind)), x.col(1, getattr(t, kind))))
    if fn == "divide":
        assert data[0] == lo and data[1] == -(lo + 1)
    else:
        assert data[0] == 0
    assert not mask[5]


def test_narrow_dividend_over_wider_divisor_matches_reference():
    """An INT16 column over an INT32 one divides in INT32 (the promoted
    type), the INT16 minimum over -1 giving +32768 there."""
    rows = [(-32768, -1), (-32768, 2), (32767, -1), (3, 0)]

    def schema_of(t):
        return t.Schema.of(("a", t.INT16), ("b", t.INT32))

    data, _ = both(schema_of, rows, lambda t, x: x.call(
        "divide", x.col(0, t.INT16), x.col(1, t.INT32)))
    assert data[0] == 32768


def test_minimum_over_minus_one_does_not_kill_the_process():
    """The case that ended the process with SIGFPE before the repair, run
    in a child process so a regression fails this test alone."""
    code = (
        "import risingwave_tpu_torch.common as T\n"
        "import risingwave_tpu_torch.expr.expr as X\n"
        "for k in ('INT64', 'INT32'):\n"
        "    t = getattr(T, k)\n"
        "    s = T.Schema.of(('a', t), ('b', t))\n"
        "    lo = -2 ** (63 if k == 'INT64' else 31)\n"
        "    ch = T.make_chunk(s, [(lo, -1)], capacity=4, device='cpu')\n"
        "    c = X.call('divide', X.col(0, t), X.col(1, t)).eval(ch)\n"
        "    print(int(c.data[0]))\n")
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == [str(-2 ** 63), str(-2 ** 31)]


SATURATING = [float("nan"), float("inf"), float("-inf"), 1e10, -1e10, 1e19,
              -1e19, 9.3e18, -9.3e18, 0.0, -0.0, 123.0]
TARGETS = ["INT16", "INT32", "INT64", "TIMESTAMP", "DATE", "dec2"]


def target(t, name):
    return t.decimal(2) if name == "dec2" else getattr(t, name)


@pytest.mark.parametrize("dst", TARGETS)
@pytest.mark.parametrize("src", ["FLOAT64", "FLOAT32"])
def test_float_cast_saturates_as_reference(dst, src):
    """NaN gives 0, ±inf and values past the range the type's limits."""
    rows = [(v,) for v in SATURATING]

    def schema_of(t):
        return t.Schema.of(("f", getattr(t, src)))

    data, _ = both(schema_of, rows, lambda t, x: x.Cast(
        x.col(0, getattr(t, src)), target(t, dst)))
    info = np.iinfo(data.dtype)
    assert data[0] == 0
    assert data[1] == info.max and data[2] == info.min


def test_int64_into_decimal_saturates_as_reference():
    """An INT64 cast to DECIMAL goes through the float path (as an INT64
    operand meeting a DECIMAL does): past 2**63 / 100 it saturates there
    too, and a comparison with a DECIMAL literal agrees."""
    rows = [(2 ** 62,), (-(2 ** 62),), (5,)]

    def schema_of(t):
        return t.Schema.of(("i", t.INT64))

    data, _ = both(schema_of, rows, lambda t, x: x.Cast(
        x.col(0, t.INT64), t.decimal(2)))
    assert data.tolist() == [2 ** 63 - 1, -(2 ** 63), 500]
    data, _ = both(schema_of, rows, lambda t, x: x.call(
        "greater_than", x.col(0, t.INT64), x.Literal(1.5, t.decimal(2))))
    assert data.tolist() == [True, False, True]


@pytest.mark.parametrize("dst", ["INT16", "INT32", "INT64"])
def test_float_to_integer_rounds_where_reference_truncates(dst):
    """Divergence (ROADMAP C3): CAST(double AS integer) rounds to the
    nearest, ties to even, as PostgreSQL does: 3.7 -> 4, 2.5 -> 2, -2.5
    -> -2, -3.7 -> -4, 0.5 -> 0. The reference truncates (3, 2, -2, -3,
    0)."""
    rows = [(3.7,), (2.5,), (-2.5,), (-3.7,), (0.5,), (32767.6,)]

    def schema_of(t):
        return t.Schema.of(("f", t.FLOAT64))

    def expr_of(t, x):
        return x.Cast(x.col(0, t.FLOAT64), getattr(t, dst))

    got, _ = evaluate("torch", schema_of, rows, expr_of)
    want, _ = evaluate("jax", schema_of, rows, expr_of)
    assert got[:5].tolist() == [4, 2, -2, -4, 0]
    assert want[:5].tolist() == [3, 2, -2, -3, 0]
    # rounding past the range saturates
    assert got[5] == (32767 if dst == "INT16" else 32768)


def test_float_to_decimal_rounds_half_to_even_as_reference():
    """FLOAT to DECIMAL keeps the reference's half-to-even rounding (0.125
    at scale 2 is 0.12; PostgreSQL gives 0.13: recorded in ROADMAP C3)."""
    rows = [(0.125,), (0.375,), (-0.125,), (1.005,)]

    def schema_of(t):
        return t.Schema.of(("f", t.FLOAT64))

    data, _ = both(schema_of, rows, lambda t, x: x.Cast(
        x.col(0, t.FLOAT64), t.decimal(2)))
    assert data[:3].tolist() == [12, 38, -12]
