"""Vectorized expression engine.

Counterpart of ``risingwave_tpu/expr/expr.py``: an expression is a small
static tree whose ``eval(chunk) -> Column`` is plain tensor code over the
column tensors. Null semantics are SQL three-valued logic: masks propagate
through strict functions; AND/OR use Kleene logic; CASE, COALESCE and IS
NULL handle masks explicitly. DECIMAL is a scaled int64: ``call`` aligns
the scales of +, -, %, comparisons, CASE and COALESCE, and a product's
scale is the sum of its operands'. VARCHAR values are dictionary ids:
equality compares ids, the ordering comparisons compare the ids' ranks,
casts to or from VARCHAR format or parse each distinct value on the host,
and the string functions (lower, upper, trim, substr, length, ||, LIKE,
the regexp functions, split_part, to_char) run on the host, as do the
functions over LIST, STRUCT and JSONB values (array_access, array_length,
struct_field and the jsonb_* accessors, JSON parsed once per distinct
text): length, LIKE, regexp_like and regexp_count with literal operands
once per dictionary id, gathered on the card; the others once per
distinct operand tuple of the chunk, their results (VARCHAR and JSONB
interned) gathered back on the card. round, floor and ceil run on the
card; over DECIMAL they give PostgreSQL's results at the argument's
scale (the reference returns the argument, ROADMAP C3).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import re
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..common import types as T
from ..common.chunk import Column, StreamChunk
from ..common.types import (
    GLOBAL_LIST_DICT, GLOBAL_STRING_DICT, DataType, TypeKind, rank_of,
)


class Expr:
    """Base class. Subclasses are immutable, hashable plan-time objects."""

    type: DataType

    def eval(self, chunk: StreamChunk) -> Column:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class InputRef(Expr):
    """Reference to input column ``index``."""

    index: int
    type: DataType

    def eval(self, chunk: StreamChunk) -> Column:
        return chunk.columns[self.index]


@dataclasses.dataclass(frozen=True, eq=False)
class Literal(Expr):
    value: Any
    type: DataType

    def eval(self, chunk: StreamChunk) -> Column:
        cap, dev = chunk.capacity, chunk.device
        if self.value is None:
            return Column(torch.zeros(cap, dtype=self.type.dtype, device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev))
        phys = self.type.to_physical(self.value)
        return Column(torch.full((cap,), phys, dtype=self.type.dtype,
                                 device=dev),
                      torch.ones(cap, dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------
# Scalar function registry
# ---------------------------------------------------------------------------

#: name -> (impl, type_infer). impl(datas, masks, out_type) -> (data, mask).
_REGISTRY: dict[str, tuple[Callable, Callable]] = {}


def register(name: str, type_infer: Callable[[Sequence[DataType]], DataType]):
    def deco(fn):
        _REGISTRY[name] = (fn, type_infer)
        return fn
    return deco


@dataclasses.dataclass(frozen=True, eq=False)
class FunctionCall(Expr):
    name: str
    args: tuple[Expr, ...]
    type: DataType

    def eval(self, chunk: StreamChunk) -> Column:
        cols = [a.eval(chunk) for a in self.args]
        if self.name in _HOST_FNS:
            return _eval_host_fn(self, cols)
        impl, _ = _REGISTRY[self.name]
        data, mask = impl([c.data for c in cols], [c.mask for c in cols],
                          self.type)
        return Column(data, mask)


_DECIMAL_ALIGN_FNS = {
    "add", "subtract", "modulus", "equal", "not_equal", "less_than",
    "less_than_or_equal", "greater_than", "greater_than_or_equal",
}


def _decimal_fixup(name: str, args: tuple) -> tuple:
    """Fixed-point scales: aligned scales make +, -, % and comparisons
    plain int64 ops (integers are cast up to the widest scale);
    ``multiply`` adds scales (``_t_mul``); ``divide`` and any float operand
    lower DECIMAL to float64."""
    if not any(a.type.kind == TypeKind.DECIMAL for a in args):
        return args
    if name == "divide" or any(a.type.is_float for a in args):
        return tuple(cast(a, T.FLOAT64) if a.type.kind == TypeKind.DECIMAL
                     else a for a in args)
    s = max(a.type.scale for a in args)

    def align(a):
        return cast(a, T.decimal(s)) if (a.type.kind == TypeKind.DECIMAL
                                         or a.type.is_integral) else a

    if name in _DECIMAL_ALIGN_FNS or name == "coalesce":
        return tuple(align(a) for a in args)
    if name == "case":
        # value positions only: odd indices and the trailing ELSE
        has_else = len(args) % 2 == 1
        out = list(args)
        for i in range(1, len(args) - (1 if has_else else 0), 2):
            out[i] = align(args[i])
        if has_else:
            out[-1] = align(args[-1])
        return tuple(out)
    return args


_STR_ORDER_FNS = {
    "less_than", "less_than_or_equal", "greater_than",
    "greater_than_or_equal",
}
#: functions that take dictionary-id operands (ids are equal exactly when
#: the values are)
_STR_OK_FNS = {"equal", "not_equal", "is_null", "is_not_null", "str_rank",
               "coalesce", "case"}


def _is_dict_type(t: DataType) -> bool:
    return t.is_string or t.is_list or t.is_struct


def call(name: str, *args: Expr) -> FunctionCall:
    if name not in _REGISTRY:
        raise KeyError(f"unknown function {name!r}")
    args = _decimal_fixup(name, tuple(args))
    if name in _HOST_FNS:
        first = _FIRST_OPERAND.get(name)
        for pos in _HOST_FNS[name][0][:len(args)]:
            t = args[pos].type
            ok = (t.kind == first if pos == 0 and first is not None
                  else t.is_string)
            if not ok:
                want = "varchar" if pos or first is None else first.value
                raise TypeError(f"{name} expects {want}, got "
                                f"{t.kind.value}")
    elif name in _STR_ORDER_FNS and all(a.type.is_string for a in args):
        # ids are insertion-ordered: order by the dictionary's ranks
        name = "str_" + name
    elif name not in _STR_OK_FNS:
        for a in args:
            if _is_dict_type(a.type):
                raise NotImplementedError(
                    f"{name} over {a.type.kind.value} is not ported")
    _, infer = _REGISTRY[name]
    return FunctionCall(name, tuple(args), infer([a.type for a in args]))


def struct_field(arg: Expr, name: str) -> FunctionCall:
    """``(arg).name``: typed by the field's declared type (the binder's
    form: the field's index as an INT64 literal)."""
    return FunctionCall("struct_field",
                        (arg, Literal(arg.type.field_index(name), T.INT64)),
                        arg.type.field_type(name))


def col(index: int, type: DataType) -> InputRef:
    return InputRef(index, type)


# -- type inference helpers --------------------------------------------------

_NUM_ORDER = [
    TypeKind.INT16, TypeKind.INT32, TypeKind.INT64, TypeKind.DECIMAL,
    TypeKind.FLOAT32, TypeKind.FLOAT64,
]


def _promote(ts: Sequence[DataType]) -> DataType:
    """Widest numeric type (of two DECIMALs the larger scale); a
    non-numeric operand (date, time or timestamp arithmetic) wins
    regardless of position."""
    for t in ts:
        if t.kind not in _NUM_ORDER:
            return t
    best = ts[0]
    for t in ts[1:]:
        if t.kind == best.kind:
            if t.kind == TypeKind.DECIMAL and t.scale > best.scale:
                best = t
            continue
        if _NUM_ORDER.index(t.kind) > _NUM_ORDER.index(best.kind):
            best = t
    return best


def _t_bool(ts): return T.BOOL
def _t_same(ts): return _promote(ts)
def _t_first(ts): return ts[0]
def _t_int64(ts): return T.INT64


def _strict_mask(masks):
    m = masks[0]
    for mm in masks[1:]:
        m = m & mm
    return m


def _common(a, b):
    ct = torch.promote_types(a.dtype, b.dtype)
    return a.to(ct), b.to(ct)


def _binary(fn):
    def impl(datas, masks, out_type):
        a, b = _common(*datas)
        return fn(a, b).to(out_type.dtype), _strict_mask(masks)
    return impl


def _unary(fn):
    def impl(datas, masks, out_type):
        return fn(datas[0]).to(out_type.dtype), masks[0]
    return impl


def _cmp(fn):
    def impl(datas, masks, out_type):
        a, b = _common(*datas)
        return fn(a, b), _strict_mask(masks)
    return impl


def _t_mul(ts):
    """A fixed-point product's scale is the sum of its operands' (float
    operands were lowered by ``_decimal_fixup``)."""
    decs = [t for t in ts if t.kind == TypeKind.DECIMAL]
    if decs:
        return T.decimal(sum(t.scale for t in decs))
    return _promote(ts)


# arithmetic
register("add", _t_same)(_binary(torch.add))
register("subtract", _t_same)(_binary(torch.sub))
register("multiply", _t_mul)(_binary(torch.mul))
register("neg", _t_first)(_unary(torch.neg))
register("abs", _t_first)(_unary(torch.abs))


@register("divide", _t_same)
def _divide(datas, masks, out_type):
    a, b = datas
    mask = _strict_mask(masks) & (b != 0)  # div-by-zero -> NULL
    if out_type.is_float:
        safe_b = torch.where(b == 0, torch.ones_like(b), b)
        return a.to(out_type.dtype) / safe_b.to(out_type.dtype), mask
    # SQL integer division truncates toward zero. A -1 divisor is kept
    # from the division like 0 (the minimum over -1 traps the CPU's
    # divide): its quotient is the dividend negated with wrap-around, so
    # the minimum over -1 is the minimum, as the reference's lax.div gives
    minus_one = b == -1
    safe_b = torch.where((b == 0) | minus_one, torch.ones_like(b), b)
    a2, b2 = _common(a, safe_b)
    r = torch.where(minus_one, torch.neg(a2),
                    torch.div(a2, b2, rounding_mode="trunc"))
    return r.to(out_type.dtype), mask


@register("modulus", _t_same)
def _modulus(datas, masks, out_type):
    a, b = datas
    mask = _strict_mask(masks) & (b != 0)
    safe_b = torch.where(b == 0, torch.ones_like(b), b)
    # SQL modulus takes the dividend's sign (C-style remainder)
    a2, b2 = _common(a, safe_b)
    return torch.fmod(a2, b2).to(out_type.dtype), mask


# comparison
register("equal", _t_bool)(_cmp(torch.eq))
register("not_equal", _t_bool)(_cmp(torch.ne))
register("less_than", _t_bool)(_cmp(torch.lt))
register("less_than_or_equal", _t_bool)(_cmp(torch.le))
register("greater_than", _t_bool)(_cmp(torch.gt))
register("greater_than_or_equal", _t_bool)(_cmp(torch.ge))


@register("str_rank", _t_int64)
def _str_rank(datas, masks, out_type):
    """VARCHAR id -> lexicographic rank, through the rank table as of this
    evaluation (the table changes as strings are interned)."""
    ranks = GLOBAL_STRING_DICT.device_ranks(datas[0].device)
    return rank_of(ranks, datas[0]), masks[0]


def _str_cmp(fn):
    """An ordering comparison of two VARCHAR operands: both sides map
    through ONE rank table fetched after both were evaluated, so a string
    interned during evaluation (a literal's first use) cannot put them in
    different rank spaces."""
    def impl(datas, masks, out_type):
        ranks = GLOBAL_STRING_DICT.device_ranks(datas[0].device)
        return (fn(rank_of(ranks, datas[0]), rank_of(ranks, datas[1])),
                _strict_mask(masks))
    return impl


register("str_less_than", _t_bool)(_str_cmp(torch.lt))
register("str_less_than_or_equal", _t_bool)(_str_cmp(torch.le))
register("str_greater_than", _t_bool)(_str_cmp(torch.gt))
register("str_greater_than_or_equal", _t_bool)(_str_cmp(torch.ge))


# Kleene AND/OR
@register("and", _t_bool)
def _and(datas, masks, out_type):
    a, b = datas
    ma, mb = masks
    result = (a & ma) & (b & mb)
    known = (ma & mb) | (ma & ~a) | (mb & ~b)
    return result, known


@register("or", _t_bool)
def _or(datas, masks, out_type):
    a, b = datas
    ma, mb = masks
    true_a = ma & a
    true_b = mb & b
    return true_a | true_b, (ma & mb) | true_a | true_b


@register("not", _t_bool)
def _not(datas, masks, out_type):
    return ~datas[0], masks[0]


# null handling
@register("is_null", _t_bool)
def _is_null(datas, masks, out_type):
    return ~masks[0], torch.ones_like(masks[0])


@register("is_not_null", _t_bool)
def _is_not_null(datas, masks, out_type):
    return masks[0].clone(), torch.ones_like(masks[0])


@register("coalesce", _t_first)
def _coalesce(datas, masks, out_type):
    data = torch.zeros_like(datas[0], dtype=out_type.dtype)
    mask = torch.zeros_like(masks[0])
    # last argument first, so the first non-null argument wins
    for d, m in zip(reversed(datas), reversed(masks)):
        data = torch.where(m, d.to(out_type.dtype), data)
        mask = mask | m
    return data, mask


# conditional: case(cond1, val1, cond2, val2, ..., else_val)
@register("case", lambda ts: ts[1])
def _case(datas, masks, out_type):
    n = len(datas)
    if n % 2 == 1:
        data = datas[-1].to(out_type.dtype)
        mask = masks[-1]
        pairs = (n - 1) // 2
    else:
        data = torch.zeros_like(datas[1], dtype=out_type.dtype)
        mask = torch.zeros_like(masks[0])
        pairs = n // 2
    for i in reversed(range(pairs)):
        cond = datas[2 * i] & masks[2 * i]
        data = torch.where(cond, datas[2 * i + 1].to(out_type.dtype), data)
        mask = torch.where(cond, masks[2 * i + 1], mask)
    return data, mask


_EPOCH = datetime.datetime(1970, 1, 1)
_BOOL_TEXT = {"t": True, "true": True, "y": True, "yes": True, "on": True,
              "1": True, "f": False, "false": False, "n": False, "no": False,
              "off": False, "0": False}


def text_of(v: Any, t: DataType) -> str:
    """A physical value's text form: the reference's pgwire text encoding
    (``risingwave_tpu/frontend/pgwire.py::_fmt_value``)."""
    if t.kind == TypeKind.BOOL:
        return "t" if v else "f"
    if t.kind == TypeKind.TIMESTAMP:
        return (_EPOCH + datetime.timedelta(microseconds=int(v))
                ).isoformat(sep=" ")
    if t.is_string:
        return GLOBAL_STRING_DICT.lookup(int(v))
    return str(t.to_python(v))


def parse_text(text: str, t: DataType) -> Any:
    """Text -> physical value of ``t``; raises ValueError on text that is
    not a value of ``t`` (PostgreSQL's "invalid input syntax")."""
    s = text.strip()
    if t.kind == TypeKind.BOOL:
        try:
            return _BOOL_TEXT[s.lower()]
        except KeyError:
            raise ValueError(
                f"invalid input syntax for type boolean: {text!r}") from None
    if t.kind == TypeKind.TIMESTAMP:
        # naive = UTC, exact integer microseconds (the reference binder's
        # timestamp literal parse)
        d = datetime.datetime.fromisoformat(s)
        if d.tzinfo is not None:
            d = d.astimezone(datetime.timezone.utc).replace(tzinfo=None)
        return (d - _EPOCH) // datetime.timedelta(microseconds=1)
    if t.is_float:
        return float(s)
    return int(s)


def _cast_text(c: Column, src: DataType, dst: DataType) -> torch.Tensor:
    """Cast to or from VARCHAR: each distinct non-null value is formatted
    (interned) or parsed once on the host. NULL rows stay NULL and are
    never parsed."""
    data = c.data.cpu().numpy()
    mask = c.mask.cpu().numpy()
    uniq, inv = np.unique(data[mask], return_inverse=True)
    if dst.is_string:
        vals = [GLOBAL_STRING_DICT.intern(text_of(u.item(), src))
                for u in uniq]
    else:
        vals = [parse_text(GLOBAL_STRING_DICT.lookup(int(u)), dst)
                for u in uniq]
    out = np.zeros(data.shape, dst.np_dtype)
    out[mask] = np.asarray(vals, dst.np_dtype)[inv.reshape(-1)]
    return torch.from_numpy(out).to(c.data.device)


@dataclasses.dataclass(frozen=True, eq=False)
class Cast(Expr):
    arg: Expr
    type: DataType

    def eval(self, chunk: StreamChunk) -> Column:
        c = self.arg.eval(chunk)
        src, dst = self.arg.type, self.type
        if src.is_string or dst.is_string:
            return Column(_cast_text(c, src, dst), c.mask)
        data = c.data
        if src.kind == TypeKind.DECIMAL and dst.kind == TypeKind.DECIMAL:
            if dst.scale >= src.scale:
                data = data * 10 ** (dst.scale - src.scale)
            else:
                data = _round_div(data, 10 ** (src.scale - dst.scale))
        elif src.kind == TypeKind.DECIMAL and dst.is_float:
            data = data.to(dst.dtype) / 10 ** src.scale
        elif src.kind == TypeKind.DECIMAL:
            data = _round_div(data, 10 ** src.scale).to(dst.dtype)
        elif dst.kind == TypeKind.DECIMAL:
            # half to even, as the reference rounds (PostgreSQL's numeric
            # rounds half away from zero: ROADMAP C3)
            data = saturate(torch.round(data.double() * 10 ** dst.scale),
                            dst.dtype)
        elif src.kind == TypeKind.DATE and dst.kind == TypeKind.TIMESTAMP:
            data = data.long() * USECS_PER_DAY
        elif src.kind == TypeKind.TIMESTAMP and dst.kind == TypeKind.DATE:
            data = torch.div(data.long(), USECS_PER_DAY,
                             rounding_mode="floor").to(dst.dtype)
        elif src.is_float and dst.kind in _SQL_INTS:
            # PostgreSQL rounds to the nearest, ties to even (rint); the
            # reference truncates (ROADMAP C3)
            data = saturate(torch.round(data.double()), dst.dtype)
        elif src.is_float and dst.is_integral:
            data = saturate(data.double(), dst.dtype)
        else:
            data = data.to(dst.dtype)
        return Column(data, c.mask)


_SQL_INTS = (TypeKind.INT16, TypeKind.INT32, TypeKind.INT64)


def saturate(f: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float64 -> integer ``dtype`` as the reference converts: NaN to 0,
    values past the range (±inf included) to its limits. ``Tensor.to``
    gives the minimum for all of these instead. The comparisons are in
    float64 against the exact bounds: the maximum 2**(bits-1) - 1 has no
    float64 when bits is 64, so the upper test is ``>= 2**(bits-1)`` and
    the maximum is written as an integer."""
    info = torch.iinfo(dtype)
    top = float(info.max + 1)
    high = f >= top
    low = f < float(info.min)
    safe = torch.where(torch.isnan(f) | high | low, torch.zeros_like(f), f)
    out = safe.to(dtype)
    out = torch.where(high, torch.full_like(out, info.max), out)
    return torch.where(low, torch.full_like(out, info.min), out)


def _round_div(d: torch.Tensor, factor: int) -> torch.Tensor:
    """Fixed-point narrowing: PostgreSQL rounds half away from zero."""
    half = factor // 2
    d = torch.where(d >= 0, d + half, d - half)
    return torch.div(d, factor, rounding_mode="trunc")


def cast(arg: Expr, to: DataType) -> Expr:
    return Cast(arg, to) if arg.type != to else arg


def _rounding(float_fn, decimal_fn):
    """round, floor or ceil: ``float_fn`` over floats, the identity over
    integers, and over DECIMAL ``decimal_fn(scaled, 10**scale)`` to whole
    units at the same scale (PostgreSQL's results: 1.25 gives 1, 1, 2;
    the reference returns the argument, ROADMAP C3)."""
    def impl(datas, masks, out_type):
        d = datas[0]
        if out_type.kind == TypeKind.DECIMAL and out_type.scale:
            f = 10 ** out_type.scale
            return decimal_fn(d, f) * f, masks[0]
        if out_type.is_float:
            return float_fn(d), masks[0]
        return d.clone(), masks[0]
    return impl


register("round", _t_first)(_rounding(torch.round, _round_div))
register("floor", _t_first)(_rounding(
    torch.floor, lambda d, f: torch.div(d, f, rounding_mode="floor")))
register("ceil", _t_first)(_rounding(
    torch.ceil, lambda d, f: -torch.div(-d, f, rounding_mode="floor")))


# temporal: epoch-microsecond arithmetic
USECS_PER_SEC = 1_000_000
USECS_PER_MIN = 60 * USECS_PER_SEC
USECS_PER_HOUR = 60 * USECS_PER_MIN
USECS_PER_DAY = 24 * USECS_PER_HOUR


@register("tumble_start", lambda ts: T.TIMESTAMP)
def _tumble_start(datas, masks, out_type):
    ts, window = datas
    w = window.long()
    safe = torch.where(w == 0, torch.ones_like(w), w)
    start = torch.div(ts.long(), safe, rounding_mode="floor") * safe
    return start, _strict_mask(masks) & (w != 0)


# ---------------------------------------------------------------------------
# EXTRACT: civil-date arithmetic on day numbers (Howard Hinnant's
# algorithm), integer tensor ops with floor division, so days before 1970
# come out right
# ---------------------------------------------------------------------------

def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _civil_from_days(days: torch.Tensor):
    z = days.long() + 719468
    era = _fdiv(z, 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = y + (m <= 2).long()
    return y, m, d, doy


def _days_from_civil(y, m, d):
    y = y - (m <= 2).long()
    era = _fdiv(y, 400)
    yoe = y - era * 400
    doy = _fdiv(153 * torch.where(m > 2, m - 3, m + 9) + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def make_extract(field: str, arg: Expr) -> Expr:
    """``extract(field FROM arg)``: the day number depends on the
    argument's logical type (DATE or TIMESTAMP), which a function's impl
    does not see, so each (field, type) registers a function of its own."""
    field = field.lower()
    t = arg.type
    days_div = 1 if t.kind == TypeKind.DATE else USECS_PER_DAY

    def days_of(data):
        return _fdiv(data.long(), days_div)

    def with_days(fn):
        def impl(datas, masks, out_type):
            return fn(days_of(datas[0])).long(), masks[0]
        return impl

    def time_part(unit_us, modulo):
        def impl(datas, masks, out_type):
            return _fdiv(datas[0].long() % modulo, unit_us), masks[0]
        return impl

    name = f"__extract_{field}_{t.kind.name.lower()}"
    if name not in _REGISTRY:
        if field == "year":
            impl = with_days(lambda d: _civil_from_days(d)[0])
        elif field == "month":
            impl = with_days(lambda d: _civil_from_days(d)[1])
        elif field == "day":
            impl = with_days(lambda d: _civil_from_days(d)[2])
        elif field == "quarter":
            impl = with_days(lambda d: _fdiv(_civil_from_days(d)[1] + 2, 3))
        elif field == "dow":        # Sunday = 0; 1970-01-01 was a Thursday
            impl = with_days(lambda d: (d + 4) % 7)
        elif field == "doy":
            def impl(datas, masks, out_type):
                days = days_of(datas[0])
                y = _civil_from_days(days)[0]
                one = torch.ones_like(y)
                return days - _days_from_civil(y, one, one) + 1, masks[0]
        elif field == "epoch":
            per = USECS_PER_DAY // USECS_PER_SEC
            if t.kind == TypeKind.DATE:
                def impl(datas, masks, out_type):
                    return datas[0].long() * per, masks[0]
            else:
                def impl(datas, masks, out_type):
                    return _fdiv(datas[0].long(), USECS_PER_SEC), masks[0]
        elif field == "hour":
            impl = time_part(USECS_PER_HOUR, USECS_PER_DAY)
        elif field == "minute":
            impl = time_part(USECS_PER_MIN, USECS_PER_HOUR)
        elif field == "second":
            impl = time_part(USECS_PER_SEC, USECS_PER_MIN)
        else:
            raise KeyError(f"unsupported EXTRACT field {field!r}")
        _REGISTRY[name] = (impl, _t_int64)
    return call(name, arg)


# ---------------------------------------------------------------------------
# Functions over dictionary ids: strings, and LIST, STRUCT and JSONB values.
# The content lives in the host dictionaries, so each function runs on the
# host. length, LIKE, regexp_like and regexp_count (a BOOL or an integer,
# never NULL), with literals for their other operands, run once per
# dictionary id (a table over every id so far, extended as the dictionary
# grows), and the result for a chunk is a gather of that table on the card:
# no row goes to the host, and no host sync. Every other function runs once
# per distinct operand tuple of the chunk (one copy to the host), its
# results gathered back on the card. A VARCHAR table over every id would
# intern its results and then have to extend over them: ``s || '!'`` would
# add one string per id on every chunk ('x!', 'x!!', ...) until the
# dictionary is full.
# ---------------------------------------------------------------------------

def _lookup_str(i: int) -> str:
    try:
        return GLOBAL_STRING_DICT.lookup(int(i))
    except IndexError:
        return ""


def _substr(s, start, n=None):
    """PostgreSQL's window is [start-1, start-1+n) in virtual positions: a
    start below 1 uses up length before the string begins."""
    if n is None:
        return s[max(start - 1, 0):]
    return s[max(start - 1, 0):max(start - 1 + n, 0)]


def _like_regex(pattern: str) -> "re.Pattern":
    """LIKE's pattern as an anchored regex: % any run, _ one character, a
    backslash makes the next character literal."""
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if ch == "%" else "." if ch == "_"
                   else re.escape(ch))
        i += 1
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


@functools.lru_cache(maxsize=256)
def _like_cached(pattern: str):
    return _like_regex(pattern)


def _like(s, pattern):
    return _like_cached(pattern).match(s) is not None


# regexp functions, with PostgreSQL's semantics: flags, ``\1`` replacement
# templates, replace-first unless 'g', a group that took no part in the
# match is NULL

@functools.lru_cache(maxsize=256)
def _compile_re(pattern: str, py_flags: int = 0):
    return re.compile(pattern, py_flags)


def _re_flags(flags: str) -> int:
    """PostgreSQL's flag letters; 'g' is the caller's (replace all)."""
    f = 0
    for ch in flags:
        if ch == "i":
            f |= re.IGNORECASE
        elif ch in ("n", "m"):     # newline-sensitive matching
            f |= re.MULTILINE
        elif ch == "s":            # '.' matches a newline
            f |= re.DOTALL
        elif ch == "x":
            f |= re.VERBOSE
        elif ch in ("c", "g"):     # 'c': case-sensitive, the default
            pass
        else:
            raise ValueError(f"invalid regexp flag: {ch!r}")
    return f


def _pg_replacement_template(r: str) -> str:
    """A PostgreSQL replacement string as a ``re.sub`` template, scanned
    left to right: ``\\&`` (the whole match) -> ``\\g<0>``, ``\\1``..``\\9``
    and ``\\\\`` kept, any other escape the literal character."""
    out = []
    i = 0
    while i < len(r):
        c = r[i]
        if c == "\\" and i + 1 < len(r):
            n = r[i + 1]
            if n == "&":
                out.append("\\g<0>")
            elif n.isdigit() or n == "\\":
                out.append(c + n)
            else:
                out.append(n)
            i += 2
        elif c == "\\":                   # a trailing lone backslash
            out.append("\\\\")
            i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _regexp_replace(s, p, r, flags=""):
    count = 0 if "g" in flags else 1
    return _compile_re(p, _re_flags(flags)).sub(
        _pg_replacement_template(r), s, count=count)


def _regexp_match(s, p, flags=""):
    """The first capture group of the first match (the whole match when
    the pattern has no group): the scalar the reference returns in place
    of PostgreSQL's text[]."""
    if "g" in flags:
        raise ValueError("regexp_match does not support the global option")
    m = _compile_re(p, _re_flags(flags)).search(s)
    if m is None:
        return None
    return m.group(1) if m.re.groups else m.group(0)


def _regexp_match_group(s: str, p: str, n: int):
    """``(regexp_match(s, p))[n]``: the 1-based group of the first match;
    NULL with no match, out of range, or a group that took no part. With
    no capture group, [1] is the whole match."""
    m = _compile_re(p).search(s)
    if m is None:
        return None
    if m.re.groups == 0:
        return m.group(0) if n == 1 else None
    if 1 <= n <= m.re.groups:
        return m.group(n)
    return None


def _split_part(s: str, delim: str, n: int):
    """1-based field; a negative one counts from the end; out of range
    gives ''."""
    if n == 0:
        raise ValueError("field position must not be zero")
    parts = s.split(delim) if delim else [s]
    i = n - 1 if n > 0 else len(parts) + n
    return parts[i] if 0 <= i < len(parts) else ""


# to_char over timestamps: a PostgreSQL pattern subset, matched
# case-insensitively, longest first; HH is HH12. Each pattern's unit: the
# value depends only on the timestamp floored to the finest unit of the
# format's patterns, so a chunk's timestamps are floored on the card
# before their distinct values go to the host.
_TO_CHAR_PATTERNS = [
    ("YYYY", lambda dt: f"{dt[0]:04d}", USECS_PER_DAY),
    ("YY", lambda dt: f"{dt[0] % 100:02d}", USECS_PER_DAY),
    ("MM", lambda dt: f"{dt[1]:02d}", USECS_PER_DAY),
    ("DD", lambda dt: f"{dt[2]:02d}", USECS_PER_DAY),
    ("HH24", lambda dt: f"{dt[3]:02d}", USECS_PER_HOUR),
    ("HH12", lambda dt: f"{(dt[3] % 12) or 12:02d}", USECS_PER_HOUR),
    ("HH", lambda dt: f"{(dt[3] % 12) or 12:02d}", USECS_PER_HOUR),
    ("MI", lambda dt: f"{dt[4]:02d}", USECS_PER_MIN),
    ("SS", lambda dt: f"{dt[5]:02d}", USECS_PER_SEC),
    ("MS", lambda dt: f"{dt[6] // 1000:03d}", 1000),
    ("AM", lambda dt: "AM" if dt[3] < 12 else "PM", USECS_PER_HOUR),
    ("PM", lambda dt: "AM" if dt[3] < 12 else "PM", USECS_PER_HOUR),
]


@functools.lru_cache(maxsize=64)
def _to_char_compile(fmt: str):
    """(segments, unit): each segment a literal character or a pattern
    function; ``unit`` the finest unit the patterns read."""
    segs: list = []
    unit = USECS_PER_DAY
    i = 0
    up = fmt.upper()
    while i < len(fmt):
        for pat, fn, u in _TO_CHAR_PATTERNS:
            if up.startswith(pat, i):
                segs.append(fn)
                unit = min(unit, u)
                i += len(pat)
                break
        else:
            segs.append(fmt[i])
            i += 1
    return segs, unit


def _to_char(us: int, fmt: str) -> str:
    d = _EPOCH + datetime.timedelta(microseconds=us)
    dt = (d.year, d.month, d.day, d.hour, d.minute, d.second, d.microsecond)
    return "".join(seg if isinstance(seg, str) else seg(dt)
                   for seg in _to_char_compile(fmt)[0])


def _to_char_floor(args, datas):
    """to_char's timestamps floored to its format's unit, on the card (a
    format that is a column is left as it is)."""
    if not isinstance(args[1], Literal):
        return datas
    unit = _to_char_compile(args[1].value)[1]
    return [_fdiv(datas[0].long(), unit) * unit] + datas[1:]


def _array_access(elems: tuple, n: int):
    """1-based element access; out of range is NULL."""
    return elems[n - 1] if 1 <= n <= len(elems) else None


def _struct_field(fields: tuple, i: int):
    return fields[i] if 0 <= i < len(fields) else None


# JSONB values are canonical JSON text. A parsed value is cached and shared,
# so it is never mutated.

@functools.lru_cache(maxsize=4096)
def _jsonb_parse(s: str):
    try:
        return json.loads(s) if s else None
    except ValueError:
        return None


_MISSING = object()    # an absent key, as opposed to a JSON null


def _jsonb_get(j, key):
    if isinstance(j, dict):
        return j.get(key, _MISSING) if isinstance(key, str) else _MISSING
    if isinstance(j, list) and isinstance(key, int):
        # a negative index counts from the end
        return j[key] if -len(j) <= key < len(j) else _MISSING
    return _MISSING


def _jsonb_access(s: str, key, as_text: bool):
    """``->`` (jsonb) or ``->>`` (text): an absent key is SQL NULL; under
    ``->`` a JSON null is jsonb 'null', under ``->>`` SQL NULL."""
    v = _jsonb_get(_jsonb_parse(s), key)
    if v is _MISSING or (as_text and v is None):
        return None
    if as_text and isinstance(v, str):
        return v
    return T.canonical_json(v)


def _jsonb_typeof(s: str):
    if s == "null":
        return "null"
    v = _jsonb_parse(s)
    if v is None:
        return None
    return {dict: "object", list: "array", str: "string", bool: "boolean",
            int: "number", float: "number"}.get(type(v))


def _jsonb_array_length(s: str):
    v = _jsonb_parse(s)
    return len(v) if isinstance(v, list) else None


def _t_elem(ts):
    return ts[0].elem_type


#: name -> (positions of dictionary-id operands, python function of the
#: operands' python values, result type or a function of the operand
#: types). A result of None is SQL NULL. An operand that is a LIST or a
#: STRUCT arrives as its tuple, a VARCHAR, BYTEA or JSONB one as its text,
#: any other as an int.
_HOST_FNS: dict[str, tuple] = {
    "lower": ((0,), str.lower, T.VARCHAR),
    "upper": ((0,), str.upper, T.VARCHAR),
    "trim": ((0,), str.strip, T.VARCHAR),
    "ltrim": ((0,), str.lstrip, T.VARCHAR),
    "rtrim": ((0,), str.rstrip, T.VARCHAR),
    "substr": ((0,), _substr, T.VARCHAR),
    "substring": ((0,), _substr, T.VARCHAR),
    "length": ((0,), len, T.INT64),
    "concat_op": ((0, 1), lambda a, b: a + b, T.VARCHAR),
    "like": ((0, 1), _like, T.BOOL),
    "not_like": ((0, 1), lambda s, p: not _like(s, p), T.BOOL),
    "regexp_like": ((0, 1), lambda s, p: _compile_re(p).search(s)
                    is not None, T.BOOL),
    "regexp_count": ((0, 1), lambda s, p: len(_compile_re(p).findall(s)),
                     T.INT64),
    "regexp_replace": ((0, 1, 2, 3), _regexp_replace, T.VARCHAR),
    "regexp_match": ((0, 1, 2), _regexp_match, T.VARCHAR),
    "regexp_match_group": ((0, 1), _regexp_match_group, T.VARCHAR),
    "split_part": ((0, 1), _split_part, T.VARCHAR),
    "to_char": ((1,), _to_char, T.VARCHAR),
    "array_access": ((0,), _array_access, _t_elem),
    "array_length": ((0,), len, T.INT64),
    # ``call`` types it INT64, as the reference's registry does;
    # ``struct_field()`` by the field's declared type, as its binder does
    "struct_field": ((0,), _struct_field, T.INT64),
    "jsonb_get_field": ((0, 1), lambda s, k: _jsonb_access(s, k, False),
                        T.JSONB),
    "jsonb_get_elem": ((0,), lambda s, i: _jsonb_access(s, i, False),
                       T.JSONB),
    "jsonb_get_field_text": ((0, 1), lambda s, k: _jsonb_access(s, k, True),
                             T.VARCHAR),
    "jsonb_get_elem_text": ((0,), lambda s, i: _jsonb_access(s, i, True),
                            T.VARCHAR),
    "jsonb_typeof": ((0,), _jsonb_typeof, T.VARCHAR),
    "jsonb_array_length": ((0,), _jsonb_array_length, T.INT64),
}
#: the kind the first operand must have, where it is not a string
_FIRST_OPERAND = {
    "array_access": TypeKind.LIST, "array_length": TypeKind.LIST,
    "struct_field": TypeKind.STRUCT,
    **{n: TypeKind.JSONB for n in _HOST_FNS if n.startswith("jsonb_")},
}
#: the functions evaluated through a table over every dictionary id
_PER_ID_FNS = {"length", "like", "not_like", "regexp_like", "regexp_count"}
for _name, (_, _, _out) in _HOST_FNS.items():
    # evaluated by ``_eval_host_fn``, not through an impl
    _REGISTRY[_name] = (None, _out if callable(_out)
                        else lambda ts, _t=_out: _t)


class _IdTable:
    """A string function's BOOL or integer result for every dictionary id
    so far, given literal values for its other operands: a numpy table grown
    by the ids interned since, and its copy on each device grown by the same
    part. It interns nothing, so extending it never grows the dictionary."""

    def __init__(self, fn, out_type: DataType):
        assert not out_type.is_string
        self.fn, self.out_type = fn, out_type
        self.host = np.zeros(0, out_type.np_dtype)
        self.device: dict = {}

    def on(self, device, n: int) -> torch.Tensor:
        m = self.host.shape[0]
        if m < n:
            vals = [self.fn(_lookup_str(i)) for i in range(m, n)]
            self.host = np.concatenate(
                [self.host, np.asarray(vals, self.out_type.np_dtype)])
        dev = torch.device(device)
        have = self.device.get(dev)
        k = 0 if have is None else have.shape[0]
        if k < n:
            part = torch.from_numpy(self.host[k:n]).to(dev)
            have = part if have is None else torch.cat([have, part])
            self.device[dev] = have
        return have


_ID_TABLES: dict = {}


def _eval_host_fn(e: "FunctionCall", cols) -> Column:
    """A function over dictionary ids, on a chunk (see the section's
    note)."""
    str_pos, fn, _ = _HOST_FNS[e.name]
    out_type = e.type
    mask = _strict_mask([c.mask for c in cols])
    if any(isinstance(a, Literal) and a.value is None for a in e.args):
        return Column(torch.zeros_like(cols[0].data, dtype=out_type.dtype),
                      mask)
    cols_at = [i for i, a in enumerate(e.args) if not isinstance(a, Literal)]
    if e.name in _PER_ID_FNS and len(cols_at) == 1 and cols_at[0] in str_pos:
        # one column operand, a VARCHAR one: gather from its id table
        at = cols_at[0]
        lits = tuple(None if i == at else a.value
                     for i, a in enumerate(e.args))
        key = (e.name, at, lits)
        table = _ID_TABLES.get(key)
        if table is None:
            def one(s, _lits=lits, _at=at):
                return fn(*(s if i == _at else v
                            for i, v in enumerate(_lits)))
            table = _ID_TABLES[key] = _IdTable(one, out_type)
        ids = cols[at].data
        t = table.on(ids.device, len(GLOBAL_STRING_DICT))
        return Column(t[ids.long().clamp(0, t.shape[0] - 1)], mask)
    # every other function: once per distinct operand tuple of the rows
    # whose operands are all non-NULL (a NULL row's sentinel never reaches
    # the function)
    datas = [c.data for c in cols]
    if e.name == "to_char":
        datas = _to_char_floor(e.args, datas)
    # the operands (0 on a NULL row) and the mask in one copy to the host
    both = torch.stack([torch.where(mask, d.long(), 0) for d in datas]
                       + [mask.long()], 1).cpu().numpy()
    host, valid = both[:, :-1], both[:, -1].astype(bool)
    uniq, inv = np.unique(host, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    wanted = np.zeros(len(uniq), bool)
    wanted[inv[valid]] = True
    vals = np.zeros(len(uniq), out_type.np_dtype)
    known = np.zeros(len(uniq), bool)
    decode = [int if i not in str_pos
              else GLOBAL_LIST_DICT.lookup if a.type.is_list or a.type.is_struct
              else _lookup_str for i, a in enumerate(e.args)]
    for u in np.nonzero(wanted)[0]:
        r = fn(*(dec(int(v)) for dec, v in zip(decode, uniq[u])))
        if r is not None:
            # VARCHAR and JSONB results interned, a STRUCT one too
            vals[u] = out_type.to_physical(r)
            known[u] = True
    dev = cols[0].data.device
    return Column(torch.from_numpy(vals[inv]).to(dev),
                  mask & torch.from_numpy(known[inv]).to(dev))


#: the reference's functions evaluated on the host (its host callbacks and
#: the rank-table readers). The planner moves residual join conditions that
#: use one into a filter above an inner join; the names are the reference's,
#: so plans split exactly where its do.
HOST_CALLBACK_FNS = {
    "lower", "upper", "trim", "ltrim", "rtrim", "substr", "substring",
    "length", "concat_op", "like", "not_like",
    "regexp_like", "regexp_count", "regexp_replace", "regexp_match",
    "regexp_match_group", "split_part", "to_char", "array_access",
    "array_length", "struct_field", "jsonb_get_field", "jsonb_get_elem",
    "jsonb_get_field_text", "jsonb_get_elem_text", "jsonb_typeof",
    "jsonb_array_length",
    "str_rank", "str_less_than", "str_less_than_or_equal",
    "str_greater_than", "str_greater_than_or_equal",
}


def uses_host_callback(e: Expr) -> bool:
    if isinstance(e, FunctionCall):
        return (e.name in HOST_CALLBACK_FNS
                or any(uses_host_callback(a) for a in e.args))
    if isinstance(e, Cast):
        return uses_host_callback(e.arg)
    return False
