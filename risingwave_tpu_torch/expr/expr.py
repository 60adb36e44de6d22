"""Vectorized expression engine — the subset the q5/q7 path needs.

Counterpart of ``risingwave_tpu/expr/expr.py``: an expression is a small
static tree whose ``eval(chunk) -> Column`` is plain tensor code over the
column tensors. Null semantics are SQL three-valued logic: masks propagate
through strict functions; AND/OR use Kleene logic. VARCHAR values are
dictionary ids: equality compares ids, the ordering comparisons compare the
ids' lexicographic ranks, and casts to or from VARCHAR format or parse each
distinct value on the host. The string, regex, JSONB, extract and decimal
function families are not ported yet.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..common import types as T
from ..common.chunk import Column, StreamChunk
from ..common.types import GLOBAL_STRING_DICT, DataType, TypeKind, rank_of


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
        impl, _ = _REGISTRY[self.name]
        cols = [a.eval(chunk) for a in self.args]
        data, mask = impl([c.data for c in cols], [c.mask for c in cols],
                          self.type)
        return Column(data, mask)


_STR_ORDER_FNS = {
    "less_than", "less_than_or_equal", "greater_than",
    "greater_than_or_equal",
}


def call(name: str, *args: Expr) -> FunctionCall:
    if name not in _REGISTRY:
        raise KeyError(f"unknown function {name!r}")
    if name in _STR_ORDER_FNS and all(a.type.is_string for a in args):
        # ids are insertion-ordered: order by the dictionary's ranks
        name = "str_" + name
    elif any(a.type.is_string for a in args) and name not in (
            "equal", "not_equal", "is_null", "is_not_null", "str_rank"):
        raise NotImplementedError(
            f"{name} over VARCHAR: string functions are not ported yet")
    _, infer = _REGISTRY[name]
    return FunctionCall(name, tuple(args), infer([a.type for a in args]))


def col(index: int, type: DataType) -> InputRef:
    return InputRef(index, type)


# -- type inference helpers --------------------------------------------------

_NUM_ORDER = [TypeKind.INT32, TypeKind.INT64, TypeKind.FLOAT64]


def _promote(ts: Sequence[DataType]) -> DataType:
    """Widest numeric type; a non-numeric operand (timestamp arithmetic)
    wins regardless of position."""
    for t in ts:
        if t.kind not in _NUM_ORDER:
            return t
    best = ts[0]
    for t in ts[1:]:
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


# arithmetic
register("add", _t_same)(_binary(torch.add))
register("subtract", _t_same)(_binary(torch.sub))
register("multiply", _t_same)(_binary(torch.mul))
register("neg", _t_first)(_unary(torch.neg))
register("abs", _t_first)(_unary(torch.abs))


@register("divide", _t_same)
def _divide(datas, masks, out_type):
    a, b = datas
    mask = _strict_mask(masks) & (b != 0)  # div-by-zero -> NULL
    safe_b = torch.where(b == 0, torch.ones_like(b), b)
    if out_type.is_float:
        r = a.to(out_type.dtype) / safe_b.to(out_type.dtype)
    else:
        # SQL integer division truncates toward zero
        a2, b2 = _common(a, safe_b)
        r = torch.div(a2, b2, rounding_mode="trunc").to(out_type.dtype)
    return r, mask


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
        if self.arg.type.is_string or self.type.is_string:
            return Column(_cast_text(c, self.arg.type, self.type), c.mask)
        return Column(c.data.to(self.type.dtype), c.mask)


def cast(arg: Expr, to: DataType) -> Expr:
    return Cast(arg, to) if arg.type != to else arg


@register("tumble_start", lambda ts: T.TIMESTAMP)
def _tumble_start(datas, masks, out_type):
    ts, window = datas
    w = window.long()
    safe = torch.where(w == 0, torch.ones_like(w), w)
    start = torch.div(ts.long(), safe, rounding_mode="floor") * safe
    return start, _strict_mask(masks) & (w != 0)
