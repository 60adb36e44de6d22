"""Aggregate function specifications.

Counterpart of ``risingwave_tpu/expr/agg.py``. Each lane aggregate keeps a
fixed number of int64/float64 lanes per group; ``contributions`` gives
per-row values that the caller scatter-reduces into the group table. min/max
are exact for append-only inputs, as in the reference. MIN/MAX over VARCHAR
stores the dictionary id and reduces in ``rank << 32 | id`` space, with the
ranks fetched fresh at each update. Calls that cannot be fixed lanes (exact
DISTINCT, the collecting kinds) run on the host tier
(``stream/materialized_agg.py``), array_agg among them. DECIMAL is an
integral kind: its sum, min and max lanes are int64 at the argument's
scale (exact, so the card's order of atomics cannot change them); avg
scales it down to float64.

approx_count_distinct keeps a HyperLogLog of 16 int64 register lanes per
call, each reduced with max (append-only: a delete cannot lower a
register). A row's value is hashed with splitmix64 (a float as its
float64 bits, a DECIMAL as its scaled int64, a VARCHAR as its dictionary
id); the hash's low 4 bits pick the register and the leading-zero count
of the rest gives its rank, as the reference computes them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..common.hashing import _shr, _splitmix64
from ..common.types import (
    FLOAT64, INT64, VARCHAR, DataType, TypeKind, list_of, rank_of,
)
from .expr import saturate

_I64_MAX = torch.iinfo(torch.int64).max
_LANE_KINDS = ("count", "sum", "min", "max", "avg", "approx_count_distinct")


def clz64(w: torch.Tensor) -> torch.Tensor:
    """Leading zeros of each non-negative int64 (64 for 0), exactly: a
    binary search over shifts (a float log2 rounds values of 2**53 and
    above)."""
    n = torch.zeros_like(w)
    x = w
    for s in (32, 16, 8, 4, 2, 1):
        hi = x >> s
        big = hi != 0
        n = n + torch.where(big, s, 0)
        x = torch.where(big, hi, x)
    return 64 - (n + x)


def hll_rho(w: torch.Tensor) -> torch.Tensor:
    """An HLL register rank from the hash with its 4 register bits shifted
    out (``w < 2**60``): the leading zeros of ``w`` less the 4 that the
    shift made, plus one, so ``w = 0`` gives 61 (the reference's
    ``clz(w) - 3``)."""
    return clz64(w) - 3


@dataclasses.dataclass(frozen=True)
class AggCall:
    """A planned aggregate: kind + input column index (-1 for count(*))."""

    kind: str
    arg: int = -1
    arg_type: Optional[DataType] = None
    distinct: bool = False
    #: constant side argument: string_agg's delimiter, percentile_cont's
    #: fraction (a python value)
    extra: Optional[object] = None

    #: HLL registers of approx_count_distinct: 16, each an int64 lane
    HLL_M = 16

    #: kinds that can never be fixed device lanes (ragged multiset state):
    #: always on the host tier
    MATERIALIZED_KINDS = frozenset(
        {"array_agg", "string_agg", "percentile_cont", "mode"})

    def __post_init__(self):
        if (self.kind not in _LANE_KINDS
                and self.kind not in self.MATERIALIZED_KINDS):
            raise ValueError(f"unknown aggregate {self.kind!r}")

    @property
    def output_type(self) -> DataType:
        if self.kind in ("count", "approx_count_distinct"):
            return INT64
        if self.kind in ("avg", "percentile_cont"):
            return FLOAT64
        if self.kind == "string_agg":
            return VARCHAR
        if self.kind == "array_agg":
            return list_of(self.arg_type)
        return self.arg_type

    @property
    def needs_append_only(self) -> bool:
        """min/max and HLL register lanes are monotone: a delete cannot
        retract them."""
        return self.kind in ("min", "max", "approx_count_distinct")

    @property
    def lanes_unsupported(self) -> bool:
        """True when this call cannot run on the fixed-lane device path at
        all (exact DISTINCT or a collecting kind); the device executors
        raise on it and the planner routes it to MaterializedAggExecutor."""
        return ((self.distinct and self.kind != "approx_count_distinct")
                or self.kind in self.MATERIALIZED_KINDS)

    @property
    def is_string_minmax(self) -> bool:
        """MIN/MAX over VARCHAR: the lane stores the dictionary id; reduces
        compare ``rank << 32 | id`` with the rank table of the update."""
        return (self.kind in ("min", "max") and self.arg_type is not None
                and self.arg_type.is_string)

    @property
    def num_lanes(self) -> int:
        if self.kind == "approx_count_distinct":
            return self.HLL_M
        return 2 if self.kind == "avg" else 1

    def _integral_arg(self) -> bool:
        return self.arg_type is not None and self.arg_type.is_integral

    def _minmax_sentinel(self):
        """Identity of a min/max lane: int64 extrema for integral and
        VARCHAR args, ±inf for floats."""
        if self._integral_arg() or self.is_string_minmax:
            return _I64_MAX if self.kind == "min" else -_I64_MAX
        return float("inf") if self.kind == "min" else float("-inf")

    def init_lanes(self):
        """Initial per-lane values (python scalars, cast by the table)."""
        if self.kind in ("min", "max"):
            return [self._minmax_sentinel()]
        return [0.0] * self.num_lanes

    def state_dtypes(self) -> list[torch.dtype]:
        if self.kind == "count":
            return [torch.int64]
        if self.kind == "approx_count_distinct":
            return [torch.int64] * self.HLL_M
        if self.kind == "sum":
            return [torch.float64 if self.arg_type.is_float else torch.int64]
        if self.kind == "avg":
            return [torch.float64, torch.int64]
        return [torch.int64 if (self._integral_arg() or self.is_string_minmax)
                else torch.float64]

    def reduce_ops(self) -> list[str]:
        if self.kind in ("min", "max"):
            return [self.kind]
        if self.kind == "approx_count_distinct":
            return ["max"] * self.HLL_M
        return ["add"] * self.num_lanes

    def contributions(self, value, vmask, signs, str_ranks=None):
        """Per-row contribution tensors, one per lane ([N] each).
        ``str_ranks``: the dictionary's rank table, required iff
        ``is_string_minmax``."""
        s = signs
        if self.is_string_minmax:
            if str_ranks is None:
                raise ValueError("MIN/MAX over VARCHAR requires the "
                                 "dictionary rank table (str_ranks)")
            packed = (rank_of(str_ranks, value) << 32) | value.long()
            return [torch.where(vmask & (s > 0), packed,
                                torch.full_like(packed,
                                                self._minmax_sentinel()))]
        if self.kind == "count":
            if self.arg < 0:
                return [s.long()]
            return [torch.where(vmask, s, torch.zeros_like(s)).long()]
        if self.kind == "sum":
            v = torch.where(vmask, value, torch.zeros_like(value))
            return [(v * s).to(self.state_dtypes()[0])]
        if self.kind == "avg":
            v = torch.where(vmask, value, torch.zeros_like(value)).double()
            if self.arg_type is not None \
                    and self.arg_type.kind == TypeKind.DECIMAL:
                v = v / 10 ** self.arg_type.scale
            return [v * s, torch.where(vmask, s, torch.zeros_like(s)).long()]
        if self.kind == "approx_count_distinct":
            return self.hll_contributions(value, vmask & (s > 0))
        dt = self.state_dtypes()[0]
        sent = torch.full_like(value, self._minmax_sentinel(), dtype=dt)
        return [torch.where(vmask & (s > 0), value.to(dt), sent)]

    def hll_contributions(self, value: torch.Tensor,
                          contributing: torch.Tensor) -> list:
        """One [N] contribution per register: the row's rank at the
        register its hash picks, 0 elsewhere and on rows not
        contributing. A float is hashed as its float64 bits (no -0.0
        fold), every other kind as its int64 value."""
        if value.is_floating_point():
            vi = value.double().view(torch.int64)
        else:
            vi = value.long()
        h = _splitmix64(vi)
        reg = h & (self.HLL_M - 1)
        rho = torch.where(contributing, hll_rho(_shr(h, 4)), 0)
        return [torch.where(reg == j, rho, 0) for j in range(self.HLL_M)]

    def pack_lane(self, lane, str_ranks):
        """A stored VARCHAR min/max lane (ids) lifted into ``rank << 32 |
        id`` space for a reduce; the identity for every other call.
        Sentinels stay as they are."""
        if not self.is_string_minmax:
            return lane
        packed = (rank_of(str_ranks, lane) << 32) | lane
        return torch.where(lane == self._minmax_sentinel(), lane, packed)

    def unpack_lane(self, lane):
        """The id again after a reduce (drops the rank)."""
        if not self.is_string_minmax:
            return lane
        return torch.where(lane == self._minmax_sentinel(), lane,
                           lane & 0xFFFFFFFF)

    def output(self, lanes, count_nonzero):
        """Project state lanes ([G] tensors) to (data, mask) columns."""
        if self.kind == "count":
            return lanes[0], torch.ones_like(count_nonzero)
        if self.kind == "sum":
            return lanes[0], count_nonzero
        if self.kind == "avg":
            cnt = lanes[1]
            safe = torch.where(cnt == 0, torch.ones_like(cnt), cnt)
            return lanes[0] / safe, cnt != 0
        if self.kind == "approx_count_distinct":
            return hll_estimate(lanes), torch.ones_like(count_nonzero)
        if self._integral_arg() or self.is_string_minmax:
            valid = lanes[0] != self._minmax_sentinel()
        else:
            valid = torch.isfinite(lanes[0])
        out = torch.where(valid, lanes[0], torch.zeros_like(lanes[0]))
        return out.to(self.output_type.dtype), valid


def hll_estimate(lanes) -> torch.Tensor:
    """The HLL estimate of each group from its 16 register lanes:
    ``0.673 m**2 / sum(2**-r)``, or ``m ln(m / zeros)`` when that is at
    most ``2.5 m`` and a register is 0, rounded half to even. The 16 terms
    are summed in lane order; each is a power of two, so the sum is exact
    while a group's registers span fewer than 53 bits."""
    m = float(len(lanes))
    s = torch.zeros_like(lanes[0], dtype=torch.float64)
    zeros = torch.zeros_like(lanes[0])
    for r in lanes:
        s = s + torch.pow(2.0, -r.double())
        zeros = zeros + (r == 0).long()
    raw = 0.673 * m * m / s
    small = m * torch.log(m / torch.clamp_min(zeros, 1).double())
    est = torch.where((raw <= 2.5 * m) & (zeros > 0), small, raw)
    # past 2**63 (every register near 61) the reference's conversion
    # saturates
    return saturate(torch.round(est), torch.int64)


def count_star() -> AggCall:
    return AggCall("count", -1)


def agg(kind: str, arg: int, arg_type: DataType,
        distinct: bool = False) -> AggCall:
    return AggCall(kind, arg, arg_type, distinct)
