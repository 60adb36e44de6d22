"""TPC-H order/lineitem event stream generated on the device — the q3 source.

Counterpart of ``risingwave_tpu/connector/tpch.py``, column for column and
bit for bit. Events interleave one ORDER row followed by
``lineitems_per_order`` LINEITEM rows of that order, so an order always
precedes its lineitems (``ops/stream_q3.Q3Core`` relies on it). Every
attribute is counter-based splitmix64 hashing of the event or order id, so a
chunk is a function of its first event id alone; the ``key`` argument of
``chunk_fn`` is accepted and ignored, for the same call shape as the NEXmark
source.

Distributions (synthetic, tuned for selectivity): o_orderdate uniform in
[cutoff - 30, cutoff + 30) days, o_mktsegment uniform over ``n_segments``
(segment 0 = 'BUILDING'), l_shipdate = o_orderdate + [-10, 40) days, prices
in cents and discounts in basis points, int64 end to end. The hash works on
int64 bit patterns (``common/hashing._splitmix64``); its result is masked to
63 bits before any ``%`` or ``>>``, as the reference's is, so signed and
unsigned arithmetic agree.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import Column, StreamChunk, map_tensors
from ..common.hashing import _splitmix64
from ..common.types import INT64, Schema

#: unified order/lineitem event schema (kind 0 = order, 1 = lineitem;
#: order rows zero the l_* columns and lineitem rows the o_* columns)
Q3_EVENT_SCHEMA = Schema.of(
    ("kind", INT64), ("orderkey", INT64), ("o_orderdate", INT64),
    ("o_shippriority", INT64), ("o_mktsegment", INT64),
    ("l_extendedprice", INT64), ("l_discount_bp", INT64),
    ("l_shipdate", INT64),
)

#: 1995-03-15 as days since the unix epoch — the q3 date parameter
Q3_CUTOFF_DAYS = 9204

_LOW63 = 0x7FFFFFFFFFFFFFFF


@dataclasses.dataclass
class TpchQ3Config:
    chunk_capacity: int = 1024
    lineitems_per_order: int = 3
    cutoff_days: int = Q3_CUTOFF_DAYS
    n_segments: int = 5            # o_mktsegment in [0, n_segments)


class DeviceQ3Generator:
    """q3 event chunks on the device; ``chunk_fn()`` feeds a fused epoch
    (``ops/fused_epoch.fused_source_q3_epoch``)."""

    def __init__(self, config: TpchQ3Config = TpchQ3Config(),
                 device=DEFAULT_DEVICE):
        self.cfg = config
        self.device = torch.device(device)

    def _rows(self, starts: torch.Tensor) -> StreamChunk:
        """One chunk per first event id in ``starts`` (int64[m]): [m, cap]
        columns."""
        cfg = self.cfg
        cap = cfg.chunk_capacity
        eids = starts[:, None] + torch.arange(cap, dtype=torch.int64,
                                              device=starts.device)
        gsize = 1 + cfg.lineitems_per_order
        g = torch.div(eids, gsize, rounding_mode="floor")     # orderkey
        kind = (eids % gsize != 0).long()
        ho = _splitmix64(g) & _LOW63
        odate = cfg.cutoff_days - 30 + ho % 60
        mkt = (ho >> 8) % cfg.n_segments
        prio = (ho >> 16) % 3
        hl = _splitmix64(eids + 0x9E37) & _LOW63
        price = 100_00 + hl % 9_000_00                         # cents
        disc = (hl >> 20) % 1001                 # basis points, <= 10%
        ship = odate + (hl >> 40) % 50 - 10
        is_li = kind == 1
        full = torch.ones_like(is_li)

        def on(vals, keep):
            return Column(torch.where(keep, vals, 0), full)

        cols = (Column(kind, full), Column(g, full),
                on(odate, ~is_li), on(prio, ~is_li), on(mkt, ~is_li),
                on(price, is_li), on(disc, is_li), on(ship, is_li))
        return StreamChunk(torch.zeros_like(kind, dtype=torch.int8), full,
                           cols)

    def chunk_fn(self):
        """``(start_event_id, key) -> StreamChunk``: ONE chunk of
        ``chunk_capacity`` events, as the reference's ``chunk_fn``. It also
        takes a batch — ``start`` int64[k] (``key`` [k, 2] or None) — and
        then returns the k chunks as [k, chunk_capacity] columns; the fused
        epoch draws a whole epoch in that one call. ``key`` is ignored."""
        dev = self.device

        def fn(start, key=None):
            if isinstance(start, torch.Tensor) and start.dim() == 1:
                return self._rows(start.to(device=dev, dtype=torch.int64))
            one = torch.as_tensor(start, dtype=torch.int64,
                                  device=dev).reshape(1)
            return map_tensors(self._rows(one), lambda a: a[0])

        return fn
