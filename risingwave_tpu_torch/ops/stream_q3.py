"""TPC-H q3 streaming-MV core — join, agg and top-n as device steps.

Counterpart of ``risingwave_tpu/ops/stream_q3.py``. The MV is

    SELECT l_orderkey, SUM(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM orders JOIN lineitem ON l_orderkey = o_orderkey
    WHERE o_mktsegment = 'BUILDING' AND o_orderdate < :date
      AND l_shipdate > :date
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, l_orderkey LIMIT 10

Per chunk: qualifying ORDER rows (segment and date filter applied at
insert) land in a hash table keyed by o_orderkey with o_orderdate and
o_shippriority lanes (kernel B3's find-or-insert on the card); qualifying
LINEITEM rows then probe that table (B3's find) and the matches fold into an
``AggCore``: SUM(revenue) and MAX lanes that carry the order's attributes.
The barrier flush recomputes the top-``limit`` from the agg lanes (two
stable sorts) and emits the churn against what was emitted before: DELETE
the rows that left, INSERT the rows that arrived, identical rows suppressed.

Money is integral: prices in cents, discounts in basis points,
``revenue = price * (10000 - disc) // 10000`` in int64. The state is updated
in place and nothing is read back to the host; o_orderkey is the orders'
primary key, so the order rows of one chunk write distinct slots
(``hash_table.set_rows``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..common.chunk import (
    OP_DELETE, OP_INSERT, OP_UPDATE_INSERT, Column, StreamChunk,
)
from ..common.types import INT64, Field, Schema
from ..expr.agg import AggCall
from .grouped_agg import AggCore, AggState
from .hash_table import (
    DeviceHashTable, ht_lookup, ht_lookup_or_insert, ht_new, set_rows,
)

_BIG = torch.iinfo(torch.int64).max

#: the state's fields besides the orders table and the agg
FIELDS = ("odate", "prio", "emitted_key", "emitted_rev", "emitted_odate",
          "emitted_prio", "emitted_valid", "orders_overflow", "saw_delete")


@dataclasses.dataclass
class Q3State:
    orders: DeviceHashTable     # keyed by o_orderkey (qualifying only)
    odate: torch.Tensor         # int64[cap]: o_orderdate lane
    prio: torch.Tensor          # int64[cap]: o_shippriority lane
    agg: AggState               # revenue SUM + odate/prio MAX lanes
    emitted_key: torch.Tensor   # int64[K]: top-n rows downstream has seen
    emitted_rev: torch.Tensor   # int64[K]
    emitted_odate: torch.Tensor  # int64[K]
    emitted_prio: torch.Tensor  # int64[K]
    emitted_valid: torch.Tensor  # bool[K]
    orders_overflow: torch.Tensor  # bool scalar, sticky
    saw_delete: torch.Tensor    # bool scalar, sticky


class Q3Core:
    """Static config and the steps of the q3 streaming MV.

    Input chunks use ``connector/tpch.Q3_EVENT_SCHEMA`` (the column indices
    are parameters): kind (0 = order, 1 = lineitem), orderkey, o_orderdate,
    o_shippriority, o_mktsegment, l_extendedprice (cents), l_discount_bp,
    l_shipdate. Output schema: (l_orderkey, revenue_cents, o_orderdate,
    o_shippriority), emitted as top-``limit`` churn."""

    def __init__(self, cutoff_days: int, mktsegment: int = 0,
                 orders_capacity: int = 1 << 16,
                 agg_capacity: int = 1 << 16, limit: int = 10,
                 kind_col: int = 0, okey_col: int = 1, odate_col: int = 2,
                 prio_col: int = 3, mkt_col: int = 4, price_col: int = 5,
                 disc_col: int = 6, ship_col: int = 7,
                 device=DEFAULT_DEVICE):
        self.cutoff_days = int(cutoff_days)
        self.mktsegment = int(mktsegment)
        self.orders_capacity = int(orders_capacity)
        self.limit = int(limit)
        self.kind_col, self.okey_col = kind_col, okey_col
        self.odate_col, self.prio_col = odate_col, prio_col
        self.mkt_col, self.price_col = mkt_col, price_col
        self.disc_col, self.ship_col = disc_col, ship_col
        self.device = torch.device(device)
        # the order attributes are constant per group, so MAX carries them
        self.agg = AggCore(
            key_types=(INT64,), group_keys=(0,),
            agg_calls=(AggCall("sum", 1, INT64), AggCall("max", 2, INT64),
                       AggCall("max", 3, INT64)),
            table_capacity=agg_capacity, out_capacity=2 * limit,
            device=device)
        self.out_schema = Schema((
            Field("l_orderkey", INT64), Field("revenue_cents", INT64),
            Field("o_orderdate", INT64), Field("o_shippriority", INT64),
        ))

    # -- state ----------------------------------------------------------------

    def init_state(self) -> Q3State:
        cap, k, dev = self.orders_capacity, self.limit, self.device

        def zeros(n, dtype=torch.int64):
            return torch.zeros(n, dtype=dtype, device=dev)

        return Q3State(
            orders=ht_new((INT64,), cap, dev),
            odate=zeros(cap), prio=zeros(cap),
            agg=self.agg.init_state(),
            emitted_key=zeros(k), emitted_rev=zeros(k),
            emitted_odate=zeros(k), emitted_prio=zeros(k),
            emitted_valid=zeros(k, torch.bool),
            orders_overflow=zeros((), torch.bool),
            saw_delete=zeros((), torch.bool))

    # -- chunk step ------------------------------------------------------------

    def apply_chunk(self, state: Q3State, chunk: StreamChunk) -> Q3State:
        """Insert the chunk's qualifying orders, then probe its qualifying
        lineitems and fold the matches into the revenue agg (in place)."""
        cap = self.orders_capacity
        cols = chunk.columns
        is_ins = (chunk.ops == OP_INSERT) | (chunk.ops == OP_UPDATE_INSERT)
        state.saw_delete |= (chunk.vis & ~is_ins).any()
        valid = chunk.vis & is_ins

        def lane(i):
            return cols[i].data.to(torch.int64)

        kind, odate, prio, mkt = (lane(self.kind_col), lane(self.odate_col),
                                  lane(self.prio_col), lane(self.mkt_col))
        price, disc, ship = (lane(self.price_col), lane(self.disc_col),
                             lane(self.ship_col))
        okey = Column(lane(self.okey_col), cols[self.okey_col].mask)

        # orders: the filter applies at insert
        qual = (valid & (kind == 0) & okey.mask
                & (odate < self.cutoff_days) & (mkt == self.mktsegment))
        _, slots, _, ovf = ht_lookup_or_insert(state.orders, [okey], qual)
        keep = qual & (slots < cap)
        set_rows(state.odate, slots, keep, odate)
        set_rows(state.prio, slots, keep, prio)

        # lineitems: shipdate filter, then probe the just-updated orders; a
        # miss means the order was filtered out
        is_li = valid & (kind == 1) & okey.mask & (ship > self.cutoff_days)
        pslots, found = ht_lookup(state.orders, [okey], is_li)
        match = is_li & found
        safe = pslots.clamp(0, cap - 1)
        revenue = torch.div(price * (10000 - disc), 10000,
                            rounding_mode="floor")
        joined = StreamChunk(
            torch.zeros_like(chunk.ops), match,
            (Column(okey.data, match), Column(revenue, match),
             Column(state.odate[safe], match),
             Column(state.prio[safe], match)))
        self.agg.apply_chunk(state.agg, joined)
        state.orders_overflow |= ovf
        return state

    # -- barrier flush ---------------------------------------------------------

    def flush_candidates(self, state: Q3State):
        """``(okey, rev, odate, prio, live)`` over every agg slot: the
        candidates of the top-``limit`` recompute."""
        lanes = state.agg.lanes
        ofs = self.agg.call_lane_ofs
        okey = state.agg.table.key_data[0].to(torch.int64)
        return (okey, lanes[ofs[0]], lanes[ofs[1]], lanes[ofs[2]],
                lanes[0] > 0)

    @staticmethod
    def topk_perm(okey, rev, valid, limit: int):
        """Indices of the top-``limit`` candidates by (revenue DESC,
        orderkey ASC): two stable sorts; orderkeys are distinct, so the
        order is total."""
        big = torch.full_like(okey, _BIG)
        o1 = torch.sort(torch.where(valid, okey, big), stable=True).indices
        o2 = torch.sort(torch.where(valid, -rev, big)[o1],
                        stable=True).indices
        return o1[o2][:limit]

    def flush(self, state: Q3State):
        """Recompute the top-``limit`` and emit the churn against the rows
        emitted before. Returns ``(state, out_chunk, packed)``: the chunk
        holds 2·limit rows, deletes then inserts; ``packed`` = int64[4]:
        [n_out, orders_overflow, agg_overflow, saw_delete]."""
        return self.flush_from_candidates(state,
                                          *self.flush_candidates(state))

    def flush_from_candidates(self, state: Q3State, okey, rev, odate, prio,
                              valid):
        """The top-``limit`` churn over a candidate set (the flush passes
        every agg slot)."""
        k = self.limit
        perm = self.topk_perm(okey, rev, valid, k)
        new_valid = valid[perm]
        new = (okey[perm], rev[perm], odate[perm], prio[perm])
        old = (state.emitted_key, state.emitted_rev, state.emitted_odate,
               state.emitted_prio)
        same = state.emitted_valid[:, None] & new_valid[None, :]
        for o, n in zip(old, new):
            same = same & (o[:, None] == n[None, :])
        del_m = state.emitted_valid & ~same.any(dim=1)
        ins_m = new_valid & ~same.any(dim=0)
        dev = okey.device
        ops = torch.cat([torch.full((k,), OP_DELETE, dtype=torch.int8,
                                    device=dev),
                         torch.full((k,), OP_INSERT, dtype=torch.int8,
                                    device=dev)])
        vis = torch.cat([del_m, ins_m])
        out = StreamChunk(ops, vis, tuple(
            Column(torch.cat([o, n]), vis) for o, n in zip(old, new)))
        packed = torch.stack([
            del_m.sum() + ins_m.sum(), state.orders_overflow.long(),
            state.agg.overflow.long(), state.saw_delete.long()])
        (state.emitted_key, state.emitted_rev, state.emitted_odate,
         state.emitted_prio) = new
        state.emitted_valid = new_valid
        return state, out, packed

    # -- checkpoint / recovery -------------------------------------------------

    def export_host(self, state: Q3State) -> dict:
        """State → named numpy arrays (the reference's payload layout, the
        agg as a mapping of its fields), which round-trip exactly through
        ``import_host``."""
        def host(a):
            return a.cpu().numpy()

        out = {f: host(getattr(state, f)) for f in FIELDS}
        out["orders_key_data"] = [host(a) for a in state.orders.key_data]
        out["orders_key_mask"] = [host(a) for a in state.orders.key_mask]
        out["orders_occupied"] = host(state.orders.occupied)
        agg = state.agg
        out["agg"] = {
            "table": {"key_data": [host(a) for a in agg.table.key_data],
                      "key_mask": [host(a) for a in agg.table.key_mask],
                      "occupied": host(agg.table.occupied)},
            "lanes": [host(a) for a in agg.lanes],
            "prev_lanes": [host(a) for a in agg.prev_lanes],
            "dirty": host(agg.dirty), "ckpt_dirty": host(agg.ckpt_dirty),
            "overflow": host(agg.overflow),
            "last_used": host(agg.last_used)}
        return out

    def import_host(self, payload) -> Q3State:
        """Recovery from a payload of this package's or the reference's
        ``export_host``, or from the reference's state with numpy leaves."""
        return state_from_host(payload, self.device)


def state_from_host(payload, device) -> Q3State:
    """A fresh state on ``device`` from host arrays: an ``export_host``
    payload (``orders_*`` entries, ``agg`` with the agg's fields) or an
    object with the state's attributes, the agg's checkpoint and LRU marks
    included."""
    def get(obj, name):
        return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    def table(obj):
        return DeviceHashTable(tuple(t(a) for a in get(obj, "key_data")),
                               tuple(t(a) for a in get(obj, "key_mask")),
                               t(get(obj, "occupied")))

    if isinstance(payload, Mapping):
        orders = DeviceHashTable(
            tuple(t(a) for a in payload["orders_key_data"]),
            tuple(t(a) for a in payload["orders_key_mask"]),
            t(payload["orders_occupied"]))
    else:
        orders = table(payload.orders)
    agg = get(payload, "agg")
    return Q3State(
        orders=orders,
        agg=AggState(table=table(get(agg, "table")),
                     lanes=[t(a) for a in get(agg, "lanes")],
                     prev_lanes=[t(a) for a in get(agg, "prev_lanes")],
                     dirty=t(get(agg, "dirty")),
                     ckpt_dirty=t(get(agg, "ckpt_dirty")),
                     overflow=t(get(agg, "overflow")),
                     last_used=t(get(agg, "last_used"))),
        **{f: t(get(payload, f)) for f in FIELDS})
