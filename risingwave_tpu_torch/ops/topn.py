"""TopN ranking over a device row set: full-sort membership computation.

Counterpart of ``risingwave_tpu/ops/topn.py``. The rank window is recomputed
wholesale at a flush: one lexicographic stable sort of all slots (a stable
``argsort`` per key, last key first), then a per-group rank and a
membership mask — correct under any insert/delete churn because membership
is derived from the whole row set every flush. The plain TopN's fast path
sorts only a candidate subset, with a threshold that says when the
candidates can no longer be trusted.

``OrderSpec``: (column index, desc, nulls_last) per sort key. VARCHAR
columns sort by the dictionary's lexicographic rank table, never by raw id.
Nothing here reads back to the host: compactions are prefix counts and
``searchsorted`` gathers, and scatters go through ``set_rows``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..common.chunk import Column
from ..common.types import rank_of
from .hash_table import set_rows
from .row_set import RowSetState

_I64 = torch.iinfo(torch.int64)


@dataclasses.dataclass(frozen=True)
class OrderSpec:
    col: int
    desc: bool = False
    nulls_last: bool = True
    # VARCHAR: the key is the id's rank in ``str_ranks``; executors set this
    # from the column's logical type
    is_string: bool = False


def _sentinels(dtype: torch.dtype):
    """(big, small) of an ascending sort key of ``dtype``."""
    if dtype == torch.int64:
        return _I64.max, _I64.min
    return float("inf"), float("-inf")


def _sort_key(c: Column, spec: OrderSpec,
              str_ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Column → ascending-sortable float64/int64 key honouring desc and the
    nulls' place. int64 keys stay int64 (exact); everything else lowers to
    float64 (int32 and bool fit exactly). NaN sorts last, as in the
    reference, and stays NaN under desc."""
    d = c.data
    if spec.is_string:
        if str_ranks is None:
            raise ValueError("ordering on a VARCHAR column requires the "
                             "dictionary rank table (str_ranks)")
        d = rank_of(str_ranks, d)
    k = d if d.dtype == torch.int64 else d.double()
    big, small = _sentinels(k.dtype)
    if spec.desc:
        k = -k
    # after the desc negation the key ascends: nulls last => big
    return torch.where(c.mask, k, big if spec.nulls_last else small)


def key0_dtype(state: RowSetState, spec: OrderSpec) -> torch.dtype:
    """Dtype of the leading sort key (the threshold scalar's storage)."""
    if spec.is_string or state.cols[spec.col].data.dtype == torch.int64:
        return torch.int64
    return torch.float64


def _sorted_perm(perm: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    return perm[torch.argsort(key[perm], stable=True)]


def _unpermute(perm: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[perm] = values`` (``perm`` a permutation)."""
    return torch.zeros_like(values).scatter_(0, perm, values)


def _live_gid(state: RowSetState, gid: torch.Tensor) -> torch.Tensor:
    """Group id per slot, dead slots routed past every group."""
    return torch.where(state.live, gid.long(), _I64.max)


def topn_order(state: RowSetState, gid: torch.Tensor,
               order: Sequence[OrderSpec],
               str_ranks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable lexicographic permutation: by gid (dead slots last), then the
    order keys, then slot index."""
    perm = torch.arange(state.capacity, device=state.live.device)
    for spec in reversed(list(order)):
        perm = _sorted_perm(perm,
                            _sort_key(state.cols[spec.col], spec, str_ranks))
    return _sorted_perm(perm, _live_gid(state, gid))


def _compact(flags: torch.Tensor, size: int) -> torch.Tensor:
    """int64[size]: the indices of the first ``size`` True entries of
    ``flags`` in order, then ``len(flags)`` (``jnp.nonzero(flags, size=,
    fill_value=len)``), as a prefix count and a ``searchsorted``."""
    rank = torch.cumsum(flags, 0)
    want = torch.arange(1, size + 1, device=flags.device)
    return torch.searchsorted(rank, want)


def topn_candidate_flush(
    state: RowSetState,
    order: Sequence[OrderSpec],
    offset: int,
    limit: int,
    cand: torch.Tensor,
    cand_cap: int,
    cand_keep: int,
    t1: torch.Tensor,
    str_ranks: Optional[torch.Tensor] = None,
):
    """Incremental plain-TopN flush: sort only the candidate slots,
    O(cand_cap log cand_cap) instead of a sort of the whole capacity.

    Rows dropped from the candidate set are remembered only through ``t1``,
    the best (ascending) leading key ever dropped. The result holds only
    while the window's worst leading key stays strictly below ``t1``.
    Returns ``(in_set, new_cand, new_t1, bad)``; ``bad`` (overflow,
    underflow or threshold breach) means the caller must run the full-sort
    refill instead."""
    cap = state.capacity
    spec0 = order[0]
    big0, small0 = _sentinels(key0_dtype(state, spec0))

    cidx = _compact(cand, cand_cap)
    valid = cidx < cap
    safe = cidx.clamp_max(cap - 1)
    live_m = valid & state.live[safe]

    perm = torch.arange(cand_cap, device=cidx.device)
    for spec in reversed(list(order)):
        keyf = _sort_key(state.cols[spec.col], spec, str_ranks)
        big, _ = _sentinels(keyf.dtype)
        perm = _sorted_perm(perm, torch.where(valid, keyf[safe], big))
    # dead and filler last (stable: key order kept among the live)
    perm = _sorted_perm(perm, ~live_m)

    rank = torch.arange(cand_cap, device=cidx.device)
    live_sorted = live_m[perm]
    in_win_sorted = live_sorted & (rank >= offset) & (rank < offset + limit)
    keep_sorted = live_sorted & (rank < cand_keep)

    n_cand = cand.sum()
    n_live_cand = live_m.sum()
    n_live = state.live.sum()
    overflow = n_cand > cand_cap
    underflow = (n_live_cand < offset + limit) & (n_live > n_live_cand)

    key0_full = _sort_key(state.cols[spec0.col], spec0,
                          str_ranks).to(key0_dtype(state, spec0))
    key0_sorted = torch.where(valid, key0_full[safe], big0)[perm]
    nwin = torch.clamp_max(n_live_cand, offset + limit)
    worst_win = torch.where(
        nwin > 0, key0_sorted[(nwin - 1).clamp(0, cand_cap - 1)], small0)
    stale = worst_win >= t1
    drop_exists = n_live_cand > cand_keep
    drop_key = key0_sorted[min(cand_keep, cand_cap - 1)]
    new_t1 = torch.where(drop_exists, torch.minimum(t1, drop_key), t1)
    bad = overflow | underflow | stale

    in_set = torch.zeros(cap, dtype=torch.bool, device=cidx.device)
    set_rows(in_set, cidx, valid, _unpermute(perm, in_win_sorted))
    new_cand = torch.zeros_like(in_set)
    set_rows(new_cand, cidx, valid, _unpermute(perm, keep_sorted))
    return in_set, new_cand, new_t1, bad


def topn_refill(
    state: RowSetState,
    gid: torch.Tensor,
    order: Sequence[OrderSpec],
    offset: int,
    limit: int,
    cand_keep: int,
    str_ranks: Optional[torch.Tensor] = None,
):
    """Full-sort recompute and candidate reseed: one permutation gives the
    rank window, the new candidate set (the top ``cand_keep``) and the
    forget threshold (the leading key of the first dropped row)."""
    cap = state.capacity
    spec0 = order[0]
    big0, _ = _sentinels(key0_dtype(state, spec0))
    perm = topn_order(state, gid, order, str_ranks)
    live_sorted = state.live[perm]
    rank = torch.arange(cap, device=perm.device)
    in_win_sorted = live_sorted & (rank >= offset) & (rank < offset + limit)
    keep_sorted = live_sorted & (rank < cand_keep)
    key0 = _sort_key(state.cols[spec0.col], spec0,
                     str_ranks).to(key0_dtype(state, spec0))[perm]
    n_live = state.live.sum()
    t1 = torch.where(n_live > cand_keep, key0[min(cand_keep, cap - 1)], big0)
    return (_unpermute(perm, in_win_sorted), _unpermute(perm, keep_sorted),
            t1)


def topn_in_set(
    state: RowSetState,
    gid: torch.Tensor,
    order: Sequence[OrderSpec],
    offset: int,
    limit: int,
    with_ties: bool = False,
    n_tie_keys: Optional[int] = None,
    str_ranks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """bool[cap]: the slot is in its group's [offset, offset+limit) rank
    window (plus, with ``with_ties``, the rows that tie the window's last
    row). ``n_tie_keys``: how many leading order keys define a tie (the pk
    tiebreak keys appended by the executor take no part)."""
    cap = state.capacity
    perm = topn_order(state, gid, order, str_ranks)
    sgid = _live_gid(state, gid)[perm]
    pos = torch.arange(cap, device=perm.device)
    is_start = torch.ones_like(state.live)
    is_start[1:] = sgid[1:] != sgid[:-1]
    start = torch.cummax(torch.where(is_start, pos, 0), 0).values
    rank = pos - start
    slive = state.live[perm]
    in_win = slive & (rank >= offset) & (rank < offset + limit)
    if with_ties:
        # rows past the window tie in when every tie key equals that of the
        # window's last row (rank offset+limit-1) in the same group
        bpos = (start + offset + limit - 1).clamp(0, cap - 1)
        tie = slive & (rank >= offset + limit) & (sgid == sgid[bpos])
        n = len(order) if n_tie_keys is None else n_tie_keys
        for spec in list(order)[:n]:
            key = _sort_key(state.cols[spec.col], spec, str_ranks)[perm]
            tie &= key == key[bpos]
        in_win |= tie
    return _unpermute(perm, in_win)
