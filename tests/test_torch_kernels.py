"""Kernel B1 (same-key rank/total counts) in the PyTorch port against the
JAX package: the plain PyTorch version equals the Pallas kernel in interpret
mode and its jnp formulation, exactly, on the cases of
tests/test_pallas_kernels.py plus ragged N; the wrapper's checks. The CUDA
kernel itself is compared with the plain version in tests/test_torch_gpu.py
and chip_smoke.py, on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from risingwave_tpu.ops.pallas_rank import (
    rank_totals_jnp, rank_totals_pallas,
)
from risingwave_tpu_torch.ops import rank_totals as rt_mod
from risingwave_tpu_torch.ops.rank_totals import (
    rank_totals, rank_totals_plain,
)


def _inputs(n, w, seed):
    rng = np.random.default_rng(seed)
    # idents cluster heavily (hot keys) and include -1 (no-match rows)
    ident = rng.integers(-1, 12, size=n).astype(np.int32)
    matches = rng.random((n, w)) < 0.3
    return ident, matches


@pytest.mark.parametrize("n,w,seed", [(256, 8, 0), (512, 128, 1),
                                      (1024, 16, 2), (300, 4, 3),
                                      (100, 4, 4)])
def test_plain_equals_pallas_and_jnp(n, w, seed):
    ident, matches = _inputs(n, w, seed)
    r_j, t_j = rank_totals_jnp(jnp.asarray(ident), jnp.asarray(matches))
    r_p, t_p = rank_totals_pallas(jnp.asarray(ident), jnp.asarray(matches),
                                  interpret=True)
    r, t = rank_totals_plain(torch.as_tensor(ident), torch.as_tensor(matches))
    for ref in (r_j, r_p):
        np.testing.assert_array_equal(np.asarray(ref), r.numpy())
    for ref in (t_j, t_p):
        np.testing.assert_array_equal(np.asarray(ref), t.numpy())
    assert r.dtype == torch.int32 and t.dtype == torch.int32


def test_semantics_small():
    """Hand-checked: rows 0,2 share key 7; row 3 (-1) matches nothing."""
    ident = torch.tensor([7, 1, 7, -1], dtype=torch.int32)
    matches = torch.ones((4, 1), dtype=torch.bool)
    r, t = rank_totals(ident, matches)
    assert r[:, 0].tolist() == [0, 0, 1, 0]
    assert t[:, 0].tolist() == [2, 1, 2, 0]


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    ident, matches = _inputs(64, 8, 5)
    ident, matches = torch.as_tensor(ident), torch.as_tensor(matches)
    before = rt_mod.rank_totals.launches
    r, t = rank_totals(ident, matches)
    r0, t0 = rank_totals_plain(ident, matches)
    assert torch.equal(r, r0) and torch.equal(t, t0)
    assert rt_mod.rank_totals.launches == before
    # uint8 matches give the same counts as bool
    r8, t8 = rank_totals(ident, matches.to(torch.uint8))
    assert torch.equal(r8, r0) and torch.equal(t8, t0)


@pytest.mark.parametrize("bad", ["ident_dtype", "matches_dtype", "shape",
                                 "rank", "contiguous"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    ident = torch.zeros(8, dtype=torch.int32)
    matches = torch.zeros((8, 4), dtype=torch.bool)
    if bad == "ident_dtype":
        ident = ident.long()
    elif bad == "matches_dtype":
        matches = matches.float()
    elif bad == "shape":
        matches = torch.zeros((7, 4), dtype=torch.bool)
    elif bad == "rank":
        ident = torch.zeros((8, 1), dtype=torch.int32)
    else:
        matches = torch.zeros((4, 8), dtype=torch.bool).t()
    with pytest.raises((TypeError, ValueError)):
        rank_totals(ident, matches)


# -- the CUDA kernel's decomposition, mirrored in torch ----------------------

def _first_row_ids(ident: torch.Tensor) -> torch.Tensor:
    """Dense group ids as the kernel gives them to a chunk whose keys are
    not grouped: keys numbered in the order of their first rows; a row with
    ident < 0 takes the newest id so far (it joins that group and counts as
    zero)."""
    n = ident.shape[0]
    rows = torch.arange(n)
    keyed = ident >= 0
    head = torch.zeros(n, dtype=torch.bool)
    if keyed.any():
        uniq, inv = torch.unique(ident[keyed], return_inverse=True)
        first = torch.full((len(uniq),), n).scatter_reduce(
            0, inv, rows[keyed], "amin")
        head[first] = True
    newest = (torch.cumsum(head.long(), 0) - 1).clamp(min=0)
    ids = newest.clone()
    if keyed.any():
        ids[keyed] = newest[first][inv]
    return ids


def _run_start_ids(ident: torch.Tensor) -> torch.Tensor:
    """The kernel's first try: if every key's rows are adjacent (rows with
    ident < 0 aside), a row's id is the row where its run starts, a row
    before the first run its own row; otherwise the first-row ids."""
    keyed = torch.nonzero(ident >= 0).flatten()
    k = ident[keyed]
    starts = keyed[torch.cat([torch.ones(min(1, len(k)), dtype=torch.bool),
                              k[1:] != k[:-1]])]
    if len(set(ident[starts].tolist())) < len(starts):
        return _first_row_ids(ident)      # a key's rows are split: not grouped
    ids = torch.arange(ident.shape[0])
    for a, b in zip(starts.tolist(), starts[1:].tolist() + [len(ids)]):
        ids[a:b] = a
    return ids


def _raw_key_ids(ident: torch.Tensor) -> torch.Tensor:
    """Sort keys as the kernel gives them to a chunk too large to sort in
    shared memory: the key, and one key above every key for ident < 0."""
    above = int(ident.max().clamp(min=-1)) + 1
    return torch.where(ident >= 0, ident.long(), above)


def _kernel_mirror(ident, matches, tile: int, rows_per_warp: int, ids):
    """Kernel B1's steps: a stable sort of the rows by group id; tiles of
    `tile` sorted rows with their sums A, P (first segment) and S (last
    segment); per tile, the carries from other tiles (S of the tile where
    the first segment starts plus A of the tiles between; A of the tiles
    between plus P where the last segment ends); a segmented scan in
    warps of `rows_per_warp` rows with carries between warps; r and t
    written back through the permutation, zeros for ident < 0."""
    n, w = matches.shape
    order = torch.sort(ids, stable=True).indices
    d = ids[order]
    v = (matches[order].long() * (ident[order] >= 0)[:, None])
    head = torch.ones(n, dtype=torch.bool)
    head[1:] = d[1:] != d[:-1]
    seg = torch.cumsum(head.long(), 0) - 1
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:] - 1, torch.tensor([n - 1])])
    nt = (n + tile - 1) // tile
    A = torch.zeros(nt, w, dtype=torch.long)
    P, S = A.clone(), A.clone()
    span = []
    for k in range(nt):
        lo, hi = k * tile, min(n, (k + 1) * tile)
        hs = torch.nonzero(head[lo:hi]).flatten().tolist()
        hf = next((h for h in hs if h >= 1), hi - lo)
        hl = hs[-1] if hs else 0
        A[k] = v[lo:hi].sum(0)
        P[k] = v[lo:lo + hf].sum(0)
        S[k] = v[lo + hl:hi].sum(0)
        span.append((int(starts[seg[lo]]) // tile,
                     int(ends[seg[hi - 1]]) // tile))
    r_s = torch.zeros(n, w, dtype=torch.long)
    t_s = torch.zeros(n, w, dtype=torch.long)
    for k in range(nt):
        f, l = span[k]
        cin = S[f] + A[f + 1:k].sum(0) if f < k else torch.zeros(w).long()
        cout = A[k + 1:l].sum(0) + P[l] if l > k else torch.zeros(w).long()
        lo = k * tile
        warps = []
        for q in range(0, tile, rows_per_warp):
            ps = [p for p in range(lo + q, lo + q + rows_per_warp)]
            hs = [p >= n or bool(head[p]) for p in ps]
            vs = [v[p] if p < n else torch.zeros(w).long() for p in ps]
            warps.append((ps, hs, vs))
        for x, (ps, hs, vs) in enumerate(warps):
            ci = torch.zeros(w).long()
            for ps2, hs2, vs2 in reversed(warps[:x]):
                run = torch.zeros(w).long()
                for hh, vv in zip(hs2, vs2):
                    run = vv.clone() if hh else run + vv
                ci = ci + run
                if any(hs2):
                    break
            else:
                ci = ci + cin
            co = torch.zeros(w).long()
            for ps2, hs2, vs2 in warps[x + 1:]:
                for hh, vv in zip(hs2, vs2):
                    if hh:
                        break
                    co = co + vv
                if any(hs2):
                    break
            else:
                co = co + cout
            incl, run, after = [], torch.zeros(w).long(), False
            for hh, vv in zip(hs, vs):
                run = vv.clone() if hh else run + vv
                after = after or hh
                incl.append(run + (0 if after else ci))
            tot = None
            for j in range(len(ps) - 1, -1, -1):
                if j == len(ps) - 1:
                    tot = incl[j] + co
                elif hs[j + 1]:
                    tot = incl[j]
                if ps[j] < n:
                    r_s[ps[j]] = incl[j] - vs[j]
                    t_s[ps[j]] = tot
    neg = ident[order] < 0
    r_s[neg] = 0
    t_s[neg] = 0
    r = torch.empty_like(r_s)
    t = torch.empty_like(t_s)
    r[order] = r_s
    t[order] = t_s
    return r.to(torch.int32), t.to(torch.int32)


def _pattern(name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "one_key":           # one segment over every tile
        return np.full(n, 7, np.int32)
    if name == "interleaved":       # 64 keys in turn: one sort pass
        return (np.arange(n) % 64).astype(np.int32)
    if name == "runs":              # runs 24, 23, ..., 1 long; some -1
        lens = np.tile(np.arange(24, 0, -1), n // 300 + 1)
        ident = np.repeat(np.arange(len(lens)), lens)[:n].astype(np.int32)
        ident[::13] = -1
        return ident
    if name == "negative":
        return np.full(n, -1, np.int32)
    if name == "clustered":         # ~50 rows a key, 10% -1
        ident = (np.arange(n) // 50).astype(np.int32)
        ident[rng.random(n) < 0.1] = -1
        return ident
    return rng.integers(-1, 5, n).astype(np.int32)


@pytest.mark.parametrize("sort_key", ["run_start", "first_row", "raw_key"])
@pytest.mark.parametrize("name,n,w,tile,rows_per_warp", [
    ("one_key", 256, 8, 8, 2), ("interleaved", 512, 16, 32, 4),
    ("runs", 300, 5, 8, 2), ("negative", 256, 4, 8, 4),
    ("random", 1, 1, 32, 4), ("runs", 4097, 3, 32, 4),
    ("one_key", 1000, 1, 16, 4), ("interleaved", 700, 129, 32, 4),
    ("clustered", 1024, 128, 32, 4)])
def test_kernel_decomposition_equals_reference(sort_key, name, n, w, tile,
                                               rows_per_warp):
    """The sort + segmented-scan decomposition of kernel B1, with tiles
    small enough that segments cross three or more of them, equals the
    JAX package's jnp formulation (and its Pallas kernel in interpret mode
    where N is a multiple of 256), as does the plain version."""
    ident = _pattern(name, n, n + w)
    matches = np.random.default_rng(n * w).random((n, w)) < 0.4
    it, mt = torch.as_tensor(ident), torch.as_tensor(matches)
    ids = {"run_start": _run_start_ids, "first_row": _first_row_ids,
           "raw_key": _raw_key_ids}[sort_key](it)
    r, t = _kernel_mirror(it, mt, tile, rows_per_warp, ids)
    r_plain, t_plain = rank_totals_plain(it, mt)
    refs = [rank_totals_jnp(jnp.asarray(ident), jnp.asarray(matches))]
    if n % 256 == 0:
        refs.append(rank_totals_pallas(jnp.asarray(ident),
                                       jnp.asarray(matches), interpret=True))
    for r_ref, t_ref in refs:
        for got in (r, r_plain):
            np.testing.assert_array_equal(got.numpy(), np.asarray(r_ref))
        for got in (t, t_plain):
            np.testing.assert_array_equal(got.numpy(), np.asarray(t_ref))
