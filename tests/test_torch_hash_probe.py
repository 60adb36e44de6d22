"""The decomposition kernel B3 (``csrc/hash_probe.cu``) rests on, on the CPU.

The kernel's find-or-insert runs in two phases. Phase 1 finds each row's
first match-or-empty slot (G consecutive slots per step) against the table
as it stands; an absent row, which meets an empty slot e after k occupied
ones, bids on e with (k, row) at once and flags a conflict when the bid it
meets is another key's. Phase 2 gives e to its smallest first bid, settles
the rows of that key there, and runs the reference's rounds only among the
rows that lost e to another key, each walking on from e + 1.
``_model_insert`` is that algorithm in numpy, its phase-1 bids in a seeded
order. It is held slot for slot (slots, is_new, overflow and the final
table) against ``risingwave_tpu.ops.hash_table.ht_lookup_or_insert`` (JAX
on the CPU) and against the port's ``ht_lookup_or_insert_plain``, for G in
{1, 4, 16}, on seeded tables at loads 0 to 0.9, with wrap-around at the end
of the table, repeated keys, NULL keys, invalid rows, an overflowing batch,
a late arrival and a slot that nine keys reach in different rounds. A
control shows that the arrival round matters: with every absent row given
round 0 the model gives another layout on the late-arrival case. Every case
has one capacity and one N, so JAX compiles the reference once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.common as J
import risingwave_tpu.ops as JO
import risingwave_tpu_torch.common as T
from risingwave_tpu_torch.ops.hash_table import (
    MAX_PROBE_ROUNDS, DeviceHashTable, ht_lookup_or_insert_plain,
)

CAP = 64          # one capacity and one N for every case: one JAX compile
N = 48
WINDOWS = (1, 4, 16)


def _homes(d0, m0, d1, m1):
    """Each row's home slot: ``hash_columns`` of its two INT64 keys."""
    cols = [T.Column(torch.as_tensor(d), torch.as_tensor(m))
            for d, m in ((d0, m0), (d1, m1))]
    return (T.hash_columns(cols) & (CAP - 1)).numpy()


def _equal(table, s, key):
    """GROUP-BY equality of the key stored at slot ``s`` and ``key``
    (((data, mask), ...) per column; NULL == NULL)."""
    kd, km, _ = table
    return all((km[c][s] and m and kd[c][s] == d) or (not km[c][s] and not m)
               for c, (d, m) in enumerate(key))


def _same(a, b):
    """GROUP-BY equality of two row keys (NULL == NULL)."""
    return all((ma and mb and da == db) or (not ma and not mb)
               for (da, ma), (db, mb) in zip(a, b))


def _prefill(keys):
    """A table built by inserting ``keys`` one at a time by linear probing
    (so every chain is one a find-or-insert would have made)."""
    kd = [np.zeros(CAP, np.int64), np.zeros(CAP, np.int64)]
    km = [np.zeros(CAP, bool), np.zeros(CAP, bool)]
    occ = np.zeros(CAP, bool)
    table = (kd, km, occ)
    flat = np.array([(d0, m0, d1, m1) for (d0, m0), (d1, m1) in keys],
                    np.int64).reshape(-1, 4)
    homes = _homes(flat[:, 0], flat[:, 1] != 0, flat[:, 2], flat[:, 3] != 0)
    for key, h in zip(keys, homes):
        s = int(h)
        while occ[s] and not _equal(table, s, key):
            s = (s + 1) & (CAP - 1)
        if not occ[s]:
            for c, (d, m) in enumerate(key):
                kd[c][s], km[c][s] = d, m
            occ[s] = True
    return table


def _model_insert(table, rows, valid, window, arrival=True, seed=0):
    """Kernel B3's find-or-insert in numpy: returns (table, slots, is_new,
    overflow, phase-2 rounds run). ``arrival=False`` gives every absent row
    arrival round 0 (the control). ``seed`` orders phase 1's bids, which
    run in parallel on the card."""
    kd, km, occ = (list(map(np.copy, table[0])), list(map(np.copy, table[1])),
                   table[2].copy())
    tab = (kd, km, occ)
    d0, m0, d1, m1 = rows
    keys = [((d0[i], m0[i]), (d1[i], m1[i])) for i in range(N)]
    homes = _homes(d0, m0, d1, m1)
    slots = np.full(N, CAP, np.int64)
    is_new = np.zeros(N, bool)
    overflow = False
    absent = []                       # (row, first empty slot e, round k)
    # phase 1: the first match-or-empty slot, G slots a step, 128 in all
    for i in range(N):
        if not valid[i]:
            continue
        hit = None
        for base in range(0, MAX_PROBE_ROUNDS, window):
            for k in range(base, min(base + window, MAX_PROBE_ROUNDS)):
                s = (int(homes[i]) + k) & (CAP - 1)
                if not occ[s] or _equal(tab, s, keys[i]):
                    hit = (k, s)
                    break
            if hit is not None:
                break
        if hit is None:
            overflow = True
        elif occ[hit[1]]:
            slots[i] = hit[1]
        else:
            absent.append((i, hit[1], hit[0] if arrival else 0))
    # ... and each absent row's bid on e, tagged with its arrival round, in
    # any order; a bidder whose key differs from the bid it replaces or
    # loses to marks a conflict
    word = {}                         # claim words: slot -> (round, row)
    conflict = False
    for n in np.random.default_rng(seed).permutation(len(absent)):
        i, e, k = absent[n]
        old = word.get(e)
        if old is not None and not _same(keys[old[1]], keys[i]):
            conflict = True
        word[e] = min(old, (k, i)) if old is not None else (k, i)

    def claim(s, row):
        for c, (d, m) in enumerate(keys[row]):
            kd[c][s], km[c][s] = d, m
        occ[s] = True
        slots[row] = s
        is_new[row] = True

    # phase 2: each e's smallest (round, row) bid takes it; a row of the
    # same key settles there; a row of another key walks on
    walking = []                      # [row, slot, round, bid?]
    for i, e, k in absent:
        t, h = word[e]
        if h == i:
            claim(e, i)
        elif not conflict or _same(keys[h], keys[i]):
            if k + 1 < MAX_PROBE_ROUNDS:
                slots[i] = e
            else:
                overflow = True
        elif t < k and k + 1 < MAX_PROBE_ROUNDS:
            walking.append([i, (e + 1) & (CAP - 1), k + 1, False])
        elif t == k and k + 2 < MAX_PROBE_ROUNDS:
            walking.append([i, (e + 1) & (CAP - 1), k + 2, False])
        else:
            overflow = True
    # ... then the reference's rounds among the walking rows only, rounds
    # in which none takes part skipped
    rounds = 0
    while walking:
        rnd = min(w[2] for w in walking)
        rounds += 1
        bids = {}
        for w in walking:
            i, s, r, bid = w
            if r != rnd:
                continue
            if bid:                   # the bid of round rnd - 1
                h = word[s][1]
                if h == i:
                    claim(s, i)
                    continue
                if rnd == MAX_PROBE_ROUNDS:   # the reference stops here
                    w[2], overflow = None, True
                    continue
                eq = _same(keys[h], keys[i])
            elif s in word:           # taken in an earlier round
                eq = _same(keys[word[s][1]], keys[i])
            elif occ[s]:              # as before the call
                eq = _equal(tab, s, keys[i])
            else:
                bids[s] = min(bids.get(s, N), i)
                w[2], w[3] = rnd + 1, True
                continue
            if eq:
                slots[i] = s
            elif rnd + 1 < MAX_PROBE_ROUNDS:
                w[1], w[2], w[3] = (s + 1) & (CAP - 1), rnd + 1, False
            else:
                w[2], overflow = None, True
        for s, i in bids.items():
            word[s] = (rnd, i)
        walking = [w for w in walking
                   if slots[w[0]] == CAP and w[2] is not None]
    return tab, slots, is_new, overflow, rounds


@functools.lru_cache(maxsize=None)
def _jax_insert():
    return jax.jit(JO.ht_lookup_or_insert)


def _jax_result(table, rows, valid):
    kd, km, occ = table
    jt = JO.ht_new([J.INT64, J.INT64], CAP).replace(
        occupied=jnp.asarray(occ),
        key_data=tuple(jnp.asarray(a) for a in kd),
        key_mask=tuple(jnp.asarray(a) for a in km))
    d0, m0, d1, m1 = rows
    cols = [J.Column(jnp.asarray(d0), jnp.asarray(m0)),
            J.Column(jnp.asarray(d1), jnp.asarray(m1))]
    jt, slots, is_new, over = _jax_insert()(jt, cols, jnp.asarray(valid))
    return (([np.asarray(a) for a in jt.key_data],
             [np.asarray(a) for a in jt.key_mask], np.asarray(jt.occupied)),
            np.asarray(slots).astype(np.int64), np.asarray(is_new),
            bool(over))


def _plain_result(table, rows, valid):
    kd, km, occ = table
    tt = DeviceHashTable(tuple(torch.as_tensor(a.copy()) for a in kd),
                         tuple(torch.as_tensor(a.copy()) for a in km),
                         torch.as_tensor(occ.copy()))
    d0, m0, d1, m1 = rows
    cols = [T.Column(torch.as_tensor(d0), torch.as_tensor(m0)),
            T.Column(torch.as_tensor(d1), torch.as_tensor(m1))]
    tt, slots, is_new, over = ht_lookup_or_insert_plain(
        tt, cols, torch.as_tensor(valid))
    return (([a.numpy() for a in tt.key_data],
             [a.numpy() for a in tt.key_mask], tt.occupied.numpy()),
            slots.numpy(), is_new.numpy(), bool(over))


def _keys_homed(want, start=0):
    """For each home slot in ``want``, a fresh (k, 0) key (both non-NULL)
    whose home is that slot, searching k upward from ``start``."""
    ks = np.arange(start, start + 20_000, dtype=np.int64)
    homes = _homes(ks, np.ones(len(ks), bool), np.zeros(len(ks), np.int64),
                   np.ones(len(ks), bool))
    out, used = [], set()
    for h in want:
        k = next(int(k) for k, hh in zip(ks, homes)
                 if hh == h and int(k) not in used)
        used.add(k)
        out.append(k)
    return out


def _case(name):
    """(table, rows, valid) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    ones = np.ones(N, bool)
    if name.startswith("load_"):
        load = float(name.split("_")[1])
        pool = rng.integers(0, 200, (int(load * CAP), 2))
        pre = [((int(a), True), (int(b), bool(b % 5))) for a, b in pool]
        table = _prefill(pre)
        # repeats of present and new keys, NULLs, invalid rows
        fresh = rng.integers(200, 260, (N, 2))
        pick = rng.random(N) < 0.5
        keys = np.where(pick[:, None], pool[rng.integers(0, len(pool), N)],
                        fresh) if len(pool) else fresh
        m0 = rng.random(N) < 0.9
        m1 = keys[:, 1] % 5 != 0
        rows = (keys[:, 0], m0, keys[:, 1], m1)
        return table, rows, rng.random(N) < 0.85
    if name == "wrap":
        # long occupied runs ending at the table's last slot, so chains
        # wrap to slot 0
        pre = [((k, True), (0, True))
               for k in _keys_homed(list(range(52, 64)) * 2, 1000)]
        table = _prefill(pre)
        new = _keys_homed([60, 61, 62, 63] * 3, 5000)
        d0 = np.array([new[i % len(new)] for i in range(N)], np.int64)
        return table, (d0, ones, np.zeros(N, np.int64), ones), ones
    if name == "overflow":
        # 4 free slots for 40 new keys: the rest pass 128 occupied slots
        pre = [((int(k), True), (1, True))
               for k in rng.choice(10_000, 60, replace=False)]
        table = _prefill(pre)
        d0 = 20_000 + rng.choice(1_000, N, replace=False)
        return table, (d0, ones, np.ones(N, np.int64), ones), ones
    if name == "late_arrival":
        # the motivating case: row 3 passes two occupied slots and reaches
        # the empty slot e in round 2; row 9 hashes straight to e and takes
        # it in round 0, although its index is larger. Three such groups.
        d0 = np.zeros(N, np.int64)
        valid = np.zeros(N, bool)
        pre = []
        for g, (b, small, large) in enumerate(((10, 3, 9), (30, 4, 20),
                                               (44, 0, 47))):
            pre += [((k, True), (0, True))
                    for k in _keys_homed([b, b + 1], 100 * g)]
            d0[small], d0[large] = _keys_homed([b, b + 2], 7000 + 100 * g)
            valid[[small, large]] = True
        table = _prefill(pre)
        return table, (d0, ones, np.zeros(N, np.int64), ones), valid
    if name == "crowd":
        # nine new keys, homed along an occupied run of eight slots and at
        # the empty slot e after it, so each reaches e in another round;
        # each key on several rows, in shuffled order: one takes e, the
        # others walk on from it
        pre = [((k, True), (0, True))
               for k in _keys_homed(list(range(20, 28)), 3000)]
        table = _prefill(pre)
        new = np.array(_keys_homed(list(range(20, 29)), 9000), np.int64)
        d0 = new[rng.integers(0, len(new), N)]
        return table, (d0, ones, np.zeros(N, np.int64), ones), ones
    raise ValueError(name)


CASES = ["load_0.0", "load_0.3", "load_0.6", "load_0.9", "wrap", "overflow",
         "late_arrival", "crowd"]


@functools.lru_cache(maxsize=None)
def _reference(name):
    table, rows, valid = _case(name)
    return table, rows, valid, _jax_result(table, rows, valid)


def _assert_same(got, want):
    (gkd, gkm, gocc), gslots, gnew, gover = got[:4]
    (wkd, wkm, wocc), wslots, wnew, wover = want[:4]
    np.testing.assert_array_equal(gslots, wslots)
    np.testing.assert_array_equal(gnew, wnew)
    assert gover == wover
    np.testing.assert_array_equal(gocc, wocc)
    for a, b in zip(gkd + gkm, wkd + wkm):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", CASES)
def test_phased_model_equals_reference(name, window):
    table, rows, valid, want = _reference(name)
    got = _model_insert(table, rows, valid, window, seed=window)
    _assert_same(got, want)
    if name == "overflow":
        assert want[3], "the batch was meant to overflow"
    if name in ("late_arrival", "crowd"):
        assert got[4] >= 1       # rows that lost e to another key walk on


@pytest.mark.parametrize("name", CASES)
def test_plain_version_equals_reference(name):
    table, rows, valid, want = _reference(name)
    _assert_same(_plain_result(table, rows, valid), want)


def test_control_without_arrival_rounds_differs_on_late_arrival():
    """Dropping the arrival round gives row 3 the slot the reference gives
    row 9: the late-arrival case reaches the trap."""
    table, rows, valid, want = _reference("late_arrival")
    got = _model_insert(table, rows, valid, 4, arrival=False)
    assert not np.array_equal(got[1], want[1])
    assert got[1][3] == want[1][9]
