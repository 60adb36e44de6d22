"""Counter-based Threefry-2x32 random numbers, bit-exact with ``jax.random``.

The on-device bid generator (``nexmark.DeviceBidGenerator``) must draw the
very numbers the reference draws, so this module is the port's own copy of
what JAX 0.9.0 computes with 64-bit types enabled and the partitionable
Threefry (``jax_threefry_partitionable = True``, the default):

  * ``prng_key(seed)``   — ``jax.random.PRNGKey``: the seed's high and low
    32-bit words;
  * ``fold_in(key, d)``  — Threefry of the counter pair ``(0, d)``;
  * ``split(key, n)``    — Threefry of the counters ``(0, i)``, i < n;
  * ``random_bits``      — Threefry of the flat index split into its high and
    low words: 32 bits are ``b1 ^ b2``, 64 bits are ``b1 << 32 | b2``;
  * ``uniform``          — float64 in [0, 1) from the top 52 bits of a 64-bit
    draw;
  * ``randint``          — int64 in [lo, hi) from two 64-bit draws (one per
    half of ``split(key)``), reduced modulo the span.

A key is an int64 tensor whose last axis holds the two 32-bit words, each in
[0, 2**32); leading axes batch keys, and every function maps over them. All
arithmetic is int64: torch has no unsigned 32- or 64-bit arithmetic on CUDA,
so each add is masked back to 32 bits, rotations are built from shifts of
values below 2**32, and a 64-bit draw stays in its two words (an arithmetic
shift of a negative int64 would smear the sign bit into the result).
"""

from __future__ import annotations

import torch

from .. import DEFAULT_DEVICE

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key ``(k1, k2)``; all int64 tensors of 32-bit values,
    broadcast together. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & M32
    return a, b


def prng_key(seed: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed in the int64 range."""
    if not -(1 << 63) <= seed < (1 << 63):
        raise ValueError(f"seed {seed} is outside the int64 range")
    key = torch.empty(2, dtype=torch.int64, device=device)
    key[0] = (seed >> 32) & M32
    key[1] = seed & M32
    return key


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (a Python int or an int64 tensor of
    values in [0, 2**32), broadcast against the key's batch axes) mixed into
    the key."""
    if not isinstance(data, torch.Tensor):
        data = torch.full((), data & M32, dtype=torch.int64,
                          device=key.device)
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                        data & M32)
    return torch.stack([a, b], dim=-1)


def _counters(key: torch.Tensor, shape: tuple[int, ...]):
    """The flat index over ``shape`` as (high word, low word), shaped to
    broadcast against ``key[..., 0]`` with ``shape`` appended."""
    n = 1
    for d in shape:
        n *= d
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    return idx >> 32, idx & M32


def _words(key: torch.Tensor, shape: tuple[int, ...]):
    """The two 32-bit words of each draw: key batch axes + ``shape``."""
    shape = tuple(shape)
    hi, lo = _counters(key, shape)
    pad = (...,) + (None,) * len(shape)
    return threefry2x32(key[..., 0][pad], key[..., 1][pad], hi, lo)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: [..., n, 2]."""
    a, b = _words(key, (n,))
    return torch.stack([a, b], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int,
                shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bits`` of 32 or 64 bits, as int64: a 32-bit draw is in
    [0, 2**32); a 64-bit draw is the uint64 value's two's-complement bit
    pattern (``.view(uint64)`` on the host gives JAX's value)."""
    a, b = _words(key, shape)
    if bit_width == 32:
        return a ^ b
    if bit_width == 64:
        return (a << 32) | b
    raise NotImplementedError(f"random_bits of {bit_width} bits")


def uniform(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float64: the top 52 bits of a
    64-bit draw as the mantissa, taken from the two words directly."""
    a, b = _words(key, shape)
    mantissa = (a << 20) | (b >> 12)
    return mantissa.to(torch.float64) * (2.0 ** -52)


def _mod64(hi: torch.Tensor, lo: torch.Tensor, span: int) -> torch.Tensor:
    """``(hi * 2**32 + lo) % span`` of a 64-bit draw held as two words."""
    return ((hi % span) * ((1 << 32) % span) + lo % span) % span


def randint(key: torch.Tensor, shape: tuple[int, ...], lo: int,
            hi: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi)`` in int64 (spans below
    2**31, so every intermediate product fits in int64)."""
    span = hi - lo if hi > lo else 1
    if span >= 1 << 31:
        raise NotImplementedError(f"randint span {span}: not ported")
    k = split(key, 2)
    higher = _mod64(*_words(k[..., 0, :], shape), span)
    lower = _mod64(*_words(k[..., 1, :], shape), span)
    multiplier = ((1 << 32) % span) ** 2 % span     # 2**64 % span
    return lo + (higher * multiplier + lower) % span
