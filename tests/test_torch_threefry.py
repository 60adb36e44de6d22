"""The port's Threefry random numbers and on-device bid generator against
``jax.random`` and the reference's ``DeviceBidGenerator``, on the CPU: keys,
fold-in, split, raw bits, float64 uniforms and int64 randints bit for bit;
generated bid chunks column for column (strings compared decoded)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu  # noqa: F401  (enables x64, as the reference runs)
from risingwave_tpu.common.types import GLOBAL_STRING_DICT
from risingwave_tpu.connector import NexmarkConfig as JConfig
from risingwave_tpu.connector.nexmark import DeviceBidGenerator as JGen
from risingwave_tpu_torch.common import map_tensors
from risingwave_tpu_torch.connector import (
    BID_SCHEMA, DeviceBidGenerator, NexmarkConfig, threefry,
)
from risingwave_tpu_torch.interop import prng_key_from_jax

SEEDS = [0, 42, 17, -5, (1 << 40) + 3]
N = 3000


def _pair(seed):
    return jax.random.PRNGKey(seed), threefry.prng_key(seed, "cpu")


def _eq(ref, got: torch.Tensor):
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split(seed):
    jk, tk = _pair(seed)
    _eq(jax.random.key_data(jk), tk)
    _eq(jax.random.key_data(jk), prng_key_from_jax(
        np.asarray(jax.random.key_data(jk)), device="cpu"))
    for d in (0, 1, 7, 1 << 20, (1 << 32) - 1):
        _eq(jax.random.fold_in(jk, d), threefry.fold_in(tk, d))
    _eq(jax.random.split(jk, 7), threefry.split(tk, 7))
    # a batch of folds equals the folds one by one
    batch = threefry.fold_in(tk, torch.arange(5))
    for i in range(5):
        _eq(jax.random.fold_in(jk, i), batch[i])


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_uniform_randint(seed):
    jk, tk = _pair(seed)
    _eq(jax.random.bits(jk, (N,), jnp.uint32).astype(jnp.int64),
        threefry.random_bits(tk, 32, (N,)))
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(jk, (5, N // 5), jnp.uint64)),
        threefry.random_bits(tk, 64, (5, N // 5)).numpy().view(np.uint64))
    u = jax.random.uniform(jk, (N,))
    assert u.dtype == jnp.float64
    got = threefry.uniform(tk, (N,))
    assert got.dtype == torch.float64
    _eq(u, got)
    for lo, hi in ((0, 4), (0, 64), (0, 100), (0, 1000), (-7, 993), (5, 3)):
        r = jax.random.randint(jk, (N,), lo, hi)
        assert r.dtype == jnp.int64
        _eq(r, threefry.randint(tk, (N,), lo, hi))


def test_batched_keys_map_over_draws():
    jk, tk = _pair(3)
    keys = threefry.fold_in(tk, torch.arange(4))
    u = threefry.uniform(keys, (100,))
    r = threefry.randint(keys, (100,), 0, 1000)
    for i in range(4):
        ki = jax.random.fold_in(jk, i)
        _eq(jax.random.uniform(ki, (100,)), u[i])
        _eq(jax.random.randint(ki, (100,), 0, 1000), r[i])


def test_randint_rejects_wide_span():
    with pytest.raises(NotImplementedError):
        threefry.randint(threefry.prng_key(0, "cpu"), (4,), 0, 1 << 40)


def _assert_chunk_equal(jc, tc, vocab):
    assert len(jc.columns) == len(tc.columns) == len(BID_SCHEMA)
    np.testing.assert_array_equal(np.asarray(jc.ops), tc.ops.numpy())
    np.testing.assert_array_equal(np.asarray(jc.vis), tc.vis.numpy())
    for field, a, c in zip(BID_SCHEMA, jc.columns, tc.columns):
        np.testing.assert_array_equal(np.asarray(a.mask), c.mask.numpy())
        want, got = np.asarray(a.data), c.data.numpy()
        if field.type.dtype == torch.int32:      # VARCHAR ids
            want = np.vectorize(GLOBAL_STRING_DICT.lookup)(want)
            got = np.asarray(vocab, dtype=object)[got]
        np.testing.assert_array_equal(want, got, err_msg=field.name)


@pytest.mark.parametrize("start,batch_no", [(0, 0), (10**9 + 7, 3),
                                            (512 * 5, 11)])
def test_bid_chunk_fn_equals_reference(start, batch_no):
    jgen = JGen(JConfig(chunk_capacity=512))
    tgen = DeviceBidGenerator(NexmarkConfig(chunk_capacity=512),
                              device="cpu")
    jk, tk = _pair(23)
    jk = jax.random.fold_in(jk, batch_no)
    tk = threefry.fold_in(tk, batch_no)
    _assert_chunk_equal(jgen.chunk_fn()(jnp.int64(start), jk),
                        tgen.chunk_fn()(start, tk), tgen.vocab)


def test_bid_batches_equal_reference():
    """A batch of per-chunk keys gives chunk i of ``chunk_fn(start[i],
    key[i])``; ``next_batch`` draws k chunks from one key as the
    reference's does."""
    jgen = JGen(JConfig(chunk_capacity=256), seed=9)
    tgen = DeviceBidGenerator(NexmarkConfig(chunk_capacity=256), seed=9,
                              device="cpu")
    jk, tk = _pair(5)
    starts = 100 + torch.arange(3) * 256
    batch = tgen.chunk_fn()(starts, threefry.fold_in(tk, torch.arange(3)))
    for i in range(3):
        ref = jgen.chunk_fn()(jnp.int64(100 + i * 256),
                              jax.random.fold_in(jk, i))
        _assert_chunk_equal(ref, _row(batch, i), tgen.vocab)
    for _ in range(2):
        jb, tb = jgen.next_batch(2), tgen.next_batch(2)
        for i in range(2):
            _assert_chunk_equal(jb.at(i), tb.at(i), tgen.vocab)


def _row(chunk, i):
    return map_tensors(chunk, lambda a: a[i])
