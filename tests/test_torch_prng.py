"""The port's threefry (``repro_torch.serve.prng``) against ``jax.random``.

jax's defaults hold here as in ``repro``: ``threefry2x32``, the
partitionable layout, 32-bit integers.  Keys, bits and uniforms are held
bit for bit (compared as uint32 words).  The Gumbel noise is
``-log(-log(u))`` of those exact uniforms, so it differs only by the two
libraries' ``log``: it is held within 4 ulps of max(|g|, 1) (2 measured
over 2.5M draws), the scale at which it enters ``log p + g``.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro_torch.serve import prng

SEEDS = [0, 1, 42, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, 2**40 + 7, -5]
SHAPES = [(1,), (2,), (7,), (256,), (3, 5), (2, 3, 4), (32001,)]


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _u32(t):
    """A port tensor of uint32 words (int64) or of f32 as uint32 bits."""
    a = t.numpy()
    return a.view(np.uint32) if a.dtype == np.float32 else a.astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    """PRNGKey(seed) is (0, seed mod 2**32) with x64 off (jax takes the
    seed to 32 bits before its 64-bit split), and fold_in hashes (0, data)
    under the key."""
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert tkey.tolist() == _key_data(key).tolist()
    assert tkey.tolist() == [0, seed % 2**32]
    for data in (0, 1, 7, 2**31 + 3, 2**32 - 1):
        want = jax.random.fold_in(key, jnp.asarray(data, jnp.uint32))
        assert prng.fold_in(tkey, data).tolist() == \
            _key_data(want).tolist(), data


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed,rid,pos", [(0, 0, 0), (3, 7, 1), (17, 2**31 + 5, 999),
                                          (2**32 + 5, 12345, 2**32 - 1)])
def test_random_bits_and_uniform_bit_exact(seed, rid, pos, shape):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(seed), jnp.asarray(rid, jnp.uint32)),
        jnp.asarray(pos, jnp.uint32))
    tkey = prng.fold_in(prng.fold_in(prng.prng_key(seed), rid), pos)
    bits = prng.random_bits(tkey, shape)
    assert bits.shape == shape and bits.dtype == torch.int64
    np.testing.assert_array_equal(
        _u32(bits), np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    u = prng.uniform(tkey, shape)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(
        _u32(u), np.asarray(jax.random.uniform(key, shape)).view(np.uint32))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    np.testing.assert_array_equal(
        _u32(prng.uniform(tkey, shape, minval=tiny, maxval=1.0)),
        np.asarray(jax.random.uniform(key, shape, minval=tiny, maxval=1.0))
        .view(np.uint32))


@pytest.mark.parametrize("seed", range(6))
def test_gumbel_within_ulps(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    shape = (50_001,)
    want = np.asarray(jax.random.gumbel(key, shape))
    got = prng.gumbel(tkey, shape).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    assert float((np.abs(got - want) / ulp).max()) <= 4


def test_a_batch_of_keys_draws_each_keys_own_numbers():
    """One key per row (the sampler's layout) gives each row what its key
    gives alone."""
    rids, pos = torch.tensor([0, 5, 2**32 - 1]), torch.tensor([3, 0, 77])
    base = prng.prng_key(9)
    keys = prng.fold_in(prng.fold_in(base.expand(3, 2), rids), pos)
    assert keys.shape == (3, 2)
    batched = prng.uniform(keys, (33,))
    assert batched.shape == (3, 33)
    for i in range(3):
        one = prng.fold_in(prng.fold_in(base, int(rids[i])), int(pos[i]))
        assert torch.equal(keys[i], one)
        assert torch.equal(batched[i].view(torch.int32),
                           prng.uniform(one, (33,)).view(torch.int32))


def test_words_stay_32_bit_and_floats_refused():
    key = prng.prng_key(2**32 - 1)
    y1, y2 = prng.threefry2x32(key, torch.tensor([2**32 - 1]),
                               torch.tensor([2**32 - 1]))
    for y in (y1, y2):
        assert 0 <= int(y) < 2**32
    with pytest.raises(TypeError, match="integers"):
        prng.fold_in(key, torch.tensor(1.0))
