"""Port parity: the counter-based RNG and the samplers that use it.

``lightgbm_tpu_torch.utils.random`` re-implements ``jax.random``'s
``PRNGKey``, ``fold_in``, ``split`` and f32 ``uniform`` under threefry2x32
with ``jax_threefry_partitionable=True``; the bagging and feature-fraction
masks drawn from them must be bit-identical to the reference's, so every
check here is exact equality.  The batched forms (one key per fused-CV
element) are held against ``jax.vmap`` of the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import sampling as jsamp
from lightgbm_tpu_torch.ops import sampling as tsamp
from lightgbm_tpu_torch.utils import random as trand

SEEDS = [0, 7, 2**31 - 1]
SHAPES = [(28,), (4352,)]          # (F,) and (n_pad,)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def test_threefry_partitionable_is_on():
    # the port reproduces the partitionable scheme only: a jax upgrade that
    # flips the default must fail here, loudly
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(key).tolist()) == trand.prng_key(seed)
    for i in (0, 1, 9, 123456):
        want = np.asarray(jax.random.fold_in(key, i)).tolist()
        assert tuple(want) == trand.fold_in(trand.prng_key(seed), i)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"n{s[0]}")
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bits(seed, shape):
    for i in (0, 3):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        want = jax.random.uniform(key, shape)
        got = trand.uniform(trand.fold_in(trand.prng_key(seed), i), shape)
        assert got.dtype == torch.float32
        assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_prng_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        trand.prng_key(-1)


@pytest.mark.parametrize("fraction", [0.6, 0.8, 0.3333, 1.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_sample_bag_masks_equal(seed, fraction):
    n, n_pad = 4100, 4352
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    for i in (0, 4):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 3), i)
        want = jsamp.sample_bag(key, jnp.asarray(mask), jnp.float32(fraction),
                                jnp.float32(n))
        got = tsamp.sample_bag(trand.fold_in(trand.prng_key(seed + 3), i),
                               torch.from_numpy(mask), fraction, float(n))
        assert np.array_equal(np.asarray(want), got.numpy())
        if fraction < 1.0:
            assert int(got.sum()) == int(np.floor(np.float32(fraction)
                                                  * np.float32(n)))


def test_approx_top_mask_two_passes_equal():
    rng = np.random.default_rng(5)
    x = np.abs(rng.standard_cauchy(3000)).astype(np.float32)  # heavy tail
    valid = rng.random(3000) < 0.9
    for k in (1, 17, 1000, 2999):
        want = jsamp.approx_top_mask(jnp.asarray(x), jnp.asarray(valid), k)
        got = tsamp.approx_top_mask(torch.from_numpy(x),
                                    torch.from_numpy(valid), k)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("fraction", [0.8, 0.5, 0.05, 1.0])
@pytest.mark.parametrize("num_features", [1, 6, 28])
@pytest.mark.parametrize("seed", SEEDS)
def test_sample_feature_mask_equal(seed, num_features, fraction):
    for i in (0, 2):
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 2), i)
        want = jsamp.sample_feature_mask(key, jnp.float32(fraction),
                                         num_features)
        got = tsamp.sample_feature_mask(
            trand.fold_in(trand.prng_key(seed + 2), i), fraction,
            num_features)
        assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split_keys(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tkey = trand.fold_in(trand.prng_key(seed), 3)
    for num in (1, 5, 40):
        want = np.asarray(jax.random.split(key, num)).tolist()
        assert [list(k) for k in trand.split(tkey, num)] == want
        assert trand.split_keys(tkey, num).tolist() == want
    keys = jax.random.split(key, 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys))
    got = trand.fold_in_keys(trand.split_keys(tkey, 6), 1)
    assert got.tolist() == want.tolist()


def test_uniform_rows_equal_vmapped_uniform():
    keys = jax.random.split(jax.random.PRNGKey(11), 7)
    want = jax.vmap(lambda k: jax.random.uniform(k, (4352,)))(keys)
    got = trand.uniform_rows(torch.from_numpy(
        np.asarray(keys).astype(np.int64)), 4352)
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_sample_bag_rows_equal_vmapped_sample_bag():
    """Per-element keys, fold masks, fractions and in-fold counts, as the
    fused program draws them; k is taken in f32."""
    rng = np.random.default_rng(4)
    e, n, n_pad = 6, 4100, 4352
    masks = np.zeros((e, n_pad), np.float32)
    masks[:, :n] = rng.random((e, n)) < 0.8
    frac = np.array([0.6, 0.8, 1.0, 0.3333, 0.6, 0.8], np.float32)
    n_in = masks.sum(axis=1).astype(np.float32)
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(9), 0), e)
    want = jax.vmap(jsamp.sample_bag)(keys, jnp.asarray(masks),
                                      jnp.asarray(frac), jnp.asarray(n_in))
    got = tsamp.sample_bag_rows(
        torch.from_numpy(np.asarray(keys).astype(np.int64)),
        torch.from_numpy(masks), torch.from_numpy(frac),
        torch.from_numpy(n_in))
    assert np.array_equal(np.asarray(want), got.numpy())
    counts = got.sum(dim=1).numpy()
    k = np.floor(frac * n_in).astype(np.int64)
    assert np.array_equal(counts[frac < 1], k[frac < 1])


@pytest.mark.parametrize("num_features", [1, 6, 28])
def test_sample_feature_mask_rows_equal_vmapped(num_features):
    keys = jax.random.split(jax.random.PRNGKey(5), 5)
    frac = np.array([0.8, 1.0, 0.5, 0.05, 0.8], np.float32)
    want = jax.vmap(lambda k, f: jsamp.sample_feature_mask(
        k, f, num_features))(keys, jnp.asarray(frac))
    got = tsamp.sample_feature_mask_rows(
        torch.from_numpy(np.asarray(keys).astype(np.int64)),
        torch.from_numpy(frac), num_features)
    assert np.array_equal(np.asarray(want), got.numpy())
