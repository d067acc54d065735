"""Port parity: ``hist_dtype="bf16sr"`` (stochastically rounded bf16
statistics in front of the bf16 histograms), on the CPU, against the JAX
package.

* ``sr_round_bf16`` bit for bit against the reference's on random f32 with
  negatives, +-inf, NaN, subnormals, zeros of both signs, the largest
  finite values and values already representable in bf16, at the ``[n, S]``
  layout of B1/B2's statistics and the ``[E, n, S]`` one of the batched
  route; a transposed view hashes the index of the viewed layout; with
  ``batch_dims`` every leading element gets the same indices (the
  reference's class vmap inside the fused batch's vmap).
* Three rounds of bf16sr ``train`` (binary on the wave grower, multiclass
  on the batched wave grower) and of fused ``cv()`` (single-class strict,
  multiclass) against the reference: split structure equal and values
  within rtol 1e-5 / atol 1e-6, the same regime as bf16 on general data;
  and the rounding is applied (bf16sr trees differ from bf16's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops.histogram import sr_round_bf16 as r_sr
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.ops.histogram import sr_round_bf16

RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _awkward(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1e3, shape).astype(np.float32)
    flat = x.reshape(-1)
    big = np.finfo(np.float32).max
    flat[:11] = [np.inf, -np.inf, np.nan, 1e-40, -1e-42, 0.0, -0.0, big,
                 -big, 1.5, -2.0]
    flat[11:300] = rng.normal(size=289).astype(jnp.bfloat16).astype(
        np.float32)
    flat[300:400] = rng.normal(0, 1e-30, 100).astype(np.float32)
    return x


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", [(5000, 3), (4, 3000, 3)])
def test_sr_round_bit_equal(shape):
    x = _awkward(shape)
    want = jax.jit(r_sr)(x)
    got = sr_round_bf16(torch.from_numpy(x))
    assert np.array_equal(_bits(want), _bits(got.numpy()))
    # representable in bf16 (but where the carry would overflow), and
    # idempotent
    fin = np.isfinite(x) & (np.abs(x) < 3e38)
    assert ((_bits(got.numpy())[fin] & 0xFFFF) == 0).all()
    assert torch.equal(sr_round_bf16(got).view(torch.int32),
                       got.view(torch.int32))


def test_sr_round_layouts():
    x = _awkward((3000, 4, 3), seed=1)           # the port's [n, E, S]
    want = np.asarray(r_sr(jnp.asarray(x.transpose(1, 0, 2)))).transpose(
        1, 0, 2)
    got = sr_round_bf16(torch.from_numpy(x).transpose(0, 1)).transpose(0, 1)
    assert np.array_equal(_bits(want), _bits(got.numpy()))
    # batch_dims=1: the reference's call vmapped over the leading axis
    y = _awkward((5, 3, 700, 3), seed=2)
    want = jax.vmap(r_sr)(y)
    got = sr_round_bf16(torch.from_numpy(y), batch_dims=1)
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_growers_round_once_then_take_bf16():
    """A bf16sr tree is the bf16 tree of the statistics rounded in the
    reference's layout: ``[n, S]`` for one tree (strict and waves), ``[E,
    n, S]`` for a batch (the port holds ``[n, E, S]``)."""
    from lightgbm_tpu_torch.models.tree import grow_tree, grow_trees_batched
    from lightgbm_tpu_torch.ops.split import SplitContext

    rng = np.random.default_rng(4)
    n, f, nb = 5000, 5, 32
    bins = torch.from_numpy(rng.integers(0, nb, (n, f)).astype(np.uint8))
    st = torch.from_numpy(np.stack([rng.normal(size=n),
                                    rng.uniform(0.1, 0.3, n),
                                    np.ones(n)], 1).astype(np.float32))
    ctx = SplitContext(0.0, 0.0, 20.0, 1e-3, 0.0, 0.0, 0.0)
    fm = torch.ones(f)
    for width in (1, 8):
        a = grow_tree(bins, st, fm, ctx, 16, nb, -1, hist_dtype="bf16sr",
                      wave_width=width)
        b = grow_tree(bins, sr_round_bf16(st), fm, ctx, 16, nb, -1,
                      hist_dtype="bf16", wave_width=width)
        for x, y in zip(a[0], b[0]):
            assert x is None and y is None or torch.equal(x, y)
        assert torch.equal(a[1], b[1])
    e = 3
    st_t = torch.stack([st * (i + 1) for i in range(e)], 1)     # [n, E, 3]
    ectx = SplitContext.per_element([ctx] * e, "cpu")
    md = torch.full((e,), -1.0)
    got = grow_trees_batched(bins, st_t, fm.expand(e, -1), ectx, md, 16, nb,
                             8, hist_dtype="bf16sr")
    want = grow_trees_batched(
        bins, sr_round_bf16(st_t.transpose(0, 1)).transpose(0, 1),
        fm.expand(e, -1), ectx, md, 16, nb, 8, hist_dtype="bf16")
    for x, y in zip(got, want):
        assert x is None and y is None or torch.equal(x, y)


def _binary(n=5000, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 6))
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    return X, (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(float)


def _check_trees(br, bp, rounds):
    for i in range(rounds):
        a, b = r_arrays(br.trees[i]), p_arrays(bp.trees[i])
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), (i, k)
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_bf16sr_train_matches_reference(objective):
    X, y = _binary()
    params = dict(objective=objective, num_leaves=31, learning_rate=0.3,
                  max_bin=63, hist_dtype="bf16sr", verbose=-1)
    if objective == "multiclass":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(float)
        params.update(num_class=3, num_leaves=16)
    br = R.train(params, R.Dataset(X, label=y), 3)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), 3)
    _check_trees(br, bp, 3)
    np.testing.assert_allclose(bp.predict(X), br.predict(X), rtol=RTOL,
                               atol=ATOL)
    bf16 = P.train(dict(params, hist_dtype="bf16"),
                   P.Dataset(X, label=y, device="cpu"), 3)
    assert not np.array_equal(bf16.predict(X), bp.predict(X))


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_bf16sr_fused_cv_matches_reference(objective):
    X, y = _binary(3000, seed=6)
    params = dict(objective=objective, num_leaves=15, learning_rate=0.3,
                  max_bin=63, hist_dtype="bf16sr", verbose=-1)
    if objective == "multiclass":
        y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(float)
        params.update(num_class=3, num_leaves=16, grow_policy="frontier")
    want = R.cv(params, R.Dataset(X, label=y), 3, nfold=3, stratified=False)
    got = P.cv(params, P.Dataset(X, label=y, device="cpu"), 3, nfold=3,
               stratified=False)
    key = next(k for k in want if k.endswith("-mean"))
    np.testing.assert_allclose(got[key], want[key], rtol=RTOL)
    assert got.best_iter == want.best_iter
