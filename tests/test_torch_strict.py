"""Port parity: the strict best-first grower (wave width 1) against the
reference's ``grow_tree(wave_width=1)`` and ``train``, on the CPU with the
plain versions of kernels B1, B3 and B6.

(a) dyadic tier — l2 on y in {0, 1} with exactly n/2 ones: every round-1
    histogram sum is exact, so the trees (structure, thresholds, leaf
    values, counts, gains) and the row routing are bit-identical, with and
    without the split regularizers;
(b) general data — split structure and row routing equal, leaf values
    within rtol 1e-5 (histogram sums are taken in other orders); with path
    smoothing on, the reference's XLA program contracts the smoothed
    objective into FMAs in an order the port does not reproduce, so stored
    split gains differ by a few ulps there (leaf values stay equal);
(c) Boosters: ``grow_policy="leafwise"`` and the automatic strict regime
    (fewer than 4,096 rows) against the reference's ``train``;
(d) the batched grower (E trees at once, kernel B6's route) grows each
    element's tree exactly as a single-tree run (kernel B1's route) does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import grow_tree as r_grow
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops.split import SplitContext as RCtx
from lightgbm_tpu_torch.models.tree import (_tree_from_packed,
                                            grow_tree_strict)
from lightgbm_tpu_torch.models.tree import grow_tree as p_grow
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.ops.split import SplitContext as PCtx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the fused and strict growers run thousands of
    small ops, which several test workers' thread pools, each as wide as
    the machine, would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves", "count")
N, F, B, LEAVES = 3000, 6, 32, 31
PLAIN = dict(l1=0.0, l2=0.0, min_data=5.0, min_hess=1e-3, min_gain=0.0,
             mds=0.0, ps=0.0)
REGS = dict(l1=0.5, l2=1.0, min_data=5.0, min_hess=0.5, min_gain=0.1,
            mds=0.3, ps=0.0)


def _data(seed, dyadic):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    if dyadic:
        g = np.where(rng.random(N) < 0.5, -0.5, 0.5)
        h = np.ones(N)
    else:
        g = rng.normal(size=N) + 0.3 * (bins[:, 0] / B)
        h = rng.uniform(0.1, 0.3, N)
    bag = (rng.random(N) < 0.9).astype(np.float64)
    stats = np.stack([g * bag, h * bag, bag], axis=1).astype(np.float32)
    return bins, stats


def _ctx_vals(reg):
    return tuple(reg[k] for k in ("l1", "l2", "min_data", "min_hess",
                                  "min_gain", "mds", "ps"))


def _reference(bins, stats, reg, max_depth):
    def run(b, s, c, md):
        return r_grow(b, s, jnp.ones(F, jnp.float32), RCtx(*c), LEAVES, B,
                      md, wave_width=1)

    tree, rl = jax.jit(run)(jnp.asarray(bins), jnp.asarray(stats),
                            tuple(jnp.float32(v) for v in _ctx_vals(reg)),
                            jnp.int32(max_depth))
    return r_arrays(tree), np.asarray(rl)


def _port(bins, stats, reg, max_depth):
    tree, rl = p_grow(torch.from_numpy(bins), torch.from_numpy(stats),
                      torch.ones(F), PCtx(*_ctx_vals(reg)), LEAVES, B,
                      max_depth, wave_width=1)
    return p_arrays(tree), rl.numpy()


@pytest.mark.parametrize("reg", ["plain", "regularized"])
def test_dyadic_trees_bit_identical(reg):
    bins, stats = _data(1, dyadic=True)
    r = PLAIN if reg == "plain" else REGS
    md = -1 if reg == "plain" else 4
    (a, rla), (b, rlb) = _reference(bins, stats, r, md), \
        _port(bins, stats, r, md)
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(rla, rlb)
    assert int(b["num_leaves"]) > 8


@pytest.mark.parametrize("reg", ["plain", "regularized", "smoothed"])
def test_general_structure_and_values(reg):
    bins, stats = _data(2, dyadic=False)
    r = {"plain": PLAIN, "regularized": REGS,
         "smoothed": dict(REGS, ps=2.0)}[reg]
    (a, rla), (b, rlb) = _reference(bins, stats, r, -1), \
        _port(bins, stats, r, -1)
    for k in STRUCTURE:
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(rla, rlb)
    np.testing.assert_allclose(b["leaf_value"], a["leaf_value"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(b["split_gain"], a["split_gain"], rtol=RTOL)


def _xy(n, seed, dyadic):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 8)).astype(np.float32)
    if dyadic:
        order = np.argsort(X @ rng.normal(0, 1, 8) + 0.6 * np.sin(X[:, 0]))
        y = np.zeros(n, np.float32)
        y[order[n // 2:]] = 1.0
        return X, y
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * rng.normal(size=n)
    return X, y


def _train_both(params, X, y, rounds):
    br = R.train(params, R.Dataset(X, label=y), rounds)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), rounds)
    return br, bp


def test_booster_leafwise_dyadic_round1_bit_identical():
    X, y = _xy(4096, 0, dyadic=True)
    params = dict(objective="l2", num_leaves=31, learning_rate=0.5,
                  min_data_in_leaf=5, max_bin=63, verbose=-1,
                  grow_policy="leafwise", hist_dtype="f32", lambda_l2=1.0,
                  max_delta_step=0.3)
    br, bp = _train_both(params, X, y, 1)
    a, b = r_arrays(br.trees[0]), p_arrays(bp.trees[0])
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert int(b["num_leaves"]) == 31
    assert np.array_equal(br.predict(X), bp.predict(X))


@pytest.mark.parametrize("case", ["leafwise", "small_n"])
def test_booster_general_matches_reference(case):
    n = 4096 if case == "leafwise" else 2500
    X, y = _xy(n, 3, dyadic=False)
    params = dict(objective="regression", num_leaves=15, learning_rate=0.3,
                  min_data_in_leaf=20, max_bin=31, verbose=-1,
                  feature_fraction=0.8, bagging_fraction=0.8, bagging_freq=2)
    if case == "leafwise":
        params["grow_policy"] = "leafwise"
    br, bp = _train_both(params, X, y, 4)
    for i in range(4):
        a, b = r_arrays(br.trees[i]), p_arrays(bp.trees[i])
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), (i, k)
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bp.predict(X), br.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_batched_grower_equals_single_tree_runs():
    """Three elements with their own regularizers, depth caps and feature
    masks: the batched grower (B6's route) gives each element the tree and
    the routing a single-tree run (B1's route) gives it."""
    rng = np.random.default_rng(5)
    bins = torch.from_numpy(rng.integers(0, B, (N, F)).astype(np.uint8))
    stats = torch.from_numpy(np.stack([
        np.stack([rng.normal(size=N), rng.uniform(0.1, 0.3, N),
                  (rng.random(N) < 0.8).astype(np.float64)], axis=1)
        for _ in range(3)], axis=1).astype(np.float32))       # [n, 3, 3]
    stats[:, :, :2] *= stats[:, :, 2:]
    ctxs = [PCtx(*_ctx_vals(PLAIN)), PCtx(*_ctx_vals(REGS)),
            PCtx(*_ctx_vals(dict(REGS, min_data=40.0, ps=1.0)))]
    depths = torch.tensor([-1.0, 3.0, 5.0])
    fmask = torch.from_numpy((rng.random((3, F)) < 0.8).astype(np.float32))
    fmask[:, 0] = 1.0
    P_b, nl_b, rl_b, _ = grow_tree_strict(bins, stats, fmask,
                                       PCtx.per_element(ctxs, "cpu"), depths,
                                       LEAVES, B)
    for e in range(3):
        P_1, nl_1, rl_1, _ = grow_tree_strict(
            bins, stats[:, e:e + 1].contiguous(), fmask[e:e + 1],
            PCtx.per_element([ctxs[e]], "cpu"), depths[e:e + 1], LEAVES, B,
            batched=False)
        a = p_arrays(_tree_from_packed(P_b[e], nl_b[e]))
        b = p_arrays(_tree_from_packed(P_1[0], nl_1[0]))
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (e, k)
        assert torch.equal(rl_b[:, e], rl_1[:, 0])
    assert int(nl_b[1]) <= 8                      # depth 3: at most 8 leaves
