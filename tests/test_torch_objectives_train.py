"""Port parity: ``train`` of every objective on the strict grower, on the
CPU, against the JAX package (``test_torch_objectives_waves.py`` runs the
same check on the wave grower).

Five rounds of each objective (the renewal objectives ``regression_l1``,
``quantile`` and ``mape`` among them) with the paramGrid's bagging and
feature fraction, 31 leaves, on the strict grower (3,000 rows: below the
wave grower's 4,096; the wave grower's file takes 7,000), under PARITY.md's
general-data regime: split structure and per-node counts equal, leaf values,
training scores and predictions within rtol 1e-5 / atol 1e-6 (the packages
sum histograms in other orders, so the values differ by ulps; the renewed
leaves are residuals of the same rows).  Then fused ``cv()`` with
``regression_l1``: the reference's fused program grows and adds Newton
leaves without renewal, so ``cv`` keeps other leaves than ``train``; the
port copies it (``best_iter`` equal, histories within rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays

OBJECTIVES = ("regression_l1", "huber", "fair", "poisson", "quantile",
              "mape", "gamma", "tweedie", "cross_entropy")
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves")
RTOL, ATOL = 1e-5, 1e-6
GRID = dict(num_leaves=31, learning_rate=0.3, min_data_in_leaf=20,
            feature_fraction=0.8, bagging_fraction=0.6, bagging_freq=4,
            alpha=0.8, tweedie_variance_power=1.3, verbose=-1)
GROWER_ROWS = {"strict": 3000, "waves": 7000}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n, seed=11):
    """Positive skewed labels (a gamma draw around a log-linear mean), so
    every objective's label domain holds; cross_entropy takes them scaled
    into [0, 1]."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 6))
    mu = np.exp(0.5 * X[:, 0] + 0.3 * np.sin(2 * X[:, 1])
                + 0.2 * X[:, 2] * X[:, 3])
    return X, rng.gamma(2.0, mu / 2.0)


def check_train_parity(objective, grower):
    """Five rounds of ``objective`` in both packages on ``grower``'s rows:
    structure and counts equal, values within rtol 1e-5 / atol 1e-6."""
    X, y = _data(GROWER_ROWS[grower])
    if objective == "cross_entropy":
        y = y / y.max()
    params = dict(GRID, objective=objective)
    br = R.train(params, R.Dataset(X, label=y), 5)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), 5)
    assert bp.init_score_ == br.init_score_
    for i in range(5):
        a, b = r_arrays(br.trees[i]), p_arrays(bp.trees[i])
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), (i, k)
        assert np.array_equal(a["count"], b["count"]), i
        leaves = a["is_leaf"]
        np.testing.assert_allclose(b["leaf_value"][leaves],
                                   a["leaf_value"][leaves], rtol=RTOL,
                                   atol=ATOL)
    if grower == "waves":
        assert int(p_arrays(bp.trees[0])["num_leaves"]) == 31
    np.testing.assert_allclose(bp._pred_train.numpy(),
                               np.asarray(br._pred_train), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(bp.predict(X), br.predict(X), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_train_matches_reference_strict(objective):
    check_train_parity(objective, "strict")


def test_renewed_leaves_are_residual_quantiles():
    """Each renewed leaf is the alpha-quantile of its rows' residuals (unit
    weights, no bagging): at least alpha of its rows lie at or below it,
    fewer than alpha strictly below."""
    X, y = _data(3000)
    params = dict(GRID, objective="quantile", bagging_fraction=1.0,
                  bagging_freq=0, feature_fraction=1.0)
    ds = P.Dataset(X, label=y, device="cpu")
    b = P.train(params, ds, 1)
    n = len(y)
    res = ds.y[:n].numpy() - np.float32(b.init_score_)
    vals = b._tree_values(b.trees[0], ds.X_binned, b._depth_cap)[:n].numpy()
    leaves = np.unique(vals)
    assert len(leaves) == int(b.trees[0].num_leaves)
    for v in leaves:
        r = res[vals == v]
        assert v in r
        assert np.mean(r <= v) >= params["alpha"] > np.mean(r < v)


def test_fused_cv_l1_keeps_newton_leaves_as_the_reference():
    X, y = _data(3000, seed=12)
    params = dict(objective="regression_l1", num_leaves=15,
                  learning_rate=0.3, max_bin=63, verbose=-1)
    want = R.cv(params, R.Dataset(X, label=y), 40, nfold=3,
                early_stopping_rounds=5, stratified=False)
    got = P.cv(params, P.Dataset(X, label=y, device="cpu"), 40, nfold=3,
               early_stopping_rounds=5, stratified=False)
    assert got.best_iter == want.best_iter
    np.testing.assert_allclose(got["valid l1-mean"], want["valid l1-mean"],
                               rtol=RTOL)
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)
    # the per-fold route (a callback takes cv off the fused program)
    # renews, so its l1 differs from the fused route's
    per_fold = P.cv(params, P.Dataset(X, label=y, device="cpu"), 5, nfold=3,
                    stratified=False, callbacks=[lambda env: None])
    assert not np.allclose(per_fold["valid l1-mean"],
                           got["valid l1-mean"][:5])
