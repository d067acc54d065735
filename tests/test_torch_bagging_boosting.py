"""Port parity: examples/bagging_boosting.py's calls through the port, at
reduced depth, against the reference on the CPU.

The script's data (``make_boosting_curve(1000, 8657)``, bit-equal to the
reference's), its params (``reg:linear``, eta 0.02, max_depth 6,
max_leaf_nodes 31, min_data_in_leaf 1), ``cv`` (5 folds, early stopping,
unstratified: the fused route) cut from 1,000 rounds to 60, ``train`` cut
from 500 rounds to 100 with the staged ``predict(grid, ntree_limit=k)`` for
k in {1, 20, 50}, and ``LGBMRandomForestRegressor`` forests of 1 and 3
trees (the notebook's 100 cut).  Predictions within the parity regime
(rtol 1e-5, atol 1e-6); the staged error falls with k, as the script
expects.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.sklearn import LGBMRandomForestRegressor as RForest
from lightgbm_tpu.utils.datasets import make_boosting_curve as r_curve
from lightgbm_tpu_torch.sklearn import LGBMRandomForestRegressor as PForest
from lightgbm_tpu_torch.utils.datasets import make_boosting_curve


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the strict and fused growers run many small
    ops, which several test workers' thread pools would contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
PARAMS = {"objective": "reg:linear", "eval_metric": "rmse", "eta": 0.02,
          "max_depth": 6, "max_leaf_nodes": 31, "verbosity": 0,
          "min_data_in_leaf": 1}
GRID = np.linspace(-4, 4, 400).reshape(-1, 1)
TRUTH = np.abs(GRID[:, 0]) + np.cos(GRID[:, 0])


def test_make_boosting_curve_bit_equal():
    for n, seed in ((1000, 8657), (37, 1)):
        (xa, ya), (xb, yb) = r_curve(n, seed), make_boosting_curve(n, seed)
        assert xa.tobytes() == xb.tobytes() and ya.tobytes() == yb.tobytes()
        assert xb.shape == (n, 1)


@pytest.fixture(scope="module")
def curve():
    return make_boosting_curve(n=1000, seed=8657)


def test_boosting_side_matches_reference(curve):
    X, y = curve
    want = R.cv(PARAMS, R.Dataset(X, label=y), num_boost_round=60,
                early_stopping_rounds=50, nfold=5, stratified=False)
    got = P.cv(PARAMS, P.Dataset(X, label=y, device="cpu"),
               num_boost_round=60, early_stopping_rounds=50, nfold=5,
               stratified=False)
    assert got.best_iter == want.best_iter
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)
    ref = R.train(PARAMS, R.Dataset(X, label=y), num_boost_round=100)
    port = P.train(PARAMS, P.Dataset(X, label=y, device="cpu"),
                   num_boost_round=100)
    errs = []
    for k in (1, 20, 50):
        pred = port.predict(GRID, ntree_limit=k)
        np.testing.assert_allclose(pred, ref.predict(GRID, ntree_limit=k),
                                   rtol=RTOL, atol=ATOL)
        errs.append(float(np.sqrt(np.mean((pred - TRUTH) ** 2))))
    assert errs[0] > errs[1] > errs[2], errs


def test_bagging_side_matches_reference(curve):
    X, y = curve
    errs = []
    for n_trees in (1, 3):
        kw = dict(n_estimators=n_trees, max_leaf_nodes=20, max_features=1,
                  random_state=345, min_samples_leaf=3)
        want = RForest(**kw).fit(X, y).predict(GRID)
        got = PForest(device="cpu", **kw).fit(X, y).predict(GRID)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        errs.append(float(np.sqrt(np.mean((got - TRUTH) ** 2))))
    assert errs[1] < errs[0], errs
