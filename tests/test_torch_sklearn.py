"""Port parity: the scikit-learn style estimators (``lightgbm_tpu_torch.
sklearn``) against the reference's on seed-made data, on the CPU.

``LGBMRegressor``, ``LGBMClassifier`` (binary and 3-class, ``predict`` and
``predict_proba``), ``LGBMRandomForestRegressor`` (rf with sklearn's
``max_features`` as per-node sampling): predictions within the parity
regime (rtol 1e-5, atol 1e-6); ``get_params``/``set_params`` equal but for
the port's ``device``; ``_mtry_fraction`` for an int, a float, ``"sqrt"``,
``"log2"`` and None.  Then the port's counterparts of the reference's
``tests/test_review_fixes.py`` checks that per-node sampling samples.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu.sklearn as RS
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.sklearn as PS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the strict grower runs many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6


def _data(classes=0, n=1200, f=5, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    s = X[:, 0] - 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n)
    if classes == 0:
        return X, s
    edges = np.quantile(s, np.linspace(0, 1, classes + 1)[1:-1])
    labels = np.array([3.0, 7.0, 9.0])[:classes]
    return X, labels[np.digitize(s, edges)]


ESTIMATORS = {
    "regressor": (lambda m: m.LGBMRegressor(
        n_estimators=5, num_leaves=7, subsample=0.8, subsample_freq=1,
        random_state=4), 0),
    "binary": (lambda m: m.LGBMClassifier(
        n_estimators=4, num_leaves=7, colsample_bytree=0.8,
        random_state=4), 2),
    "multiclass": (lambda m: m.LGBMClassifier(
        n_estimators=3, num_leaves=7, random_state=4), 3),
    "forest": (lambda m: m.LGBMRandomForestRegressor(
        n_estimators=5, max_leaf_nodes=9, max_features="sqrt",
        min_samples_leaf=3, random_state=345), 0),
}


@pytest.mark.parametrize("name", sorted(ESTIMATORS))
def test_estimators_match_reference(name):
    make, classes = ESTIMATORS[name]
    X, y = _data(classes)
    ref = make(RS).fit(X, y)
    port = make(PS)
    port.set_params(device="cpu")
    port.fit(X, y)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=RTOL,
                               atol=ATOL)
    if classes:
        np.testing.assert_array_equal(port.classes_, ref.classes_)
        np.testing.assert_allclose(port.predict_proba(X),
                                   ref.predict_proba(X), rtol=RTOL,
                                   atol=ATOL)
        assert port.predict_proba(X).shape == (len(y), max(classes, 2))
    np.testing.assert_allclose(port.score(X, y), ref.score(X, y),
                               rtol=RTOL)
    assert port.n_estimators_ == ref.n_estimators_
    assert port.n_features_in_ == ref.n_features_in_ == X.shape[1]
    np.testing.assert_array_equal(port.feature_importances_,
                                  ref.feature_importances_)


def test_get_and_set_params_match_reference():
    for name, (make, _) in ESTIMATORS.items():
        ref, port = make(RS), make(PS)
        got = port.get_params()
        assert got.pop("device") is None
        assert got == ref.get_params(), name
        for est in (ref, port):
            est.set_params(num_leaves=5, my_extra_key=2)
        got = port.get_params()
        got.pop("device")
        assert got == ref.get_params()
        assert port.num_leaves == 5 and port._other_params == \
            ref._other_params
    assert P.LGBMRegressor is PS.LGBMRegressor


@pytest.mark.parametrize("mf", [1, 3, 0.5, "sqrt", "log2", None, 1.0])
def test_mtry_fraction_matches_reference(mf):
    for f in (1, 6, 28):
        want = RS.LGBMRandomForestRegressor(
            max_features=mf)._mtry_fraction(f)
        got = PS.LGBMRandomForestRegressor(max_features=mf)._mtry_fraction(f)
        assert got == want, (mf, f)


def _used_features(booster):
    used = set()
    for t in booster.trees:
        feats = t.split_feature.numpy()
        internal = ~t.is_leaf.numpy() & (feats >= 0)
        used.update(feats[internal].tolist())
    return used


def test_rf_max_features_actually_samples():
    rng = np.random.default_rng(9)
    n = 1500
    X = rng.normal(0, 1, (n, 6))
    y = 3.0 * X[:, 0] + 0.2 * X[:, 1:].sum(axis=1)
    rf = PS.LGBMRandomForestRegressor(n_estimators=8, max_leaf_nodes=8,
                                      max_features=1, random_state=0,
                                      min_samples_leaf=5, device="cpu")
    rf.fit(X, y)
    # mtry=1 of 6: the dominant feature cannot monopolize every split
    assert len(_used_features(rf.booster_)) >= 3


def test_feature_fraction_bynode_samples_per_split():
    rng = np.random.default_rng(5)
    n = 2000
    X = rng.normal(0, 1, (n, 8))
    # every feature matters a bit, feature 0 dominates
    y = 3.0 * X[:, 0] + X[:, 1:].sum(axis=1) * 0.3
    params = {"objective": "regression", "feature_fraction_bynode": 0.25,
              "num_leaves": 31, "verbosity": 0, "seed": 1}
    b = P.train(params, P.Dataset(X, label=y, device="cpu"),
                num_boost_round=5)
    # with per-node sampling, splits cannot all be on the dominant feature
    assert len(_used_features(b)) > 1
