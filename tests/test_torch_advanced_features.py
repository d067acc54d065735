"""Port parity: ``examples/advanced_features.py`` on both packages, on the
CPU: monotone constraints (section 1), linear leaves (section 2), TreeSHAP
on the monotone model (section 3) and a learning-rate schedule through
``reset_parameter`` (section 4), each as the script calls it, with the
script's printed numbers compared at the tolerances stated below.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _advanced_features_data():
    rng = np.random.default_rng(7)
    n = 5000
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (1.2 * X[:, 0] - 0.8 * X[:, 1]
         + np.where(X[:, 2] > 0, 2.0 * X[:, 2], 0.3 * X[:, 2])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _advanced_features(L, X, y, **kw):
    """The script's four sections on package ``L``: its RMSEs, mean
    |SHAP| per feature and additivity gap."""
    tr, te = slice(0, 4000), slice(4000, None)
    dtrain = L.Dataset(X[tr], label=y[tr], **kw)

    def rmse(b, **k):
        return float(np.sqrt(np.mean((b.predict(X[te], **k) - y[te]) ** 2)))

    b_mono = L.train({"objective": "regression", "verbosity": -1,
                      "monotone_constraints": [1, -1, 0, 0, 0]},
                     dtrain, num_boost_round=60)
    b_lin = L.train({"objective": "regression", "verbosity": -1,
                     "num_leaves": 8, "linear_tree": True},
                    dtrain, num_boost_round=25)
    b_con = L.train({"objective": "regression", "verbosity": -1,
                     "num_leaves": 8}, dtrain, num_boost_round=25)
    contrib = b_mono.predict(X[te][:500], pred_contrib=True)
    check = np.abs(contrib.sum(axis=1)
                   - b_mono.predict(X[te][:500], raw_score=True)).max()
    b_sched = L.train(
        {"objective": "regression", "verbosity": -1, "learning_rate": 0.3},
        dtrain, num_boost_round=60,
        callbacks=[L.reset_parameter(
            learning_rate=lambda i: 0.3 * (0.97 ** i))])
    return {"mono": rmse(b_mono), "lin": rmse(b_lin), "con": rmse(b_con),
            "shap": np.abs(contrib[:, :5]).mean(axis=0), "check": check,
            "sched": rmse(b_sched), "b_mono": b_mono}


def test_advanced_features_example_on_both_packages():
    """All four sections of examples/advanced_features.py as the script
    calls them.  Linear leaves beat constant ones on the kink in both, with
    RMSEs within 1e-5 relative (ROADMAP C.7 moves no digit the script
    prints); TreeSHAP is additive within 1e-4 and x3/x4 get ~nothing.  The
    monotone models part at tree 50 (ROADMAP C.6), so mean |SHAP| is
    compared within rtol 2e-3, atol 2e-4 across packages (x3/x4's
    near-zero attributions move by 1.1e-4 with the parted trees), and
    within rtol 1e-5, atol 1e-6 on the reference's own model carried into
    the port by its text model; the lr schedule's RMSE within 1e-5
    relative."""
    X, y = _advanced_features_data()
    r = _advanced_features(R, X, y)
    p = _advanced_features(P, X, y, device="cpu")
    for key in ("lin", "con", "sched"):
        assert abs(p[key] - r[key]) <= 1e-5 * r[key], (key, p[key], r[key])
    assert abs(p["mono"] - r["mono"]) <= 2e-4 * r["mono"]
    assert p["lin"] < p["con"] and r["lin"] < r["con"]
    assert p["check"] <= 1e-4 and r["check"] <= 1e-4
    np.testing.assert_allclose(p["shap"], r["shap"], rtol=2e-3, atol=2e-4)
    assert p["shap"][3:].max() < 0.05 * p["shap"][:3].min()
    carried = P.Booster(model_str=r["b_mono"].model_to_string(),
                        device="cpu")
    te = X[4000:4500]
    np.testing.assert_allclose(carried.predict(te, pred_contrib=True),
                               r["b_mono"].predict(te, pred_contrib=True),
                               rtol=1e-5, atol=1e-6)
