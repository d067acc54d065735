"""Port parity: fused cross-validation (``models/fused.py``) and the route
``cv()`` takes, against the reference on the CPU with the plain versions of
kernels B3 and B6.

* ``run_fused_cv_batch`` on 2 configs x 3 folds with bagging 0.8 every 4
  rounds, ``feature_fraction`` 0.8 and min_data 20 / 40: the same bags,
  feature masks and trees as the reference's fused program, so
  ``best_iter`` and ``rounds_run`` are equal and the metric history and
  ``best_score`` agree within rtol 1e-5 (the metric's sums run in another
  order);
* dyadic tier: after one round every element's predictions are bit-equal
  to the reference's (the trees are exact, and the train-score update is
  one fused multiply-add, as XLA contracts it there);
* ``cv()`` with no callbacks takes the fused route and matches the
  reference's ``cv()`` (this pins the repaired route fault: the port used to
  train one Booster per fold, whose key streams differ);
* the wave regime (an explicit ``grow_policy="frontier"``, which at 3,000
  rows takes the batched wave grower with the exact tail at width 30, whose
  waves take kernel B5's route) with bagging and ``feature_fraction``
  matches the reference's ``cv()``: ``best_iter`` equal, ``best_score``
  within rtol 1e-5.  At 255 bins a node often has two thresholds between
  which none of its in-bag rows lie; their gains are then equal but for the
  f32 rounding of the histogram subtraction, which differs between the
  packages, so either package may take either one (they route the training
  rows alike and the held-out rows of those bins differently).  Six of the
  first eight ``cv`` seeds show such a swap within 30 rounds at this shape,
  each with gains within 3 ulps; seed 3 shows none;
* callbacks and ``return_cvbooster`` take the per-fold route; int8 in the
  wave regime equals f32 (its batched histograms run at full precision), and
  a learner outside the slice raises by name;
* a carry taken to numpy and restored continues to the result an
  uninterrupted run gives.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.config import parse_params as r_params
from lightgbm_tpu.models.fused import FusedCVProgram as RProgram
from lightgbm_tpu.models.fused import run_fused_cv_batch as r_run
from lightgbm_tpu_torch.config import parse_params as p_params
from lightgbm_tpu_torch.models import fused as pf


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the fused and strict growers run thousands of
    small ops, which several test workers' thread pools, each as wide as
    the machine, would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5
BASE = dict(objective="regression", num_leaves=15, max_bin=31, verbose=-1,
            learning_rate=0.3, bagging_freq=4)
CONFIGS = [dict(BASE, min_data_in_leaf=20, feature_fraction=0.8,
                bagging_fraction=0.8),
           dict(BASE, min_data_in_leaf=40, feature_fraction=1.0,
                bagging_fraction=0.8)]


def _general(n=3000, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 6))
    y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] * X[:, 3]
         + 2.0 * rng.normal(0, 1, n))
    return X, y


def _folds(n, k=3, seed=1):
    assign = np.random.default_rng(seed).permutation(n) % k
    return np.stack([assign != i for i in range(k)])


@pytest.fixture(scope="module")
def data():
    X, y = _general()
    return X, y, R.Dataset(X, label=y), P.Dataset(X, label=y, device="cpu")


def test_fused_batch_matches_reference(data):
    X, y, rd, pd = data
    fm = _folds(len(y))
    want = r_run(rd, [r_params(c) for c in CONFIGS], fm, 25, 5, 7)
    got = pf.run_fused_cv_batch(pd, [p_params(c) for c in CONFIGS], fm, 25,
                                5, 7)
    assert got[4] == want[4] == "l2"
    assert got[3] == want[3] and 5 < got[3] <= 25            # rounds_run
    assert np.array_equal(got[1], want[1])                    # best_iter
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)    # best_score
    assert np.array_equal(np.isnan(got[0]), np.isnan(want[0]))
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)    # history


def test_dyadic_round1_predictions_bit_equal():
    n = 3000
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (n, 6)).astype(np.float32)
    order = np.argsort(X @ rng.normal(0, 1, 6) + 0.6 * np.sin(X[:, 0] * 2))
    y = np.zeros(n, np.float32)
    y[order[n // 2:]] = 1.0
    cfgs = [dict(BASE, learning_rate=0.1, min_data_in_leaf=5),
            dict(BASE, learning_rate=0.3, min_data_in_leaf=40)]
    fm = _folds(n)
    rp = RProgram(R.Dataset(X, label=y), [r_params(c) for c in cfgs], fm, 25,
                  5, 7)
    pp = pf.FusedCVProgram(P.Dataset(X, label=y, device="cpu"),
                           [p_params(c) for c in cfgs], fm, 25, 5, 7)
    rc, pc = rp.step(rp.init(), 1), pp.step(pp.init(), 1)
    assert np.array_equal(np.asarray(rc.pred), pc.pred.numpy())
    np.testing.assert_allclose(pc.history[0].numpy(),
                               np.asarray(rc.history)[0], rtol=RTOL)


def test_cv_default_route_matches_reference(data):
    X, y, rd, pd = data
    params = dict(CONFIGS[0], learning_rate=0.2)
    want = R.cv(params, rd, 30, nfold=3, early_stopping_rounds=5, seed=5)
    got = P.cv(params, pd, 30, nfold=3, early_stopping_rounds=5, seed=5)
    assert sorted(got) == sorted(want)
    assert got.best_iter == want.best_iter and 1 <= got.best_iter < 30
    for k in want:
        assert len(got[k]) == len(want[k]) == got.best_iter
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7)
    assert got.best_score < 0
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)


def test_route_eligibility(data, monkeypatch):
    X, y, rd, pd = data
    calls = []
    real = pf.run_fused_cv_batch

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pf, "run_fused_cv_batch", spy)
    params = dict(CONFIGS[1], num_leaves=7)
    P.cv(params, pd, 3, nfold=3)
    assert len(calls) == 1
    seen = []
    res = P.cv(params, pd, 3, nfold=3, callbacks=[lambda env: seen.append(1)])
    res2 = P.cv(params, pd, 3, nfold=3, return_cvbooster=True)
    assert len(calls) == 1 and len(seen) == 3
    assert len(res2.cvbooster.boosters) == 3 and res.best_iter >= 1
    assert pf.fused_cv_eligible(p_params(params), None, None)
    assert not pf.fused_cv_eligible(p_params(dict(params, boosting="dart")),
                                    None, None)


def test_cv_wave_regime_matches_reference(data):
    X, y, rd, pd = data
    params = dict(CONFIGS[0], num_leaves=31, learning_rate=0.2,
                  grow_policy="frontier")
    want = R.cv(params, rd, 30, nfold=3, early_stopping_rounds=5, seed=3)
    got = P.cv(params, pd, 30, nfold=3, early_stopping_rounds=5, seed=3)
    assert got.best_iter == want.best_iter and 1 <= got.best_iter < 30
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)


def test_wave_regime_raises_by_name(data):
    """int8 in the wave regime trains (its batched histograms run at full
    precision, so it equals f32); a mesh learner on the fused route trains
    the fused program, as the reference's fused route does (it never
    consults ``tree_learner``), so it equals the serial result."""
    X, y, rd, pd = data
    base = dict(CONFIGS[0], grow_policy="frontier", num_leaves=7)
    q8 = P.cv(dict(base, hist_dtype="int8"), pd, 3, nfold=3)
    f32 = P.cv(dict(base, hist_dtype="f32"), pd, 3, nfold=3)
    assert q8.best_iter == f32.best_iter
    for k in f32:
        np.testing.assert_array_equal(q8[k], f32[k])
    dp = P.cv(dict(base, hist_dtype="f32", tree_learner="data"), pd, 3,
              nfold=3)
    assert dp.best_iter == f32.best_iter
    for k in f32:
        np.testing.assert_array_equal(dp[k], f32[k])


def test_carry_round_trip_continues_identically(data):
    X, y, rd, pd = data
    fm = _folds(len(y))
    params = [p_params(dict(c, num_leaves=7)) for c in CONFIGS]
    full = pf.FusedCVProgram(pd, params, fm, 12, 0, 3)
    c_full = full.step(full.init(), 12)
    prog = pf.FusedCVProgram(pd, params, fm, 12, 0, 3)
    arrays = prog.carry_arrays(prog.step(prog.init(), 5))
    assert int(arrays["r"]) == 5 and arrays["pred"].dtype == np.float32
    again = pf.FusedCVProgram(pd, params, fm, 12, 0, 3)
    c_resumed = again.step(again.restore_carry(arrays), 12)
    for f in ("pred", "bag", "history", "best_score", "best_iter", "done"):
        a, b = getattr(c_full, f), getattr(c_resumed, f)
        assert torch.equal(a, b) if f != "history" else \
            torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0)), f
    res = again.finalize(c_resumed)
    assert res.rounds_run == 12 and res.history.shape == (12, 2, 3)
