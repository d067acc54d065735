"""Port parity: multiclass training (``multiclass.py``, the Booster's class
batch, fused ``cv()`` over configs x folds x classes, model files) against
the reference on the CPU with the plain versions of kernels B3, B5 and B6.

* objectives and metrics: ``grad_hess`` and the transforms of
  ``multiclass`` and ``multiclassova`` within 4 f32 ulps of 1, relative and
  absolute (XLA's f32 ``exp`` is not torch's, and ``p - 1`` keeps the
  absolute error of ``p``),
  ``init_score`` (log class priors) equal, ``multi_logloss`` and
  ``multi_error`` within rtol 1e-6;
* dyadic tier: 4 classes at a zero init score (``boost_from_average``
  off), so every round-1 probability is 1/4, every gradient 1/4 or -3/4 and
  every hessian 3/8: the K round-1 trees and the predictions are
  bit-identical, on the batched strict grower (fewer than 4,096 rows) and
  on the batched wave grower (exact tail);
* general data, three rounds: split structure and row routing equal, leaf
  values and predictions within rtol 1e-5 / atol 1e-6.  Softmax gradients
  differ by an ulp where the two ``exp`` differ, so near-tied splits could
  swap; seed 4 (wave) and seed 5 (strict) have no near-tie in three rounds;
* fused ``cv()`` (3 folds, early stopping): the same route, keys and
  trees as the reference's, ``best_iter`` equal, the ``multi_logloss``
  history within rtol 1e-5;
* model files: a multiclass model saved as JSON text or packed ``.npz`` by
  either package loads in the other and predicts the same ``[n, K]``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.config import parse_params as r_params
from lightgbm_tpu.metrics import get_metric as r_metric
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.objectives import create_objective as r_objective
from lightgbm_tpu_torch.config import parse_params as p_params
from lightgbm_tpu_torch.metrics import get_metric as p_metric
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.objectives import create_objective as p_objective


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batched growers run thousands of small ops,
    which several test workers' thread pools, each as wide as the machine,
    would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
K = 4
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves")
BASE = dict(objective="multiclass", num_class=K, num_leaves=16,
            learning_rate=0.3, min_data_in_leaf=20, max_bin=31, verbose=-1)
WAVE, STRICT = 5000, 3000          # rows: the wave batch, the strict batch


def _data(n, seed, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f))
    W = np.random.default_rng(99).normal(0, 1, (f, K))
    y = np.argmax(X @ W + rng.gumbel(size=(n, K)), axis=1).astype(np.float64)
    return X, y


def _train_both(params, X, y, rounds, **kw):
    br = R.train(params, R.Dataset(X, label=y), rounds, **kw)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), rounds, **kw)
    return br, bp


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_objective_and_metrics_match_reference(objective):
    rng = np.random.default_rng(1)
    n = 500
    pred = rng.normal(0, 2, (n, K)).astype(np.float32)
    y = rng.integers(0, K, n).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    params = dict(objective=objective, num_class=K)
    ro, po = r_objective(r_params(params)), p_objective(p_params(params))
    np.testing.assert_array_equal(po.init_score(y, w), ro.init_score(y, w))
    rg, rh = ro.grad_hess(jnp.asarray(pred), jnp.asarray(y), jnp.asarray(w))
    pg, ph = po.grad_hess(torch.from_numpy(pred), torch.from_numpy(y),
                          torch.from_numpy(w))
    ulp = 4 * np.finfo(np.float32).eps
    np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=ulp,
                               atol=ulp)
    np.testing.assert_allclose(ph.numpy(), np.asarray(rh), rtol=ulp,
                               atol=ulp)
    rp = np.asarray(ro.transform(jnp.asarray(pred)))
    pp = po.transform(torch.from_numpy(pred)).numpy()
    np.testing.assert_allclose(pp, rp, rtol=ulp, atol=ulp)
    for name in ("multi_logloss", "multi_error"):
        want = float(r_metric(name).fn(jnp.asarray(rp), jnp.asarray(y),
                                       jnp.asarray(w)))
        got = float(p_metric(name).fn(torch.from_numpy(rp),
                                      torch.from_numpy(y),
                                      torch.from_numpy(w)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("grower", ["strict", "wave"])
def test_dyadic_round1_bit_identical(grower):
    n = STRICT if grower == "strict" else WAVE
    X, y = _data(n, 2)
    params = dict(BASE, boost_from_average=False, hist_dtype="f32")
    br, bp = _train_both(params, X, y, 1)
    a, b = r_arrays(br.trees[0]), p_arrays(bp.trees[0])
    assert a["split_feature"].shape[0] == K
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert (b["num_leaves"] > 8).all()
    np.testing.assert_array_equal(bp.predict(X, raw_score=True),
                                  br.predict(X, raw_score=True))


@pytest.mark.parametrize("grower", ["strict", "wave"])
def test_general_three_rounds(grower):
    n = STRICT if grower == "strict" else WAVE
    X, y = _data(n, 5 if grower == "strict" else 4)
    params = dict(BASE, bagging_fraction=0.8, bagging_freq=1,
                  feature_fraction=0.8)
    br, bp = _train_both(params, X, y, 3)
    assert bp.num_model_per_iteration() == K and bp.num_trees() == 3
    for tr, tp in zip(br.trees, bp.trees):
        a, b = r_arrays(tr), p_arrays(tp)
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)
    for raw in (True, False):
        got, want = bp.predict(X, raw_score=raw), br.predict(X, raw_score=raw)
        assert got.shape == want.shape == (n, K)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bp.predict(X, num_iteration=1),
                               br.predict(X, num_iteration=1), rtol=RTOL,
                               atol=ATOL)


def test_valid_set_and_early_stopping():
    X, y = _data(STRICT, 5)
    Xv, yv = _data(1000, 6)
    params = dict(BASE, learning_rate=0.5, metric="multi_logloss")
    res_r, res_p = {}, {}
    br = R.train(params, R.Dataset(X, label=y), 8,
                 valid_sets=[R.Dataset(Xv, label=yv)], valid_names=["v"],
                 early_stopping_rounds=2, evals_result=res_r)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), 8,
                 valid_sets=[P.Dataset(Xv, label=yv, device="cpu")],
                 valid_names=["v"], early_stopping_rounds=2,
                 evals_result=res_p)
    assert bp.best_iteration == br.best_iteration
    np.testing.assert_allclose(res_p["v"]["multi_logloss"],
                               res_r["v"]["multi_logloss"], rtol=RTOL)


def test_fused_cv_matches_reference():
    X, y = _data(STRICT, 5)
    params = dict(BASE, learning_rate=0.5, bagging_fraction=0.8,
                  bagging_freq=2)
    want = R.cv(params, R.Dataset(X, label=y), 12, nfold=3,
                early_stopping_rounds=2, seed=3)
    got = P.cv(params, P.Dataset(X, label=y, device="cpu"), 12, nfold=3,
               early_stopping_rounds=2, seed=3)
    assert sorted(got) == sorted(want) == ["valid multi_logloss-mean",
                                           "valid multi_logloss-stdv"]
    assert got.best_iter == want.best_iter and 1 <= got.best_iter < 12
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)


@pytest.mark.parametrize("fmt", ["txt", "npz"])
def test_model_files_both_ways(fmt, tmp_path):
    X, y = _data(STRICT, 5)
    params = dict(BASE, num_leaves=7)
    br, bp = _train_both(params, X, y, 2)
    p_path, r_path = str(tmp_path / f"p.{fmt}"), str(tmp_path / f"r.{fmt}")
    bp.save_model(p_path)
    br.save_model(r_path)
    in_ref = R.Booster(model_file=p_path)
    in_port = P.Booster(model_file=r_path, device="cpu")
    assert in_port.num_model_per_iteration() == K
    for raw in (True, False):
        np.testing.assert_allclose(in_ref.predict(X, raw_score=raw),
                                   bp.predict(X, raw_score=raw), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(in_port.predict(X, raw_score=raw),
                                   br.predict(X, raw_score=raw), rtol=1e-6,
                                   atol=1e-7)
