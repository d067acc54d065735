"""Port parity: ``boosting="rf"`` (bagged forests) with per-node column
sampling, against the reference on the CPU.

(a) ``train`` single-class (l2, strict and wave growers) and 3-class
    multiclass: the trees' structure, the metrics ``eval_train`` (the mean
    over the trees, ``_pred_train`` staying at the init score) and the valid
    sets (scores replayed at shrink 1.0 and averaged) report per round, and
    ``predict`` averaged over ``num_iteration`` trees, within the parity
    regime (rtol 1e-5, atol 1e-6);
(b) the text model and the packed ``.npz`` carry an rf forest both ways
    (shrink 1.0 in the packed file), and the served forest
    (``PredictorRuntime``) predicts what ``Booster.predict`` does;
(c) rf ``cv()`` takes the per-fold route, with early stopping;
(d) checkpoints of an rf + bynode run: killed after any round and resumed
    it is bit-identical to the uninterrupted run; a checkpoint of either
    package resumes in the other.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.training as RT
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.serving.packed import PackedForest as RPacked
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.serving import (PackedForest, PredictorRuntime,
                                        pack_booster)
from lightgbm_tpu_torch.training import (list_checkpoints, resume_booster,
                                         save_checkpoint, train_resumable)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the strict and fused growers run many small
    ops, which several test workers' thread pools would contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves", "count")
RF = dict(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
          feature_fraction_bynode=0.5, num_leaves=15, min_data_in_leaf=5,
          max_bin=63, verbose=-1, seed=5)
CASES = {
    "strict": dict(objective="regression"),
    "wave": dict(objective="regression", grow_policy="frontier"),
    "multiclass": dict(objective="multiclass", num_class=3),
}
ROUNDS = 4


def _problem(case, n=2000, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    s = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n)
    if case == "multiclass":
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    else:
        y = s.astype(np.float32)
    return X, y


def _trained(case):
    params = dict(RF, **CASES[case])
    X, y = _problem(case)
    tr, va = slice(0, 1600), slice(1600, None)
    out = {}
    for name, pkg, kw in (("ref", R, {}), ("port", P, {"device": "cpu"})):
        dtr = pkg.Dataset(X[tr], label=y[tr], **kw)
        dva = pkg.Dataset(X[va], label=y[va], reference=dtr)
        hist = {}
        b = pkg.train(dict(params, is_provide_training_metric=True), dtr,
                      ROUNDS, valid_sets=[dva], valid_names=["valid"],
                      callbacks=[pkg.record_evaluation(hist)])
        out[name] = (b, hist)
    return params, X, y, out


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    return request.param, _trained(request.param)


def test_rf_train_matches_reference(trained):
    case, (params, X, y, out) = trained
    (rb, rhist), (pb, phist) = out["ref"], out["port"]
    assert len(pb.trees) == ROUNDS
    for ta, tb in zip(rb.trees, pb.trees):
        a, b = r_arrays(ta), p_arrays(tb)
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)
    assert phist.keys() == rhist.keys() == {"training", "valid"}
    for ds in rhist:
        for m in rhist[ds]:
            np.testing.assert_allclose(phist[ds][m], rhist[ds][m],
                                       rtol=RTOL, atol=ATOL)
    # _pred_train stays at the init score; eval_train sees the tree mean
    assert torch.equal(pb._pred_train, pb._init_scores(
        int(pb._pred_train.shape[0])))
    X = X[:500]
    for k, raw in ((None, False), (3, True)):
        np.testing.assert_allclose(
            pb.predict(X, num_iteration=k, raw_score=raw),
            rb.predict(X, num_iteration=k, raw_score=raw),
            rtol=RTOL, atol=ATOL)
    # averaging: one tree's raw prediction is that tree's value plus init
    one = pb.predict(X, num_iteration=1, raw_score=True)
    assert not np.allclose(one, pb.predict(X, raw_score=True))


def test_rf_model_files_round_trip(trained, tmp_path):
    case, (params, X, y, out) = trained
    rb, pb = out["ref"][0], out["port"][0]
    X = X[:500]
    want = pb.predict(X)
    for suffix in ("txt", "npz"):
        path = str(tmp_path / f"port.{suffix}")
        pb.save_model(path)
        np.testing.assert_allclose(R.Booster(model_file=path).predict(X),
                                   want, rtol=RTOL, atol=ATOL)
        back = P.Booster(model_file=path, device="cpu")
        np.testing.assert_allclose(back.predict(X), want, rtol=1e-6,
                                   atol=ATOL)
        rpath = str(tmp_path / f"ref.{suffix}")
        rb.save_model(rpath)
        np.testing.assert_allclose(
            P.Booster(model_file=rpath, device="cpu").predict(X),
            rb.predict(X), rtol=1e-6, atol=ATOL)
    packed = PackedForest.load(str(tmp_path / "port.npz"))
    assert packed.shrink == RPacked.load(str(tmp_path / "ref.npz")).shrink \
        == 1.0


def test_rf_served_forest_matches_predict(trained):
    case, (params, X, y, out) = trained
    pb = out["port"][0]
    rt = PredictorRuntime(pack_booster(pb), max_bucket=256, device="cpu")
    for k in (None, 2):
        for raw in (False, True):
            np.testing.assert_allclose(
                rt.predict(X[:300], num_iteration=k, raw_score=raw),
                pb.predict(X[:300], num_iteration=k, raw_score=raw),
                rtol=RTOL, atol=ATOL)


def test_rf_cv_per_fold_with_early_stopping():
    X, y = _problem("strict", n=1500)
    params = dict(RF, objective="regression", num_leaves=7)
    want = R.cv(params, R.Dataset(X, label=y), 30, nfold=3,
                stratified=False, seed=2, early_stopping_rounds=3)
    got = P.cv(params, P.Dataset(X, label=y, device="cpu"), 30, nfold=3,
               stratified=False, seed=2, early_stopping_rounds=3)
    assert got.best_iter == want.best_iter < 30
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)
    np.testing.assert_allclose(got["valid l2-mean"], want["valid l2-mean"],
                               rtol=RTOL, atol=ATOL)


CKPT = dict(RF, objective="binary", num_leaves=7, max_bin=31,
            feature_fraction=0.8)


def _ckpt_problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(700, 5)).astype(np.float32)
    s = X @ rng.normal(size=5) + 0.3 * rng.normal(size=700)
    y = (rng.random(700) < 1 / (1 + np.exp(-s))).astype(np.float32)
    return X, y


def _same_run(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        x, z = p_arrays(ta), p_arrays(tb)
        for k in x:
            assert np.array_equal(x[k], z[k]), k
    assert torch.equal(a._pred_train, b._pred_train)
    assert torch.equal(a._bag, b._bag)


def test_rf_bynode_kill_and_resume_bit_identical(tmp_path):
    X, y = _ckpt_problem()

    def ds():
        return P.Dataset(X, label=y, params=dict(CKPT), device="cpu")

    whole = P.Booster(dict(CKPT), ds())
    for _ in range(ROUNDS):
        whole.update()
    d = str(tmp_path / "ck")
    res = train_resumable(dict(CKPT), ds(), ROUNDS, checkpoint_dir=d,
                          checkpoint_rounds=1, keep_last=ROUNDS + 1,
                          resume=False)
    _same_run(whole, res.booster)
    for k, path in zip(range(1, ROUNDS), list_checkpoints(d)):
        b = resume_booster(path, ds())
        assert b._iter == k
        for _ in range(ROUNDS - k):
            b.update()
        _same_run(whole, b)
        np.testing.assert_array_equal(b.predict(X), whole.predict(X))


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_rf_bynode_checkpoints_interchange(tmp_path, direction):
    X, y = _ckpt_problem()
    at = 2
    ref = R.Booster(dict(CKPT), R.Dataset(X, label=y, params=dict(CKPT)))
    port = P.Booster(dict(CKPT), P.Dataset(X, label=y, params=dict(CKPT),
                                           device="cpu"))
    for _ in range(at):
        ref.update()
        port.update()
    if direction == "ref_to_port":
        path = RT.save_checkpoint(ref, str(tmp_path / "ref"))
        resumed = resume_booster(path, P.Dataset(X, label=y,
                                                 params=dict(CKPT),
                                                 device="cpu"))
        want, _ = RT.load_checkpoint(path)
        got, _ = resumed.checkpoint_state()
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        other = ref
    else:
        path = save_checkpoint(port, str(tmp_path / "port"))
        resumed = RT.resume_booster(path, R.Dataset(X, label=y,
                                                    params=dict(CKPT)))
        assert np.array_equal(np.asarray(resumed._key), port._key)
        other = port
    for _ in range(ROUNDS - at):
        resumed.update()
        other.update()
    for ta, tb in zip(resumed.trees, other.trees):
        a = (r_arrays if direction == "port_to_ref" else p_arrays)(ta)
        b = (p_arrays if direction == "port_to_ref" else r_arrays)(tb)
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), k
    np.testing.assert_allclose(resumed.predict(X), other.predict(X),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("given", [{}, {"bagging_fraction": 0.5},
                                   {"bagging_freq": 3}])
def test_rf_forces_bagging_as_reference(given):
    """rf needs bagging: both packages' configs fill in LightGBM's
    bootstrap-sized bag the same way."""
    want = R.parse_params(dict(given, boosting="rf"))
    got = P.parse_params(dict(given, boosting="rf"))
    assert (got.bagging_fraction, got.bagging_freq) == \
        (want.bagging_fraction, want.bagging_freq)
    assert 0.0 < got.bagging_fraction < 1.0 and got.bagging_freq >= 1
