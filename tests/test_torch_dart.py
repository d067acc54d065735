"""Port parity: ``boosting="dart"`` (dropout trees, Rashmi &
Gilad-Bachrach, AISTATS 2015; upstream ``dart.hpp``) against the reference
on the CPU.

(a) 8 rounds at ``drop_rate=0.5, skip_drop=0`` so that rounds drop trees:
    upstream and ``xgboost_dart_mode`` normalisation, ``max_drop=2``,
    3-class DART, a ``reset_parameter`` learning-rate schedule (no rate is
    baked into DART's stored leaves, in either package) and
    ``uniform_drop=True`` (parsed and unused by both packages, so the same
    model as ``False``).  The drop sequence is the reference's host draw,
    and the stored leaves after every rescaling, the metrics per round and
    the predictions agree within the parity regime (rtol 1e-5, atol 1e-6);
(b) a valid set with early stopping, and per-fold ``cv()``;
(c) ``train_resumable`` killed after any round and resumed is bit-identical
    to the uninterrupted run (the checkpoint carries the rescaled leaves);
(d) text and packed ``.npz`` model files interchange both ways;
(e) ``predict`` and a served forest right after a drop round see the
    rescaled leaves (no stale stacked forest or node table survives);
(f) the sklearn estimator and ``task=train`` of the CLI take ``dart``
    (and ``goss``).
"""

import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.models.gbdt import dart_drops
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster
from lightgbm_tpu_torch.training import (list_checkpoints, resume_booster,
                                         train_resumable)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves", "count")
DART = dict(boosting="dart", drop_rate=0.5, skip_drop=0.0, num_leaves=15,
            min_data_in_leaf=5, max_bin=63, learning_rate=0.2, verbose=-1,
            seed=5, objective="regression")
ROUNDS = 8
CASES = {
    "upstream": {},
    "xgboost": {"xgboost_dart_mode": True},
    "max_drop": {"max_drop": 2},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "reset_lr": {},
    "uniform_drop": {"uniform_drop": True},
}


def _problem(n=1500, seed=3, classes=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    s = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + 0.5 * X[:, 2] * X[:, 3] \
        + 0.1 * rng.normal(size=n)
    if classes:
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    else:
        y = s.astype(np.float32)
    return X, y


def _train(pkg, params, X, y, case, **kw):
    """8 rounds with the training metric recorded, and a valid set's but
    for multiclass (whose per-class replays the reference compiles per
    dropped-tree count and row count)."""
    tr, va = slice(0, 1200), slice(1200, None)
    dtr = pkg.Dataset(X[tr], label=y[tr], **kw)
    valid = {}
    if case != "multiclass":
        valid = dict(valid_sets=[pkg.Dataset(X[va], label=y[va],
                                             reference=dtr)],
                     valid_names=["valid"])
    hist = {}
    cbs = [pkg.record_evaluation(hist)]
    if case == "reset_lr":
        cbs.append(pkg.reset_parameter(
            learning_rate=[0.2 * 0.8 ** i for i in range(ROUNDS)]))
    b = pkg.train(dict(params, is_provide_training_metric=True), dtr, ROUNDS,
                  callbacks=cbs, **valid)
    return b, hist


@functools.lru_cache(maxsize=None)
def _trained(case):
    params = dict(DART, **CASES[case])
    X, y = _problem(classes=params.get("num_class", 0))
    out = {"ref": _train(R, params, X, y, case),
           "port": _train(P, params, X, y, case, device="cpu")}
    return case, params, X, out


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    return _trained(request.param)


def _assert_trees(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for ta, tb in zip(ref_trees, port_trees):
        a, b = r_arrays(ta), p_arrays(tb)
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)


def test_dart_train_matches_reference(trained):
    case, params, X, out = trained
    (rb, rhist), (pb, phist) = out["ref"], out["port"]
    p = pb.params
    drops = [dart_drops(p, i, i) for i in range(ROUNDS)]
    assert sum(map(len, drops)) >= ROUNDS            # rounds did drop trees
    if case == "max_drop":
        assert max(map(len, drops)) == 2
    _assert_trees(rb.trees, pb.trees)
    for ds in rhist:
        for m in rhist[ds]:
            np.testing.assert_allclose(phist[ds][m], rhist[ds][m],
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pb.predict(X[:400], raw_score=True),
                               rb.predict(X[:400], raw_score=True),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(pb._pred_train.numpy(),
                               np.asarray(rb._pred_train), rtol=RTOL,
                               atol=1e-5)


def test_dart_uniform_drop_is_parsed_and_unused():
    """``uniform_drop`` is parsed and used nowhere, in both packages: the
    model equals the one trained without it."""
    _, _, X, plain = _trained("upstream")
    _, _, _, uniform = _trained("uniform_drop")
    for pkg in ("ref", "port"):
        assert uniform[pkg][0].params.uniform_drop is True
        assert plain[pkg][0].params.uniform_drop is False
        np.testing.assert_array_equal(uniform[pkg][0].predict(X),
                                      plain[pkg][0].predict(X))


def test_dart_drop_sequence_is_the_reference_draw():
    p = P.parse_params(dict(DART, max_drop=3, skip_drop=0.4, seed=9))
    for i in range(1, 30):
        rng = np.random.default_rng(p.drop_seed + p.seed + i * 7919)
        want = []
        if rng.random() >= p.skip_drop:
            want = list(np.flatnonzero(rng.random(i) < p.drop_rate))
            if len(want) > p.max_drop:
                want = sorted(rng.choice(want, p.max_drop, replace=False))
        assert dart_drops(p, i, i) == [int(t) for t in want]
    assert dart_drops(p, 0, 0) == []


# ------------------------------------------- (b) early stopping and cv()
def test_dart_valid_set_early_stopping_matches_reference():
    X, y = _problem(1500, seed=12)
    params = dict(DART, drop_rate=0.2, skip_drop=0.5, learning_rate=0.7)
    tr, va = slice(0, 1200), slice(1200, None)
    got = {}
    for name, pkg, kw in (("ref", R, {}), ("port", P, {"device": "cpu"})):
        dtr = pkg.Dataset(X[tr], label=y[tr], **kw)
        dva = pkg.Dataset(X[va], label=y[va], reference=dtr)
        hist = {}
        b = pkg.train(params, dtr, 20, valid_sets=[dva],
                      valid_names=["valid"], early_stopping_rounds=3,
                      callbacks=[pkg.record_evaluation(hist)])
        got[name] = (b, hist)
    (rb, rh), (pb, ph) = got["ref"], got["port"]
    assert pb.best_iteration == rb.best_iteration
    np.testing.assert_allclose(ph["valid"]["l2"], rh["valid"]["l2"],
                               rtol=RTOL, atol=ATOL)
    # the incremental valid scores track every rescaling
    _, vds, vpred = pb._valid[0]
    np.testing.assert_allclose(
        vpred.numpy()[:300], pb.predict(X[va], num_iteration=pb.num_trees(),
                                        raw_score=True),
        rtol=1e-5, atol=1e-5)


def test_dart_cv_per_fold_matches_reference():
    X, y = _problem(900, seed=4)
    params = dict(DART, num_leaves=7, learning_rate=0.7, skip_drop=0.5)
    want = R.cv(params, R.Dataset(X, label=y), 10, nfold=2,
                stratified=False, seed=2, early_stopping_rounds=2)
    got = P.cv(params, P.Dataset(X, label=y, device="cpu"), 10, nfold=2,
               stratified=False, seed=2, early_stopping_rounds=2)
    assert got.best_iter == want.best_iter
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)
    np.testing.assert_allclose(got["valid l2-mean"], want["valid l2-mean"],
                               rtol=RTOL, atol=ATOL)


# -------------------------------------------------- (c) kill and resume
def test_dart_kill_and_resume_bit_identical(tmp_path):
    X, y = _problem(700, seed=6)
    params = dict(DART, bagging_fraction=0.8, bagging_freq=1,
                  feature_fraction=0.8)

    def ds():
        return P.Dataset(X, label=y, params=dict(params), device="cpu")

    whole = P.Booster(dict(params), ds())
    for _ in range(ROUNDS):
        whole.update()
    d = str(tmp_path / "ck")
    res = train_resumable(dict(params), ds(), ROUNDS, checkpoint_dir=d,
                          checkpoint_rounds=1, keep_last=ROUNDS + 1,
                          resume=False)
    for k, path in [(0, None)] + list(zip(range(1, ROUNDS),
                                          list_checkpoints(d))):
        b = res.booster if path is None else resume_booster(path, ds())
        for _ in range(ROUNDS - b._iter):
            b.update()
        for ta, tb in zip(whole.trees, b.trees):
            x, z = p_arrays(ta), p_arrays(tb)
            for f in x:
                assert np.array_equal(x[f], z[f]), (k, f)
        assert torch.equal(whole._pred_train, b._pred_train)
        np.testing.assert_array_equal(b.predict(X), whole.predict(X))


# -------------------------------------------- (d) model files, (e) serving
@pytest.mark.parametrize("suffix", ["txt", "npz"])
def test_dart_model_files_interchange(tmp_path, suffix):
    _, _, X, out = _trained("upstream")
    rb, pb = out["ref"][0], out["port"][0]
    for b, other, tag in ((pb, R, "port"), (rb, P, "ref")):
        path = str(tmp_path / f"{tag}.{suffix}")
        b.save_model(path)
        kw = {"device": "cpu"} if other is P else {}
        back = other.Booster(model_file=path, **kw)
        np.testing.assert_allclose(back.predict(X[:300]), b.predict(X[:300]),
                                   rtol=1e-6, atol=1e-6)


def test_dart_predict_and_serving_see_rescaled_leaves():
    X, y = _problem(800, seed=8)
    b = P.Booster(dict(DART), P.Dataset(X, label=y, device="cpu"))
    for _ in range(3):
        b.update()
    rt = PredictorRuntime(pack_booster(b), max_bucket=256, device="cpu")
    before = b.predict(X[:200], raw_score=True)
    np.testing.assert_allclose(rt.predict(X[:200], raw_score=True), before,
                               rtol=1e-6, atol=1e-6)
    while not dart_drops(b.params, b._iter, len(b.trees)):
        b.update()
    dropped = dart_drops(b.params, b._iter, len(b.trees))
    old = [b.trees[t].leaf_value.clone() for t in dropped]
    b.update()                                       # a drop round
    for t, lv in zip(dropped, old):
        assert not torch.equal(b.trees[t].leaf_value, lv)
    fresh = P.Booster(model_str=b.model_to_string(), device="cpu")
    want = fresh.predict(X[:200], raw_score=True)
    np.testing.assert_allclose(b.predict(X[:200], raw_score=True), want,
                               rtol=1e-6, atol=1e-6)
    rt = PredictorRuntime(pack_booster(b), max_bucket=256, device="cpu")
    np.testing.assert_allclose(rt.predict(X[:200], raw_score=True), want,
                               rtol=1e-6, atol=1e-6)


def test_dart_sklearn_estimator_trains_dart():
    X, y = _problem(600)
    kw = dict(boosting_type="dart", n_estimators=4, num_leaves=7,
              min_child_samples=5, random_state=3, verbose=-1)
    est = P.LGBMRegressor(device="cpu", **kw).fit(X, y)
    assert est.booster_.params.boosting == "dart"
    want = P.train(dict(boosting="dart", num_leaves=7, min_data_in_leaf=5,
                        seed=3, verbose=-1, objective="regression"),
                   P.Dataset(X, label=y, device="cpu"), 4)
    np.testing.assert_array_equal(est.predict(X[:200]), want.predict(X[:200]))


@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_cli_task_train_goss_and_dart(tmp_path, boosting):
    """``task=train boosting=goss|dart`` through the CLI writes the model
    ``train`` makes from the same rows and params."""
    from lightgbm_tpu_torch.__main__ import main as port_main

    X, y = _problem(600, seed=9)
    csv = tmp_path / "train.csv"
    with open(csv, "w") as f:
        f.write("a,b,c,d,e,y\n")
        for xr, yv in zip(X, y):
            f.write(",".join(f"{v:.9g}" for v in (*xr, yv)) + "\n")
    model = str(tmp_path / "m.txt")
    assert port_main(["task=train", f"data={csv}", "header=true",
                      "label_column=name:y", "objective=regression",
                      f"boosting={boosting}", "num_trees=5",
                      "num_leaves=7", "verbose=-1", "device=cpu",
                      f"output_model={model}"]) == 0
    got = P.Booster(model_file=model, device="cpu")
    assert got.params.boosting == boosting and got.num_trees() == 5
    Xc = np.loadtxt(csv, delimiter=",", skiprows=1)
    want = P.train(dict(objective="regression", boosting=boosting,
                        num_leaves=7, verbose=-1),
                   P.Dataset(Xc[:, :5], label=Xc[:, 5], device="cpu"), 5)
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=1e-6,
                               atol=1e-6)
