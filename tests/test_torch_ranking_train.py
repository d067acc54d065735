"""Port parity: ranking training against the reference on the CPU.

(a) ``train`` with ``objective="lambdarank"`` for 4 rounds on the wave
    grower (4,545 rows over 300 queries, 31 leaves: the exact wave tail)
    and on the strict grower (40 queries of 8-24 documents), with a grouped
    valid set: tree structure equal, ``ndcg@k`` / ``map@k`` histories and
    predictions within the parity regime (rtol 1e-5, atol 1e-6), leaf
    values within rtol 1e-5, atol 1e-5 (ROADMAP C.5);
(b) ``eval_valid``/``eval_train`` names, flags and values, and early
    stopping on the higher-better ``ndcg@k``;
(c) ``cv()`` on a grouped Dataset: whole-query folds equal to the
    reference's index arrays, each fold's groups cut from its rows, the
    per-round means and ``best_iter`` as the reference's;
(d) ``LGBMRanker.fit(group=, eval_set=, eval_group=, eval_at=)``;
(e) text and packed ``.npz`` model files of a ranker interchange both ways
    and serve raw scores; a killed lambdarank run resumes bit-identical
    (the groups re-packed from the Dataset);
(f) lambdarank under GOSS and DART, 3 rounds each, as the reference.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.engine as RE
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.engine as PE
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.models.gbdt import resolve_wave_width
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
# ROADMAP C.5: a query's lambdas sum to zero, so a leaf's gradient sum
# cancels and the f32 histogram sums' order ulps (the general regime) reach
# 5e-6 on a leaf of 0.27 by round 3 of the wave case; leaf values are held
# to this absolute tolerance, predictions and metrics to the regime
LEAF_ATOL = 1e-5
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves", "count")
ROUNDS = 4


def make_ranked(n_queries=120, docs_lo=8, docs_hi=24, f=6, seed=0):
    """The reference test's ranked data: a hidden utility, graded labels
    0-4 by within-query quantile."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(docs_lo, docs_hi + 1, n_queries)
    n = int(sizes.sum())
    X = rng.normal(0, 1, (n, f))
    u = (1.2 * X[:, 0] + np.sin(2 * X[:, 1]) + 0.6 * X[:, 2] ** 2
         + 0.3 * rng.normal(0, 1, n))
    y = np.zeros(n, np.float64)
    start = 0
    for s in sizes:
        ranks = u[start:start + s].argsort().argsort()
        y[start:start + s] = np.minimum(4, (5 * ranks) // s)
        start += s
    return X, y, sizes


RANK = dict(objective="lambdarank", min_data_in_leaf=5, verbose=-1,
            learning_rate=0.1, eval_at=[3, 5], metric=["ndcg", "map"])
GROWERS = {
    "wave": (dict(n_queries=300, docs_lo=10, docs_hi=20, seed=1),
             dict(num_leaves=31)),
    "strict": (dict(n_queries=40, seed=5), dict(num_leaves=15)),
}


def _assert_trees(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for ta, tb in zip(ref_trees, port_trees):
        a, b = r_arrays(ta), p_arrays(tb)
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=LEAF_ATOL)


@pytest.fixture(scope="module", params=sorted(GROWERS))
def trained(request):
    data_kw, extra = GROWERS[request.param]
    X, y, sizes = make_ranked(**data_kw)
    Xv, yv, sv = make_ranked(n_queries=30, seed=data_kw["seed"] + 50)
    params = dict(RANK, **extra)
    out = {}
    for name, pkg, kw in (("ref", R, {}), ("port", P, {"device": "cpu"})):
        dtr = pkg.Dataset(X, label=y, group=sizes, **kw)
        dva = pkg.Dataset(Xv, label=yv, group=sv, reference=dtr)
        hist = {}
        b = pkg.train(dict(params, is_provide_training_metric=True), dtr,
                      ROUNDS, valid_sets=[dva], valid_names=["va"],
                      callbacks=[pkg.record_evaluation(hist)])
        out[name] = (b, hist)
    return request.param, params, (X, y, sizes), (Xv, yv, sv), out


# --------------------------------------------------------------- (a) train
def test_lambdarank_train_matches_reference(trained):
    grower, params, (X, _, _), (Xv, _, _), out = trained
    (rb, rhist), (pb, phist) = out["ref"], out["port"]
    width = resolve_wave_width(pb.params, int(pb.train_set.row_mask.shape[0]))
    if grower == "wave":
        assert width >= 1024              # the exact tail (ranking default)
    else:
        assert width == 1
    _assert_trees(rb.trees, pb.trees)
    assert phist.keys() == rhist.keys() == {"training", "va"}
    for ds in rhist:
        assert set(phist[ds]) == set(rhist[ds]) == {
            "ndcg@3", "ndcg@5", "map@3", "map@5"}
        for m in rhist[ds]:
            np.testing.assert_allclose(phist[ds][m], rhist[ds][m],
                                       rtol=RTOL, atol=ATOL)
    for data in (X, Xv):
        np.testing.assert_allclose(pb.predict(data), rb.predict(data),
                                   rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- (b) evaluation
def test_eval_valid_and_train_names_and_values(trained):
    _, _, _, _, out = trained
    rb, pb = out["ref"][0], out["port"][0]
    for call in ("eval_valid", "eval_train"):
        want, got = getattr(rb, call)(), getattr(pb, call)()
        assert [r[:2] + r[3:] for r in got] == [r[:2] + r[3:] for r in want]
        assert all(r[3] and 0.0 <= r[2] <= 1.0 for r in got)
        np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                                   rtol=RTOL, atol=ATOL)


def test_early_stopping_on_ndcg_at_k():
    X, y, sizes = make_ranked(n_queries=40, seed=12)
    Xv, yv, sv = make_ranked(n_queries=15, seed=13)
    params = dict(RANK, num_leaves=7, eval_at=[5], metric="ndcg",
                  learning_rate=0.5, first_metric_only=True)
    got = {}
    for name, pkg, kw in (("ref", R, {}), ("port", P, {"device": "cpu"})):
        dtr = pkg.Dataset(X, label=y, group=sizes, **kw)
        dva = pkg.Dataset(Xv, label=yv, group=sv, reference=dtr)
        hist = {}
        b = pkg.train(params, dtr, 40, valid_sets=[dva], valid_names=["va"],
                      early_stopping_rounds=3,
                      callbacks=[pkg.record_evaluation(hist)])
        got[name] = (b.best_iteration, b.best_score, hist)
    (rbest, rscore, rhist), (pbest, pscore, phist) = got["ref"], got["port"]
    assert pbest == rbest and 1 <= pbest < 40
    assert len(phist["va"]["ndcg@5"]) == len(rhist["va"]["ndcg@5"]) < 40
    np.testing.assert_allclose(phist["va"]["ndcg@5"], rhist["va"]["ndcg@5"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pscore["va"]["ndcg@5"],
                               rscore["va"]["ndcg@5"], rtol=RTOL)


# -------------------------------------------------------------------- (c) cv
def test_group_aware_cv_matches_reference():
    X, y, sizes = make_ranked(n_queries=40, seed=5)
    for shuffle in (True, False):
        want = RE._make_folds(len(y), 3, y, False, shuffle, 7, sizes)
        got = PE._make_folds(len(y), 3, y, False, shuffle, 7, sizes)
        for (a_tr, a_te), (b_tr, b_te) in zip(want, got):
            assert np.array_equal(a_tr, b_tr) and np.array_equal(a_te, b_te)
    params = dict(objective="lambdarank", num_leaves=7, min_data_in_leaf=5,
                  verbose=-1, eval_at=[5], learning_rate=0.3)
    want = R.cv(params, R.Dataset(X, label=y, group=sizes), 10, nfold=3,
                early_stopping_rounds=5, seed=7)
    got = P.cv(params, P.Dataset(X, label=y, group=sizes, device="cpu"), 10,
               nfold=3, early_stopping_rounds=5, seed=7,
               return_cvbooster=True)
    keys = sorted(k for k in want if k != "cvbooster")
    assert sorted(k for k in got if k != "cvbooster") == keys == [
        "valid ndcg@5-mean", "valid ndcg@5-stdv"]
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
    assert got.best_iter == want.best_iter >= 1
    assert 0.0 < got.best_score <= 1.0
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)
    # each fold trains on whole queries: its groups are runs of the rows'
    # query ids
    qid = np.repeat(np.arange(len(sizes)), sizes)
    folds = PE._make_folds(len(y), 3, y, False, True, 7, sizes)
    for b, (tr, _) in zip(got.cvbooster.boosters, folds):
        gs = b.train_set.get_group()
        assert gs.sum() == len(tr)
        assert np.array_equal(gs, np.unique(qid[tr], return_counts=True)[1])


# --------------------------------------------------------------- (d) sklearn
def test_lgbm_ranker():
    X, y, sizes = make_ranked(n_queries=50, seed=7)
    Xv, yv, sv = make_ranked(n_queries=12, seed=8)
    kw = dict(n_estimators=5, num_leaves=15, min_child_samples=5)
    est = P.LGBMRanker(device="cpu", **kw).fit(
        X, y, group=sizes, eval_set=[(Xv, yv)], eval_group=[sv],
        eval_at=[2, 10])
    assert est.booster_.params.objective == "lambdarank"
    assert set(est.best_score_["valid_0"]) == {"ndcg@2", "ndcg@10"}
    want = P.train(dict(objective="lambdarank", num_leaves=15,
                        min_data_in_leaf=5, verbose=-1),
                   P.Dataset(X, label=y, group=sizes, device="cpu"), 5)
    s = est.predict(X)
    assert s.shape == (len(y),)
    np.testing.assert_array_equal(s, want.predict(X))
    assert R.LGBMRanker._objective_default == P.LGBMRanker._objective_default
    with pytest.raises(ValueError, match="group"):
        P.LGBMRanker(device="cpu", **kw).fit(X, y)


# ------------------------------------------------ (e) files, serving, resume
@pytest.mark.parametrize("suffix", ["txt", "npz"])
def test_ranker_model_files_interchange_and_serve(trained, tmp_path, suffix):
    _, _, (X, _, _), _, out = trained
    rb, pb = out["ref"][0], out["port"][0]
    for b, other, tag in ((pb, R, "port"), (rb, P, "ref")):
        path = str(tmp_path / f"{tag}.{suffix}")
        b.save_model(path)
        kw = {"device": "cpu"} if other is P else {}
        back = other.Booster(model_file=path, **kw)
        np.testing.assert_allclose(back.predict(X[:300]), b.predict(X[:300]),
                                   rtol=1e-6, atol=1e-6)
        if other is P:
            assert back.params.objective == "lambdarank"
            rt = PredictorRuntime(pack_booster(back), max_bucket=256,
                                  device="cpu")
            np.testing.assert_allclose(
                rt.predict(X[:300], raw_score=True),
                back.predict(X[:300], raw_score=True), rtol=1e-6, atol=1e-6)


def test_lambdarank_kill_and_resume_bit_identical(tmp_path):
    """The groups are re-packed from the Dataset on resume: a run killed
    after any round and resumed grows the uninterrupted run."""
    X, y, sizes = make_ranked(n_queries=40, seed=9)
    params = dict(objective="lambdarank", num_leaves=7, min_data_in_leaf=5,
                  verbose=-1, bagging_fraction=0.8, bagging_freq=1)

    def ds():
        return P.Dataset(X, label=y, group=sizes, params=dict(params),
                         device="cpu")

    whole = P.Booster(dict(params), ds())
    for _ in range(ROUNDS):
        whole.update()
    d = str(tmp_path / "ck")
    train_resumable(dict(params), ds(), ROUNDS, checkpoint_dir=d,
                    checkpoint_rounds=1, keep_last=ROUNDS + 1, resume=False)
    paths = list_checkpoints(d)[:-1]
    assert paths
    for path in paths:
        b = resume_booster(path, ds())
        for _ in range(ROUNDS - b._iter):
            b.update()
        for ta, tb in zip(whole.trees, b.trees):
            x, z = p_arrays(ta), p_arrays(tb)
            for f in x:
                assert np.array_equal(x[f], z[f]), f
        assert torch.equal(whole._pred_train, b._pred_train)


# ---------------------------------------------------------- (f) goss, dart
@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_lambdarank_goss_and_dart_match_reference(boosting):
    X, y, sizes = make_ranked(n_queries=60, seed=11)
    params = dict(objective="lambdarank", num_leaves=15, min_data_in_leaf=5,
                  verbose=-1, boosting=boosting, seed=3, drop_rate=0.5,
                  skip_drop=0.0)
    rb = R.train(params, R.Dataset(X, label=y, group=sizes), 3)
    pb = P.train(params, P.Dataset(X, label=y, group=sizes, device="cpu"), 3)
    _assert_trees(rb.trees, pb.trees)
    np.testing.assert_allclose(pb.predict(X), rb.predict(X), rtol=RTOL,
                               atol=ATOL)
