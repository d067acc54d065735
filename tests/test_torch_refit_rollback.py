"""Port parity: ``Booster.refit`` and ``Booster.rollback_one_iter`` against
the reference on the CPU (the reference's ``tests/test_api_surface.py``,
``test_multiclass.py``, ``test_ranking.py``, ``test_linear_tree.py`` and
``test_review_fixes.py`` cases, on both packages).

The parity regime:

(a) refit: one model file the reference wrote, loaded by both packages and
    refit on the same new rows, gives the same leaf values bit for bit
    (the per-leaf sums run in row order on CPU tensors, as the reference's
    scatter-add, and ``decay * old`` is fused into the sum as XLA contracts
    the reference's expression) for gbdt (``decay_rate``, ``weight``),
    GOSS, binary, multiclass (a round's K trees at once) and lambdarank
    (``group=`` packs a fresh layout, with ``weight``); predictions within
    rtol 1e-5 / atol 1e-6; the refit Booster is predict-only and the source
    untouched;
(b) refit's refusals with the reference's exception types and messages;
(c) rollback: both packages ingest the same model and take two rounds
    back; the train scores of gbdt and linear leaves equal the reference's
    bit for bit, multiclass within atol 1e-6 (the port's multiclass round
    and its replay update with one multiply-add, the reference's eagerly),
    valid scores within atol 1e-6; rf
    keeps its train scores at the init score; a rolled-back run's scores
    and valid metric are the shorter run's within 1e-6, and it trains on.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCT = ("split_feature", "split_bin", "left", "right", "is_leaf")
BASE = {"objective": "regression", "num_leaves": 7, "verbosity": -1}


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(5)
    n = 2000
    X = rng.normal(size=(n, 5))
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.3 * rng.normal(size=n)
    return X, y


def _labels(kind, y):
    if kind == "multiclass":
        return np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    if kind == "binary":
        return (y > 0).astype(float)
    if kind == "lambdarank":
        return np.digitize(y, np.quantile(y, [0.5, 0.8, 0.95])).astype(float)
    return y


REFIT = {
    "gbdt": (BASE, {}, {"decay_rate": 0.5}),
    "gbdt_weight": (BASE, {}, {"weight": "ramp"}),
    "goss": (dict(BASE, boosting="goss"), {}, {}),
    "binary": (dict(BASE, objective="binary"), {}, {}),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "verbosity": -1}, {},
                   {"decay_rate": 0.7}),
    "lambdarank": ({"objective": "lambdarank", "num_leaves": 7,
                    "verbosity": -1, "min_data_in_leaf": 5},
                   {"group": [20] * 100},
                   {"group": [15] * 100, "weight": "ramp"}),
}


def _model_file(params, X, y, dkw, tmp_path, rounds=4):
    path = str(tmp_path / "ref.txt")
    R.train(params, R.Dataset(X, label=y, **dkw), rounds).save_model(path)
    return path


# ---------------------------------------------------------------- (a) refit
@pytest.mark.parametrize("case", sorted(REFIT))
def test_refit_matches_the_reference_bit_for_bit(case, frame, tmp_path):
    params, dkw, rkw = REFIT[case]
    X, y = frame
    kind = params.get("objective") if case != "goss" else "regression"
    y = _labels(kind, y)
    path = _model_file(params, X, y, dkw, tmp_path)
    Xn, yn = X[:1500] * 0.9, y[:1500]
    if kind != "lambdarank" and kind != "multiclass" and kind != "binary":
        yn = yn + 1.0                               # a shifted target
    kw = dict(rkw)
    if kw.get("weight") == "ramp":
        kw["weight"] = np.linspace(0.5, 2.0, len(yn))
    rb, pb = R.Booster(model_file=path), P.Booster(model_file=path,
                                                   device="cpu")
    before = [p_arrays(t)["leaf_value"].copy() for t in pb.trees]
    rr, pr = rb.refit(Xn, yn, **kw), pb.refit(Xn, yn, **kw)
    assert pr is not pb and pr.train_set is None and pr._pred_train is None
    for i, (tr, tp, old) in enumerate(zip(rr.trees, pr.trees, before)):
        a, b = r_arrays(tr), p_arrays(tp)
        for k in STRUCT:
            assert np.array_equal(a[k], b[k]), (i, k)
        assert np.array_equal(a["leaf_value"], b["leaf_value"]), i
        # the source booster keeps its leaves
        assert np.array_equal(p_arrays(pb.trees[i])["leaf_value"], old)
    assert any(not np.array_equal(p_arrays(t)["leaf_value"], old)
               for t, old in zip(pr.trees, before))
    np.testing.assert_allclose(pr.predict(X), rr.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_refit_moves_toward_the_new_target(frame):
    """A port Booster refit on a shifted target predicts it better, its
    structure kept (the reference's ``test_refit_on_shifted_data``)."""
    X, y = frame
    b = P.train(dict(BASE, num_leaves=15, learning_rate=0.2),
                P.Dataset(X, label=y, device="cpu"), 20)
    shifted = y + 3.0
    b2 = b.refit(X, shifted, decay_rate=0.5)
    for t1, t2 in zip(b.trees, b2.trees):
        assert torch.equal(t1.split_feature, t2.split_feature)
    assert np.abs(b2.predict(X) - shifted).mean() < \
        np.abs(b.predict(X) - shifted).mean()


def _refit_refusal(pkg, kind, X, y):
    kw = {"device": "cpu"} if pkg is P else {}
    try:
        if kind in ("rf", "dart"):
            extra = ({"bagging_fraction": 0.8, "bagging_freq": 1}
                     if kind == "rf" else {})
            b = pkg.train(dict(BASE, boosting=kind, **extra),
                          pkg.Dataset(X, label=y, **kw), 2)
            b.refit(X, y)
        elif kind == "linear":
            b = pkg.train(dict(BASE, linear_tree=True),
                          pkg.Dataset(X, label=y,
                                      params={"enable_bundle": False}, **kw),
                          2)
            b.refit(X, y)
        elif kind == "kwargs":
            pkg.train(BASE, pkg.Dataset(X, label=y, **kw), 1).refit(
                X, y, bogus_arg=1)
        elif kind == "group_not_ranking":
            pkg.train(BASE, pkg.Dataset(X, label=y, **kw), 1).refit(
                X, y, group=[len(y)])
        elif kind == "ranking_without_group":
            yr = _labels("lambdarank", y)
            pkg.train(REFIT["lambdarank"][0],
                      pkg.Dataset(X, label=yr, group=[20] * 100, **kw),
                      1).refit(X, yr)
    except Exception as e:            # noqa: BLE001 — compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kind", ["rf", "dart", "linear", "kwargs",
                                  "group_not_ranking",
                                  "ranking_without_group"])
def test_refit_refusals_are_the_references(frame, kind):
    X, y = frame
    want = _refit_refusal(R, kind, X, y)
    assert want is not None and _refit_refusal(P, kind, X, y) == want


# ------------------------------------------------------------- (c) rollback
ROLLBACK = {
    "gbdt": (BASE, {}, 0.0),
    "multiclass": (REFIT["multiclass"][0], {}, ATOL),
    "linear": (dict(BASE, linear_tree=True),
               {"params": {"enable_bundle": False}}, 0.0),
}


@pytest.mark.parametrize("case", sorted(ROLLBACK))
def test_rollback_matches_the_reference(case, frame, tmp_path):
    params, dkw, atol = ROLLBACK[case]
    X, y = frame
    y = _labels(params["objective"], y)
    path = _model_file(params, X, y, dkw, tmp_path)
    Xv, yv = X[:500] * 1.1, y[:500]
    boosters = []
    for pkg, kw in ((R, {}), (P, {"device": "cpu"})):
        b = pkg.Booster(params, pkg.Dataset(X, label=y, **dkw, **kw))
        b.ingest_init_model(pkg.Booster(model_file=path, **kw))
        b.add_valid(pkg.Dataset(Xv, label=yv, reference=b.train_set), "v")
        for _ in range(2):
            b.rollback_one_iter()
        boosters.append(b)
    rb, pb = boosters
    assert pb.num_trees() == 2 and pb.current_iteration() == 2
    np.testing.assert_allclose(pb._pred_train.numpy(),
                               np.asarray(rb._pred_train), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(pb._valid[0][2].numpy(),
                               np.asarray(rb._valid[0][2]), rtol=0,
                               atol=ATOL)
    for (_, _, a, _), (_, _, b, _) in zip(rb.eval_valid(), pb.eval_valid()):
        np.testing.assert_allclose(b, a, rtol=RTOL)


def test_rollback_rf_keeps_the_init_score(frame):
    X, y = frame
    params = dict(BASE, boosting="rf", bagging_fraction=0.8, bagging_freq=1)
    Xv, yv = X[:500] * 1.1, y[:500]
    out = []
    for pkg, kw in ((R, {}), (P, {"device": "cpu"})):
        ds = pkg.Dataset(X, label=y, **kw)
        b = pkg.Booster(params, ds)
        b.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "v")
        for _ in range(3):
            b.update()
        init = np.asarray(b._pred_train).copy()
        b.rollback_one_iter()
        assert np.array_equal(np.asarray(b._pred_train), init)
        out.append(b)
    rb, pb = out
    assert pb.num_trees() == 2
    np.testing.assert_allclose(pb._valid[0][2].numpy(),
                               np.asarray(rb._valid[0][2]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pb.eval_valid()[0][2], rb.eval_valid()[0][2],
                               rtol=RTOL)


@pytest.mark.parametrize("case", ["gbdt", "linear"])
def test_rollback_equals_the_shorter_run(case, frame):
    """Five rounds rolled back twice hold the three-round run's train and
    valid scores within 1e-6, its valid metric within 1e-6 (the reference's
    ``test_rollback_restores_valid_eval`` and
    ``test_rollback_with_linear_tree``), and train on."""
    params, dkw, _ = ROLLBACK[case]
    X, y = frame
    Xv, yv = X[:500] * 1.1, y[:500]
    runs = []
    for rounds in (5, 3):
        ds = P.Dataset(X, label=y, device="cpu", **dkw)
        b = P.Booster(dict(params, metric="l2"), ds)
        b.add_valid(P.Dataset(Xv, label=yv, reference=ds), "va")
        for _ in range(rounds):
            b.update()
        runs.append(b)
    long, short = runs
    long.rollback_one_iter()
    long.rollback_one_iter()
    np.testing.assert_allclose(long._pred_train.numpy(),
                               short._pred_train.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(long._valid[0][2].numpy(),
                               short._valid[0][2].numpy(), rtol=0, atol=1e-6)
    assert abs(long.eval_valid()[0][2] - short.eval_valid()[0][2]) < 1e-6
    np.testing.assert_allclose(
        long.predict(X, raw_score=True)[:100],
        long._pred_train.numpy()[:100], rtol=0, atol=1e-5)
    long.update()
    assert long.num_trees() == 4 and long.current_iteration() == 4
