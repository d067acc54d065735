"""Port parity: introspection against the reference on the CPU —
``predict(pred_leaf=True)``, TreeSHAP ``predict(pred_contrib=True)``,
``dump_model``, ``trees_to_dataframe``, the plotting helpers,
``can_fuse_rounds`` and the sklearn estimators' pass-through.

Each case trains the reference and carries its model into the port by the
text model (model files interchange), so both packages read the same
trees.  On those:

(a) ``pred_leaf`` is equal exactly (leaf ordinals, iteration-major
    ``[n, T*K]``), whole and truncated by ``start_iteration`` /
    ``num_iteration``, for single-class, strict, multiclass, categorical,
    EFB and rf forests;
(b) ``pred_contrib`` is within rtol 1e-5, atol 1e-5 of the reference's (the
    reference's own suite holds it at rtol 1e-4, atol 1e-5 against brute
    force; the f32 polynomial's and division's roundings differ by ulps),
    rows sum to the raw score within 1e-4, multiclass lays out
    ``[n, K*(F+1)]``, EFB attributes to original features and rf divides
    by the tree count;
(c) ``dump_model`` is equal as a dict, ``trees_to_dataframe`` frame for
    frame, and ``create_tree_digraph``'s DOT text character for character;
    on a model the port grew itself, ``dump_model``'s structure, thresholds
    and counts are exact and gains within rtol 1e-5 of the reference's
    model of the same data;
(d) ``plot_importance``, ``plot_metric`` and ``plot_split_value_histogram``
    draw the reference's bars and lines on Agg;
(e) ``can_fuse_rounds`` agrees over an option grid, and
    ``LGBMClassifier.predict``/``predict_proba`` pass ``pred_contrib`` and
    ``pred_leaf`` through unchanged.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.plotting as RP
import lightgbm_tpu.sklearn as RS
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.plotting as PP
import lightgbm_tpu_torch.sklearn as PS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CONTRIB_RTOL, CONTRIB_ATOL = 1e-5, 1e-5
ADDITIVITY = 1e-4


def _frame(n=2048, seed=0, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    s = 1.2 * X[:, 0] - 0.8 * X[:, 1] + np.sin(2 * X[:, 2]) \
        + 0.5 * X[:, 3] * X[:, 4]
    return X, s, rng


def _case(name):
    """(reference params, X, y, Dataset kwargs, rounds) of one case."""
    X, s, rng = _frame(seed=len(name))
    base = {"verbosity": -1, "seed": 3}
    if name == "regression":
        return dict(base, objective="regression", num_leaves=15), X, s, {}, 8
    if name == "binary_strict":
        y = (s + 0.3 * rng.normal(size=len(s)) > 0).astype(np.float32)
        return (dict(base, objective="binary", num_leaves=7,
                     grow_policy="leafwise"), X, y, {}, 6)
    if name == "multiclass":
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
        return (dict(base, objective="multiclass", num_class=3,
                     num_leaves=7), X, y, {}, 4)
    if name == "categorical":
        X = X.copy()
        X[:, 1] = rng.integers(0, 12, len(X))
        y = s + np.where(X[:, 1] % 3 == 0, 1.5, -0.5)
        return (dict(base, objective="regression", num_leaves=15), X, y,
                {"categorical_feature": [1]}, 5)
    if name == "efb":
        Xe = np.zeros((len(X), 16), np.float32)
        Xe[:, :4] = X[:, :4]
        hot = rng.integers(0, 12, len(X))
        for j in range(12):             # mutually exclusive sparse columns
            Xe[hot == j, 4 + j] = 1.0 + rng.random((hot == j).sum())
        y = s + 2 * Xe[:, 4] - 2 * Xe[:, 6] + Xe[:, 9]
        return dict(base, objective="regression", num_leaves=15), Xe, y, {}, 5
    if name == "rf":
        return (dict(base, objective="regression", num_leaves=15,
                     boosting="rf", bagging_fraction=0.7, bagging_freq=1,
                     feature_fraction=0.8), X, s, {}, 6)
    raise KeyError(name)


CASES = ("regression", "binary_strict", "multiclass", "categorical", "efb",
         "rf")


@pytest.fixture(scope="module")
def carried():
    """Each case's reference model and the port's copy of it."""
    out = {}
    for name in CASES:
        params, X, y, dkw, rounds = _case(name)
        rb = R.train(dict(params), R.Dataset(X, label=y, **dkw), rounds)
        pb = P.Booster(model_str=rb.model_to_string(), device="cpu")
        out[name] = (rb, pb, X)
    return out


def test_cases_exercise_what_they_name(carried):
    assert carried["efb"][0]._bin_mapper_for_predict().bundler is not None
    assert any(bool(np.asarray(t.is_cat_split).any())
               for t in carried["categorical"][0].trees)
    assert carried["multiclass"][1].trees[0].leaf_value.ndim == 2


# -------------------------------------------------------------- (a) leaves
@pytest.mark.parametrize("name", CASES)
def test_pred_leaf_equals_reference(carried, name):
    rb, pb, X = carried[name]
    Xt = X[:300]
    want = rb.predict(Xt, pred_leaf=True)
    got = pb.predict(Xt, pred_leaf=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    k = pb.num_model_per_iteration()
    assert want.shape == (300, pb.num_trees() * k)
    # ordinals, not node slots: each tree's values lie in [0, leaves)
    assert got.min() >= 0 and got.max() < 15
    for kw in ({"start_iteration": 1, "num_iteration": 2},
               {"num_iteration": 1}, {"start_iteration": 2}):
        np.testing.assert_array_equal(pb.predict(Xt, pred_leaf=True, **kw),
                                      rb.predict(Xt, pred_leaf=True, **kw))


def test_pred_leaf_of_a_port_grown_model():
    params, X, y, _, rounds = _case("regression")
    rb = R.train(dict(params), R.Dataset(X, label=y), rounds)
    pb = P.train(dict(params), P.Dataset(X, label=y, device="cpu"), rounds)
    np.testing.assert_array_equal(pb.predict(X[:500], pred_leaf=True),
                                  rb.predict(X[:500], pred_leaf=True))


# ------------------------------------------------------------- (b) TreeSHAP
@pytest.mark.parametrize("name", CASES)
def test_pred_contrib_against_reference(carried, name):
    rb, pb, X = carried[name]
    Xt = X[:200]
    want = rb.predict(Xt, pred_contrib=True)
    got = pb.predict(Xt, pred_contrib=True)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=CONTRIB_RTOL,
                               atol=CONTRIB_ATOL)
    k = pb.num_model_per_iteration()
    f = pb.num_feature()
    assert got.shape == (200, k * (f + 1))
    raw = pb.predict(Xt, raw_score=True).reshape(200, k)
    sums = got.reshape(200, k, f + 1).sum(-1)
    assert np.abs(sums - raw).max() <= ADDITIVITY
    # truncation selects the same trees as the reference's
    np.testing.assert_allclose(
        pb.predict(Xt, pred_contrib=True, start_iteration=1,
                   num_iteration=2),
        rb.predict(Xt, pred_contrib=True, start_iteration=1,
                   num_iteration=2),
        rtol=CONTRIB_RTOL, atol=CONTRIB_ATOL)


def test_pred_contrib_efb_and_rf_specifics(carried):
    rb, pb, X = carried["efb"]
    got = pb.predict(X[:200], pred_contrib=True)
    # sixteen ORIGINAL features (the bundles resolved), sparse ones used
    assert got.shape == (200, 17)
    assert np.abs(got[:, 4]).max() > 0 and np.abs(got[:, 6]).max() > 0
    rb, pb, X = carried["rf"]
    got = pb.predict(X[:200], pred_contrib=True)
    # an rf forest averages its trees: its contributions are the mean of
    # each tree's alone (each of which carries the init score once)
    each = [pb.predict(X[:200], pred_contrib=True, start_iteration=t,
                       num_iteration=1) for t in range(pb.num_trees())]
    np.testing.assert_allclose(got, np.mean(each, axis=0), rtol=1e-5,
                               atol=1e-5)
    assert np.abs(got.sum(1) - pb.predict(X[:200], raw_score=True)).max() \
        <= ADDITIVITY


def test_pred_contrib_row_chunks_change_no_bit(carried):
    from lightgbm_tpu_torch.ops.shap import forest_pred_contrib

    rb, pb, X = carried["categorical"]
    bins = torch.from_numpy(pb._bin_mapper.transform(X[:300]))
    shrink = np.full(pb.num_trees(), pb._shrink, np.float32)
    whole = forest_pred_contrib(pb.trees, bins, pb.num_feature(), shrink)
    parts = forest_pred_contrib(pb.trees, bins, pb.num_feature(), shrink,
                                chunk_rows=37)
    assert torch.equal(whole, parts)


# ------------------------------------------------------------ (c) the dumps
@pytest.mark.parametrize("name", CASES)
def test_dump_frame_and_digraph_equal_reference(carried, name):
    rb, pb, _ = carried[name]
    assert pb.dump_model() == rb.dump_model()
    assert pb.dump_model(num_iteration=2, start_iteration=1) == \
        rb.dump_model(num_iteration=2, start_iteration=1)
    assert pb.trees_to_dataframe().equals(rb.trees_to_dataframe())
    last = pb.num_trees() * pb.num_model_per_iteration() - 1
    for i in (0, last):
        assert P.create_tree_digraph(pb, tree_index=i) == \
            R.create_tree_digraph(rb, tree_index=i)


def _walk(node, out):
    out.append(node)
    for side in ("left_child", "right_child"):
        if side in node:
            _walk(node[side], out)
    return out


def test_dump_of_a_port_grown_model():
    """Numeric splits: a categorical subset may come out mirrored on
    general data (ROADMAP C.4), which the carried cases cover instead."""
    params, X, y, _, rounds = _case("binary_strict")
    rb = R.train(dict(params), R.Dataset(X, label=y), rounds)
    pb = P.train(dict(params), P.Dataset(X, label=y, device="cpu"), rounds)
    rd, pd_ = rb.dump_model(), pb.dump_model()
    assert {k: v for k, v in pd_.items() if k != "tree_info"} == \
        {k: v for k, v in rd.items() if k != "tree_info"}
    for rt, pt in zip(rd["tree_info"], pd_["tree_info"]):
        rn, pn = _walk(rt["tree_structure"], []), \
            _walk(pt["tree_structure"], [])
        assert len(rn) == len(pn)
        for a, b in zip(rn, pn):
            assert set(a) == set(b)
            for key in a:
                if key in ("left_child", "right_child"):
                    continue
                if key in ("split_gain", "leaf_value"):
                    np.testing.assert_allclose(b[key], a[key], rtol=1e-5,
                                               atol=1e-6)
                else:
                    assert a[key] == b[key], key


# ------------------------------------------------------------ (d) plotting
def test_plots_draw_the_reference_bars_and_lines(carried):
    import matplotlib

    matplotlib.use("Agg")
    rb, pb, X = carried["regression"]
    for kw in ({}, {"importance_type": "gain", "max_num_features": 3}):
        ra, pa = RP.plot_importance(rb, **kw), PP.plot_importance(pb, **kw)
        np.testing.assert_allclose([p.get_width() for p in pa.patches],
                                   [p.get_width() for p in ra.patches],
                                   rtol=1e-6)
        assert [t.get_text() for t in pa.get_yticklabels()] == \
            [t.get_text() for t in ra.get_yticklabels()]
    evals = {}
    params, X, y, _, _ = _case("regression")
    ds = P.Dataset(X, label=y, device="cpu")
    P.train(dict(params), ds, 5, valid_sets=[ds],
            callbacks=[P.record_evaluation(evals)])
    ra, pa = RP.plot_metric(evals), PP.plot_metric(evals)
    for rl, pl in zip(ra.get_lines(), pa.get_lines()):
        np.testing.assert_array_equal(pl.get_xydata(), rl.get_xydata())
        assert pl.get_label() == rl.get_label()
    ra = RP.plot_split_value_histogram(rb, 0)
    pa = PP.plot_split_value_histogram(pb, 0)
    assert [p.get_height() for p in pa.patches] == \
        [p.get_height() for p in ra.patches]
    with pytest.raises(ValueError):
        PP.plot_metric({})


# --------------------------------------------- (e) can_fuse_rounds, sklearn
FUSE_GRID = (
    {}, {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1},
    {"boosting": "goss"}, {"boosting": "dart"},
    {"objective": "multiclass", "num_class": 3}, {"linear_tree": True},
    {"monotone_constraints": [1, 0, 0, 0, 0, 0]})


@pytest.mark.parametrize("valid", [False, True])
def test_can_fuse_rounds_equals_reference(valid):
    X, s, _ = _frame(n=600, seed=4)
    y = np.digitize(s, [0.0, 1.0]).astype(np.float32)
    got, want = [], []
    for extra in FUSE_GRID:
        params = dict({"objective": "regression", "verbosity": -1}, **extra)
        for L, kw, out in ((R, {}, want), (P, {"device": "cpu"}, got)):
            ds = L.Dataset(X, label=y, **kw)
            b = L.Booster(dict(params), ds)
            if valid:
                b.add_valid(L.Dataset(X[:100], label=y[:100], reference=ds),
                            "v")
            out.append(b.can_fuse_rounds())
    assert got == want
    assert any(got) or valid


def test_classifier_passes_contrib_and_leaf_through():
    X, s, rng = _frame(n=1500, seed=5)
    for y in ((s > 0).astype(int), np.digitize(s, [-1.0, 1.0])):
        kw = dict(n_estimators=4, num_leaves=7, random_state=1)
        rc = RS.LGBMClassifier(**kw).fit(X, y)
        pc = PS.LGBMClassifier(device="cpu", **kw).fit(X, y)
        for method in ("predict", "predict_proba"):
            for flag in ("pred_contrib", "pred_leaf"):
                got = getattr(pc, method)(X[:100], **{flag: True})
                want = getattr(rc, method)(X[:100], **{flag: True})
                assert got.shape == want.shape, (method, flag)
                direct = pc.booster_.predict(X[:100], **{flag: True})
                np.testing.assert_array_equal(got, direct)
                if flag == "pred_leaf":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-4,
                                               atol=1e-5)
        assert set(pc.predict(X[:50])) <= set(np.unique(y))
