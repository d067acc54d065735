"""The port's public surface against the reference's: no option the
reference names vanishes into ``**kwargs``, and no public name is missing
without a refusal that cites its ROADMAP item.

(a) ``Booster.predict(X, ntree_limit=k)`` is the staged prediction of the
    first ``k`` trees (the xgboost-style alias of ``num_iteration``, which
    examples/bagging_boosting.py calls) in both packages, and the port's
    values equal the reference's within the parity regime;
(b) every parameter of the reference's public callables on this path is
    named by the port's, or refused by name with its item (the ranking
    parameters ``group``/``eval_group`` take the query groups);
(c) the package's, ``Dataset``'s, ``BinMapper``'s and ``Booster``'s public
    names, the lazy serving, estimator and plotting attributes included.
"""

import inspect

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.sklearn as RS
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.sklearn as PS
from lightgbm_tpu.models.gbdt import Booster as RB
from lightgbm_tpu_torch.models.gbdt import Booster as PB


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the strict grower runs many small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
PARAMS = {"objective": "regression", "num_leaves": 7, "verbose": -1}
ROUNDS = 20


@pytest.fixture(scope="module")
def c3_models():
    """Fault C.3's input: 2,000 x 4 f32, y = x0 + 0.1 noise, 20 rounds."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(2000, 4)).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.normal(size=2000)).astype(np.float32)
    ref = R.train(PARAMS, R.Dataset(X, label=y), ROUNDS)
    port = P.train(PARAMS, P.Dataset(X, label=y, device="cpu"), ROUNDS)
    return X, ref, port


@pytest.mark.parametrize("k", [1, 7, ROUNDS])
def test_ntree_limit_is_the_staged_prediction(c3_models, k):
    X, ref, port = c3_models
    for b in (ref, port):
        np.testing.assert_array_equal(b.predict(X, ntree_limit=k),
                                      b.predict(X, num_iteration=k))
    if k < ROUNDS:
        assert not np.array_equal(port.predict(X, ntree_limit=k),
                                  port.predict(X))
    np.testing.assert_allclose(port.predict(X, ntree_limit=k),
                               ref.predict(X, ntree_limit=k),
                               rtol=RTOL, atol=ATOL)


# parameters the port names but refuses, each with the item that ports it
REFUSED = {
    ("train", "init_model"): "item 10",
}
# parameters that were refused until introspection was ported (item 10's
# first half): each now returns the reference's layout
INTROSPECTION_PARAMS = (("Booster.predict", "pred_leaf"),
                        ("Booster.predict", "pred_contrib"))
# parameters that were refused until ranking was ported (item 8): each now
# takes its query groups
RANKING_PARAMS = (("Dataset.__init__", "group"), ("LGBMModel.fit", "group"),
                  ("LGBMModel.fit", "eval_group"))
# parameters the port adds: the entry points' device
PORT_ONLY = {"device"}

CALLABLES = {
    "train": (R.train, P.train),
    "cv": (R.cv, P.cv),
    "Booster.__init__": (RB.__init__, PB.__init__),
    "Booster.predict": (RB.predict, PB.predict),
    "Booster.update": (RB.update, PB.update),
    "Dataset.__init__": (R.Dataset.__init__, P.Dataset.__init__),
    "LGBMModel.__init__": (RS.LGBMModel.__init__, PS.LGBMModel.__init__),
    "LGBMModel.fit": (RS.LGBMModel.fit, PS.LGBMModel.fit),
    "LGBMModel.predict": (RS.LGBMModel.predict, PS.LGBMModel.predict),
    "LGBMClassifier.predict_proba": (RS.LGBMClassifier.predict_proba,
                                     PS.LGBMClassifier.predict_proba),
    "LGBMRandomForestRegressor.__init__": (
        RS.LGBMRandomForestRegressor.__init__,
        PS.LGBMRandomForestRegressor.__init__),
}


@pytest.mark.parametrize("name", sorted(CALLABLES))
def test_reference_parameters_are_named_by_the_port(name):
    ref, port = CALLABLES[name]
    rp = inspect.signature(ref).parameters
    pp = inspect.signature(port).parameters
    missing = [k for k in rp if k not in pp]
    assert not missing, f"{name}: {missing} would vanish into **kwargs"
    assert set(pp) - set(rp) <= PORT_ONLY, name
    for k, v in rp.items():
        if v.default is not inspect.Parameter.empty and (name, k) not in \
                REFUSED:
            assert pp[k].default == v.default, (name, k)


def test_refused_parameters_cite_their_item():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(200, 3))
    y = (X[:, 0] > 0).astype(float)
    ds = P.Dataset(X, label=y, device="cpu")
    b = P.train({"objective": "binary", "num_leaves": 4, "verbose": -1},
                ds, 1)
    calls = {
        ("train", "init_model"): lambda: P.train(
            {"objective": "binary"}, ds, 1, init_model=b),
    }
    assert set(calls) == set(REFUSED)
    for key, call in calls.items():
        with pytest.raises(NotImplementedError, match=REFUSED[key]):
            call()
    # the introspection parameters return the reference's shapes
    shapes = {
        ("Booster.predict", "pred_leaf"): (
            b.predict(X, pred_leaf=True).shape, (200, 1)),
        ("Booster.predict", "pred_contrib"): (
            b.predict(X, pred_contrib=True).shape, (200, 4)),
    }
    assert set(shapes) == set(INTROSPECTION_PARAMS)
    for key, (got, want) in shapes.items():
        assert got == want, key
    # the ranking parameters take the query groups now
    taken = {
        ("Dataset.__init__", "group"): lambda: P.Dataset(
            X, label=y, device="cpu", group=[100, 100]).get_group(),
        ("LGBMModel.fit", "group"): lambda: PS.LGBMRanker(
            n_estimators=1, min_child_samples=5, device="cpu").fit(
                X, y, group=[100, 100]).booster_.train_set.get_group(),
        ("LGBMModel.fit", "eval_group"): lambda: PS.LGBMRanker(
            n_estimators=1, min_child_samples=5, device="cpu").fit(
                X, y, group=[100, 100], eval_set=[(X, y)],
                eval_group=[[200]]).booster_._valid[0][1].get_group(),
    }
    assert set(taken) == set(RANKING_PARAMS)
    for key, call in taken.items():
        assert call().sum() == 200, key


# public names of the reference with no counterpart yet, by item
NAME_GAPS = {}
DATASET_GAPS = {"save_binary": "item 10"}
# Booster methods still to port: item 10's continuation half
BOOSTER_GAPS = {"ingest_init_model": "item 10", "refit": "item 10",
                "rollback_one_iter": "item 10"}
PLOTTING = ("plot_importance", "plot_metric", "create_tree_digraph",
            "plot_split_value_histogram")
LAZY = ("serving", "sklearn", "PackedForest", "PredictorRuntime",
        "MicroBatcher", "pack_booster", "LGBMModel", "LGBMRegressor",
        "LGBMClassifier", "LGBMRanker", "LGBMRandomForestRegressor",
        "plotting") + PLOTTING


def test_package_public_names():
    for name in list(R.__all__) + list(LAZY):
        assert getattr(P, name) is not None, name
    for name, item in NAME_GAPS.items():
        with pytest.raises(NotImplementedError, match=item):
            getattr(P, name)()       # the estimator refuses on construction
    # the plotting helpers (refused until item 10) are the plotting module's
    import lightgbm_tpu.plotting as RP

    for name in PLOTTING:
        assert getattr(P, name) is getattr(P.plotting, name), name
        assert list(inspect.signature(getattr(P, name)).parameters) == \
            list(inspect.signature(getattr(RP, name)).parameters), name
    assert P.Params is P.config.Params
    assert P.sklearn.LGBMRandomForestRegressor is P.LGBMRandomForestRegressor
    # the ranker (refused until item 8) constructs with the reference's
    # objective and parameters
    assert P.LGBMRanker is P.sklearn.LGBMRanker
    est = P.LGBMRanker(n_estimators=3)
    assert est._resolved_params()["objective"] == "lambdarank"
    assert est.get_params() == {**R.LGBMRanker(n_estimators=3).get_params(),
                                "device": None}


def test_booster_public_names():
    def public(cls):
        return {m for m in dir(cls) if not m.startswith("_")}

    assert public(RB) - public(PB) == set(BOOSTER_GAPS)
    # introspection (item 10's first half) names the reference's methods
    for name in ("dump_model", "trees_to_dataframe", "can_fuse_rounds"):
        assert list(inspect.signature(getattr(PB, name)).parameters) == \
            list(inspect.signature(getattr(RB, name)).parameters), name


def test_dataset_and_bin_mapper_public_names():
    def public(cls):
        return {m for m in dir(cls) if not m.startswith("_")}

    assert public(R.Dataset) - public(P.Dataset) == set(DATASET_GAPS)
    assert public(R.BinMapper) <= public(P.BinMapper)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 3))
    y = X[:, 0]
    rd, pd = R.Dataset(X, label=y), P.Dataset(X, label=y, device="cpu")
    rd.construct()
    pd.construct()
    for f in range(3):
        assert pd.feature_num_bin(f) == rd.feature_num_bin(f)
        for b in (0, 5, 10_000):
            assert pd.bin_mapper.bin_upper_bound(f, b) == \
                rd.bin_mapper.bin_upper_bound(f, b)
    assert pd.get_feature_name() == rd.get_feature_name()
    w = rng.uniform(0.5, 1.5, 300)
    pd.set_weight(w).set_label(2 * y).set_init_score(np.zeros(300))
    np.testing.assert_array_equal(pd.get_field("weight"), w)
    np.testing.assert_array_equal(pd.w[:300].numpy(), w.astype(np.float32))
    np.testing.assert_array_equal(pd.y[:300].numpy(),
                                  (2 * y).astype(np.float32))
    pd.set_field("label", y)
    np.testing.assert_array_equal(pd.get_field("label"), y)
    # the group fields (refused until item 8) hold the query sizes
    assert pd.get_group() is None
    pd.set_group([100, 200])
    np.testing.assert_array_equal(pd.get_field("group"), [100, 200])
    np.testing.assert_array_equal(pd.group_id[:300].numpy(),
                                  np.repeat([0, 1], [100, 200]))
    rd.set_group([100, 200])
    np.testing.assert_array_equal(pd.group_id.numpy(),
                                  np.asarray(rd.group_id))
    valid = pd.create_valid(X[:50], label=y[:50])
    valid.construct()
    assert valid.bin_mapper is pd.bin_mapper and valid.device == pd.device


def test_reset_parameter_schedule_matches_reference():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1500, 4)).astype(np.float32)
    y = (X[:, 0] + 0.2 * rng.normal(size=1500)).astype(np.float32)
    params = {"objective": "regression", "num_leaves": 7, "verbose": -1}

    def sched(i):
        return 0.2 * 0.8 ** i

    ref = R.train(params, R.Dataset(X, label=y), 6,
                  callbacks=[R.reset_parameter(learning_rate=sched)])
    port = P.train(params, P.Dataset(X, label=y, device="cpu"), 6,
                   callbacks=[P.reset_parameter(learning_rate=sched)])
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=RTOL,
                               atol=ATOL)
    b = P.train(params, P.Dataset(X, label=y, device="cpu"), 1)
    with pytest.raises(ValueError, match="num_leaves"):
        b.reset_parameter({"num_leaves": 15})
