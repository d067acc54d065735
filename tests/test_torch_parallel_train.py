"""Port parity: multi-device training (``tree_learner="data"``,
``"voting"``, ``"feature"`` and the 2-D mesh) over 8 virtual shards on the
CPU, mirroring the reference's ``tests/test_parallel.py`` and
``tests/test_merge_modes.py``.

The port's virtual shards (``parallel.set_virtual_devices(8)``) stand where
the reference's 8-device virtual CPU mesh does.  The same numpy inputs go
through ``lightgbm_tpu`` (on its mesh) and ``lightgbm_tpu_torch``:

* dp/fp trees against the port's serial trees and the reference's at
  ``D = 8``: split structure equal, leaves and predictions within rtol
  1e-5 / atol 1e-6 (the merged sums are taken in other orders than a
  serial sum, as the reference's own tests allow);
* the dyadic tier (every sum exact): round-1 trees bit-identical across D,
  across merge modes at f32 wire and across packages;
* the options the mesh composes with (bagging, GOSS, multiclass,
  lambdarank, categorical, linear leaves, int8, the wave and strict
  growers, bf16/int8 wire) against serial or on quality, and the
  reference's warnings and refusals for what it keeps serial.
"""


import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.parallel import set_virtual_devices

RTOL, ATOL = 1e-5, 1e-6
STRUCT = ("split_feature", "split_bin", "left", "right", "is_leaf")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the mesh growers run thousands of small ops,
    which several test workers' thread pools, each as wide as the machine,
    would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def virtual8():
    set_virtual_devices(8)
    yield
    set_virtual_devices(0)


def _reg(n=2048, f=6, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1] * 3) + X[:, 2] * X[:, 3]
         + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


def _dyadic(n=4096, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    order = np.argsort(X @ w + 0.6 * np.sin(X[:, 0] * 2))
    y = np.zeros(n, np.float32)
    y[order[n // 2:]] = 1.0
    return X, y


def _ptrain(prm, X, y, rounds, **ds_kw):
    return P.train(dict(prm), P.Dataset(X, label=y, device="cpu", **ds_kw),
                   rounds)


def _arr(t):
    return np.asarray(t.cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _same_structure(a, b, rtol=RTOL, atol=ATOL):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for f in STRUCT:
            np.testing.assert_array_equal(_arr(getattr(ta, f)),
                                          _arr(getattr(tb, f)), err_msg=f)
        np.testing.assert_allclose(_arr(ta.leaf_value), _arr(tb.leaf_value),
                                   rtol=rtol, atol=atol)


def _bit_equal(a, b):
    for ta, tb in zip(a.trees, b.trees):
        for f in STRUCT + ("leaf_value",):
            assert np.array_equal(_arr(getattr(ta, f)), _arr(getattr(tb, f))), f


BASE = {"objective": "regression", "num_leaves": 15, "learning_rate": 0.2,
        "verbosity": -1}


# --------------------------------------------- the learners vs serial/ref

@pytest.fixture(scope="module")
def reg_models():
    """The serial port model (5 rounds); the reference's dp model is
    trained per test where it is needed."""
    X, y = _reg()
    set_virtual_devices(8)
    serial = _ptrain(BASE, X, y, 5)
    return X, y, serial


@pytest.mark.parametrize("extra", [
    {}, {"histogram_merge": "psum"}, {"histogram_merge": "reduce_scatter"},
    {"histogram_merge": "reduce_scatter_ring"},
    {"histogram_merge": "reduce_scatter_pipelined", "merge_chunks": 3},
    {"tree_learner": "voting"}, {"tree_learner": "feature"},
    {"mesh_shape": "4x2"}, {"mesh_shape": "2x4"}])
def test_learner_matches_serial(reg_models, extra):
    """Every learner and merge mode at D = 8 grows the serial trees
    (voting: 2k >= F, the exact union)."""
    X, y, serial = reg_models
    p = dict(BASE, tree_learner="data")
    p.update(extra)
    b = _ptrain(p, X, y, 5)
    assert b._mesh is not None and b._mesh.n_devices == 8
    _same_structure(serial, b)
    np.testing.assert_allclose(b.predict(X), serial.predict(X), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("learner,extra", [
    ("data", {}), ("voting", {}), ("feature", {}), ("data",
                                                    {"mesh_shape": "4x2"})])
def test_learner_matches_reference_at_d8(reg_models, learner, extra):
    X, y, _ = reg_models
    p = dict(BASE, tree_learner=learner, **extra)
    got = _ptrain(p, X, y, 4)
    want = R.train(dict(p), R.Dataset(X, label=y), num_boost_round=4)
    assert (want._dp_mesh if learner != "feature" else want._fp_mesh) \
        is not None
    assert got._mesh.n_devices == 8
    for tg, tw in zip(got.trees, want.trees):
        for f in ("split_feature", "split_bin", "left", "right"):
            np.testing.assert_array_equal(_arr(getattr(tg, f)),
                                          np.asarray(getattr(tw, f)))
        np.testing.assert_allclose(_arr(tg.leaf_value),
                                   np.asarray(tw.leaf_value), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=RTOL,
                               atol=1e-5)


@pytest.mark.parametrize("extra", [
    {}, {"histogram_merge": "psum"}, {"histogram_merge": "reduce_scatter"},
    {"histogram_merge": "reduce_scatter_ring"}, {"tree_learner": "voting"},
    {"tree_learner": "feature"}, {"mesh_shape": "4x2"},
    {"grow_policy": "frontier"}])
def test_dyadic_round_one_bit_identical(extra):
    """Exact sums: the round-1 tree is the serial tree bit for bit in every
    merge mode at f32 wire, on the strict and wave growers."""
    X, y = _dyadic()
    p = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 20}
    if "grow_policy" in extra:
        p.update(extra)
        extra = {}
    serial = _ptrain(p, X, y, 1)
    b = _ptrain(dict(dict(p, tree_learner="data"), **extra), X, y, 1)
    assert b._mesh is not None
    _bit_equal(serial, b)


def test_dyadic_across_d_and_packages():
    X, y = _dyadic()
    p = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
         "tree_learner": "data"}
    trees = []
    for d in (2, 4, 8):
        set_virtual_devices(d)
        b = _ptrain(p, X, y, 1)
        assert b._mesh.n_devices == d
        trees.append(b)
    for b in trees[1:]:
        _bit_equal(trees[0], b)
    want = R.train(dict(p), R.Dataset(X, label=y), num_boost_round=1)
    for f in STRUCT + ("leaf_value",):
        np.testing.assert_array_equal(_arr(getattr(trees[-1].trees[0], f)),
                                      np.asarray(getattr(want.trees[0], f)))


def test_wave_grower_matches_serial():
    X, y = _reg(n=6000, f=8, seed=3)
    p = dict(BASE, num_leaves=31, grow_policy="frontier")
    serial = _ptrain(p, X, y, 4)
    for merge in ("reduce_scatter_pipelined", "psum"):
        b = _ptrain(dict(p, tree_learner="data", histogram_merge=merge), X,
                    y, 4)
        _same_structure(serial, b)


def test_bagging_and_feature_fraction():
    rng = np.random.default_rng(11)
    n = 2000
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (X[:, 0] - X[:, 1] ** 2 + rng.normal(0, 0.1, n)).astype(np.float32)
    p = {"objective": "regression", "num_leaves": 15,
         "bagging_fraction": 0.7, "bagging_freq": 2,
         "feature_fraction": 0.8, "verbosity": -1}
    serial = _ptrain(p, X, y, 5)
    b = _ptrain(dict(p, tree_learner="data"), X, y, 5)
    assert b._mesh is not None
    np.testing.assert_allclose(serial.predict(X), b.predict(X), rtol=1e-4,
                               atol=1e-4)


# ------------------------------------------------------ what it composes with

def test_multiclass_matches_serial():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(3000, 5)).astype(np.float32)
    y = (np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5])).astype(np.float32)
    p = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
         "verbosity": -1}
    serial = _ptrain(p, X, y, 3)
    for extra in ({"tree_learner": "data"},
                  {"tree_learner": "data", "histogram_merge": "psum"},
                  {"tree_learner": "voting"}, {"tree_learner": "feature"},
                  {"tree_learner": "data", "grow_policy": "frontier"}):
        s = serial if "grow_policy" not in extra else _ptrain(
            dict(p, grow_policy="frontier"), X, y, 3)
        b = _ptrain(dict(p, **extra), X, y, 3)
        assert b._mesh is not None, extra
        _same_structure(s, b)


def test_lambdarank_matches_serial():
    rng = np.random.default_rng(6)
    n = 2048
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = np.clip(np.round(X[:, 0] + rng.normal(0, 0.5, n) + 1), 0, 3)
    group = [64] * (n // 64)
    p = {"objective": "lambdarank", "num_leaves": 7, "verbosity": -1}
    serial = _ptrain(p, X, y, 3, group=group)
    b = _ptrain(dict(p, tree_learner="data"), X, y, 3, group=group)
    assert b._mesh is not None and b._mesh.dc == 1
    _same_structure(serial, b, rtol=1e-5, atol=1e-5)


def test_categorical_and_voting_fallback():
    rng = np.random.default_rng(8)
    n = 3000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[:, 1] = rng.integers(0, 12, n)
    y = (np.isin(X[:, 1], [1, 3, 7]) + X[:, 0] > 0.5).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    kw = dict(categorical_feature=[1])
    serial = _ptrain(p, X, y, 3, **kw)
    assert any(bool(t.is_cat_split.any()) for t in serial.trees)
    # reduce_scatter sums in shard order, as psum does: the serial trees
    for extra in ({"tree_learner": "data", "histogram_merge":
                   "reduce_scatter"}, {"tree_learner": "feature"}):
        b = _ptrain(dict(p, **extra), X, y, 3, **kw)
        assert b._mesh is not None
        _same_structure(serial, b)
    with pytest.warns(UserWarning, match="reduce_scatter merge instead"):
        b = _ptrain(dict(p, tree_learner="voting"), X, y, 3, **kw)
    assert b._mesh.mode == "reduce_scatter"
    _same_structure(serial, b)
    # the default ring on the dyadic tier (every sum exact): the serial
    # round-1 tree and the reference's ring tree bit for bit.  On the
    # general data above the ring's order meets an ulp near-tie in the
    # subset ranking g / (h + cat_smooth) (a leaf's gains 466.34619 and
    # 466.34595: ROADMAP C.4's regime), so it is held where sums are exact
    yd = np.zeros(n, np.float32)
    yd[np.argsort(X[:, 0] + np.isin(X[:, 1], [1, 3, 7]))[n // 2:]] = 1.0
    pd = {"objective": "regression", "num_leaves": 7, "verbosity": -1}
    s1 = _ptrain(pd, X, yd, 1, **kw)
    b = _ptrain(dict(pd, tree_learner="data"), X, yd, 1, **kw)
    assert b._mesh.mode == "reduce_scatter_pipelined"
    assert bool(b.trees[0].is_cat_split.any())
    _bit_equal(s1, b)
    want = R.train(dict(pd, tree_learner="data"),
                   R.Dataset(X, label=yd, categorical_feature=[1]),
                   num_boost_round=1)
    for f in STRUCT + ("leaf_value",):
        np.testing.assert_array_equal(_arr(getattr(b.trees[0], f)),
                                      np.asarray(getattr(want.trees[0], f)))


def test_linear_tree_matches_serial():
    X, y = _reg(n=2048, f=4, seed=9)
    p = dict(BASE, linear_tree=True, num_leaves=7)
    kw = dict(params={"enable_bundle": False}, free_raw_data=False)
    serial = _ptrain(p, X, y, 3, **kw)
    b = _ptrain(dict(p, tree_learner="data"), X, y, 3, **kw)
    assert b._mesh is not None
    for ts_, tb in zip(serial.trees, b.trees):
        np.testing.assert_array_equal(_arr(ts_.split_feature),
                                      _arr(tb.split_feature))
        np.testing.assert_array_equal(_arr(ts_.linear_feat),
                                      _arr(tb.linear_feat))
        np.testing.assert_allclose(_arr(ts_.linear_coef),
                                   _arr(tb.linear_coef), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(serial.predict(X), b.predict(X), rtol=1e-4,
                               atol=1e-4)
