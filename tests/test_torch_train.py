"""Port parity: the training slice as a whole (``Dataset`` -> ``train`` /
``cv`` -> the wave grower), on the CPU with the plain histogram versions.

Every input is made from a numpy seed and goes through ``lightgbm_tpu``
(the reference) and ``lightgbm_tpu_torch`` with the same params:

(a) dyadic tier — l2 on y in {0, 1} with exactly n/2 ones, so the init score
    is 0.5 and every round-1 gradient is +-0.5: every histogram sum is exact
    in any order, and the round-1 trees (split feature, bin, children, leaf
    values) and predictions are bit-identical, at f32 and bf16 histograms,
    for the exact and greedy wave tails;
(b) general data with the paramGrid's bagging and feature fraction, l2 and
    binary, five rounds: split structure and row routing equal, leaf values
    and predictions within rtol 1e-5 / atol 1e-6 (the sums are taken in
    other orders, and XLA's f32 ``exp`` is not torch's: split gains differ
    by ~1e-6 relative, so two candidate thresholds whose gains lie closer
    than that can swap; the data below has no such near-tie in five rounds,
    as about four seeds in five do);
(c) ``train`` with a valid set and early stopping: ``best_iteration``
    equal, ``evals_result`` within rtol 1e-5;
(d) ``cv(nfold=3, early_stopping_rounds=5)`` against the reference's
    per-fold path: histories within rtol 1e-5, ``best_iter`` equal,
    ``best_score`` sign-flipped and within rtol 1e-5;
(e) every option under a mesh learner (``tree_learner="data"`` /
    ``"feature"``) trains on 8 virtual shards, or warns and trains serially
    where the reference keeps it serial.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays

RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves")
GRID = dict(num_leaves=31, learning_rate=0.1, min_data_in_leaf=20,
            feature_fraction=0.8, bagging_fraction=0.6, bagging_freq=4,
            verbose=-1)


def _dyadic(n=4096, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    order = np.argsort(X @ w + 0.6 * np.sin(X[:, 0] * 2))
    y = np.zeros(n, np.float32)
    y[order[n // 2:]] = 1.0
    return X, y


def _general(n, f=6, seed=3, noise=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f))
    y_reg = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] * X[:, 3]
             + noise * rng.normal(0, 1, n))
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y_bin = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return X, y_reg, y_bin


def _train_both(params, X, y, rounds, **kw):
    br = R.train(params, R.Dataset(X, label=y), rounds, **kw)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), rounds, **kw)
    return br, bp


# ---------------------------------------------------------------- (a) dyadic
DYADIC = dict(objective="l2", num_leaves=31, learning_rate=0.5,
              min_data_in_leaf=5, max_bin=63, verbose=-1)


@pytest.fixture(scope="module")
def dyadic_data():
    return _dyadic()


@pytest.mark.parametrize("hist_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("tail", ["exact", "greedy"])
def test_dyadic_round1_bit_identical(dyadic_data, tail, hist_dtype):
    X, y = dyadic_data
    params = dict(DYADIC, hist_dtype=hist_dtype, wave_tail=tail)
    br, bp = _train_both(params, X, y, 1)
    a, b = r_arrays(br.trees[0]), p_arrays(bp.trees[0])
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert int(b["num_leaves"]) == 31
    assert np.array_equal(br.predict(X), bp.predict(X))
    assert np.array_equal(np.asarray(br._pred_train),
                          bp._pred_train.numpy())


def test_dyadic_half_tail_with_every_regularizer(dyadic_data):
    """The half tail, and the split regularizers of ops/split.py, on the
    dyadic tier: still bit-identical (the same f32 ops on exact sums)."""
    X, y = dyadic_data
    params = dict(DYADIC, hist_dtype="f32", wave_tail="half", max_depth=4,
                  lambda_l1=0.5, lambda_l2=1.0, min_gain_to_split=0.1,
                  path_smooth=2.0, max_delta_step=0.3,
                  min_sum_hessian_in_leaf=3.0)
    br, bp = _train_both(params, X, y, 2)
    for i in range(2):
        a, b = r_arrays(br.trees[i]), p_arrays(bp.trees[i])
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), (i, k)
    a, b = r_arrays(br.trees[0]), p_arrays(bp.trees[0])
    assert np.array_equal(a["leaf_value"], b["leaf_value"])
    assert np.abs(b["leaf_value"]).max() <= np.float32(0.3)


# ------------------------------------------------------- (b) + (c) general
@pytest.fixture(scope="module")
def general_l2():
    """l2 with bagging and feature fraction, a valid set and early stopping
    — its first five rounds serve (b), the run as a whole (c)."""
    X, y, _ = _general(7000, noise=1.5)
    Xt, yt, Xv, yv = X[:5000], y[:5000], X[5000:], y[5000:]
    params = dict(GRID, objective="regression", learning_rate=0.3,
                  metric=["l2", "l1"])
    out = {}
    for name, lib, kw in (("ref", R, {}), ("port", P, {"device": "cpu"})):
        dtrain = lib.Dataset(Xt, label=yt, **kw)
        dvalid = lib.Dataset(Xv, label=yv, reference=dtrain)
        evals = {}
        b = lib.train(params, dtrain, 60, valid_sets=[dvalid],
                      valid_names=["valid"], early_stopping_rounds=3,
                      evals_result=evals)
        out[name] = (b, evals)
    return out, Xt


@pytest.fixture(scope="module")
def general_binary():
    X, _, y = _general(5000, seed=5)
    return _train_both(dict(GRID, objective="binary"), X, y, 5), X


def _check_general(br, bp, X, rounds=5):
    for i in range(rounds):
        a, b = r_arrays(br.trees[i]), p_arrays(bp.trees[i])
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), (i, k)
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(b["count"], a["count"], rtol=0, atol=0)
    np.testing.assert_allclose(bp.predict(X, num_iteration=rounds),
                               br.predict(X, num_iteration=rounds),
                               rtol=RTOL, atol=ATOL)


def test_general_l2_structure_and_values(general_l2):
    out, X = general_l2
    br, bp = out["ref"][0], out["port"][0]
    assert br.num_trees() >= 5
    _check_general(br, bp, X)


def test_general_binary_structure_and_values(general_binary):
    (br, bp), X = general_binary
    _check_general(br, bp, X)
    # row routing: every training row accumulated the same leaves
    np.testing.assert_allclose(bp._pred_train.numpy(),
                               np.asarray(br._pred_train), rtol=RTOL,
                               atol=ATOL)


def test_early_stopping_and_evals_result(general_l2):
    out, _ = general_l2
    (br, er), (bp, ep) = out["ref"], out["port"]
    assert 5 <= bp.best_iteration < 60
    assert bp.best_iteration == br.best_iteration
    assert bp.num_trees() == br.num_trees()
    assert set(ep) == set(er) == {"valid"}
    for m in ("l2", "l1"):
        assert len(ep["valid"][m]) == len(er["valid"][m])
        np.testing.assert_allclose(ep["valid"][m], er["valid"][m],
                                   rtol=RTOL)
    for m, v in br.best_score["valid"].items():
        np.testing.assert_allclose(bp.best_score["valid"][m], v, rtol=RTOL)
    # predict() defaults to the best iteration in both packages
    Xq = np.random.default_rng(1).normal(size=(50, 6))
    np.testing.assert_allclose(bp.predict(Xq), br.predict(Xq), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------------- (d) cv
def test_cv_matches_reference_per_fold_path():
    # noisy labels and a high rate stop early: every extra round of every
    # fold is one more chance of a near-tie swap (see (b))
    X, y, _ = _general(6400, seed=6, noise=2.0)
    params = dict(GRID, objective="regression", learning_rate=0.5,
                  num_leaves=16, max_bin=31)
    want = R.cv(params, R.Dataset(X, label=y), 40, nfold=3,
                early_stopping_rounds=5, return_cvbooster=True)
    got = P.cv(params, P.Dataset(X, label=y, device="cpu"), 40, nfold=3,
               early_stopping_rounds=5, return_cvbooster=True)
    keys = [k for k in want if k != "cvbooster"]
    assert sorted(k for k in got if k != "cvbooster") == sorted(keys)
    for k in keys:
        assert len(got[k]) == len(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-7)
    assert got.best_iter == want.best_iter
    assert 1 <= got.best_iter < 40
    assert got.best_score < 0
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)
    assert len(got.cvbooster.boosters) == 3


# ------------------------------------------------------ (e) out of the slice
# each option under a mesh learner: on 8 virtual shards it trains on the
# mesh, or (the reference's scope) warns and trains serially
MESH_SERIAL = ("dart", "multiclass", "bynode", "quantile")
OUT_OF_SLICE = {
    # goss and dart train since their slice; under a learner outside the
    # slice they still raise by name
    "goss": {"boosting": "goss", "tree_learner": "data"},
    "dart": {"boosting": "dart", "tree_learner": "data"},
    # rf and per-node sampling train since the bagging/boosting slice;
    # under a learner outside the slice they still raise by name
    "rf": {"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1,
           "tree_learner": "data"},
    # multiclass trains since the batched wave grower, and multiclass dart
    # since its slice; under a learner outside the slice it still raises by
    # name
    "multiclass": {"objective": "multiclass", "num_class": 3,
                   "boosting": "dart", "tree_learner": "data"},
    # ranking trains since its slice (a Dataset with group=); under a
    # learner outside the slice it still raises by name
    "lambdarank": {"objective": "lambdarank", "tree_learner": "data"},
    # the remaining objectives and bf16sr train since their slice; under a
    # learner outside the slice they still raise by name
    "poisson": {"objective": "poisson", "tree_learner": "data"},
    # linear leaves train since their slice; under a learner outside the
    # slice they still raise by name
    "linear_tree": {"linear_tree": True, "tree_learner": "data"},
    # the constraints and extra_trees train since their slice; under a
    # learner outside the slice they still raise by name
    "monotone": {"monotone_constraints": [1, 0, 0, 0],
                 "tree_learner": "data"},
    "interaction": {"interaction_constraints": [[0, 1], [2, 3]],
                    "tree_learner": "data"},
    "extra_trees": {"extra_trees": True, "tree_learner": "data"},
    "bynode": {"feature_fraction_bynode": 0.5, "tree_learner": "feature"},
    "bf16sr": {"hist_dtype": "bf16sr", "tree_learner": "data"},
    # feature screening trains since its slice; under a learner outside
    # the slice it still raises by name
    "feature_screen": {"feature_screen": "ema", "tree_learner": "data"},
    "data_parallel": {"tree_learner": "data"},
    "feature_parallel": {"tree_learner": "feature"},
    # int8 trains since B1's int8 mode; under a learner outside the slice
    # it still raises by name
    "int8": {"hist_dtype": "int8", "tree_learner": "data"},
    "quantile": {"objective": "quantile", "tree_learner": "data"},
}


@pytest.fixture(scope="module")
def small_set():
    rng = np.random.default_rng(8)
    X = rng.normal(size=(4096, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_out_of_slice_raises_named_error(small_set, case):
    """Since the multi-device slice these options train under the mesh
    learners (the name is kept from when they raised): on the mesh, or with
    the reference's warning serially; lambdarank still needs its groups."""
    from lightgbm_tpu_torch.parallel import set_virtual_devices

    X, y = small_set
    params = dict(objective="binary", num_leaves=31, verbose=-1)
    params.update(OUT_OF_SLICE[case])
    set_virtual_devices(8)
    try:
        ds = P.Dataset(X, label=y, device="cpu",
                       free_raw_data=case != "linear_tree",
                       params={"enable_bundle": False})
        if case == "lambdarank":
            with pytest.raises(ValueError, match="query group"):
                P.train(params, ds, 2)
            return
        if case in MESH_SERIAL:
            with pytest.warns(UserWarning, match="training serially"):
                b = P.train(params, ds, 2)
            assert b._mesh is None
        else:
            b = P.train(params, ds, 2)
            assert b._mesh is not None and b._mesh.n_devices == 8
        assert b.current_iteration() == 2
        assert np.isfinite(b.predict(X)).all()
    finally:
        set_virtual_devices(0)


def test_out_of_slice_datasets_and_init_model(small_set, tmp_path):
    X, y = small_set
    # categorical features train (ROADMAP item 7): a categorical Dataset
    # constructs, flags its column and grows subset splits on it
    Xc = X.copy()
    Xc[:, 0] = X[:, 3]                  # the label lives in the categories
    Xc[:, 1] = np.where(X[:, 0] > 0, 2.0, 5.0) + (X[:, 2] > 0)
    dc = P.Dataset(Xc, label=y, device="cpu", categorical_feature=[1])
    assert dc.col_is_categorical.tolist() == [False, True, False, False]
    bc = P.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                 dc, 2)
    assert all(t.is_cat_split is not None for t in bc.trees)
    assert bool(torch.stack([t.is_cat_split for t in bc.trees]).any())
    # query groups train (ROADMAP item 8): a grouped Dataset constructs,
    # holds its per-row query ids and trains lambdarank
    dg = P.Dataset(X, label=y, device="cpu", group=[2048, 2048])
    assert np.array_equal(dg.get_group(), [2048, 2048])
    bg = P.train({"objective": "lambdarank", "num_leaves": 7, "verbose": -1,
                  "eval_at": [5]}, dg, 2, valid_sets=[dg])
    assert int(dg.group_id.max()) == 1 and bg.num_trees() == 2
    assert [r[1] for r in bg.eval_train()] == ["ndcg@5"]
    # streamed datasets train (ROADMAP item 11): from_blocks constructs a
    # block store with the codes on the host, and train grows from it
    blocks = [(X[i:i + 1024], y[i:i + 1024]) for i in range(0, 4096, 1024)]
    dstream = P.Dataset.from_blocks(
        blocks, params={"stream_block_rows": 1024}, device="cpu")
    assert dstream.is_streamed and dstream.X_binned is None
    assert dstream.block_store.num_blocks == 4
    bs = P.train({"objective": "binary", "num_leaves": 7, "verbose": -1},
                 dstream, 2)
    assert bs.num_trees() == 2 and dstream.block_store.passes > 0
    # continuation trains (ROADMAP item 10): init_model's trees come first
    ds = P.Dataset(X, label=y, device="cpu")
    b = P.train({"objective": "binary", "verbose": -1}, ds, 1)
    c = P.train({"objective": "binary", "verbose": -1}, ds, 1, init_model=b)
    assert c.num_trees() == 2
    assert torch.equal(c.trees[0].leaf_value, b.trees[0].leaf_value)
    # a binary dataset file reloads (ROADMAP item 10)
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    back = P.Dataset(path, device="cpu")
    assert torch.equal(back.construct().X_binned, ds.X_binned)


def test_update_many_equals_update_loop(small_set):
    X, y = small_set
    params = dict(GRID, objective="binary", num_leaves=16)
    a = P.Booster(params, P.Dataset(X, label=y, device="cpu"))
    a.update_many(3)
    b = P.Booster(params, P.Dataset(X, label=y, device="cpu"))
    for _ in range(3):
        b.update()
    for ta, tb in zip(a.trees, b.trees):
        for k, v in p_arrays(ta).items():
            assert np.array_equal(v, p_arrays(tb)[k])
    assert a.current_iteration() == 3
    imp = a.feature_importance("split")
    assert imp.sum() == sum(int(t.num_leaves) - 1 for t in a.trees)
    assert torch.equal(a._pred_train, b._pred_train)
