"""Port parity: what multi-device training composes with, and its
warnings, refusals and entry points, over 8 virtual shards on the CPU
(the options half of the reference's ``tests/test_parallel.py`` and
``tests/test_merge_modes.py``; the learners themselves are in
``test_torch_parallel_train.py``).

* per-shard GOSS against the reference's (single-class) and multiclass GOSS;
* quantized histograms (per-shard int8 scales), lossy bf16/int8 wires and
  the sampled or constrained options: the dp model's held-in L2 within 2%
  of the serial model's, and the serial trees wherever the option is exact
  (rf, monotone, extra-trees, per-node sampling, interaction groups,
  screening, bf16sr on exact statistics);
* the reference's warnings (DART, leaf renewal, the feature learner's
  scope, a 2-D shape the options do not allow, one visible device) and its
  refusals (``tree_learner``, ``top_k``, ``histogram_merge``,
  ``histogram_wire``, ``merge_chunks``, ``mesh_shape``), and D lowered to
  a divisor of the padded rows;
* the keys through the sklearn estimator, ``cv``'s per-fold route and the
  CLI (``LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES`` for its shards).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.parallel import set_virtual_devices

from test_torch_parallel_train import ATOL, BASE, RTOL, _arr, _ptrain, \
    _reg, _same_structure


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


def test_goss_samples_per_shard_and_matches_reference():
    """Per-shard GOSS: each shard compacts its own rows under fold_in(key,
    shard) — the reference's selection, so the trees are the reference's
    (within the regime); the tree is replicated and every row scored."""
    X, y = _reg(n=4096, f=6, seed=5)
    p = dict(BASE, boosting="goss", tree_learner="data", top_rate=0.2,
             other_rate=0.1)
    got = _ptrain(p, X, y, 3)
    assert got._mesh is not None and got._goss_k_shard() == (102, 51)
    want = R.train(dict(p), R.Dataset(X, label=y), num_boost_round=3)
    for tg, tw in zip(got.trees, want.trees):
        np.testing.assert_array_equal(_arr(tg.split_feature),
                                      np.asarray(tw.split_feature))
        np.testing.assert_allclose(_arr(tg.leaf_value),
                                   np.asarray(tw.leaf_value), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=RTOL,
                               atol=1e-5)


def test_multiclass_goss_trains():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(2048, 4)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32) + (X[:, 1] > 0.5)
    b = _ptrain({"objective": "multiclass", "num_class": 3, "num_leaves": 7,
                 "boosting": "goss", "tree_learner": "data",
                 "verbosity": -1}, X, y, 3)
    assert b._mesh is not None and b.current_iteration() == 3
    assert np.isfinite(b.predict(X)).all()


@pytest.mark.parametrize("extra", [
    {"hist_dtype": "int8"}, {"histogram_wire": "bf16"},
    {"histogram_wire": "int8"},
    {"histogram_wire": "bf16", "histogram_merge": "reduce_scatter_ring"},
    {"hist_dtype": "bf16sr"}, {"boosting": "rf", "bagging_fraction": 0.6,
                               "bagging_freq": 1},
    {"monotone_constraints": [1, 0, 0, 0, 0, 0]}, {"extra_trees": True},
    {"feature_fraction_bynode": 0.6},
    {"interaction_constraints": [[0, 1], [2, 3, 4, 5]]},
    {"feature_screen": "ema", "screen_keep_ratio": 0.5,
     "screen_refresh_rounds": 2}])
def test_option_trains_close_to_serial(extra):
    """Quantized histograms (per-shard scales), lossy wires and sampled or
    constrained options: the dp model's held-in L2 stays within 2% of the
    serial model's (exact options grow the serial trees too)."""
    X, y = _reg(n=2048, seed=12)
    p = dict(BASE, **extra)
    serial = _ptrain(p, X, y, 3)
    b = _ptrain(dict(p, tree_learner="data"), X, y, 3)
    assert b._mesh is not None
    l2s = float(np.mean((serial.predict(X) - y) ** 2))
    l2d = float(np.mean((b.predict(X) - y) ** 2))
    assert abs(l2d - l2s) <= 0.02 * l2s + 1e-6, (l2s, l2d)
    if not any(k in extra for k in ("hist_dtype", "histogram_wire")):
        _same_structure(serial, b)


# ------------------------------------------------- warnings and refusals

@pytest.mark.parametrize("extra,match", [
    ({"boosting": "dart", "tree_learner": "data"}, "training serially"),
    ({"objective": "quantile", "tree_learner": "data"}, "training serially"),
    ({"boosting": "goss", "tree_learner": "feature"}, "training serially"),
    ({"feature_fraction_bynode": 0.5, "tree_learner": "feature"},
     "training serially"),
    ({"tree_learner": "data", "mesh_shape": "2x4",
      "histogram_merge": "psum"}, "1-D row mesh")])
def test_out_of_scope_warns_and_trains(extra, match):
    X, y = _reg(n=1024)
    with pytest.warns(UserWarning, match=match):
        b = _ptrain(dict(BASE, **extra), X, y, 2)
    assert b.num_trees() == 2
    if match == "training serially":
        assert b._mesh is None
    else:
        assert b._mesh is not None and b._mesh.dc == 1


def test_one_device_trains_serially():
    set_virtual_devices(0)
    X, y = _reg(n=1024)
    with pytest.warns(UserWarning, match="only one device is visible"):
        b = _ptrain(dict(BASE, tree_learner="data"), X, y, 2)
    assert b._mesh is None
    with pytest.warns(UserWarning, match="only one device is visible"):
        _ptrain(dict(BASE, tree_learner="feature"), X, y, 1)
    with pytest.raises(P.NoDeviceError if hasattr(P, "NoDeviceError")
                       else RuntimeError):
        if torch.cuda.is_available():
            raise RuntimeError("a card is visible")
        P.train(dict(BASE, tree_learner="data"), P.Dataset(X, label=y), 1)


def test_rows_lower_d_to_a_divisor():
    """D drops until it divides the padded rows (the reference's rule)."""
    set_virtual_devices(3)
    X, y = _reg(n=1024)                     # 1,024 padded rows: D = 2
    b = _ptrain(dict(BASE, tree_learner="data"), X, y, 1)
    assert b._mesh.n_devices == 2


@pytest.mark.parametrize("spec,f,want", [
    ("auto", 64, (4, 2)), ("auto", 63, (8, 1)), ("1d", 64, (8, 1)),
    ("2x4", 6, (2, 4)), ("8x1", 6, (8, 1))])
def test_dp2_mesh_shape_routing(spec, f, want):
    """The reference's ``_dp2_shape``: ``"auto"`` promotes the plain data
    learner to ``(D / 2, 2)`` at D >= 8 and F >= 64, ``"1d"`` keeps rows,
    ``"RxC"`` pins the shape (C = 1 is the row mesh)."""
    rng = np.random.default_rng(f)
    X = rng.normal(size=(1024, f)).astype(np.float32)
    y = X[:, 0].astype(np.float32)
    b = P.Booster(dict(BASE, tree_learner="data", mesh_shape=spec),
                  P.Dataset(X, label=y, device="cpu",
                            params={"enable_bundle": False}))
    assert (b._mesh.dr, b._mesh.dc) == want
    assert b._dp2 == (want[1] > 1)
    assert ("mesh" in b.parallel_meta()) == (want[1] > 1)


def test_validation_errors():
    X, y = _reg(n=1024)
    with pytest.raises(ValueError, match="tree_learner"):
        _ptrain(dict(BASE, tree_learner="ring"), X, y, 1)
    with pytest.raises(ValueError, match="top_k"):
        _ptrain(dict(BASE, tree_learner="voting", top_k=0), X, y, 1)
    with pytest.raises(ValueError, match="histogram_merge"):
        _ptrain(dict(BASE, tree_learner="data", histogram_merge="gather"),
                X, y, 1)
    with pytest.raises(ValueError, match="histogram_wire"):
        _ptrain(dict(BASE, tree_learner="data", histogram_wire="fp8"),
                X, y, 1)
    with pytest.raises(ValueError, match="ring"):
        _ptrain(dict(BASE, tree_learner="data", histogram_merge="psum",
                     histogram_wire="int8"), X, y, 1)
    with pytest.raises(ValueError, match="merge_chunks"):
        _ptrain(dict(BASE, tree_learner="data", merge_chunks=0), X, y, 1)
    with pytest.raises(ValueError, match="mesh_shape"):
        _ptrain(dict(BASE, tree_learner="data", mesh_shape="4by2"), X, y, 1)
    with pytest.raises(ValueError, match="wants 6 devices"):
        _ptrain(dict(BASE, tree_learner="data", mesh_shape="3x2"), X, y, 1)
    p = P.Booster(dict(BASE, tree_learner="voting", topk=11),
                  P.Dataset(X, label=y, device="cpu"))
    assert p.params.top_k == 11 and p._mesh.voting_k == 11


def test_entry_points_pass_the_keys(tmp_path):
    """sklearn, cv's per-fold route and the CLI reach the mesh."""
    import subprocess
    import sys

    X, y = _reg(n=2048)
    est = P.LGBMRegressor(n_estimators=3, num_leaves=7, tree_learner="data",
                          histogram_merge="reduce_scatter", device="cpu")
    est.fit(X, y)
    assert est.booster_._mesh is not None
    assert est.booster_._mesh.mode == "reduce_scatter"
    ser = P.LGBMRegressor(n_estimators=3, num_leaves=7, device="cpu").fit(X, y)
    np.testing.assert_allclose(est.predict(X), ser.predict(X), rtol=RTOL,
                               atol=1e-5)
    res = P.cv(dict(BASE, num_leaves=7, boosting="goss",
                    tree_learner="data"),
               P.Dataset(X, label=y, device="cpu"), 3, nfold=2,
               return_cvbooster=True)
    assert all(b._mesh is not None for b in res["cvbooster"].boosters)
    csv = tmp_path / "train.csv"
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",",
               header=",".join(["y"] + [f"x{i}" for i in range(6)]),
               comments="")
    env = dict(__import__("os").environ,
               LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES="4")
    out = subprocess.run(
        [sys.executable, "-m", "lightgbm_tpu_torch", "task=train",
         f"data={csv}", "header=true", "label_column=name:y",
         "objective=regression", "num_trees=3", "num_leaves=7",
         "tree_learner=data", "histogram_merge=reduce_scatter_ring",
         "histogram_wire=bf16", "merge_chunks=2", "mesh_shape=1d",
         "top_k=5", "device=cpu", f"output_model={tmp_path / 'm.txt'}"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = P.Booster(model_file=str(tmp_path / "m.txt"), device="cpu")
    assert loaded.num_trees() == 3
