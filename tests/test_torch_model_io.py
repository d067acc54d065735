"""Port parity: model files and trees carried between the two packages.

* The JSON text model: a port-trained model saved as text loads into
  ``lightgbm_tpu.Booster(model_file=...)``, and a reference-trained one into
  the port's ``Booster(model_file=..., device="cpu")``; predictions agree
  within rtol 1e-6 either way (the same trees, the same f32 arithmetic).
* ``pack_booster``: the port packs the same trees into the same arrays as
  the reference, and the packed forest predicts what ``Booster.predict``
  does (rtol 1e-5); the ``.npz`` interchanges both ways.
* ``tree_to_arrays`` / ``tree_from_arrays`` carry a reference tree into the
  port unchanged.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.serving.packed import PackedForest as RPacked
from lightgbm_tpu.serving.packed import pack_booster as r_pack
from lightgbm_tpu_torch.models.tree import tree_from_arrays, tree_to_arrays
from lightgbm_tpu_torch.ops.predict import predict_tree_binned
from lightgbm_tpu_torch.serving import PackedForest, pack_booster

PARAMS = dict(objective="binary", num_leaves=31, learning_rate=0.2,
              min_data_in_leaf=10, feature_fraction=0.8, verbose=-1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    X = rng.normal(size=(4500, 5))
    y = (rng.random(4500) < 1 / (1 + np.exp(-(X[:, 0] - X[:, 1] * X[:, 2])))
         ).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def port_model(data):
    X, y = data
    return P.train(PARAMS, P.Dataset(X, label=y, device="cpu"), 4)


@pytest.fixture(scope="module")
def ref_model(data):
    X, y = data
    return R.train(PARAMS, R.Dataset(X, label=y), 4)


def test_port_text_model_loads_in_reference(port_model, data, tmp_path):
    X, _ = data
    path = str(tmp_path / "port_model.txt")
    port_model.save_model(path)
    ref = R.Booster(model_file=path)
    assert ref.num_trees() == port_model.num_trees() == 4
    np.testing.assert_allclose(ref.predict(X), port_model.predict(X),
                               rtol=1e-6)
    np.testing.assert_allclose(ref.predict(X, raw_score=True),
                               port_model.predict(X, raw_score=True),
                               rtol=1e-6, atol=1e-7)


def test_reference_text_model_loads_in_port(ref_model, data, tmp_path):
    X, _ = data
    path = str(tmp_path / "ref_model.txt")
    ref_model.save_model(path)
    port = P.Booster(model_file=path, device="cpu")
    assert port.num_trees() == 4 and port.device.type == "cpu"
    np.testing.assert_allclose(port.predict(X), ref_model.predict(X),
                               rtol=1e-6)
    again = P.Booster(model_str=port.model_to_string(), device="cpu")
    np.testing.assert_array_equal(again.predict(X), port.predict(X))
    for i in range(4):
        a = r_arrays(ref_model.trees[i])
        b = tree_to_arrays(port.trees[i])
        for k in ("split_feature", "split_bin", "left", "right", "is_leaf",
                  "leaf_value"):
            assert np.array_equal(a[k], b[k]), k


def test_pack_booster_matches_reference(ref_model, data, tmp_path):
    X, _ = data
    path = str(tmp_path / "ref_model.txt")
    ref_model.save_model(path)
    port = P.Booster(model_file=path, device="cpu")
    want, got = r_pack(ref_model), pack_booster(port)
    for k in ("split_feature", "split_bin", "left", "right", "leaf_value",
              "is_leaf"):
        assert np.array_equal(getattr(want, k), getattr(got, k)), k
    assert got.shrink == want.shrink and got.depth_cap == want.depth_cap
    np.testing.assert_array_equal(got.init_score, want.init_score)
    assert got.bin_mapper_dict == want.bin_mapper_dict
    codes = got.bin_mapper.transform(X)
    np.testing.assert_allclose(got.predict_numpy(codes, raw_score=False),
                               port.predict(X), rtol=1e-5)


def test_port_packed_npz_interchanges(port_model, data, tmp_path):
    X, _ = data
    path = str(tmp_path / "port_model.npz")
    port_model.save_model(path)
    codes = port_model.train_set.bin_mapper.transform(X)
    mine = PackedForest.load(path)
    theirs = RPacked.load(path)
    direct = port_model.predict(X)
    np.testing.assert_allclose(mine.predict_numpy(codes, raw_score=False),
                               direct, rtol=1e-5)
    np.testing.assert_allclose(theirs.predict_numpy(codes, raw_score=False),
                               direct, rtol=1e-5)
    loaded = P.Booster(model_file=path, device="cpu")
    np.testing.assert_allclose(loaded.predict(X), direct, rtol=1e-6)
    with pytest.raises(ValueError, match="empty tree selection"):
        pack_booster(port_model, start_iteration=9)


def test_tree_arrays_carry_reference_trees(ref_model, data):
    X, _ = data
    import jax.numpy as jnp
    from lightgbm_tpu.ops.predict import predict_tree_binned as r_tree

    codes = ref_model.train_set.bin_mapper.transform(X)
    for i in range(2):
        arrays = r_arrays(ref_model.trees[i])
        tree = tree_from_arrays(arrays)
        assert tree.split_feature.dtype == torch.int32
        assert tree.is_leaf.dtype == torch.bool
        got = predict_tree_binned(tree, torch.from_numpy(codes), 31)
        want = r_tree(ref_model.trees[i], jnp.asarray(codes), 31)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = tree_to_arrays(tree)
        for k, v in arrays.items():
            assert np.array_equal(back[k], v), k
