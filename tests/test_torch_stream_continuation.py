"""Port parity: streamed Datasets beyond the round step, on the CPU —
model files carried across between the packages in both directions and
continued on a streamed Dataset (``Booster(model_file).update``, the
block-store replay of the loaded forest), ``rollback_one_iter`` and rf's
train metric by block passes, and ``iter_higgs_like_blocks`` equal to the
reference's blocks.

Tolerances: the replayed train scores equal the writer's scores within
rtol 1e-5 / atol 1e-6 across packages (bit for bit within the port); the
continued trees keep the writer's split structure with leaf values within
the same regime (PARITY's).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.utils.datasets as RD
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.utils.datasets as PD
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays

PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              max_bin=63, min_data_in_leaf=5, wave_width=4, verbose=-1,
              seed=7, stream_block_rows=512)


def _blocks(n=1800, f=6, seed=17):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X[:, 0] - X[:, 1] * X[:, 2]))
                              )).astype(np.float32)
    return X, [(X[lo:lo + 512], y[lo:lo + 512]) for lo in range(0, n, 512)]


def _regime(ta, tb):
    for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
        assert np.array_equal(ta[k], tb[k]), k
    np.testing.assert_allclose(ta["leaf_value"], tb["leaf_value"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_streamed_model_file_continues_in_the_other_package(writer,
                                                            tmp_path):
    X, blocks = _blocks()
    path = str(tmp_path / "m.txt")
    if writer == "reference":
        src = R.train(PARAMS, R.Dataset.from_blocks(blocks,
                                                    params=dict(PARAMS)), 3)
        src.save_model(path)
        ds = P.Dataset.from_blocks(blocks, params=dict(PARAMS), device="cpu")
        dst = P.Booster(model_file=path, device="cpu")
    else:
        src = P.train(PARAMS, P.Dataset.from_blocks(
            blocks, params=dict(PARAMS), device="cpu"), 3)
        src.save_model(path)
        ds = R.Dataset.from_blocks(blocks, params=dict(PARAMS))
        dst = R.Booster(model_file=path)
    dst.update(ds)                       # replays the 3 trees, grows one
    src.update()
    assert len(dst.trees) == len(src.trees) == 4
    sa = r_arrays if writer == "reference" else p_arrays
    da = p_arrays if writer == "reference" else r_arrays
    for ts, td in zip(src.trees, dst.trees):
        _regime(sa(ts), da(td))
    np.testing.assert_allclose(np.asarray(dst._pred_train),
                               np.asarray(src._pred_train), rtol=1e-5,
                               atol=1e-6)


def test_rollback_and_rf_metric_by_block_passes():
    X, blocks = _blocks(seed=19)
    ds = P.Dataset.from_blocks(blocks, params=dict(PARAMS), device="cpu")
    b = P.Booster(dict(PARAMS), ds)
    b.update()
    after1 = b._pred_train.clone()
    b.update()
    b.rollback_one_iter()
    assert len(b.trees) == 1
    torch.testing.assert_close(b._pred_train, after1, rtol=1e-6, atol=1e-6)
    rf = dict(PARAMS, boosting="rf", bagging_fraction=0.6, bagging_freq=1)
    brf = P.train(rf, P.Dataset.from_blocks(blocks, params=dict(rf),
                                            device="cpu"), 3)
    mem = P.train(rf, P.Dataset(X, label=np.concatenate(
        [b_[1] for b_ in blocks]), params=dict(rf), device="cpu"), 3)
    (_, name, got, _), = brf.eval_train()
    (_, _, want, _), = mem.eval_train()
    assert name == "binary_logloss"
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_iter_higgs_like_blocks_equal_reference():
    ours = list(PD.iter_higgs_like_blocks(5000, 7, seed=3, block_rows=2048))
    ref = list(RD.iter_higgs_like_blocks(5000, 7, seed=3, block_rows=2048))
    assert [len(x) for x, _ in ours] == [2048, 2048, 904]
    for (xa, ya), (xb, yb) in zip(ours, ref):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)
    ds = P.Dataset.from_blocks(
        lambda: PD.iter_higgs_like_blocks(5000, 7, seed=3, block_rows=2048),
        params={"stream_block_rows": 2048}, device="cpu")
    assert ds.num_data() == 5000 and ds.block_store.num_blocks == 3
