"""Port parity: out-of-core (streamed) training on the CPU —
``Dataset.from_blocks`` -> ``train`` / ``Booster.update`` through the
streamed growers (``data/stream_grow.py``, the ``_stream_*`` steps of
``models/tree.py``) — against the reference's streamed training and the
port's own in-memory training.

Tolerances: the port sums a pass's block histograms in float64 and rounds
once, where the reference's streamed path replicates XLA's chunked f32
sums, so

* on the dyadic tier (l2 on y in {0, 1} with exactly n/2 ones: every
  round-1 histogram sum exact in any order) the round-1 trees and scores
  are bit for bit the reference's streamed ones and the port's in-memory
  ones, strict and wave growers, multi-block stores with ragged tails and a
  single padded block, F in {5, 13};
* on general data (binary, several rounds, bagging and feature fraction,
  rf, an l1 renewal) split structure and routing are equal and leaf values
  and scores within rtol 1e-5 / atol 1e-6 (PARITY's regime);
* GOSS at the source selects the reference's rows exactly from bit-equal
  gradients (round 1);
* the streamed scope fences raise ``StreamScopeError`` with the
  reference's keys in the reference's order, ``tree_learner="feature"`` /
  ``"voting"`` warns and streams serially, as ``"data"`` does on one
  device, and a streamed valid set, ``save_binary`` and ``subset`` are
  refused;
* streamed checkpoints interchange with the reference's in both directions
  (``streamed: true``, a ``padded_rows``-long ``pred_train``), a killed run
  resumes bit for bit, and ``init_model`` continues a streamed run bit for
  bit.
"""

import warnings

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.data.block_store as RB
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.data.block_store as PB
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.training import resume_booster as r_resume
from lightgbm_tpu.training import save_checkpoint as r_save
from lightgbm_tpu_torch.faults import StreamScopeError
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.training import resume_booster as p_resume
from lightgbm_tpu_torch.training import save_checkpoint as p_save
from lightgbm_tpu_torch.training import train_resumable

BASE = dict(objective="binary", num_leaves=15, learning_rate=0.1,
            max_bin=63, min_data_in_leaf=5, verbose=-1, seed=7)
DYADIC = dict(BASE, objective="l2", learning_rate=0.5)
GROWERS = {"strict": {"wave_width": 1},
           "wave_half": {"wave_width": 4},
           "wave_exact": {"wave_width": 4, "wave_tail": "exact"}}
SHAPES = [(1800, 5, 512), (500, 13, 512), (2300, 13, 768)]


def _problem(n, f, seed=0, dyadic=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    s = (X @ w) * 0.7 + 0.6 * np.sin(X[:, 0] * 2)
    if dyadic:
        y = np.zeros(n, np.float32)
        y[np.argsort(s, kind="stable")[n // 2:]] = 1.0
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-s))).astype(np.float32)
    return X, y


def _blocks(X, y, br):
    return [(X[lo:lo + br], y[lo:lo + br]) for lo in range(0, len(X), br)]


def _streamed(pkg, params, X, y, br, rounds):
    p = dict(params, stream_block_rows=br)
    if pkg is R:
        b = R.Booster(p, R.Dataset.from_blocks(_blocks(X, y, br),
                                               params=dict(p)))
    else:
        b = P.Booster(p, P.Dataset.from_blocks(_blocks(X, y, br),
                                               params=dict(p), device="cpu"))
    for _ in range(rounds):
        b.update()
    return b


def _in_memory(params, X, y, rounds):
    b = P.Booster(dict(params), P.Dataset(X, label=y, params=dict(params),
                                          device="cpu"))
    for _ in range(rounds):
        b.update()
    return b


def _bit_equal(ta, tb):
    assert set(ta) == set(tb)
    for k in ta:
        assert np.array_equal(ta[k], tb[k]), k


def _regime(ta, tb):
    for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
        assert np.array_equal(ta[k], tb[k]), k
    np.testing.assert_allclose(ta["leaf_value"], tb["leaf_value"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,f,br", SHAPES)
@pytest.mark.parametrize("grower", sorted(GROWERS))
def test_dyadic_streamed_bit_equal_reference_and_in_memory(grower, n, f, br):
    X, y = _problem(n, f, dyadic=True)
    p = dict(DYADIC, **GROWERS[grower])
    ours = _streamed(P, p, X, y, br, 1)
    ref = _streamed(R, p, X, y, br, 1)
    assert ours._streamed and ours.train_set.X_binned is None
    _bit_equal(r_arrays(ref.trees[0]), p_arrays(ours.trees[0]))
    assert np.array_equal(np.asarray(ref._pred_train),
                          ours._pred_train.numpy())
    if -(-n // 256) * 256 == ours.train_set.block_store.padded_rows:
        mem = _in_memory(p, X, y, 1)      # the same padding and wave tail
        _bit_equal(p_arrays(mem.trees[0]), p_arrays(ours.trees[0]))


@pytest.mark.parametrize("grower", sorted(GROWERS))
def test_general_streamed_within_regime(grower):
    X, y = _problem(1800, 13, seed=3)
    p = dict(BASE, **GROWERS[grower])
    ours = _streamed(P, p, X, y, 512, 3)
    ref = _streamed(R, p, X, y, 512, 3)
    mem = _in_memory(p, X, y, 3)
    for tr, to, tm in zip(ref.trees, ours.trees, mem.trees):
        _regime(r_arrays(tr), p_arrays(to))
        _regime(p_arrays(tm), p_arrays(to))
    np.testing.assert_allclose(ours._pred_train.numpy(),
                               np.asarray(ref._pred_train), rtol=1e-5,
                               atol=1e-6)
    assert len(ours.trees) == 3


@pytest.mark.parametrize("case", ["bagging_ff", "rf", "l1"])
def test_streamed_sampling_and_renewal_within_regime(case):
    extra = {"bagging_ff": dict(bagging_fraction=0.7, bagging_freq=1,
                                feature_fraction=0.6, wave_width=4),
             "rf": dict(boosting="rf", bagging_fraction=0.6,
                        bagging_freq=1, wave_width=4),
             "l1": dict(objective="l1", wave_width=1)}[case]
    X, y = _problem(1800, 8, seed=5)
    if case == "l1":
        y = (X[:, 0] * 2 + np.sin(X[:, 1])).astype(np.float32)
    p = dict(BASE, **extra)
    ours = _streamed(P, p, X, y, 512, 3)
    ref = _streamed(R, p, X, y, 512, 3)
    for tr, to in zip(ref.trees, ours.trees):
        _regime(r_arrays(tr), p_arrays(to))
    assert np.array_equal(np.asarray(ref._bag), ours._bag.numpy())
    np.testing.assert_allclose(ours.predict(X[:300]),
                               np.asarray(ref.predict(X[:300])), rtol=1e-5,
                               atol=1e-6)


def test_goss_at_source_selects_the_reference_rows(monkeypatch):
    """Round 1 of streamed GOSS: the host sampler draws the reference's
    rows from bit-equal gradients (top |g| by ``argpartition``, then
    ``default_rng(seed * 1,000,003 + i)``), and only they cross to the
    device (the odometer counts them plus one traversal pass)."""
    X, y = _problem(1800, 6, seed=9)
    p = dict(BASE, boosting="goss", top_rate=0.2, other_rate=0.1)
    seen = {}

    def spy(mod, key):
        orig = mod.BlockStore.gather_rows

        def gather(self, idx, col_ids=None):
            seen[key] = np.asarray(idx).copy()
            return orig(self, idx, col_ids)
        monkeypatch.setattr(mod.BlockStore, "gather_rows", gather)

    spy(PB, "port")
    spy(RB, "ref")
    ours = _streamed(P, p, X, y, 512, 1)
    ref = _streamed(R, p, X, y, 512, 1)
    assert np.array_equal(seen["port"], seen["ref"])
    assert len(seen["port"]) == int(0.2 * 1800) + int(0.1 * 1800)
    _regime(r_arrays(ref.trees[0]), p_arrays(ours.trees[0]))
    store = ours.train_set.block_store
    assert store.bytes_streamed == (len(seen["port"]) * 6
                                    + store.padded_rows * 6)


def _streamed_booster(n=1024, f=5, **params):
    X, y = _problem(n, f)
    p = dict(objective="binary", verbose=-1, stream_block_rows=512)
    p.update(params)
    return P.Booster(p, P.Dataset.from_blocks(_blocks(X, y, 512),
                                              params=dict(p), device="cpu"))


@pytest.mark.parametrize("params,key", [
    (dict(objective="multiclass", num_class=3, extra_trees=True),
     "num_class"),
    (dict(linear_tree=True, extra_trees=True), "linear_tree"),
    (dict(extra_trees=True, monotone_constraints=[1, 0, 0, 0, 0]),
     "extra_trees"),
    (dict(monotone_constraints=[1, 0, 0, 0, 0],
          interaction_constraints=[[0, 1], [2, 3, 4]]),
     "monotone_constraints"),
    (dict(interaction_constraints=[[0, 1], [2, 3, 4]],
          feature_fraction_bynode=0.5), "interaction_constraints"),
    (dict(feature_fraction_bynode=0.5, boosting="dart"),
     "feature_fraction_bynode"),
    (dict(boosting="dart"), "boosting"),
], ids=["num_class", "linear_tree", "extra_trees", "monotone",
        "interaction", "bynode", "dart"])
def test_stream_scope_keys_in_reference_order(params, key):
    X, y = _problem(1024, 5)
    if params.get("objective") == "multiclass":
        y = (np.abs(X[:, 0]) * 2).astype(np.int32) % 3
    p = dict(dict(objective="binary", verbose=-1, stream_block_rows=512),
             **params)
    with pytest.raises(StreamScopeError) as ei:
        P.Booster(p, P.Dataset.from_blocks(_blocks(X, y, 512),
                                           params=dict(p), device="cpu"))
    assert ei.value.key == key
    with pytest.raises(ValueError) as er:
        R.Booster(p, R.Dataset.from_blocks(_blocks(X, y, 512),
                                           params=dict(p)))
    assert getattr(er.value, "key", key) == key


def test_stream_scope_categorical_reference_schema():
    X, y = _problem(1024, 5)
    Xc = X.copy()
    Xc[:, 1] = np.round(np.abs(X[:, 1]) * 3)
    ref = P.Dataset(Xc, label=y, categorical_feature=[1], device="cpu")
    ref.construct()
    with pytest.raises(StreamScopeError) as ei:
        P.Booster({"objective": "binary", "verbose": -1},
                  P.Dataset.from_blocks(_blocks(Xc, y, 512),
                                        params={"stream_block_rows": 512},
                                        reference=ref))
    assert ei.value.key == "categorical_feature"


@pytest.mark.parametrize("learner", ["feature", "voting"])
def test_tree_learner_warns_and_streams_serially(learner):
    with pytest.warns(UserWarning, match="serial"):
        b = _streamed_booster(tree_learner=learner)
    b.update()
    assert len(b.trees) == 1
    # "data" composes with the block loop; on one device it warns and
    # streams serially, as the reference does (test_torch_stream_dp.py
    # covers the mesh)
    with pytest.warns(UserWarning, match="only one device is visible"):
        b = _streamed_booster(tree_learner="data")
    assert b._mesh is None


def test_streamed_refusals():
    b = _streamed_booster()
    X, y = _problem(600, 5, seed=5)
    vs = P.Dataset.from_blocks(_blocks(X, y, 512),
                               params={"stream_block_rows": 512},
                               device="cpu")
    with pytest.raises(ValueError, match="streamed"):
        b.add_valid(vs, "v0")
    with pytest.raises(ValueError, match="save_binary"):
        vs.save_binary("never_written.bin")
    with pytest.raises(ValueError, match="subset"):
        vs.subset([0, 1, 2])
    # a valid set binned in memory against the streamed schema is fine
    mem_vs = P.Dataset(X, label=y, reference=b.train_set)
    b.add_valid(mem_vs, "v1")
    b.update()
    assert b.eval_valid()[0][0] == "v1"
    assert not b.can_fuse_rounds()


def test_streamed_kill_resume_and_init_model_bit_identical(tmp_path):
    X, y = _problem(1800, 6, seed=11)
    p = dict(BASE, bagging_fraction=0.8, bagging_freq=1,
             feature_fraction=0.8, stream_block_rows=512)

    def ds():
        return P.Dataset.from_blocks(_blocks(X, y, 512), params=dict(p),
                                     device="cpu")

    d = ds()
    full = train_resumable(p, d, 6, checkpoint_dir=str(tmp_path / "f"),
                           resume=False, checkpoint_rounds=3)
    part = train_resumable(p, d, 3, checkpoint_dir=str(tmp_path / "k"),
                           resume=False, checkpoint_rounds=3)
    again = train_resumable(p, ds(), 6, checkpoint_dir=str(tmp_path / "k"),
                            checkpoint_rounds=3)
    assert part.rounds_done == 3 and again.resumed_from is not None
    for ta, tb in zip(full.booster.trees, again.booster.trees):
        _bit_equal(p_arrays(ta), p_arrays(tb))
    assert torch.equal(full.booster._pred_train, again.booster._pred_train)
    assert torch.equal(full.booster._bag, again.booster._bag)
    # init_model: 3 + 3 rounds continue the streamed run bit for bit
    first = P.train(p, d, 3)
    path = str(tmp_path / "first.txt")
    first.save_model(path)
    for init in (first, path):
        cont = P.train(p, d, 3, init_model=init)
        for ta, tb in zip(full.booster.trees, cont.trees):
            _bit_equal(p_arrays(ta), p_arrays(tb))
        assert torch.equal(full.booster._pred_train, cont._pred_train)
    loaded = P.Booster(model_file=path, device="cpu")
    for _ in range(3):
        loaded.update(d)
    assert torch.equal(full.booster._pred_train, loaded._pred_train)
    # a Dataset binned by another sketch is refused by its digest
    other = P.Dataset.from_blocks(_blocks(X * 1.5, y, 512), params=dict(p),
                                  device="cpu")
    with pytest.raises(Exception, match="schema"):
        p_resume(again.last_checkpoint, other)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_streamed_checkpoint_interchange(writer, tmp_path):
    """A streamed checkpoint (``streamed: true``, ``pred_train`` and bag
    ``padded_rows`` long) written by one package resumes in the other and
    continues within the regime of the writer's uninterrupted run."""
    X, y = _problem(1800, 6, seed=13)
    p = dict(BASE, bagging_fraction=0.8, bagging_freq=1, wave_width=4,
             stream_block_rows=512)
    blocks = _blocks(X, y, 512)
    if writer == "reference":
        src = R.Booster(p, R.Dataset.from_blocks(blocks, params=dict(p)))
        save, resume = r_save, p_resume
        dst_ds = P.Dataset.from_blocks(blocks, params=dict(p), device="cpu")
    else:
        src = P.Booster(p, P.Dataset.from_blocks(blocks, params=dict(p),
                                                 device="cpu"))
        save, resume = p_save, r_resume
        dst_ds = R.Dataset.from_blocks(blocks, params=dict(p))
    for _ in range(2):
        src.update()
    path = save(src, str(tmp_path / "ck"))
    dst = resume(path, dst_ds)
    assert np.asarray(dst._pred_train).shape == (2048,)
    assert np.array_equal(np.asarray(dst._pred_train),
                          np.asarray(src._pred_train))
    assert np.array_equal(np.asarray(dst._bag), np.asarray(src._bag))
    for _ in range(2):
        src.update()
        dst.update()
    arrays = r_arrays if writer == "reference" else p_arrays
    other = p_arrays if writer == "reference" else r_arrays
    for ts, td in zip(src.trees, dst.trees):
        _regime(arrays(ts), other(td))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.testing.assert_allclose(np.asarray(dst.predict(X[:200])),
                                   np.asarray(src.predict(X[:200])),
                                   rtol=1e-5, atol=1e-6)
