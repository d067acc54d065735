"""Port parity: gain-informed feature screening (``feature_screen="ema"``,
``models/feature_mask.py`` ``FeatureScreener``) on the CPU, in memory and
streamed, against the reference's screening.

* identity: ``screen_keep_ratio=1.0`` and ``screen_refresh_rounds=1`` (every
  round a refresh round) train bit for bit as screening off — trees, train
  scores — on the strict and wave growers, in memory and streamed;
* the screener (plan / observe / state / restore) equals the reference's on
  the same gains, and ``remap_split_features`` passes sentinels through;
* screened training against the reference's: the same active sets each
  round, split structure equal, leaf values and scores within rtol 1e-5 /
  atol 1e-6 (PARITY's regime), the EWMA within rtol 1e-5; the port's
  screened streamed run within the same regime of its screened in-memory
  run;
* ``ScreenScopeError`` keys as the reference's;
* a screened run killed and resumed (``screen_ema`` and the refresh
  counter in the checkpoint) is bit for bit the uninterrupted run, and a
  screened checkpoint written by either package resumes in the other.
"""

import collections

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
from lightgbm_tpu.models import feature_mask as RFM
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.training import resume_booster as r_resume
from lightgbm_tpu.training import save_checkpoint as r_save
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.faults import ScreenScopeError
from lightgbm_tpu_torch.models import feature_mask as PFM
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.training import resume_booster as p_resume
from lightgbm_tpu_torch.training import save_checkpoint as p_save
from lightgbm_tpu_torch.training import train_resumable

BASE = dict(objective="binary", num_leaves=15, learning_rate=0.1,
            max_bin=63, min_data_in_leaf=5, verbose=-1, seed=7)
SCREEN = dict(feature_screen="ema", screen_keep_ratio=0.3,
              screen_refresh_rounds=3)


def _problem(n, f, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    w[f // 3:] *= 0.05                    # a few hot columns
    logits = (X @ w) * 0.9 + 0.6 * np.sin(X[:, 0] * 2)
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


def _blocks(X, y, br=512):
    return [(X[lo:lo + br], y[lo:lo + br]) for lo in range(0, len(X), br)]


def _booster(pkg, params, X, y, streamed):
    p = dict(params, stream_block_rows=512)
    if pkg is R:
        d = (R.Dataset.from_blocks(_blocks(X, y), params=dict(p)) if streamed
             else R.Dataset(X, label=y, params=dict(p)))
        return R.Booster(p, d)
    d = (P.Dataset.from_blocks(_blocks(X, y), params=dict(p), device="cpu")
         if streamed else P.Dataset(X, label=y, params=dict(p),
                                    device="cpu"))
    return P.Booster(p, d)


def _run(pkg, params, X, y, streamed, rounds, plans=None):
    b = _booster(pkg, params, X, y, streamed)
    for _ in range(rounds):
        if plans is not None:
            ids, _ = b._screener.plan()
            plans.append(None if ids is None else ids.tolist())
        b.update()
    return b


def _bit_equal(a, b):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        fa, fb = p_arrays(ta), p_arrays(tb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k
    assert torch.equal(a._pred_train, b._pred_train)


def _regime(ta, tb):
    for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
        assert np.array_equal(ta[k], tb[k]), k
    np.testing.assert_allclose(ta["leaf_value"], tb["leaf_value"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("streamed", [False, True], ids=["memory", "stream"])
@pytest.mark.parametrize("grower", [{"wave_width": 1}, {"wave_width": 4}],
                         ids=["strict", "wave"])
def test_screen_off_identities(grower, streamed):
    X, y = _problem(1500, 13)
    p = dict(BASE, **grower)
    off = _run(P, p, X, y, streamed, 4)
    for extra in (dict(SCREEN, screen_keep_ratio=1.0),
                  dict(SCREEN, screen_refresh_rounds=1)):
        _bit_equal(off, _run(P, dict(p, **extra), X, y, streamed, 4))


def test_screener_equals_reference():
    rng = np.random.default_rng(3)
    ours = PFM.FeatureScreener(40, 0.25, 0.8, 4)
    ref = RFM.FeatureScreener(40, 0.25, 0.8, 4)
    assert ours.keep == ref.keep == PFM.active_feature_count(40, 0.25) == 10
    for _ in range(11):
        a, b = ours.plan(), ref.plan()
        assert a[1] == b[1]
        assert (a[0] is None) == (b[0] is None)
        if a[0] is not None:
            assert np.array_equal(a[0], b[0]) and a[0].dtype == np.int32
        sf = rng.integers(-1, 40, 31)
        sg = rng.gamma(1.0, 2.0, 31).astype(np.float32)
        ours.observe(sf, sg)
        ref.observe(sf, sg)
        ea, eb = ours.state(), ref.state()
        assert np.array_equal(ea[0], eb[0]) and ea[1] == eb[1]
    fresh = PFM.FeatureScreener(40, 0.25, 0.8, 4)
    fresh.restore(*ours.state())
    assert np.array_equal(fresh.plan()[0], ours.plan()[0])
    with pytest.raises(ValueError, match="shape"):
        fresh.restore(np.zeros(39, np.float32), 0)


def test_remap_split_features_passes_sentinels_through():
    T = collections.namedtuple("T", ["split_feature"])
    tree = T(split_feature=torch.tensor([2, -1, 0, 1, -1], dtype=torch.int32))
    out = PFM.remap_split_features(tree, np.asarray([4, 9, 130], np.int32))
    assert out.split_feature.tolist() == [130, -1, 4, 9, -1]
    assert out.split_feature.dtype == torch.int32


@pytest.mark.parametrize("streamed", [False, True], ids=["memory", "stream"])
def test_screened_training_equals_reference(streamed):
    X, y = _problem(1800, 13, seed=4)
    p = dict(BASE, wave_width=4, **SCREEN)
    plans_p, plans_r = [], []
    ours = _run(P, p, X, y, streamed, 6, plans_p)
    ref = _run(R, p, X, y, streamed, 6, plans_r)
    assert plans_p == plans_r
    assert sum(ids is not None for ids in plans_p) >= 3
    for tr, to in zip(ref.trees, ours.trees):
        _regime(r_arrays(tr), p_arrays(to))
        assert int(np.asarray(tr.split_feature).max()) < 13
    np.testing.assert_allclose(ours._pred_train.numpy(),
                               np.asarray(ref._pred_train), rtol=1e-5,
                               atol=1e-6)
    ea, eb = ours._screener.state(), ref._screener.state()
    np.testing.assert_allclose(ea[0], eb[0], rtol=1e-5)
    assert ea[1] == eb[1]


def test_screened_streamed_within_regime_of_in_memory():
    X, y = _problem(1800, 13, seed=6)
    p = dict(BASE, wave_width=4, **SCREEN)
    plans_m, plans_s = [], []
    mem = _run(P, p, X, y, False, 6, plans_m)
    st = _run(P, p, X, y, True, 6, plans_s)
    assert plans_m == plans_s
    for ta, tb in zip(mem.trees, st.trees):
        _regime(p_arrays(ta), p_arrays(tb))
    # screened rounds moved only the active columns
    store = st.train_set.block_store
    assert store.bytes_streamed < store.passes * store.padded_rows * 13


@pytest.mark.parametrize("extra,key", [
    (dict(objective="multiclass", num_class=3), "num_class"),
    (dict(linear_tree=True), "linear_tree"),
    (dict(boosting="dart"), "boosting"),
    (dict(extra_trees=True), "extra_trees"),
    (dict(monotone_constraints=[1, 0, 0, 0, 0]), "monotone_constraints"),
    (dict(interaction_constraints=[[0, 1], [2, 3, 4]]),
     "interaction_constraints"),
    (dict(tree_learner="feature"), "tree_learner"),
])
def test_screen_scope_keys(extra, key):
    X, y = _problem(600, 5, seed=2)
    if extra.get("objective") == "multiclass":
        y = (np.abs(X[:, 0]) * 2).astype(np.int32) % 3
    p = dict(dict(objective="binary", num_leaves=7, verbose=-1,
                  feature_screen="ema"), **extra)
    # the feature-parallel learner reaches the screening fence in memory
    # and on a streamed Dataset, as the reference's does
    for streamed in ((False, True) if key == "tree_learner" else (False,)):
        with pytest.raises(ScreenScopeError) as ei:
            _booster(P, p, X, y, streamed)
        assert ei.value.key == key


def test_screened_kill_resume_bit_identical(tmp_path):
    X, y = _problem(1500, 13, seed=8)
    p = dict(BASE, wave_width=4, bagging_fraction=0.8, bagging_freq=1,
             **SCREEN)
    d = P.Dataset(X, label=y, params=dict(p), device="cpu")
    full = train_resumable(p, d, 7, checkpoint_dir=str(tmp_path / "f"),
                           resume=False, checkpoint_rounds=4)
    part = train_resumable(p, d, 4, checkpoint_dir=str(tmp_path / "k"),
                           resume=False, checkpoint_rounds=4)
    assert part.booster._screener.state()[1] == 1   # mid-cycle
    again = train_resumable(p, d, 7, checkpoint_dir=str(tmp_path / "k"),
                            checkpoint_rounds=4)
    assert again.resumed_from is not None
    _bit_equal(full.booster, again.booster)
    ea, eb = full.booster._screener.state(), again.booster._screener.state()
    assert np.array_equal(ea[0], eb[0]) and ea[1] == eb[1]


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("streamed", [False, True], ids=["memory", "stream"])
def test_screened_checkpoint_interchange(writer, streamed, tmp_path):
    """A screened checkpoint (``screen_ema``, the refresh counter; streamed:
    ``streamed: true`` and ``padded_rows``-long scores) written by one
    package resumes in the other with the screener's state, and the two
    go on within the regime."""
    X, y = _problem(1800, 13, seed=10)
    p = dict(BASE, wave_width=4, **SCREEN)
    src_pkg, dst_pkg = (R, P) if writer == "reference" else (P, R)
    save = r_save if writer == "reference" else p_save
    resume = p_resume if writer == "reference" else r_resume
    src = _run(src_pkg, p, X, y, streamed, 4)
    path = save(src, str(tmp_path / "ck"))
    dst = resume(path, _booster(dst_pkg, p, X, y, streamed).train_set)
    es, ed = src._screener.state(), dst._screener.state()
    assert np.array_equal(es[0], ed[0]) and es[1] == ed[1]
    assert np.array_equal(np.asarray(src._pred_train),
                          np.asarray(dst._pred_train))
    for _ in range(3):
        (ids_s, _), (ids_d, _) = src._screener.plan(), dst._screener.plan()
        assert (ids_s is None and ids_d is None) or np.array_equal(ids_s,
                                                                   ids_d)
        src.update()
        dst.update()
    sa = r_arrays if writer == "reference" else p_arrays
    da = p_arrays if writer == "reference" else r_arrays
    for ts, td in zip(src.trees, dst.trees):
        _regime(sa(ts), da(td))
