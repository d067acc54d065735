"""Port parity: training under injected faults (``faults.py``,
``training/loop.py``), mirroring the reference's
``tests/test_training_chaos.py`` on the CPU.

* the fault registry is the reference's (every site, the same typed
  ``NonFiniteGradientError``);
* the finiteness screen stops a round whose input scores are non-finite
  before a tree grows;
* a ``gradient`` fault poisons a round's scores; the run stops at that round,
  and resuming its last checkpoint (which precedes the corruption) reproduces
  the uninterrupted forest bit for bit;
* a ``checkpoint_write`` fault costs one generation, never the run: no torn
  file survives and the forest is unchanged;
* what the port cannot resume is refused by name: a multi-device
  checkpoint or merge mode (``n_devices``, ``merge_mode``); a
  feature-screened checkpoint (``screen_ema``) resumes with the screener's
  state and goes on bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu.faults as RF
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.faults import (SITES, TRAINING_SITES, FaultError,
                                       FaultInjector, FaultSpec,
                                       NonFiniteGradientError)
from lightgbm_tpu_torch.models.tree import tree_to_arrays
from lightgbm_tpu_torch.training import (latest_checkpoint, list_checkpoints,
                                         load_checkpoint, resume_booster,
                                         save_checkpoint, train_resumable)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the strict grower runs thousands of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PARAMS = dict(objective="binary", num_leaves=7, learning_rate=0.2, max_bin=31,
              min_data_in_leaf=5, verbose=-1, seed=7)


def _problem(n=700, f=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return X, y


def _make_ds():
    X, y = _problem()
    return P.Dataset(X, label=y, params=dict(PARAMS), device="cpu")


def _reference_run(rounds=4):
    b = P.Booster(dict(PARAMS), _make_ds())
    for _ in range(rounds):
        b.update()
    return b


def _trees_equal(a, b):
    if len(a.trees) != len(b.trees):
        return False
    for ta, tb in zip(a.trees, b.trees):
        x, y = tree_to_arrays(ta), tree_to_arrays(tb)
        if not all(np.array_equal(x[k], y[k]) for k in x):
            return False
    return True


def test_fault_registry_matches_reference():
    assert SITES == RF.SITES and TRAINING_SITES == RF.TRAINING_SITES
    e = NonFiniteGradientError("x", round_index=3)
    assert isinstance(e, RuntimeError) and e.round_index == 3
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec("nowhere")


def test_nonfinite_predictions_screened_before_growing():
    b = P.Booster(dict(PARAMS), _make_ds())
    b.update()
    b._screen_finite(1)                      # finite: no error
    b._pred_train[3] = float("nan")
    with pytest.raises(NonFiniteGradientError) as ei:
        b._screen_finite(1)
    assert ei.value.round_index == 1
    assert b.num_trees() == 1                # no garbage tree was grown


def test_gradient_poison_stops_run_and_prior_checkpoint_resumes(tmp_path):
    ref = _reference_run()
    d = str(tmp_path / "ckpts")
    inj = FaultInjector([FaultSpec("gradient", after=2, times=1,
                                   message="upstream corruption")])
    with pytest.raises(NonFiniteGradientError) as ei:
        train_resumable(dict(PARAMS), _make_ds(), 4, checkpoint_dir=d,
                        checkpoint_rounds=1, keep_last=8, resume=False,
                        injector=inj)
    assert ei.value.round_index == 2        # rounds 0, 1 clean, 2 poisoned
    assert inj.fired["gradient"] == 1
    assert load_checkpoint(latest_checkpoint(d))[1]["iter"] == 2

    # the last checkpoint PRECEDES the corruption: resuming it and rerunning
    # the lost rounds reproduces the uninterrupted forest
    res = train_resumable(dict(PARAMS), _make_ds(), 4, checkpoint_dir=d,
                          checkpoint_rounds=1, resume=True)
    assert res.completed and res.resumed_from is not None
    assert _trees_equal(ref, res.booster)
    assert torch.equal(ref._pred_train, res.booster._pred_train)


def test_screen_off_lets_the_poisoned_round_run(tmp_path):
    inj = FaultInjector([FaultSpec("gradient", after=1, times=1)])
    res = train_resumable(dict(PARAMS), _make_ds(), 2,
                          checkpoint_dir=str(tmp_path / "ck"), resume=False,
                          injector=inj, finite_screen=False)
    assert res.completed
    assert not bool(torch.isfinite(res.booster._pred_train).all())


def test_checkpoint_write_fault_costs_generation_not_run(tmp_path):
    ref = _reference_run()
    d = str(tmp_path / "ckpts")
    inj = FaultInjector([FaultSpec("checkpoint_write", after=1, times=1)])
    with pytest.warns(UserWarning, match="checkpoint write failed"):
        res = train_resumable(dict(PARAMS), _make_ds(), 4, checkpoint_dir=d,
                              checkpoint_rounds=1, keep_last=8,
                              resume=False, injector=inj)
    assert res.completed and res.checkpoint_failures == 1
    assert _trees_equal(ref, res.booster)   # training never flinched
    # the fault hit iter 2's write; every other generation landed, no torn
    # tmp file survived, and the prior checkpoint stayed loadable
    assert [load_checkpoint(q)[1]["iter"] for q in list_checkpoints(d)] \
        == [1, 3, 4]
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]


def test_checkpoint_write_fault_raises_from_the_writer(tmp_path):
    b = P.Booster(dict(PARAMS), _make_ds())
    b.update()
    d = str(tmp_path / "ck")
    inj = FaultInjector([FaultSpec("checkpoint_write")])
    with pytest.raises(FaultError, match="checkpoint_write"):
        save_checkpoint(b, d, injector=inj)
    assert os.listdir(d) == []               # the tmp file is gone too


@pytest.mark.parametrize("field,edit", [
    ("n_devices", lambda a, m: m["parallel"].update(n_devices=2)),
    ("merge_mode", lambda a, m: m["parallel"].update(
        merge_mode="reduce_scatter")),
    ("screen_ema", lambda a, m: a.update(
        screen_ema=np.zeros(5, np.float32))),
])
def test_unported_checkpoint_state_refused_by_name(tmp_path, field, edit):
    b = P.Booster(dict(PARAMS), _make_ds())
    b.update()
    arrays, meta = b.checkpoint_state()
    edit(arrays, meta)
    if field == "screen_ema":
        # a feature-screened checkpoint resumes (ROADMAP item 11): the
        # screener's EWMA and refresh counter come back, and the resumed
        # run grows the uninterrupted run's trees
        sp = dict(PARAMS, feature_screen="ema", screen_keep_ratio=0.4,
                  screen_refresh_rounds=3)
        full = P.Booster(sp, _make_ds())
        for _ in range(2):
            full.update()
        arrays, meta = full.checkpoint_state()
        back = resume_booster((arrays, meta), _make_ds())
        ema, since = back._screener.state()
        assert np.array_equal(ema, arrays["screen_ema"])
        assert since == meta["screen_rounds_since_refresh"] == 2
        for _ in range(3):
            full.update()
            back.update()
        assert _trees_equal(full, back)
        assert torch.equal(full._pred_train, back._pred_train)
        return
    # since the multi-device slice (item 12) the reference's elastic gate:
    # a one-device resume of a checkpoint naming n_devices = 2 (shard
    # boundaries nest) or a merge mode (no mesh here to differ) goes on,
    # and the resumed run is the uninterrupted one bit for bit; the
    # refusals are pinned in test_torch_parallel_checkpoint.py
    back = resume_booster((arrays, meta), _make_ds())
    assert back._iter == 1 and back._mesh is None
    for _ in range(2):
        b.update()
        back.update()
    assert _trees_equal(b, back)
    assert torch.equal(b._pred_train, back._pred_train)


def test_requested_histogram_merge_refused_by_name(tmp_path):
    """A serial checkpoint names no merge mode, so a resume requesting
    ``histogram_merge`` is not refused (the reference's gate compares the
    request with the writer's mode only); the checkpoint's params rule the
    resumed run, which is the uninterrupted one."""
    b = P.Booster(dict(PARAMS), _make_ds())
    b.update()
    path = save_checkpoint(b, str(tmp_path / "ck"))
    res = train_resumable(dict(PARAMS, histogram_merge="reduce_scatter"),
                          _make_ds(), 2, checkpoint_dir=str(tmp_path / "ck"),
                          resume=path)
    assert res.completed and res.resumed_from == path
    b.update()
    assert _trees_equal(b, res.booster)
