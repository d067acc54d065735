"""Port parity: checkpoints of multi-device training (the reference's
``validate_parallel_topology`` and elastic resume), over virtual shards on
the CPU.

* the ``parallel`` block of the checkpoint meta is the reference's
  (learner, ``n_devices``, ``merge_mode``/``voting_k``, ``"mesh": "dp2"``),
  and the arrays are in global row order;
* killed (a real SIGTERM drained by ``train_resumable``) and resumed at the
  same D: bit-identical to the uninterrupted run, on the strict and wave
  growers, with bagging, and for the feature learner;
* resumed at another D that divides or is a multiple of the writer's
  (8 -> 4, 8 -> 2, 4 -> 8): the forest so far is kept bit for bit and the
  rest of the run is the uninterrupted run's within the parity regime
  (structure equal, leaves rtol 1e-5 / atol 1e-6: another D sums the
  shards' partials in another order), as the reference's elastic resume;
* a foreign D (3 or 6 against 8), another resolved merge mode, or another
  requested ``histogram_merge`` raises ``IncompatibleCheckpointError``
  naming the field, before any round runs;
* a checkpoint written by the reference's dp run at D = 8 resumes in the
  port at D = 8 and continues within the regime, and the port's meta block
  passes the reference's own gate.
"""

import os
import signal

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.parallel import set_virtual_devices
from lightgbm_tpu_torch.training import (IncompatibleCheckpointError,
                                         list_checkpoints, load_checkpoint,
                                         resume_booster, save_checkpoint,
                                         train_resumable)

ROUNDS = 6


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


def _data(n=2048, f=5, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] ** 2 + X[:, 2] * X[:, 3]
         + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


CASES = {
    "data_strict": {"tree_learner": "data"},
    "data_wave_bagging": {"tree_learner": "data", "grow_policy": "frontier",
                          "bagging_fraction": 0.7, "bagging_freq": 2},
    "voting": {"tree_learner": "voting", "top_k": 2},
    "feature": {"tree_learner": "feature"},
}


def _params(case):
    return dict({"objective": "regression", "num_leaves": 15,
                 "learning_rate": 0.2, "verbosity": -1,
                 "min_data_in_leaf": 10}, **CASES[case])


def _ds():
    X, y = _data()
    return P.Dataset(X, label=y, device="cpu")


def _same_run(a, b, exact=True):
    assert len(a.trees) == len(b.trees)
    for ta, tb in zip(a.trees, b.trees):
        for f in ("split_feature", "split_bin", "left", "right", "is_leaf"):
            assert torch.equal(getattr(ta, f), getattr(tb, f)), f
        if exact:
            assert torch.equal(ta.leaf_value, tb.leaf_value)
        else:
            torch.testing.assert_close(ta.leaf_value, tb.leaf_value,
                                       rtol=1e-5, atol=1e-6)
    if exact:
        assert torch.equal(a._pred_train, b._pred_train)
        assert torch.equal(a._bag, b._bag)


def _uninterrupted(case, rounds=ROUNDS):
    b = P.Booster(_params(case), _ds())
    for _ in range(rounds):
        b.update()
    return b


def test_meta_block_and_global_row_order():
    b = _uninterrupted("data_strict", 2)
    arrays, meta = b.checkpoint_state()
    assert meta["parallel"] == {"tree_learner": "data", "n_devices": 8,
                                "merge_mode": "reduce_scatter_pipelined",
                                "voting_k": 20}
    assert arrays["pred_train"].shape == (2048,)
    assert np.array_equal(arrays["pred_train"], b._pred_train.numpy())
    set_virtual_devices(4)
    p2 = P.Booster(dict(_params("data_strict"), mesh_shape="2x2"), _ds())
    assert p2.checkpoint_state()[1]["parallel"] == {
        "tree_learner": "data", "n_devices": 4, "mesh": "dp2"}
    fp = P.Booster(_params("feature"), _ds())
    assert fp.checkpoint_state()[1]["parallel"] == {
        "tree_learner": "feature", "n_devices": 4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sigterm_resumes_bit_identical(tmp_path, case):
    """A real SIGTERM after round index 2: the drain writes a checkpoint
    and a second invocation at the same D resumes to the uninterrupted run
    bit for bit."""
    ref = _uninterrupted(case)
    d = str(tmp_path / "ck")

    def kill_at(booster, i):
        if i == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    res = train_resumable(_params(case), _ds(), ROUNDS, checkpoint_dir=d,
                          checkpoint_rounds=10, resume=False,
                          round_callbacks=[kill_at])
    assert res.preempted and res.rounds_done == 3
    assert res.booster._mesh is not None
    res2 = train_resumable(_params(case), _ds(), ROUNDS, checkpoint_dir=d,
                           checkpoint_rounds=10, resume=True)
    assert res2.completed and res2.resumed_from == res.last_checkpoint
    assert res2.booster._mesh.n_devices == 8
    _same_run(ref, res2.booster)


@pytest.mark.parametrize("d_from,d_to", [(8, 4), (8, 2), (4, 8)])
def test_elastic_resume(tmp_path, d_from, d_to):
    set_virtual_devices(d_from)
    b = _uninterrupted("data_strict", 3)
    path = save_checkpoint(b, str(tmp_path / "ck"))
    set_virtual_devices(d_to)
    got = resume_booster(path, _ds())
    assert got._mesh.n_devices == d_to and got._iter == 3
    for ta, tb in zip(b.trees, got.trees):
        assert torch.equal(ta.leaf_value, tb.leaf_value)
    assert torch.equal(got._pred_train, b._pred_train)
    for _ in range(ROUNDS - 3):
        got.update()
    set_virtual_devices(d_from)
    ref = _uninterrupted("data_strict")
    _same_run(ref, got, exact=False)


@pytest.mark.parametrize("field,mutate,requested", [
    ("n_devices", {"n_devices": 3}, None),
    ("n_devices", {"n_devices": 6}, None),
    ("merge_mode", {"merge_mode": "psum"}, None),
    ("merge_mode", {}, {"histogram_merge": "reduce_scatter_ring"})])
def test_typed_refusals(tmp_path, field, mutate, requested):
    b = _uninterrupted("data_strict", 1)
    arrays, meta = b.checkpoint_state()
    meta["parallel"].update(mutate)
    with pytest.raises(IncompatibleCheckpointError) as ei:
        resume_booster((arrays, meta), _ds(), params=requested)
    assert ei.value.field == field and field in str(ei.value)


def test_reference_dp_checkpoint_resumes_in_port(tmp_path):
    """The reference's dp run at D = 8 writes its checkpoint; the port
    resumes it at D = 8 (the same merge mode) and continues within the
    regime of the reference's own continuation; the port's meta block
    passes the reference's gate."""
    from lightgbm_tpu.training.checkpoint import (
        resume_booster as r_resume, save_checkpoint as r_save,
        validate_parallel_topology as r_validate)

    X, y = _data()
    p = _params("data_strict")
    rb = R.Booster(dict(p), R.Dataset(X, label=y))
    for _ in range(3):
        rb.update()
    assert rb._dp_mesh is not None
    path = r_save(rb, str(tmp_path / "ref"))
    got = resume_booster(path, _ds())
    assert got._mesh.n_devices == 8 and got._iter == 3
    r2 = r_resume(path, R.Dataset(X, label=y))
    for _ in range(3):
        got.update()
        r2.update()
    for tg, tw in zip(got.trees, r2.trees):
        np.testing.assert_array_equal(tg.split_feature.numpy(),
                                      np.asarray(tw.split_feature))
        np.testing.assert_allclose(tg.leaf_value.numpy(),
                                   np.asarray(tw.leaf_value), rtol=1e-5,
                                   atol=1e-6)
    _, meta = got.checkpoint_state()
    r_validate(r2, meta)                  # the reference accepts the block
    assert len(list_checkpoints(str(tmp_path / "ref"))) == 1
    assert load_checkpoint(path)[1]["parallel"]["n_devices"] == 8
