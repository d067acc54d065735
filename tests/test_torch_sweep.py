"""Port parity: the grid sweep (``sweep/``, ``utils.sweep.run_grid_search``)
against the reference's on the CPU.

* a 4-config grid (two num_leaves buckets, min_data 20 / 40, bagging and
  feature fraction as in the 108-config grid): every ledger row's
  ``iteration`` equal to the reference's, ``score`` within rtol 1e-5;
* a rerun with the same ledger skips the recorded rows; a sweep stopped by
  an injected fault before a ledger commit resumes to the same ledger;
* per-hyper-batch carry checkpoints (``checkpoint_dir``): a fault at a
  segment boundary or a SIGTERM mid-sweep, then a rerun, gives a ledger
  FILE byte-identical to an uninterrupted run's, on the JSON and the
  ``.RData`` codec, with ``resumed_units >= 1`` (the reference's
  ``tests/test_sweep.py`` kill-anywhere parity); the resumed ``.RData``
  ledger holds the reference's iterations and its scores within rtol 1e-5;
  a corrupt unit checkpoint falls back to a clean restart and one of another
  sweep definition (grid digest) is discarded;
* several devices: the plan's units, uids and device groups are the
  reference scheduler's, and a 4-device sweep in groups of 2 writes the
  single-device ledger, its buckets carrying the plan's groups;
* a multi-device checkpoint resumes under the elastic gate; continuing a
  saved model in ``train_resumable`` trains on from the model file.
"""

import hashlib
import json
import os
import signal

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.sweep import SweepService as RSweepService
from lightgbm_tpu.utils.rdata import read_rdata as r_read_rdata
from lightgbm_tpu.utils.sweep import run_grid_search as r_sweep
from lightgbm_tpu_torch.faults import FaultInjector
from lightgbm_tpu_torch.models import fused as pf
from lightgbm_tpu_torch.sweep import SweepService
from lightgbm_tpu_torch.training import (IncompatibleCheckpointError,
                                         resume_booster, train_resumable)
from lightgbm_tpu_torch.utils.sweep import expand_grid
from lightgbm_tpu_torch.utils.sweep import run_grid_search as p_sweep


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the fused and strict growers run thousands of
    small ops, which several test workers' thread pools, each as wide as
    the machine, would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = {"objective": "regression", "verbosity": -1, "max_bin": 31}
KW = dict(num_boost_round=25, nfold=3, early_stopping_rounds=5, seed=11,
          verbose=False)


def _grid():
    return expand_grid(learning_rate=[0.3], num_leaves=[7, 15],
                       min_data_in_leaf=[20, 40], feature_fraction=[0.8],
                       bagging_fraction=[0.8], bagging_freq=[4], nthread=[4])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    X = rng.normal(0, 1, (3000, 6))
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * rng.normal(0, 1, 3000)
    return X, y, P.Dataset(X, label=y, device="cpu")


@pytest.fixture(scope="module")
def swept(data, tmp_path_factory):
    X, y, pd = data
    d = tmp_path_factory.mktemp("sweep")
    want = r_sweep(_grid(), R.Dataset(X, label=y), base_params=BASE,
                   ledger_path=str(d / "ref.json"), **KW)
    path = str(d / "port.json")
    got = p_sweep(_grid(), pd, base_params=BASE, ledger_path=path, **KW)
    return want, got, path


def test_sweep_ledger_matches_reference(swept):
    want, got, _ = swept
    assert len(got.rows) == len(want.rows) == 4
    for a, b in zip(want.rows, got.rows):
        assert {k: v for k, v in a.items() if k not in ("iteration", "score")} \
            == {k: v for k, v in b.items() if k not in ("iteration", "score")}
        assert a["iteration"] == b["iteration"]
        np.testing.assert_allclose(b["score"], a["score"], rtol=1e-5)
        assert b["score"] < 0
    assert [r["num_leaves"] for r in got.leaderboard()] == \
        [r["num_leaves"] for r in want.leaderboard()]
    buckets = got.sweep_stats["buckets"]
    assert sorted(b["num_leaves"] for b in buckets) == [7, 15]
    assert all(b["configs"] == 2 and b["rounds"] >= 1 for b in buckets)


def test_rerun_skips_recorded_rows(swept, data, monkeypatch):
    _, got, path = swept
    built = []
    real = pf.FusedCVProgram

    def spy(*a, **k):
        built.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pf, "FusedCVProgram", spy)
    again = p_sweep(_grid(), data[2], base_params=BASE, ledger_path=path,
                    **KW)
    assert not built and again.rows == got.rows
    with open(path) as f:
        assert len(json.load(f)["rows"]) == 4


def test_fault_before_commit_resumes_to_same_ledger(swept, data, tmp_path):
    _, got, _ = swept
    path = str(tmp_path / "ledger.json")
    inj = FaultInjector()
    inj.arm("sweep_record", after=1, times=1, message="killed at commit")
    res = SweepService(_grid(), data[2], base_params=BASE,
                       ledger_path=path, injector=inj,
                       **{k: v for k, v in KW.items() if k != "verbose"}
                       ).run()
    assert res.preempted and "killed at commit" in res.error
    assert res.units_done == 1 and len(res.ledger.pending()) == 2
    done = p_sweep(_grid(), data[2], base_params=BASE, ledger_path=path, **KW)
    assert done.rows == got.rows


def _plan_of(svc, ds, **kw):
    plan = svc.scheduler.plan(svc._parsed(), ds, n_devices=svc.n_devices,
                              group_size=svc.group_size, **kw)
    return (plan.n_devices, plan.group_size, plan.n_groups,
            [(u.uid, u.config_indices, u.group) for u in plan.units])


@pytest.mark.parametrize("n_devices,group_size,hyper_batch",
                         [(2, 1, 36), (4, 2, 1), (8, 2, 3), (8, 8, 2)])
def test_multi_device_plan_matches_reference(data, n_devices, group_size,
                                             hyper_batch):
    """The scheduler's greedy LPT over device groups: the same units, uids
    and groups as the reference's, on a grid whose buckets split into
    several hyper-batches, with and without rows already done."""
    X, y, pd = data
    grid = expand_grid(learning_rate=[0.3, 0.1], num_leaves=[7, 15, 31],
                       min_data_in_leaf=[20, 40])
    kw = dict(base_params=BASE, n_devices=n_devices, group_size=group_size,
              hyper_batch=hyper_batch)
    ours = SweepService(grid, pd, **kw)
    ref = RSweepService(grid, R.Dataset(X, label=y), **kw)
    for done in ((), (0, 5, 6)):
        assert _plan_of(ours, pd, done=done) == _plan_of(
            ref, ref.train_set, done=done)


def test_multi_device_sweep_ledger_groups(swept, data):
    """``n_devices=4, group_size=2`` runs the same units one after another:
    every ledger row is the single-device run's, the plan stats name two
    groups, and each bucket's ``group`` is the reference plan's."""
    X, y, pd = data
    _, got, _ = swept
    kw = {k: v for k, v in KW.items() if k != "verbose"}
    res = SweepService(_grid(), pd, base_params=BASE, n_devices=4,
                       group_size=2, **kw).run()
    assert not res.preempted
    assert res.ledger.rows == got.rows
    stats = res.stats
    assert stats["plan"] == {"units": 2, "n_groups": 2, "group_size": 2}
    ref = RSweepService(_grid(), R.Dataset(X, label=y), base_params=BASE,
                        n_devices=4, group_size=2)
    want = {u.uid: u.group for u in ref.scheduler.plan(
        ref._parsed(), ref.train_set, n_devices=4, group_size=2).units}
    assert {b["uid"]: b["group"] for b in stats["buckets"]} == want
    assert sorted(want.values()) == [0, 1]


def test_expand_grid_and_digest_match_reference():
    from lightgbm_tpu.sweep.ledger import expand_grid as r_expand
    from lightgbm_tpu.sweep.ledger import grid_digest as r_digest
    from lightgbm_tpu_torch.sweep.ledger import grid_digest

    axes = dict(learning_rate=[0.1, 0.05, 0.01], num_leaves=[31, 63, 127],
                min_data_in_leaf=[20, 40], feature_fraction=[0.8, 1.0],
                bagging_fraction=[0.6, 0.8, 1.0], bagging_freq=[4],
                nthread=[4])
    grid = expand_grid(**axes)
    assert grid == r_expand(**axes) and len(grid) == 108
    assert grid[0]["learning_rate"] == 0.1 and grid[1]["learning_rate"] == 0.05
    assert grid_digest(grid, nfold=5, seed=1) == r_digest(grid, nfold=5,
                                                          seed=1)


def test_not_ported_options_raise_by_name(data, tmp_path):
    pd = data[2]
    model = str(tmp_path / "model.txt")
    P.train(dict(BASE), pd, 1).save_model(model)
    res = train_resumable(dict(BASE), pd, 2,
                          checkpoint_dir=str(tmp_path / "c"),
                          init_model=model)
    assert res.resumed_from == model and res.rounds_done == 2
    b = P.Booster({"objective": "regression", "num_leaves": 4,
                   "verbosity": -1}, pd)
    b.update()
    arrays, meta = b.checkpoint_state()
    # elastic resume: a one-device run resumes a checkpoint written at 2
    # (or 3) devices, shard boundaries nest; another merge mode requested
    # than the writer's raises by name
    for d in (2, 3):
        meta["parallel"].update(n_devices=d, merge_mode="psum")
        assert resume_booster((arrays, meta), pd).current_iteration() == 1
    with pytest.raises(IncompatibleCheckpointError, match="merge_mode"):
        resume_booster((arrays, meta), pd,
                       params={"histogram_merge": "reduce_scatter"})
    # a sweep over several devices is planned over device groups (the
    # plan: test_multi_device_plan_matches_reference); a group size that
    # does not divide the devices raises by name
    svc = SweepService(_grid(), pd, base_params=BASE, n_devices=2,
                       group_size=1)
    with pytest.raises(ValueError, match="group_size"):
        svc.scheduler.plan(svc._parsed(), pd, n_devices=2, group_size=3)


# -- carry checkpoints: kill-anywhere parity ---------------------------------

CHAOS_GRID = expand_grid(learning_rate=[0.3, 0.1], num_leaves=[7])
CHAOS_BASE = {"objective": "regression", "metric": "l2", "verbosity": -1,
              "min_data_in_leaf": 5, "cv_segment_rounds": 5}
FROZEN_CLOCK = lambda: 0.0  # noqa: E731 — pins saved_at for byte parity
CHAOS_KW = dict(base_params=CHAOS_BASE, num_boost_round=20, nfold=3,
                early_stopping_rounds=20, seed=0, clock=FROZEN_CLOCK)


def _chaos_problem(n=400, f=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2
         + rng.normal(0, 0.1, n)).astype(np.float32)
    return X, y


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    """The uninterrupted sweep's ledgers (both codecs, the port) and the
    reference's rows on the same grid."""
    X, y = _chaos_problem()
    ds = P.Dataset(X, label=y, device="cpu")
    d = tmp_path_factory.mktemp("chaos")
    clean = {}
    for suffix in ("json", "RData"):
        clean[suffix] = str(d / f"clean.{suffix}")
        res = SweepService(CHAOS_GRID, ds, ledger_path=clean[suffix],
                           **CHAOS_KW).run()
        assert res.completed and res.resumed_units == 0
    ref = RSweepService(CHAOS_GRID, R.Dataset(X, label=y),
                        **CHAOS_KW).run()
    return ds, clean, ref.ledger.rows


def _chaos_run(ds, path, ck, **kw):
    return SweepService(CHAOS_GRID, ds, ledger_path=path, checkpoint_dir=ck,
                        **CHAOS_KW, **kw).run()


@pytest.mark.parametrize("suffix", ["json", "RData"])
def test_kill_anywhere_file_level_parity(chaos, tmp_path, suffix):
    """A fault mid-sweep at a segment boundary, then a rerun that resumes
    from the hyper-batch checkpoint: the ledger FILE is byte-identical to an
    uninterrupted run's."""
    ds, clean, ref_rows = chaos
    path, ck = str(tmp_path / f"chaos.{suffix}"), str(tmp_path / "ck")
    inj = FaultInjector()
    inj.arm("sweep_segment", after=2)
    r = _chaos_run(ds, path, ck, injector=inj)
    assert r.preempted and "sweep_segment" in r.error
    assert os.path.isdir(ck)           # mid-unit carry checkpoints exist
    r2 = _chaos_run(ds, path, ck)
    assert r2.completed and r2.resumed_units >= 1
    assert r2.checkpoint_failures == 0
    assert _digest(path) == _digest(clean[suffix])
    assert not os.path.exists(ck)      # spent checkpoints pruned
    if suffix == "RData":
        df = r_read_rdata(path)["paramGrid"]
        assert df["iteration"] == [row["iteration"] for row in ref_rows]
        np.testing.assert_allclose(df["score"],
                                   [row["score"] for row in ref_rows],
                                   rtol=1e-5)


class _TermAt(FaultInjector):
    """Delivers a real SIGTERM at the n-th ``sweep_segment`` hit instead of
    raising: the guard drains at the next segment boundary."""

    def __init__(self, n):
        super().__init__()
        self.n = n

    def check(self, site):
        out = super().check(site)
        if site == "sweep_segment" and self.hits[site] == self.n:
            os.kill(os.getpid(), signal.SIGTERM)
        return out


def test_sigterm_mid_sweep_resumes(chaos, tmp_path):
    ds, clean, _ = chaos
    path, ck = str(tmp_path / "drain.json"), str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGTERM)
    r = _chaos_run(ds, path, ck, injector=_TermAt(3))
    assert signal.getsignal(signal.SIGTERM) == before
    assert r.preempted and "SIGTERM" in r.error
    r2 = _chaos_run(ds, path, ck)
    assert r2.completed and r2.resumed_units >= 1
    assert _digest(path) == _digest(clean["json"])


def test_corrupt_unit_checkpoint_falls_back_to_restart(chaos, tmp_path):
    ds, clean, _ = chaos
    path, ck = str(tmp_path / "c.json"), str(tmp_path / "ck")
    inj = FaultInjector()
    inj.arm("sweep_segment", after=2)
    _chaos_run(ds, path, ck, injector=inj)
    for root, _, files in os.walk(ck):
        for f in files:
            with open(os.path.join(root, f), "r+b") as fh:
                fh.write(b"\x00garbage\x00")
    with pytest.warns(UserWarning, match="corrupt sweep checkpoint"):
        r2 = _chaos_run(ds, path, ck)
    assert r2.completed and r2.resumed_units == 0    # clean restart
    assert _digest(path) == _digest(clean["json"])


def test_stale_grid_digest_and_lost_writes(chaos, tmp_path):
    ds, clean, _ = chaos
    path, ck = str(tmp_path / "led.json"), str(tmp_path / "ck")
    inj = FaultInjector()
    inj.arm("sweep_segment", after=2)
    inj.arm("checkpoint_write", after=0, times=1)
    with pytest.warns(UserWarning, match="sweep checkpoint write failed"):
        r = _chaos_run(ds, path, ck, injector=inj)
    assert r.preempted and r.checkpoint_failures == 1
    if os.path.exists(path):      # the fault may land before a commit
        os.unlink(path)
    # same units (the uid keys on bucket + indices), another seed: the
    # checkpoint's grid digest rejects the restore
    kw = dict(CHAOS_KW, seed=1)
    with pytest.warns(UserWarning, match="different sweep definition"):
        r2 = SweepService(CHAOS_GRID, ds, ledger_path=path,
                          checkpoint_dir=ck, **kw).run()
    assert r2.completed and r2.resumed_units == 0
