"""Port parity: the grid sweep (``sweep/``, ``utils.sweep.run_grid_search``)
against the reference's on the CPU.

* a 4-config grid (two num_leaves buckets, min_data 20 / 40, bagging and
  feature fraction as in the 108-config grid): every ledger row's
  ``iteration`` equal to the reference's, ``score`` within rtol 1e-5;
* a rerun with the same ledger skips the recorded rows; a sweep stopped by
  an injected fault before a ledger commit resumes to the same ledger;
* what is not ported raises by name: ``.RData`` ledgers, ``checkpoint_dir``
  and more than one device.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.utils.sweep import run_grid_search as r_sweep
from lightgbm_tpu_torch.faults import FaultInjector
from lightgbm_tpu_torch.models import fused as pf
from lightgbm_tpu_torch.sweep import SweepService
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
    with pytest.raises(NotImplementedError, match="RData"):
        p_sweep(_grid(), pd, base_params=BASE,
                ledger_path=str(tmp_path / "paramGrid.RData"), **KW)
    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        SweepService(_grid(), pd, checkpoint_dir=str(tmp_path / "ck"))
    with pytest.raises(NotImplementedError, match="slice 6"):
        SweepService(_grid(), pd, base_params=BASE, n_devices=2,
                     group_size=1).run()
