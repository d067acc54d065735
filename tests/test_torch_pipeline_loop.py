"""Port parity: the refresh daemon's loop beyond one run, on CPU tensors —
``latest_artifact`` and ``DirectoryFeed`` skipping in-progress ``.tmp``
files, a ``state_dir`` written by either package's daemon re-anchored by the
other's (the anchor's trees carried bit for bit, the next generation within
the streamed regime: split structure equal, leaf values within rtol 1e-5 /
atol 1e-6), the bank's ``compile`` and ``clock`` fault sites, and a retune
with a ``sweep_promote`` fault ending on the reference's winner and ledger
(cv scores within rtol 1e-5).  The shared fixtures are
``tests/test_torch_pipeline.py``'s.
"""

import json

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.serving.bank import ModelBank, SwapRejected
from lightgbm_tpu_torch.serving.packed import PackedForest as PPacked
from test_torch_pipeline import FOREST, PF, PKG, PP, _daemon, _problem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the growers run many small ops, which several
    test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_latest_artifact_and_directory_feed_skip_tmp(tmp_path):
    X, y = _problem(n=256)
    for pkg, (pipe, _) in PKG.items():
        models = tmp_path / pkg / "models"
        models.mkdir(parents=True)
        for name in ("model_g0001.npz", ".tmp-model_g0002.npz",
                     "model_g12.npz", "other.npz"):
            (models / name).write_bytes(b"")
        path, gen = pipe.latest_artifact(str(models))
        assert gen == 1 and path.endswith("model_g0001.npz")
        watch = tmp_path / pkg / "watch"
        watch.mkdir()
        feed = pipe.DirectoryFeed(str(watch), pipe.SimClock())
        np.savez(str(watch / "b0.npz"), X=X, y=y)
        (watch / "b1.npz.tmp").write_bytes(b"")
        got = feed.poll()
        assert len(got) == 1 and got[0].X.shape == (256, 5)
        assert feed.poll() == []
        np.savez(str(watch / "bad.npz"), Z=X)
        with pytest.raises(ValueError, match="'X' and 'y'"):
            feed.poll()


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_state_dir_reanchored_across_packages(writer, reader, tmp_path):
    d, feed = _daemon(writer, tmp_path, PKG[writer][0].SimClock())
    feed.push(*_problem())
    assert d.tick()["event"] == "flipped"
    d2, feed2 = _daemon(reader, tmp_path, PKG[reader][0].SimClock())
    assert d2._gen == 1 and d2._live_rounds == 4
    assert d2.bank.version("model") == "g0001"
    feed2.push(*_problem(seed=1))
    ev = d2.tick()
    assert ev["event"] == "flipped" and ev["version"] == "g0002"
    assert ev["rounds"] == 7
    assert str(ev["resumed_from"]).endswith("model_g0001.npz")
    # the anchor's four trees are carried bit for bit, and generation 2
    # follows the regime of the reader re-anchoring on its own generation 1
    anchor, cont = PPacked.load(d._live_path), PPacked.load(d2._live_path)
    for f in FOREST + ("leaf_value",):
        assert np.array_equal(getattr(cont, f)[:4], getattr(anchor, f)), f
    ctrl, cfeed = _daemon(reader, tmp_path / "ctrl",
                          PKG[reader][0].SimClock())
    cfeed.push(*_problem())
    assert ctrl.tick()["event"] == "flipped"
    ctrl2, cfeed2 = _daemon(reader, tmp_path / "ctrl",
                            PKG[reader][0].SimClock())
    cfeed2.push(*_problem(seed=1))
    assert ctrl2.tick()["event"] == "flipped"
    own = PPacked.load(ctrl2._live_path)
    for f in FOREST:
        assert np.array_equal(getattr(cont, f), getattr(own, f)), f
    np.testing.assert_allclose(cont.leaf_value, own.leaf_value, rtol=1e-5,
                               atol=1e-6)


# -- serving faults through the daemon's bank ----------------------------


def test_bank_compile_stall_and_clock_skew(tmp_path):
    inj = PF.FaultInjector([PF.FaultSpec("compile", stall_s=7.5)])
    assert inj.check("compile") == 7.5        # returned, not raised
    assert inj.check("compile") == 0.0        # single-shot
    clock = PP.SimClock()
    skewed = inj.wrap_clock(clock)
    inj.arm("clock", after=inj.hits["clock"], times=-1, skew_s=60.0)
    assert skewed() == 60.0 and inj.fired["clock"] >= 1
    d, feed = _daemon("port", tmp_path, clock)
    feed.push(*_problem())
    assert d.tick()["event"] == "flipped"
    bank = ModelBank(faults=inj, compile_timeout_s=0.5, clock=clock,
                     warm_on_deploy=True, device="cpu")
    inj.arm("compile", stall_s=10.0)
    with pytest.raises(SwapRejected, match="compile stalled"):
        bank.deploy("model", d._live_path, version="g0001")


# -- the closed tune -> serve loop ---------------------------------------

GRID = [{"learning_rate": lr, "min_data_in_leaf": m}
        for lr in (0.2, 0.1) for m in (5, 10)]


def test_retune_with_sweep_promote_fault_ends_on_reference_winner(tmp_path):
    out = {}
    for pkg, (pipe, faults) in PKG.items():
        inj = faults.FaultInjector()
        d, feed = _daemon(pkg, tmp_path / pkg, pipe.SimClock(),
                          injector=inj, sweep_grid=GRID, sweep_rounds=6,
                          sweep_nfold=3, sweep_early_stopping=6)
        feed.push(*_problem())
        assert [e["event"] for e in d.run_until_idle()] == ["flipped"]
        inj.arm("sweep_promote")
        feed.push(*_problem(seed=1))
        first = d.retune()
        assert first["event"] == "preempted"
        assert first["phase"] == "sweep_promote"
        done = d.run_until_idle()
        assert [e["event"] for e in done] == ["retuned"]
        with open(tmp_path / pkg / "sweep" / "gen_0002" /
                  "ledger.json") as f:
            ledger = json.load(f)
        out[pkg] = (done[0], ledger, d.params)
    ev_p, led_p, params_p = out["port"]
    ev_r, led_r, params_r = out["reference"]
    assert ev_p["winner"] == ev_r["winner"]
    assert ev_p["rounds"] == ev_r["rounds"]
    assert params_p == params_r
    assert ev_p["sweep_units"] == ev_r["sweep_units"]
    # the ledger: the same rows and best iterations, the cv scores within
    # the general-data regime (f32 histogram sums round differently)
    rows_p, rows_r = led_p["rows"], led_r["rows"]
    assert [{k: v for k, v in r.items() if k != "score"} for r in rows_p] \
        == [{k: v for k, v in r.items() if k != "score"} for r in rows_r]
    np.testing.assert_allclose([r["score"] for r in rows_p],
                               [r["score"] for r in rows_r], rtol=1e-5)
