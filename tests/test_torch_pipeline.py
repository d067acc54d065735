"""Port parity: the refresh daemon (``pipeline/``) against the reference's,
on CPU tensors.

The same 512-row problem, params and dyadic stage costs as the reference's
freshness tests, on a ``SimClock``: every generation's stamps,
decomposition and staleness are equal as floats; the forests follow the
streamed regime (split structure equal, leaf values within rtol 1e-5 /
atol 1e-6, README's port section); the faults at every pipeline site give
the reference's events; a ``state_dir`` written by either package's daemon
is re-anchored by the other's (``tests/test_torch_pipeline_loop.py``, with
the retune).
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu.faults as RF
import lightgbm_tpu.pipeline as RP
import lightgbm_tpu_torch.faults as PF
import lightgbm_tpu_torch.pipeline as PP
from lightgbm_tpu.serving.packed import PackedForest as RPacked
from lightgbm_tpu_torch.serving.packed import PackedForest as PPacked

PARAMS = dict(objective="binary", num_leaves=7, learning_rate=0.2,
              max_bin=31, min_data_in_leaf=5, verbose=-1, seed=7,
              stream_block_rows=256)
# dyadic stage costs -> exact float sums -> exact staleness assertions
COSTS = dict(dataset_build=0.5, train_round=0.25, publish=0.25,
             deploy=1.0, flip=0.5)
PKG = {"reference": (RP, RF), "port": (PP, PF)}
FOREST = ("split_feature", "split_bin", "left", "right", "is_leaf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the growers run many small ops, which several
    test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=512, f=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    y = (rng.random(n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return X, y


def _daemon(pkg, state_dir, clock, *, injector=None, stage_costs=None,
            slo_ms=None, **kw):
    pipe, _ = PKG[pkg]
    feed = pipe.ArrivalFeed(clock)
    if pkg == "port":
        kw["device"] = "cpu"
    d = pipe.RefreshDaemon(PARAMS, str(state_dir), feed=feed,
                           refresh_rounds=3, initial_rounds=4,
                           checkpoint_rounds=2, staleness_slo_ms=slo_ms,
                           canary_rows=4, clock=clock, injector=injector,
                           stage_costs=stage_costs, **kw)
    return d, feed


def _regime(path_a, path_b):
    a, b = RPacked.load(path_a), PPacked.load(path_b)
    for f in FOREST:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                               atol=1e-6)


def _event(ev):
    """An event without the parts that name a package's own objects."""
    return {k: v for k, v in ev.items()
            if k not in ("report", "resumed_from", "rollback", "error")}


# -- staleness arithmetic ------------------------------------------------


def test_staleness_arithmetic_as_reference():
    out = {}
    for pkg, (pipe, _) in PKG.items():
        rec = pipe.RefreshRecord(generation=1)
        with pytest.raises(ValueError, match="unknown stage"):
            rec.stamp("nope", 0.0)
        for stage, t in zip(("data_arrival", "train_start", "trained",
                             "artifact_saved", "canaried", "serving"),
                            (1.0, 1.5, 3.0, 3.25, 4.25, 4.5)):
            rec.stamp(stage, t)
        tr = pipe.StalenessTracker(slo_ms=2_000.0)
        r1 = tr.begin(1)
        assert tr.begin(1) is r1 and r1.attempts == 2
        r1.stamps.update(rec.stamps)
        r1.status = "serving"
        clock = pipe.SimClock(10.0)
        with pytest.raises(ValueError, match="backwards"):
            clock.advance(-1.0)
        out[pkg] = (rec.as_dict(), tr.snapshot(), tr.breaches(),
                    clock(), clock.advance(0.5), pipe.STAGES)
    assert out["port"] == out["reference"]


# -- generations on the sim clock ----------------------------------------


@pytest.fixture(scope="module")
def generations(tmp_path_factory):
    """Three generations of both daemons on dyadic stage costs."""
    out = {}
    for pkg in PKG:
        root = tmp_path_factory.mktemp(f"gens_{pkg}")
        clock = PKG[pkg][0].SimClock()
        d, feed = _daemon(pkg, root, clock, stage_costs=COSTS,
                          slo_ms=3_250.0)
        events, paths = [], []
        for seed in (0, 1, 2):
            feed.push(*_problem(seed=seed))
            clock.advance(0.25)
            events.append(d.tick())
            paths.append(d._live_path)
        assert d.tick() is None
        out[pkg] = (d, events, paths)
    return out


def test_generations_stamps_and_staleness_match_reference(generations):
    dr, er, _ = generations["reference"]
    dp, ep, _ = generations["port"]
    assert [_event(e) for e in ep] == [_event(e) for e in er]
    assert [e["event"] for e in ep] == ["flipped"] * 3
    assert [e["rounds"] for e in ep] == [4, 7, 10]
    for g in (1, 2, 3):
        a, b = dr.tracker.record(g), dp.tracker.record(g)
        assert b.stamps == a.stamps
        assert b.decomposition() == a.decomposition()
        assert dp.tracker.staleness_ms(g) == dr.tracker.staleness_ms(g)
    assert dp.tracker.record(1).decomposition()["train"] == \
        COSTS["dataset_build"] + 4 * COSTS["train_round"]
    assert dp.tracker.snapshot() == dr.tracker.snapshot()
    assert dp.tracker.breaches() == dr.tracker.breaches() == [1]
    snap_p, snap_r = dp.snapshot(), dr.snapshot()
    for k in ("generation", "live_rounds", "pending_blocks",
              "absorbed_blocks", "poll_faults", "flips_since_sweep",
              "retry_mode"):
        assert snap_p[k] == snap_r[k], k


def test_generations_forests_follow_the_streamed_regime(generations):
    _, _, pr = generations["reference"]
    _, _, pp = generations["port"]
    for a, b in zip(pr, pp):
        assert os.path.basename(a) == os.path.basename(b)
        _regime(a, b)
    # the served raw scores are the artifact's own
    dp = generations["port"][0]
    packed = PPacked.load(pp[-1])
    X = _problem(n=64, seed=9)[0]
    want = packed.predict_numpy(packed.bin_mapper.transform(X))
    np.testing.assert_allclose(dp.bank.predict("model", X, raw_score=True),
                               want, rtol=1e-6, atol=1e-6)


# -- chaos at every pipeline site ----------------------------------------


def _chaos(pkg, tmp_path, site, rel=0):
    """Gen 1 clean, then gen 2 with ``site`` armed; returns the daemon,
    its feed, the injector and the events of the first tick and a retry."""
    pipe, faults = PKG[pkg]
    inj = faults.FaultInjector()
    d, feed = _daemon(pkg, tmp_path / pkg, pipe.SimClock(), injector=inj)
    feed.push(*_problem())
    assert d.tick()["event"] == "flipped"
    inj.arm(faults.FaultSpec(site=site, after=inj.hits[site] + rel,
                             times=1))
    feed.push(*_problem(seed=1))
    return d, feed, inj, d.tick()


def test_preempted_generation_converges_to_the_unfaulted_flip(tmp_path):
    from lightgbm_tpu_torch.training import latest_checkpoint

    evs = {}
    for pkg in PKG:
        # +2 fires at round 7, after the round-6 checkpoint landed
        d, _, _, ev = _chaos(pkg, tmp_path, "continue_train", rel=2)
        assert ev["event"] == "preempted"
        assert d.bank.version("model") == "g0001"
        if pkg == "port":
            ck = latest_checkpoint(str(tmp_path / pkg / "ckpt" / "gen_0002"))
            assert ck is not None and ck.endswith(".lgckpt")
        retry = d.tick()
        assert str(retry["resumed_from"]).endswith(".lgckpt")
        assert d.tracker.record(2).attempts == 2
        evs[pkg] = (_event(ev), _event(retry), d._live_path)
    assert evs["port"][:2] == evs["reference"][:2]
    ctrl, cfeed = _daemon("port", tmp_path / "ctrl", PP.SimClock())
    for seed in (0, 1):
        cfeed.push(*_problem(seed=seed))
        assert ctrl.tick()["event"] == "flipped"
    a, b = PPacked.load(evs["port"][2]), PPacked.load(ctrl._live_path)
    for f in FOREST + ("leaf_value",):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    _regime(evs["reference"][2], evs["port"][2])


def test_poisoned_artifact_rejected_while_prior_serves(tmp_path):
    evs = {}
    for pkg in PKG:
        inj = PKG[pkg][1].FaultInjector()
        d, feed = _daemon(pkg, tmp_path / pkg, PKG[pkg][0].SimClock(),
                          injector=inj)
        feed.push(*_problem())
        assert d.tick()["event"] == "flipped"
        probe = np.random.default_rng(9).normal(size=(16, 5))
        before = d.bank.predict("model", probe)
        inj.arm(PKG[pkg][1].FaultSpec(site="artifact_push", after=0,
                                      times=1))
        feed.push(*_problem(seed=1))
        ev = d.tick()
        assert ev["event"] == "rejected" and ev["poisoned"]
        assert d.bank.version("model") == "g0001"
        assert np.array_equal(before, d.bank.predict("model", probe))
        retry = d.tick()
        assert d.bank.version("model") == "g0002"
        evs[pkg] = (_event(ev), _event(retry))
    assert evs["port"] == evs["reference"]
    assert evs["port"][0]["stage"] == "ingest"   # NaN leaves die there


def test_flip_fault_rolls_back_and_reanchors(tmp_path):
    evs = {}
    for pkg in PKG:
        d, feed, _, ev = _chaos(pkg, tmp_path, "flip")
        assert ev["event"] == "rolled_back"
        assert d.bank.version("model") == "g0001"
        assert d.tracker.record(2).status == "rolled_back"
        feed.push(*_problem(seed=2))
        nxt = d.tick()
        assert nxt["generation"] == 3 and nxt["rounds"] == 4 + 3
        evs[pkg] = (_event(ev), _event(nxt),
                    d.tracker.record(2).decomposition())
    assert evs["port"] == evs["reference"]


def test_data_arrival_fault_loses_no_arrival(tmp_path):
    evs = {}
    for pkg in PKG:
        inj = PKG[pkg][1].FaultInjector()
        d, feed = _daemon(pkg, tmp_path / pkg, PKG[pkg][0].SimClock(),
                          injector=inj)
        feed.push(*_problem())
        inj.arm(PKG[pkg][1].FaultSpec(site="data_arrival", after=0,
                                      times=1))
        ev = d.tick()
        assert ev["event"] == "poll_fault" and d.poll_faults == 1
        evs[pkg] = (ev, _event(d.tick()))
    assert evs["port"] == evs["reference"]
    assert evs["port"][1]["event"] == "flipped"
