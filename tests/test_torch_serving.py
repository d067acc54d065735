"""Port parity: ``lightgbm_tpu_torch.serving`` against ``lightgbm_tpu.serving``.

Small forests are trained with the reference (``lightgbm_tpu.train``) and
packed with its ``pack_booster``; the port receives them through
``packed_from_arrays`` and through the ``.npz`` artifact.  The port's
``PredictorRuntime(device="cpu")`` (whose kernel wrapper takes the plain
PyTorch version on CPU tensors) is held to the reference runtime (whose
Pallas kernel runs in interpret mode on the CPU) at rtol 1e-5 / atol 1e-6
for every forest precision, both ``raw_score`` settings, multiclass,
``num_iteration``, rf averaging and the legacy categorical path.  The rest
covers ModelBank deploy/canary/swap/rollback and MicroBatcher shedding and
timeouts, run on the same scenario in both packages where the two can be
compared.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.serving as js
from lightgbm_tpu.serving.packed import _ARRAY_FIELDS, pack_booster
from lightgbm_tpu_torch import serving as ts
from lightgbm_tpu_torch.device import NoDeviceError

RTOL, ATOL = 1e-5, 1e-6
PRECISIONS = ["f32", "bf16", "int8"]


def to_port(jpf):
    """The reference PackedForest's numpy fields -> the port's."""
    arrays = {f: getattr(jpf, f) for f in _ARRAY_FIELDS}
    meta = {"shrink": jpf.shrink, "init_score": jpf.init_score,
            "num_class": jpf.num_class,
            "best_iteration": jpf.best_iteration,
            "depth_cap": jpf.depth_cap, "params": jpf.params,
            "bin_mapper": jpf.bin_mapper_dict,
            "feature_names": jpf.feature_names}
    return ts.packed_from_arrays(arrays, meta)


@pytest.fixture(scope="module")
def binary():
    rng = np.random.default_rng(12)
    X = rng.normal(size=(600, 5))
    X[rng.random(600) < 0.08, 1] = np.nan
    logits = 1.5 * X[:, 0] - np.nan_to_num(X[:, 1]) + X[:, 2] * X[:, 3]
    y = (rng.random(600) < 1 / (1 + np.exp(-logits))).astype(float)
    b = lgb.train({"objective": "binary", "num_leaves": 15,
                   "verbosity": -1}, lgb.Dataset(X, label=y),
                  num_boost_round=8)
    return X, pack_booster(b)


@pytest.fixture(scope="module")
def multiclass():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(400, 4))
    y = ((X[:, 0] + X[:, 1] > 0).astype(int)
         + (X[:, 2] > 0.5).astype(int)).astype(float)
    b = lgb.train({"objective": "multiclass", "num_class": 3,
                   "num_leaves": 7, "verbosity": -1},
                  lgb.Dataset(X, label=y), num_boost_round=3)
    return X, pack_booster(b)


def _close(got, want):
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_runtime_matches_reference(binary, precision):
    X, jpf = binary
    jrt = js.PredictorRuntime(jpf, max_bucket=256, donate=False,
                              forest_precision=precision)
    trt = ts.PredictorRuntime(to_port(jpf), max_bucket=256,
                              forest_precision=precision, device="cpu")
    assert trt.quant_error_bound == jrt.quant_error_bound
    assert trt.forest_nbytes == jrt.forest_nbytes
    assert trt.kernel_launches_per_dispatch == 1 and trt.fused_predict
    Xq = X[:200]
    for raw in (True, False):
        _close(trt.predict(Xq, raw_score=raw), jrt.predict(Xq, raw_score=raw))
    # the oracle is the reference's dequantized oracle
    codes = jpf.bin_mapper.transform(Xq)
    np.testing.assert_array_equal(trt.oracle.leaf_value,
                                  jrt.oracle.leaf_value)
    _close(trt.oracle.predict_numpy(codes, raw_score=False),
           jrt.oracle.predict_numpy(codes, raw_score=False))


def test_num_iteration_and_chunking_match_reference(binary):
    X, jpf = binary
    jrt = js.PredictorRuntime(jpf, max_bucket=64, donate=False)
    trt = ts.PredictorRuntime(to_port(jpf), max_bucket=64, device="cpu")
    for k in (3, 0, 100):
        _close(trt.predict(X[:150], num_iteration=k, raw_score=True),
               jrt.predict(X[:150], num_iteration=k, raw_score=True))
    # 150 rows over max_bucket 64: two full chunks and one of 22 rows
    assert trt.cache_info()["buckets_live"] == [32, 64]
    assert set(trt.cache_info()) == set(jrt.cache_info())


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_multiclass_matches_reference(multiclass, precision):
    X, jpf = multiclass
    jrt = js.PredictorRuntime(jpf, max_bucket=128, donate=False,
                              forest_precision=precision)
    trt = ts.PredictorRuntime(to_port(jpf), max_bucket=128,
                              forest_precision=precision, device="cpu")
    assert trt.kernel_launches_per_dispatch == 3
    for raw in (True, False):
        got = trt.predict(X[:100], raw_score=raw)
        assert got.shape == (100, 3)
        _close(got, jrt.predict(X[:100], raw_score=raw))


@pytest.mark.parametrize("objective", ["multiclassova", "rf"])
def test_ova_and_rf_transforms_match_reference_oracle(multiclass, binary,
                                                      objective):
    if objective == "rf":
        X, jpf = binary
        params = dict(jpf.params, boosting="rf")
    else:
        X, jpf = multiclass
        params = dict(jpf.params, objective="multiclassova")
    jpf = dataclasses.replace(jpf, params=params, _mapper_cache=None)
    trt = ts.PredictorRuntime(to_port(jpf), max_bucket=128, device="cpu")
    codes = jpf.bin_mapper.transform(X[:90])
    for k in (None, 2):
        for raw in (True, False):
            _close(trt.predict(X[:90], num_iteration=k, raw_score=raw),
                   jpf.predict_numpy(codes, num_iteration=k,
                                     raw_score=raw))


def test_categorical_forest_takes_legacy_path(small_regression):
    X, y = small_regression
    rng = np.random.default_rng(3)
    Xc = np.column_stack([rng.integers(0, 8, len(y)).astype(float),
                          X[:, :2]])
    b = lgb.train({"objective": "regression", "num_leaves": 7,
                   "verbosity": -1, "min_data_in_leaf": 5},
                  lgb.Dataset(Xc, label=y, categorical_feature=[0]),
                  num_boost_round=4)
    jpf = pack_booster(b)
    assert jpf.is_cat_split is not None
    for precision in ("f32", "int8"):
        jrt = js.PredictorRuntime(jpf, max_bucket=32, donate=False,
                                  forest_precision=precision)
        trt = ts.PredictorRuntime(to_port(jpf), max_bucket=32,
                                  forest_precision=precision, device="cpu")
        assert not trt.fused_predict
        assert trt.kernel_launches_per_dispatch == 0
        _close(trt.predict(Xc[:30]), jrt.predict(Xc[:30]))
        snap = trt.stats.snapshot()
        assert snap["fused_path"]["legacy_dispatches"] == 1
        assert snap["predict_kernel_launches"] == 0


def test_npz_interchanges_both_ways(binary, tmp_path):
    X, jpf = binary
    ref_path = str(tmp_path / "ref.npz")
    jpf.save(ref_path)
    tpf = ts.PackedForest.load(ref_path)          # reference file -> port
    for f in _ARRAY_FIELDS[:6]:
        np.testing.assert_array_equal(getattr(tpf, f), getattr(jpf, f))
    assert tpf.depth_cap == jpf.depth_cap
    port_path = str(tmp_path / "port.npz")
    tpf.save(port_path)
    back = js.PackedForest.load(port_path)        # port file -> reference
    for f in _ARRAY_FIELDS[:6]:
        np.testing.assert_array_equal(getattr(back, f), getattr(jpf, f))
    assert back.params == jpf.params
    assert back.bin_mapper_dict == jpf.bin_mapper_dict
    codes = jpf.bin_mapper.transform(X[:120])
    trt = ts.PredictorRuntime(tpf, max_bucket=128, device="cpu")
    _close(trt.predict(X[:120]), back.predict_numpy(codes, raw_score=False))
    with pytest.raises(ts.PackedForestError):
        ts.PackedForest.load(_corrupt(jpf, tmp_path))


def _corrupt(jpf, tmp_path):
    """An artifact whose root's left child points out of range."""
    bad = dataclasses.replace(jpf, left=jpf.left.copy())
    bad.left[0, 0] = 10_000
    path = str(tmp_path / "bad.npz")
    bad.save(path)
    return path


def test_runtime_contract_errors(binary):
    _, jpf = binary
    pf = to_port(jpf)
    # the serving mesh needs as many devices as it shards over (virtual
    # shards: parallel.set_virtual_devices), and a power of two of them
    with pytest.raises(ValueError, match="need 2 devices"):
        ts.PredictorRuntime(pf, mesh_devices=2, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        ts.PredictorRuntime(pf, mesh_devices=3, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        ts.PredictorRuntime(pf, max_bucket=12, device="cpu")
    bad = dataclasses.replace(pf, split_bin=pf.split_bin.copy())
    bad.split_bin[0, int(np.argmin(pf.is_leaf[0]))] = 300
    with pytest.raises(ts.ThresholdBoundError, match="split_bin"):
        ts.PredictorRuntime(bad, forest_precision="int8", device="cpu")
    rt = ts.PredictorRuntime(pf, device="cpu")
    assert rt.predict(np.zeros((0, 5))).shape == (0,)
    with pytest.raises(ValueError, match=r"\[0, 255\]"):
        rt.predict_binned(np.full((2, 5), 300))
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            ts.PredictorRuntime(pf)


def test_warm_covers_full_key_and_lru(binary):
    _, jpf = binary
    rt = ts.PredictorRuntime(to_port(jpf), max_bucket=64,
                             max_cache_entries=4, device="cpu")
    assert rt.warm() == 4                 # the 4 largest of 7 buckets
    assert rt.warmed_keys == {(b, False, "single") for b in (8, 16, 32, 64)}
    assert rt.warm(raw_score=True, buckets=[64]) == 1
    info = rt.cache_info()
    assert info["entries"] == 4 and info["num_compiles"] == 5
    assert info["warmed_keys"] == 5 and info["routes_live"] == ["single"]


# ---------------------------------------------------------------------------
# ModelBank
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def artifacts(binary, tmp_path_factory):
    X, jpf = binary
    d = tmp_path_factory.mktemp("bank")
    v1 = str(d / "v1.npz")
    jpf.save(v1)
    v2 = str(d / "v2.npz")
    dataclasses.replace(jpf, leaf_value=jpf.leaf_value * 0.5).save(v2)
    return X, jpf, v1, v2, _corrupt(jpf, d)


def test_bank_deploy_canary_swap_rollback(artifacts):
    X, jpf, v1, v2, bad = artifacts
    bank = ts.ModelBank(max_bucket=64, warm_on_deploy=True, canary_rows=16,
                        forest_precision="int8", device="cpu")
    rep = bank.deploy("m", v1)
    assert rep["ok"] and rep["version"] == "v1" and rep["warmed"] == 7
    assert rep["canary"]["max_abs_err"] <= 1e-5
    assert rep["canary"]["quant_abs_err"] <= (
        1e-5 + rep["canary"]["quant_error_bound"])
    first = bank.predict("m", X[:20])
    assert bank.deploy("m", v2)["version"] == "v2"
    second = bank.predict("m", X[:20])
    assert not np.allclose(first, second)
    with pytest.raises(ts.SwapRejected) as e:
        bank.deploy("m", bad)
    assert e.value.stage == "ingest" and bank.version("m") == "v2"
    assert bank.rollback("m")["version"] == "v1"
    np.testing.assert_array_equal(bank.predict("m", X[:20]), first)
    snap = bank.snapshot()["models"]["m"]
    assert [h["ok"] for h in snap["swap_history"]] == [True, True, False,
                                                       True]
    assert snap["stats"]["compile_cache"]["kernel_launches_per_dispatch"] == 1


def test_bank_rejections_keep_serving(artifacts, tmp_path):
    X, jpf, v1, _, _ = artifacts
    faults = ts.FaultInjector()
    bank = ts.ModelBank(max_bucket=32, faults=faults, device="cpu")
    bank.deploy("m", v1)
    faults.arm("artifact_load")
    with pytest.raises(ts.SwapRejected, match="artifact_load"):
        bank.deploy("m", v1)
    faults.arm("device_predict")
    with pytest.raises(ts.SwapRejected) as e:
        bank.deploy("m", v1)
    assert e.value.stage == "canary"
    bad = dataclasses.replace(jpf, split_bin=jpf.split_bin.copy())
    bad.split_bin[0, int(np.argmin(jpf.is_leaf[0]))] = 300
    qbank = ts.ModelBank(max_bucket=32, forest_precision="int8",
                         device="cpu")
    with pytest.raises(ts.SwapRejected) as e:
        qbank.deploy("q", to_port(bad))
    assert e.value.stage == "build"
    narrow = dataclasses.replace(
        jpf, bin_mapper_dict=dict(
            jpf.bin_mapper_dict,
            **{k: jpf.bin_mapper_dict[k][:4] for k in
               ("upper_bounds", "nan_bin", "n_bins", "is_categorical")}),
        _mapper_cache=None)
    with pytest.raises(ts.SwapRejected, match="feature count"):
        bank.deploy("m", to_port(dataclasses.replace(
            narrow, split_feature=np.minimum(jpf.split_feature, 3))))
    assert bank.version("m") == "v1"
    assert np.isfinite(bank.predict("m", X[:5])).all()
    with pytest.raises(ts.SwapRejected, match="no previous"):
        bank.rollback("m")


def test_bank_warm_manifest_roundtrip(artifacts, tmp_path):
    _, _, v1, _, _ = artifacts
    bank = ts.ModelBank(max_bucket=16, device="cpu")
    bank.deploy("m", v1, warm_buckets=[4, 16])
    path = bank.save_warm_manifest(str(tmp_path / "warm.json"))
    fresh = ts.ModelBank(max_bucket=16, device="cpu")
    got = fresh.restore_warm_manifest(path)
    # the live programs: the two warmed buckets and the canary's
    assert got == {"models": 1, "compiled": 3, "skipped": []}
    assert fresh.runtime("m").cache_info()["buckets_live"] == [4, 8, 16]


# ---------------------------------------------------------------------------
# MicroBatcher: the same scenario through both packages
# ---------------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _queue_scenario(pkg, rt, X):
    """Coalescing, deadlines, depth shedding and the numpy fallback, driven
    by a mocked clock; returns the answers and the queue counters."""
    clk = _Clock()
    mb = pkg.MicroBatcher(rt, max_batch=4, max_delay_ms=10.0,
                          timeout_ms=5.0, clock=clk, max_queue_depth=6,
                          shed_policy="depth")
    hs = [mb.submit(X[i], timeout_ms=1e6) for i in range(3)]
    assert mb.pump() == 0
    clk.t = 0.011
    assert mb.pump() == 1                         # one coalesced dispatch
    expiring = mb.submit(X[3])                    # default 5 ms deadline
    hs += [mb.submit(X[i], timeout_ms=1e6) for i in range(4, 9)]
    shed = mb.submit(X[9], timeout_ms=1e6)        # 7th live request
    clk.t = 0.02
    mb.pump()
    mb.flush()
    with pytest.raises(pkg.RequestTimeout):
        expiring.result()
    with pytest.raises(pkg.Overloaded, match="queue full"):
        shed.result()
    answers = [h.result() for h in hs]
    s = rt.stats.snapshot()
    counters = {k: s[k] for k in ("requests", "batched_dispatches",
                                  "timeouts", "sheds", "fallbacks")}
    return np.asarray(answers, np.float32), counters


def test_microbatcher_scenario_matches_reference(binary):
    X, jpf = binary
    jrt = js.PredictorRuntime(jpf, max_bucket=256, donate=False)
    trt = ts.PredictorRuntime(to_port(jpf), max_bucket=256, device="cpu")
    ja, jc = _queue_scenario(js, jrt, X)
    ta, tc = _queue_scenario(ts, trt, X)
    _close(ta, ja)
    assert tc == jc
    assert tc["timeouts"] == 1 and tc["sheds"] == 1


def test_microbatcher_falls_back_on_device_fault(binary):
    X, jpf = binary
    faults = ts.FaultInjector([ts.FaultSpec("device_predict", times=1)])
    rt = ts.PredictorRuntime(to_port(jpf), max_bucket=64, faults=faults,
                             forest_precision="bf16", device="cpu")
    mb = ts.MicroBatcher(rt, max_batch=3, max_delay_ms=0.0, clock=_Clock())
    hs = [mb.submit(X[i]) for i in range(6)]
    mb.pump()
    got = np.array([h.result() for h in hs], np.float32)
    assert rt.stats.fallbacks == 3               # the first batch only
    assert rt.stats.snapshot()["fused_path"]["dispatches"] == 1
    codes = rt.packed.bin_mapper.transform(X[:6])
    _close(got, rt.oracle.predict_numpy(codes, raw_score=False))
    mb2 = ts.MicroBatcher(rt, max_batch=1, clock=_Clock(),
                          fallback_unbatched=False)
    faults.arm("device_predict")
    h = mb2.submit(X[0])
    mb2.pump()
    with pytest.raises(RuntimeError, match="fallback is disabled"):
        h.result()


def test_microbatcher_raises_kernel_errors_instead_of_falling_back(
        binary, monkeypatch):
    # a kernel that fails to build or launch is a defect: the batch fails
    # with it and pump() raises; nothing is answered on the host
    from lightgbm_tpu_torch.kernels import (KernelBuildError, KernelError,
                                            KernelLaunchError)
    from lightgbm_tpu_torch.ops import predict as port_predict

    X, jpf = binary
    for err in (KernelLaunchError("launch refused"),
                KernelBuildError("nvcc refused the source")):
        assert isinstance(err, KernelError)

        def broken(*args, _err=err, **kwargs):
            raise _err

        monkeypatch.setattr(port_predict, "predict_forest", broken)
        rt = ts.PredictorRuntime(to_port(jpf), max_bucket=64, device="cpu")
        mb = ts.MicroBatcher(rt, max_batch=3, max_delay_ms=0.0,
                             clock=_Clock())
        hs = [mb.submit(X[i]) for i in range(4)]
        with pytest.raises(type(err)):
            mb.pump()
        for h in hs[:3]:
            with pytest.raises(type(err)):
                h.result()
        assert not hs[3].done and mb.pending_count() == 1
        assert rt.stats.fallbacks == 0
        # nor does a deploy's canary turn it into a rejected swap
        with pytest.raises(type(err)):
            ts.ModelBank(max_bucket=64, canary_rows=4,
                         device="cpu").deploy("m", to_port(jpf))


def test_deadline_policy_sheds_predicted_miss(binary):
    X, jpf = binary
    rt = ts.PredictorRuntime(to_port(jpf), max_bucket=64, device="cpu")
    mb = ts.MicroBatcher(rt, max_batch=2, max_delay_ms=1.0,
                         clock=_Clock(), service_time_hint_ms=10.0)
    ok = mb.submit(X[0], timeout_ms=100.0)
    late = mb.submit(X[1], timeout_ms=5.0)
    assert not ok.done
    with pytest.raises(ts.Overloaded, match="predicted queue wait"):
        late.result()
    assert rt.stats.sheds == 1


def test_stats_snapshot_keys_match_reference():
    assert set(ts.ServingStats().snapshot()) == set(
        js.ServingStats().snapshot())
    assert ts.SHED_POLICIES == js.SHED_POLICIES
    assert ts.FAULT_SITES == js.FAULT_SITES
    assert ts.bucket_for(300, 256) == js.bucket_for(300, 256) == 256
    assert not ts.enable_persistent_cache(os.devnull)
