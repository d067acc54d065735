"""Port parity: the serving mesh (``lightgbm_tpu_torch/serving/mesh.py``)
against the reference's ``lightgbm_tpu/serving/mesh.py``.

The reference serves on the 8 virtual JAX CPU devices of
``tests/conftest.py``; the port on 8 virtual shards
(``parallel.set_virtual_devices(8)``), where each shard's kernel wrapper
takes the plain PyTorch version on CPU tensors.

* ``choose_route`` is the reference's on every (policy, bucket, trees, D);
* dp is bit-identical to the port's single route at D = 2, 4 and 8, ragged
  tails and ``num_iteration`` included, binary, multiclass and int8, and
  within rtol 1e-5 / atol 1e-6 of the reference's dp (the single routes'
  regime);
* tp is within the reference's bound of 2 ulp of the largest output of
  the single route and of the reference's tp, for binary, multiclass,
  truncated windows (``num_iteration`` 1, 5, all) and bf16 / int8 forests;
  on the legacy route of a categorical forest within 2 ulp of the port's
  single route and within rtol 1e-5 / atol 1e-6 of the reference's single
  route (the reference's legacy tp program does not trace under the JAX of
  these tests);
* the shards' SoA slices are built once per runtime: repeated tp dispatches
  hand the kernel the same slices, so its node tables build once a slice;
* ``warm()`` builds every shard program traffic resolves; the bank's canary,
  hot swap, rollback and oracle fallback run with the mesh active; the
  CLI's mesh keys keep the reference's messages and the server drains on
  SIGTERM with the mesh on.
"""

import io
import signal

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.serving as js
import lightgbm_tpu.serving.mesh as jm
from lightgbm_tpu.serving.packed import _ARRAY_FIELDS, pack_booster
from lightgbm_tpu_torch import serving as ts
from lightgbm_tpu_torch.parallel import set_virtual_devices
from lightgbm_tpu_torch.serving import mesh as tm

RTOL, ATOL = 1e-5, 1e-6


def to_port(jpf):
    arrays = {f: getattr(jpf, f) for f in _ARRAY_FIELDS}
    meta = {"shrink": jpf.shrink, "init_score": jpf.init_score,
            "num_class": jpf.num_class,
            "best_iteration": jpf.best_iteration,
            "depth_cap": jpf.depth_cap, "params": jpf.params,
            "bin_mapper": jpf.bin_mapper_dict,
            "feature_names": jpf.feature_names}
    return ts.packed_from_arrays(arrays, meta)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain forest sums run many small ops, which
    several test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def virtual8():
    set_virtual_devices(8)
    yield
    set_virtual_devices(0)


def _ulp_tol(ref, ulps=2):
    return ulps * np.spacing(np.float32(np.max(np.abs(ref))))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two same-width regression forests (12 and 4 trees) as ``.npz``
    artifacts, and their rows."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(800, 5))
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] * X[:, 3]
    d = tmp_path_factory.mktemp("mesh")
    b1 = lgb.train({"objective": "regression", "num_leaves": 15,
                    "verbosity": -1}, lgb.Dataset(X, label=y), 12)
    b2 = lgb.train({"objective": "regression", "num_leaves": 7,
                    "verbosity": -1}, lgb.Dataset(X, label=X[:, 0]), 4)
    v1, v2 = str(d / "v1.npz"), str(d / "v2.npz")
    pack_booster(b1).save(v1)
    pack_booster(b2).save(v2)
    return X, v1, v2


@pytest.fixture(scope="module")
def binary():
    rng = np.random.default_rng(12)
    X = rng.normal(size=(600, 5))
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y = (rng.random(600) < 1 / (1 + np.exp(-logits))).astype(float)
    b = lgb.train({"objective": "binary", "num_leaves": 15,
                   "verbosity": -1}, lgb.Dataset(X, label=y), 11)
    return X, pack_booster(b)


@pytest.fixture(scope="module")
def multiclass():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(500, 4))
    y = ((X[:, 0] + X[:, 1] > 0).astype(int)
         + (X[:, 2] > 0.5).astype(int)).astype(float)
    b = lgb.train({"objective": "multiclass", "num_class": 3,
                   "num_leaves": 7, "verbosity": -1},
                  lgb.Dataset(X, label=y), 5)
    return X, pack_booster(b)


def _pair(jpf, **kw):
    """The reference's and the port's runtime on the same forest."""
    return (js.PredictorRuntime(jpf, donate=False, **kw),
            ts.PredictorRuntime(to_port(jpf), device="cpu", **kw))


def test_choose_route_matrix_is_the_reference():
    assert tm.SHARD_POLICIES == jm.SHARD_POLICIES
    assert (tm.DP_MIN_ROWS_PER_SHARD, tm.TP_BUCKET_CEILING,
            tm.TP_MIN_TREES_PER_DEVICE) == (
        jm.DP_MIN_ROWS_PER_SHARD, jm.TP_BUCKET_CEILING,
        jm.TP_MIN_TREES_PER_DEVICE)
    for pol in tm.SHARD_POLICIES:
        for d in (1, 2, 4, 8):
            for bucket in (1, 8, 16, 32, 63, 64, 65, 128, 256, 1024):
                for trees in (1, 3, 4, 7, 8, 16, 100):
                    assert tm.choose_route(pol, bucket, trees, d) == \
                        jm.choose_route(pol, bucket, trees, d)
    with pytest.raises(ValueError, match="shard_policy"):
        tm.choose_route("both", 64, 100, 4)


def test_mesh_and_runtime_validation(models):
    _, v1, _ = models
    with pytest.raises(ValueError, match="power of two"):
        tm.ServingMesh(3, base="cpu")
    pf = ts.PackedForest.load(v1)
    with pytest.raises(ValueError, match="power of two"):
        ts.PredictorRuntime(pf, mesh_devices=3, device="cpu")
    with pytest.raises(ValueError, match="shard_policy"):
        ts.PredictorRuntime(pf, mesh_devices=2, shard_policy="maybe",
                            device="cpu")
    set_virtual_devices(0)
    with pytest.raises(ValueError, match="need 2 devices"):
        ts.PredictorRuntime(pf, mesh_devices=2, device="cpu")
    assert repr(tm.ServingMesh(1, base="cpu")) == "ServingMesh(devices=1)"


@pytest.mark.parametrize("d", [2, 4, 8])
def test_dp_bit_identical_to_single(models, d):
    X, v1, _ = models
    pf = ts.PackedForest.load(v1)
    single = ts.PredictorRuntime(pf, max_bucket=256, device="cpu")
    rt = ts.PredictorRuntime(pf, max_bucket=256, mesh_devices=d,
                             shard_policy="dp", device="cpu")
    ref = js.PredictorRuntime(js.PackedForest.load(v1), max_bucket=256,
                              mesh_devices=d, shard_policy="dp",
                              donate=False)
    for n in (1, 17, 16 * d, 137, 256):       # ragged tails + exact tile
        for k in (None, 5):
            got = rt.predict(X[:n], num_iteration=k)
            assert np.array_equal(got, single.predict(X[:n],
                                                      num_iteration=k))
            np.testing.assert_allclose(
                got, ref.predict(X[:n], num_iteration=k), rtol=RTOL,
                atol=ATOL)
    assert "dp" in rt.cache_info()["routes_live"]
    assert rt.route_for(256) == ref.route_for(256) == "dp"
    assert rt.route_for(8) == "single"


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_dp_multiclass_and_quantized_bit_identical(multiclass, binary,
                                                   precision):
    for X, jpf in (multiclass, binary):
        single = ts.PredictorRuntime(to_port(jpf), max_bucket=128,
                                     forest_precision=precision,
                                     device="cpu")
        rt = ts.PredictorRuntime(to_port(jpf), max_bucket=128,
                                 mesh_devices=4, shard_policy="dp",
                                 forest_precision=precision, device="cpu")
        got = rt.predict(X[:97])
        assert got.shape == (97,) + ((3,) if jpf.num_class > 1 else ())
        assert np.array_equal(got, single.predict(X[:97]))


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_tp_within_two_ulp(binary, multiclass, precision):
    for (X, jpf), d in ((binary, 4), (multiclass, 2)):
        single = ts.PredictorRuntime(to_port(jpf), max_bucket=32,
                                     forest_precision=precision,
                                     device="cpu")
        jrt, rt = _pair(jpf, max_bucket=32, mesh_devices=d,
                        shard_policy="tp", forest_precision=precision)
        for raw in (True, False):
            got = rt.predict(X[:16], raw_score=raw)
            ref = single.predict(X[:16], raw_score=raw)
            assert np.max(np.abs(got - ref)) <= _ulp_tol(ref)
            want = jrt.predict(X[:16], raw_score=raw)
            assert np.max(np.abs(got - want)) <= _ulp_tol(want)
        assert rt.cache_info()["routes_live"] == ["tp"]
        assert rt.cache_info()["mesh_devices"] == d


def test_tp_truncation_window(models):
    """The global ``num_iteration`` window lands in the right shard: shard
    ``d``'s kernel window is ``[0, clip(k - d * t_loc, 0, t_loc))``."""
    X, v1, _ = models
    jpf = js.PackedForest.load(v1)
    single = ts.PredictorRuntime(to_port(jpf), max_bucket=32, device="cpu")
    jrt, rt = _pair(jpf, max_bucket=32, mesh_devices=4, shard_policy="tp")
    for k in (1, 5, jpf.num_trees):
        ref = single.predict(X[:8], num_iteration=k)
        got = rt.predict(X[:8], num_iteration=k)
        assert np.max(np.abs(got - ref)) <= _ulp_tol(ref), k
        want = jrt.predict(X[:8], num_iteration=k)
        assert np.max(np.abs(got - want)) <= _ulp_tol(want), k
    _, t_loc = rt._tp_soa_parts()
    assert t_loc == 8                # 12 trees pad to 32 = 8 chunks x 4


def test_tp_categorical_legacy_route():
    rng = np.random.default_rng(3)
    X = np.column_stack([rng.integers(0, 8, 600).astype(float),
                         rng.normal(size=(600, 2))])
    y = np.sin(X[:, 0]) + X[:, 1] - 0.5 * X[:, 2]
    b = lgb.train({"objective": "regression", "num_leaves": 7,
                   "verbosity": -1, "min_data_in_leaf": 5},
                  lgb.Dataset(X, label=y, categorical_feature=[0]), 9)
    jpf = pack_booster(b)
    for precision in ("f32", "int8"):
        # the reference's own legacy tp program does not trace under this
        # JAX (its shard_map scan carry); its single route is the anchor
        jrt, single = _pair(jpf, max_bucket=32, forest_precision=precision)
        rt = ts.PredictorRuntime(to_port(jpf), max_bucket=32, mesh_devices=4,
                                 shard_policy="tp",
                                 forest_precision=precision, device="cpu")
        assert not rt.fused_predict
        for k in (3, None):
            ref = single.predict(X[:16], num_iteration=k)
            got = rt.predict(X[:16], num_iteration=k)
            assert np.max(np.abs(got - ref)) <= _ulp_tol(ref)
            np.testing.assert_allclose(
                got, jrt.predict(X[:16], num_iteration=k), rtol=RTOL,
                atol=ATOL)
        dp = ts.PredictorRuntime(to_port(jpf), max_bucket=128,
                                 mesh_devices=4, shard_policy="dp",
                                 forest_precision=precision, device="cpu")
        assert np.array_equal(dp.predict(X[:100]), single.predict(X[:100]))


def test_tp_shard_slices_built_once(binary, monkeypatch):
    """Every tp dispatch hands the kernel the same per-shard SoA slices,
    so the node-table cache (keyed per SoA) builds a slice's tables once,
    whatever the number of dispatches."""
    import lightgbm_tpu_torch.kernels.predict as KP
    import lightgbm_tpu_torch.ops.predict as OP

    X, jpf = binary
    rt = ts.PredictorRuntime(to_port(jpf), max_bucket=32, mesh_devices=4,
                             shard_policy="tp", device="cpu")
    seen, builds = [], []
    real_predict, real_build = OP.predict_forest, KP.build_node_tables

    def spy(soa, *a, **kw):
        seen.append(soa)
        KP.node_tables(soa)          # what the card's wrapper looks up
        return real_predict(soa, *a, **kw)

    def count(soa):
        builds.append(id(soa.left))
        return real_build(soa)

    monkeypatch.setattr(OP, "predict_forest", spy)
    monkeypatch.setattr(KP, "build_node_tables", count)
    for n in (3, 16, 9, 32, 1):
        rt.predict(X[:n])
    assert len(seen) == 5 * 4
    assert len({id(s.left) for s in seen}) == 4
    assert len(builds) == 4


def test_warm_covers_shard_programs(models):
    X, v1, _ = models
    rt = ts.PredictorRuntime(ts.PackedForest.load(v1), max_bucket=128,
                             mesh_devices=4, shard_policy="auto",
                             device="cpu")
    rt.warm()
    info0 = rt.cache_info()
    assert info0["shard_programs"] > 0
    # 12 trees over 4 shards: tp up to the 64-row ceiling, dp above it
    assert info0["routes_live"] == ["dp", "tp"]
    for n in (3, 64, 100, 128):
        rt.predict(X[:n])
    info1 = rt.cache_info()
    assert info1["num_compiles"] == info0["num_compiles"]
    assert info1["mesh_devices"] == 4
    snap = rt.stats.snapshot()
    assert snap["compile_cache"]["shard_programs"] == \
        info1["shard_programs"]
    assert snap["route_dispatches"].get("dp", 0) > 0
    assert snap["route_dispatches"].get("tp", 0) > 0


def _mesh_bank(**kw):
    kw.setdefault("max_bucket", 128)
    kw.setdefault("canary_rows", 4)
    kw.setdefault("mesh_devices", 4)
    kw.setdefault("shard_policy", "dp")
    return ts.ModelBank(device="cpu", **kw)


def test_bank_quantized_canary_with_mesh(models):
    _, v1, _ = models
    bank = _mesh_bank(forest_precision="int8", warm_on_deploy=True)
    rep = bank.deploy("m", v1)
    assert rep["canary"]["quant_abs_err"] <= rep["canary"][
        "quant_error_bound"]
    assert bank.runtime("m").mesh.devices == 4


def test_mesh_hot_swap_and_rollback(models, tmp_path):
    import copy

    X, v1, v2 = models
    bank = _mesh_bank(warm_on_deploy=False)
    bank.deploy("m", v1)
    t = [0.0]
    mb = bank.batcher("m", max_batch=4, max_delay_ms=5.0,
                      clock=lambda: t[0])
    singles = [ts.PredictorRuntime(ts.PackedForest.load(v), max_bucket=128,
                                   device="cpu") for v in (v1, v2)]
    pre = [mb.submit(X[i]) for i in range(3)]
    bank.deploy("m", v2)                  # swap with requests queued
    post = [mb.submit(X[i]) for i in range(3)]
    t[0] += 1.0
    mb.pump()
    mb.flush()
    got = np.array([h.result() for h in pre + post])
    want_v2 = singles[1].predict(X[:3])
    assert np.array_equal(got[3:], want_v2)
    assert all(np.array_equal(g, a) or np.array_equal(g, b)
               for g, a, b in zip(got[:3], singles[0].predict(X[:3]),
                                  want_v2))
    bad = copy.deepcopy(ts.PackedForest.load(v1))
    bad.left[0, 0] = 0                    # a cycle: rejected at ingest
    bad_path = str(tmp_path / "cycle.npz")
    bad.save(bad_path)
    with pytest.raises(ts.SwapRejected, match="ingest"):
        bank.deploy("m", bad_path)
    assert bank.version("m") == "v2"
    assert bank.rollback("m")["version"] == "v1"
    assert np.array_equal(bank.predict("m", X[:64]),
                          singles[0].predict(X[:64]))


def test_mesh_device_fault_falls_back_to_oracle(models):
    X, v1, _ = models
    bank = _mesh_bank(warm_on_deploy=False, forest_precision="int8")
    bank.deploy("m", v1)
    rt = bank.runtime("m")
    inj = ts.FaultInjector()
    inj.arm("device_predict", after=0, times=1, message="mesh boom")
    rt.faults = inj
    t = [0.0]
    mb = bank.batcher("m", max_batch=4, max_delay_ms=5.0,
                      clock=lambda: t[0])
    handles = [mb.submit(X[i]) for i in range(4)]
    mb.pump()
    mb.flush()
    got = np.array([h.result() for h in handles])
    want = rt.oracle.predict_numpy(
        rt.packed.bin_mapper.transform(np.asarray(X[:4], np.float64)),
        raw_score=False)
    assert np.allclose(got, want, atol=1e-6)
    assert mb.stats.snapshot()["fallbacks"] > 0


def _run_serve(path, cfg, lines):
    from lightgbm_tpu_torch.__main__ import _serve

    out, err = io.StringIO(), io.StringIO()
    rc = _serve(path, dict(cfg, device="cpu"), stdin=iter(lines),
                stdout=out, stderr=err)
    return rc, out.getvalue().splitlines(), err.getvalue()


def test_cli_serve_mesh_keys_and_sigterm_drain(models):
    from lightgbm_tpu_torch.__main__ import _serve

    X, v1, _ = models
    for cfg, msg in (({"mesh_devices": "3"}, "mesh_devices"),
                     ({"mesh_devices": "lots"}, "mesh_devices"),
                     ({"shard_policy": "sometimes"}, "shard_policy"),
                     ({"forest_precision": "fp4"}, "forest_precision")):
        with pytest.raises(SystemExit, match=msg):
            _serve(v1, dict(cfg, device="cpu"), stdin=iter(()),
                   stdout=io.StringIO(), stderr=io.StringIO())
    rows = [",".join(f"{x:.8g}" for x in X[i]) for i in range(3)]

    def feed():
        yield rows[0] + "\n"
        yield rows[1] + "\n"
        signal.raise_signal(signal.SIGTERM)
        yield rows[2] + "\n"

    rc, out, err = _run_serve(
        v1, {"mesh_devices": "4", "shard_policy": "dp",
             "forest_precision": "int8", "canary_rows": "4"}, feed())
    assert rc == 0
    assert len(out) == 2 and "ERROR" not in "".join(out)
    set_virtual_devices(0)
    with pytest.raises(SystemExit, match="LIGHTGBM_TPU_TORCH_VIRTUAL"):
        _serve(v1, {"mesh_devices": "2", "device": "cpu"}, stdin=iter(()),
               stdout=io.StringIO(), stderr=io.StringIO())
