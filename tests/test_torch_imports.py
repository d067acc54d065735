"""The port stands alone: ``lightgbm_tpu_torch`` and ``chip_smoke.py``
import torch and numpy, never jax and nothing of ``lightgbm_tpu``; and its
entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "lightgbm_tpu_torch")
# the card's machine has neither scikit-learn nor matplotlib
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "lightgbm_tpu", "sklearn",
             "matplotlib")
# the plotting helpers draw with matplotlib, imported inside the function
# that draws (as the reference's): importing the module needs none of it
LAZY_IMPORTS = {os.path.join(PORT, "plotting.py"): ("matplotlib",)}


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path, lazy=()):
    """The modules ``path`` imports; those named in ``lazy`` are skipped
    where a function imports them, never at module level."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    inside = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inside.update(id(n) for n in ast.walk(node) if n is not node)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if id(node) in inside and name.split(".")[0] in lazy:
                continue
            yield name


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    for mod in _imported_modules(path, LAZY_IMPORTS.get(path, ())):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.serving, "
            "lightgbm_tpu_torch.__main__, lightgbm_tpu_torch.kernels.predict, "
            "lightgbm_tpu_torch.kernels.histogram, "
            "lightgbm_tpu_torch.ops.histogram, lightgbm_tpu_torch.ops.split, "
            "lightgbm_tpu_torch.ops.sampling, lightgbm_tpu_torch.engine, "
            "lightgbm_tpu_torch.models.gbdt, lightgbm_tpu_torch.metrics, "
            "lightgbm_tpu_torch.utils.random, lightgbm_tpu_torch.callback, "
            "lightgbm_tpu_torch.models.fused, lightgbm_tpu_torch.sweep, "
            "lightgbm_tpu_torch.sweep.service, lightgbm_tpu_torch.utils.sweep, "
            "lightgbm_tpu_torch.kernels.split_iter, "
            "lightgbm_tpu_torch.utils.datasets, lightgbm_tpu_torch.utils.rdata, "
            "lightgbm_tpu_torch.training, lightgbm_tpu_torch.training.loop, "
            "lightgbm_tpu_torch.training.checkpoint, lightgbm_tpu_torch.data, "
            "lightgbm_tpu_torch.data.sketch, lightgbm_tpu_torch.faults, "
            "lightgbm_tpu_torch.sklearn, lightgbm_tpu_torch.models.tree, "
            "lightgbm_tpu_torch.models.feature_mask, "
            "lightgbm_tpu_torch.plotting, lightgbm_tpu_torch.ops.shap, "
            "lightgbm_tpu_torch.pipeline, lightgbm_tpu_torch.pipeline.daemon, "
            "lightgbm_tpu_torch.utils.profiling, lightgbm_tpu_torch.analysis, "
            "lightgbm_tpu_torch.analysis.cli, "
            "lightgbm_tpu_torch.analysis.budgets;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_default_to_the_card():
    from lightgbm_tpu_torch.device import NoDeviceError, resolve_device
    from lightgbm_tpu_torch.serving import ModelBank

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(NoDeviceError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(NoDeviceError):
        ModelBank()


@pytest.mark.parametrize("module", [
    "utils/rdata.py", "data/sketch.py", "training/checkpoint.py",
    "training/loop.py", "sklearn.py", "models/feature_mask.py",
    "models/tree.py", "utils/datasets.py"])
def test_recovery_modules_are_walked(module):
    assert os.path.join(PORT, module) in set(_sources())


def test_recovery_entry_points_default_to_the_card(tmp_path):
    from lightgbm_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        return
    data = tmp_path / "d.csv"
    data.write_text("1,0.5\n0,0.25\n")
    grid = tmp_path / "g.json"
    grid.write_text('{"rows": [{"num_leaves": 7}]}')
    with pytest.raises(SystemExit, match="task=train: .*device='cpu'"):
        main(["task=train", f"data={data}", f"checkpoint_dir={tmp_path}"])
    with pytest.raises(SystemExit, match="task=sweep: .*device='cpu'"):
        main(["task=sweep", f"data={data}", f"sweep_grid={grid}"])


def test_kernel_wrapper_refuses_cpu_tensors_and_builds_lazily():
    import lightgbm_tpu_torch.kernels.build as build
    from lightgbm_tpu_torch.kernels.predict import forest_sums

    with pytest.raises(ValueError, match="CUDA tensors"):
        forest_sums(None, torch.zeros((2, 3), dtype=torch.uint8), 0, 1, 1)
    # importing the binding compiled and loaded nothing
    assert not build._loaded
    assert build.library_path("predict_forest").name.startswith(
        "libpredict_forest-")


def test_training_entry_points_default_to_the_card(tmp_path):
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.device import NoDeviceError

    X = np.random.default_rng(0).normal(size=(300, 3))
    y = (X[:, 0] > 0).astype(float)
    ds = lgb.Dataset(X, label=y, device="cpu")
    assert ds.device.type == "cpu"
    assert lgb.Dataset(X, label=y, reference=ds).device.type == "cpu"
    booster = lgb.train({"objective": "binary", "grow_policy": "frontier",
                         "num_leaves": 4, "verbose": -1}, ds, 1)
    path = str(tmp_path / "m.txt")
    booster.save_model(path)
    if torch.cuda.is_available():
        return
    with pytest.raises(NoDeviceError):
        lgb.Dataset(X, label=y)
    with pytest.raises(NoDeviceError):
        lgb.train({"objective": "binary"}, lgb.Dataset(X, label=y), 1)
    with pytest.raises(NoDeviceError):
        lgb.Booster(model_file=path)
    with pytest.raises(NoDeviceError):
        lgb.Booster({"objective": "binary"})
    assert lgb.Booster(model_file=path, device="cpu").num_trees() == 1


def test_histogram_wrappers_refuse_cpu_tensors_and_build_lazily():
    import lightgbm_tpu_torch.kernels.build as build
    from lightgbm_tpu_torch.kernels import histogram as kh

    bins = torch.zeros((4, 2), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kh.hist_fused(bins, torch.zeros((4, 3)), torch.zeros(4, dtype=torch.int32),
                      1, 4, "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        kh.hist_partition(bins, torch.zeros((4, 3)), None, None, None, None,
                          None, 1, 4, "f32")
    assert not build._loaded
    for name in ("hist_fused", "hist_partition"):
        assert build.library_path(name).name.startswith(f"lib{name}-")
    # the launch plan: tests/test_torch_b1_b2_passes.py


def test_b3_b6_wrappers_refuse_cpu_tensors_and_build_lazily():
    import lightgbm_tpu_torch.kernels.build as build
    from lightgbm_tpu_torch.kernels import histogram as kh
    from lightgbm_tpu_torch.kernels import split_iter as ks

    with pytest.raises(ValueError, match="CUDA tensors"):
        ks.split_iter(torch.zeros((1, 2, 3, 4, 3)), None, None, None, None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kh.hist_segstats(torch.zeros((4, 2), dtype=torch.uint8),
                         torch.zeros((4, 6)), 4, "f32")
    assert not build._loaded
    assert build.library_path("split_iter").name.startswith("libsplit_iter-")
    assert "-fmad=false" in build.SOURCE_FLAGS["split_iter"]
    # B6's row chunks keep every block inside the opt-in shared memory and
    # its channel-group sets cover every channel
    for kc in (15, 240, 1080):
        rows, chunks, per_set, sets = kh.plan_segstats(45_957, 6, kc, 256,
                                                       132)
        assert kh.segstats_smem_bytes(rows) <= kh.SMEM_LIMIT
        assert per_set * sets >= -(-kc // kh.B6_LANES)
        assert rows * chunks >= 45_957
    # B3 at the strict Booster's shape holds its pairs in one chunk
    cluster, chunk = ks.plan_split_iter(1, 28, 256, 132)
    assert chunk * cluster >= 2 * 28
    assert ks.smem_bytes(256, chunk) <= ks.SMEM_LIMIT


def test_sklearn_estimators_default_to_the_card():
    import numpy as np

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.device import NoDeviceError

    X = np.random.default_rng(0).normal(size=(200, 2))
    y = X[:, 0] + 0.1 * X[:, 1]
    rf = lgb.LGBMRandomForestRegressor(n_estimators=2, max_leaf_nodes=4,
                                       device="cpu").fit(X, y)
    assert rf.predict(X[:3]).shape == (3,)
    if torch.cuda.is_available():
        return
    with pytest.raises(NoDeviceError):
        lgb.LGBMRandomForestRegressor(n_estimators=2).fit(X, y)


@pytest.mark.parametrize("module", [
    "pipeline/__init__.py", "pipeline/staleness.py", "pipeline/daemon.py",
    "utils/profiling.py", "analysis/__init__.py", "analysis/rules.py",
    "analysis/program.py", "analysis/baseline.py", "analysis/engine.py",
    "analysis/cli.py", "analysis/budgets.py"])
def test_production_loop_modules_are_walked(module):
    assert os.path.join(PORT, module) in set(_sources())


def test_production_loop_entry_points_default_to_the_card(tmp_path):
    import numpy as np

    from lightgbm_tpu_torch.__main__ import main
    from lightgbm_tpu_torch.device import NoDeviceError
    from lightgbm_tpu_torch.pipeline import ArrivalFeed, RefreshDaemon
    from lightgbm_tpu_torch.utils.profiling import profile_training

    d = RefreshDaemon({"objective": "binary"}, str(tmp_path / "cpu"),
                      feed=ArrivalFeed(), device="cpu")
    assert d.device.type == d.bank.device.type == "cpu"
    if torch.cuda.is_available():
        return
    with pytest.raises(NoDeviceError):
        RefreshDaemon({"objective": "binary"}, str(tmp_path / "card"),
                      feed=ArrivalFeed())
    X = np.zeros((8, 2))
    with pytest.raises(NoDeviceError):
        profile_training({"objective": "binary"}, X, np.zeros(8), 1)
    with pytest.raises(SystemExit, match="task=refresh: .*device='cpu'"):
        main(["task=refresh", f"watch_dir={tmp_path}",
              f"state_dir={tmp_path / 's'}"])
