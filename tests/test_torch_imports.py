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
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "lightgbm_tpu")


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


def test_import_leaves_jax_and_reference_out():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.serving, "
            "lightgbm_tpu_torch.__main__, lightgbm_tpu_torch.kernels.predict;"
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


def test_kernel_wrapper_refuses_cpu_tensors_and_builds_lazily():
    import lightgbm_tpu_torch.kernels.build as build
    from lightgbm_tpu_torch.kernels.predict import forest_sums

    with pytest.raises(ValueError, match="CUDA tensors"):
        forest_sums(None, torch.zeros((2, 3), dtype=torch.uint8), 0, 1, 1)
    # importing the binding compiled and loaded nothing
    assert not build._loaded
    assert build.library_path("predict_forest").name.startswith(
        "libpredict_forest-")
