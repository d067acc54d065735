"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/kernels/lib<name>-<digest>.so`` at the root of the checkout, where
``<digest>`` hashes the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source rebuilds
and an unchanged one is reused.  The sources have a plain C interface and
include no PyTorch header, so a build takes seconds.  :func:`build` starts
one nvcc per missing library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# per-source flags: the split iteration and the int8 quantization must
# round as their plain versions do, so nvcc may not contract a multiply and
# an add into an FMA
SOURCE_FLAGS = {"split_iter": ("-fmad=false",),
                "hist_fused_int8": ("-fmad=false",)}

# nvcc's report (ptxas registers, shared memory, spills) per library built
# by this process
BUILD_LOG: Dict[str, str] = {}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, bind or launch.

    This is a defect of the program or the card, not a transient fault of
    one request: serving code lets it propagate instead of answering on the
    host."""


class KernelBuildError(KernelError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(KernelError):
    """The card refused a launch (the C entry point's ``cudaGetLastError``
    was not 0), or a library disagrees with its binding."""


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                  else []) + [shutil.which("nvcc") or "",
                              "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH)")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers are hashed too, so editing one rebuilds its users
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        src += header.read_bytes()
    flags = NVCC_FLAGS + SOURCE_FLAGS.get(name, ())
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, one nvcc per
    source, all started together.  Returns the wall seconds per library
    built (0.0 for one already there)."""
    todo = {}
    for name in names:
        out = library_path(name)
        if not out.exists():
            todo[name] = out
    seconds = {name: 0.0 for name in names}
    if not todo:
        return seconds
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)       # atomic against a concurrent build
    if failed:
        raise KernelBuildError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
