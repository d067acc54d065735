"""ctypes binding of the forest-predict kernel (``csrc/predict_forest.cu``).

:func:`forest_sums` checks its tensors, allocates the output, picks how many
trees the kernel stages in shared memory at a time, and launches on the
calling thread's current CUDA stream without synchronising.  A launch the
card refuses raises :class:`~.build.KernelLaunchError` at once.
``PREDICT_FOREST_LAUNCHES`` counts the launches, and nothing else counts
them.

A block stages its rows' codes (``[128, F]`` uint8) in shared memory only
while that tile fits ``STAGED_CODES_LIMIT`` bytes (F <= 256); wider rows
are read from global memory, so the column count is not limited.  What must
fit a block's shared memory is one tree's node tables: about 11,400 node
slots at f32 (5,700 leaves), 25,000 at bf16, 28,000 at int8; a bigger tree
raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import build

KERNEL = "predict_forest"
ROWS_PER_BLOCK = 128                 # kRows in the source
STAGED_CODES_LIMIT = 32 * 1024       # kStagedCodesLimit in the source
SMEM_TARGET = 96 * 1024              # bytes a block stages per tree chunk
SMEM_LIMIT = 232_448                 # opt-in dynamic shared memory per block
MAX_TREE_CHUNK = 64

# (split_feature / left / right, split_bin, leaf) dtypes the kernel takes,
# and their sizes in bytes
DTYPES = {"f32": (torch.int32, torch.int32, torch.float32),
          "bf16": (torch.int16, torch.uint8, torch.bfloat16),
          "int8": (torch.int16, torch.uint8, torch.int8)}
_SIZES = {"f32": (4, 4, 4), "bf16": (2, 1, 2), "int8": (2, 1, 1)}


class LaunchCounter:
    """Kernel launches since the last :meth:`reset` (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def add(self, k: int = 1) -> None:
        with self._lock:
            self.count += k

    def reset(self) -> None:
        with self._lock:
            self.count = 0


PREDICT_FOREST_LAUNCHES = LaunchCounter()

_bind_lock = threading.Lock()
_funcs = {}


def _bound():
    """The library's entry points with their ctypes signatures."""
    with _bind_lock:
        if not _funcs:
            lib = build.load(KERNEL)
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for prec in DTYPES:
                fn = getattr(lib, f"predict_forest_{prec}")
                fn.argtypes = [vp, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci,
                               ci, ci, ci, vp, vp]
                fn.restype = ci
                _funcs[prec] = fn
            err = lib.predict_forest_error_string
            err.argtypes = [ci]
            err.restype = ctypes.c_char_p
            _funcs["error_string"] = err
            rows = lib.predict_forest_rows_per_block
            rows.restype = ci
            limit = lib.predict_forest_staged_codes_limit
            limit.restype = ci
            if (rows() != ROWS_PER_BLOCK
                    or limit() != STAGED_CODES_LIMIT):
                raise build.KernelLaunchError(
                    "the kernel's rows per block or staged-code limit "
                    "disagree with the binding")
        return _funcs


def _align16(x: int) -> int:
    return (x + 15) & ~15


def stages_codes(num_features: int) -> bool:
    """Whether a block stages its rows' codes in shared memory
    (``stages_codes`` in the source)."""
    return ROWS_PER_BLOCK * num_features <= STAGED_CODES_LIMIT


def smem_bytes(precision: str, num_features: int, tc: int, mp: int) -> int:
    """Dynamic shared memory of one block (``Layout::total`` in the
    source)."""
    idx, thr, leaf = _SIZES[precision]
    nodes = tc * mp
    codes = (_align16(ROWS_PER_BLOCK * num_features)
             if stages_codes(num_features) else 0)
    return (codes + _align16(4 * tc)
            + 3 * _align16(nodes * idx) + _align16(nodes * leaf)
            + _align16(nodes * thr))


@functools.lru_cache(maxsize=256)
def tree_chunk(precision: str, num_features: int, mp: int,
               window: int) -> int:
    """Trees staged per chunk: as many as fit ``SMEM_TARGET`` (at least
    one, at most the window)."""
    if smem_bytes(precision, num_features, 1, mp) > SMEM_LIMIT:
        raise ValueError(
            f"one tree of {mp} node slots at {precision} needs more shared "
            f"memory than a block has ({SMEM_LIMIT} bytes)")
    tc = 1
    while (tc < min(window, MAX_TREE_CHUNK)
           and smem_bytes(precision, num_features, tc + 1, mp)
           <= SMEM_TARGET):
        tc += 1
    return tc


def _check(soa, bins: torch.Tensor) -> str:
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise TypeError(f"bins must be a uint8 [n, F] tensor, got "
                        f"{bins.dtype} {tuple(bins.shape)}")
    prec = soa.precision
    idx_t, thr_t, leaf_t = DTYPES[prec]
    want = {"split_feature": idx_t, "split_bin": thr_t, "left": idx_t,
            "right": idx_t, "leaf": leaf_t}
    shape = tuple(soa.split_feature.shape)
    for name, dtype in want.items():
        t = getattr(soa, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"ForestSoA.{name} must be {dtype} {shape} at "
                            f"{prec}, got {t.dtype} {tuple(t.shape)}")
    if soa.scale.dtype != torch.float32 or tuple(soa.scale.shape) != (
            shape[0],):
        raise TypeError("ForestSoA.scale must be float32 [Tp]")
    for t in (bins, soa.split_feature, soa.split_bin, soa.left, soa.right,
              soa.leaf, soa.scale):
        if t.device != bins.device:
            raise ValueError(f"bins on {bins.device} but a ForestSoA table "
                             f"on {t.device}")
    return prec


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernel stages the
    tables with 16-byte asynchronous copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def forest_sums(soa, bins: torch.Tensor, t0: int, t1: int,
                depth_cap: int) -> torch.Tensor:
    """Launch the kernel: f32 ``[n]`` sums of ``leaf * scale`` over trees
    ``[t0, t1)`` for the uint8 bins ``[n, F]`` on a CUDA device."""
    if bins.device.type != "cuda":
        raise ValueError(f"the predict_forest kernel takes CUDA tensors, got "
                         f"{bins.device}")
    prec = _check(soa, bins)
    n, f = bins.shape
    tp, mp = soa.split_feature.shape
    out = torch.empty(n, dtype=torch.float32, device=bins.device)
    if n == 0:
        return out
    tc = tree_chunk(prec, f, mp, max(t1 - t0, 1))
    tables = [_aligned(t) for t in (soa.split_feature, soa.split_bin,
                                    soa.left, soa.right, soa.leaf,
                                    soa.scale)]
    bins = bins.contiguous()
    funcs = _bound()
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = funcs[prec](bins.data_ptr(), n, f,
                          tables[0].data_ptr(), tables[1].data_ptr(),
                          tables[2].data_ptr(), tables[3].data_ptr(),
                          tables[4].data_ptr(), tables[5].data_ptr(),
                          mp, int(t0), int(t1), int(depth_cap), tc,
                          out.data_ptr(), stream)
    if err != 0:
        msg = funcs["error_string"](err).decode()
        raise build.KernelLaunchError(
            f"predict_forest_{prec} launch failed: {msg} (cudaError {err})")
    PREDICT_FOREST_LAUNCHES.add()
    return out
