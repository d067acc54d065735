"""ctypes binding of the split-iteration kernel (``csrc/split_iter.cu``, B3).

:func:`split_iter` checks its tensors, allocates the output table and aux
row, and launches one block per batch element on the current CUDA stream
without synchronising.  A launch the card refuses raises
:class:`~.build.KernelLaunchError` at once.  ``SPLIT_ITER_LAUNCHES`` counts
the calls that launched, and nothing else counts them.  It takes CUDA
tensors only: the plain PyTorch version (``split_iter_plain``) and the
dispatch on the tensor's device live in ``models/tree.py``.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from . import build
from .predict import LaunchCounter

NAME = "split_iter"
NC, AUX, SCAL = 24, 8, 16           # table columns, aux row, scalar row
MAX_BINS = 256
SMEM_LIMIT = 232_448                # opt-in dynamic shared memory per block

SPLIT_ITER_LAUNCHES = LaunchCounter()

_bind_lock = threading.Lock()
_funcs = {}


def _bound():
    with _bind_lock:
        if not _funcs:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib = build.load(NAME)
            fn = lib.split_iter_launch
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp, vp, vp]
            fn.restype = ci
            err = lib.split_iter_error_string
            err.argtypes = [ci]
            err.restype = ctypes.c_char_p
            cols = lib.split_iter_table_columns
            cols.restype = ci
            if cols() != NC:
                raise build.KernelLaunchError(
                    "split_iter: the kernel's table layout disagrees with the "
                    "binding")
            smem = lib.split_iter_smem_bytes
            smem.argtypes = [ci, ci]
            smem.restype = ctypes.c_longlong
            if smem(28, 256) != smem_bytes(28, 256):
                raise build.KernelLaunchError(
                    "split_iter: the kernel's shared-memory layout disagrees "
                    "with the binding")
            _funcs.update(launch=fn, error=err)
        return _funcs


def smem_bytes(num_features: int, num_bins: int) -> int:
    """Dynamic shared memory of one block: each (child, feature)'s sums
    before each block of 16 bins, and its totals."""
    nb = -(-num_bins // 16)
    return 4 * (2 * num_features * nb * 3 + 2 * num_features * 3)


def split_iter(hist: torch.Tensor, table: torch.Tensor, fmask: torch.Tensor,
               aux: torch.Tensor, scal: torch.Tensor):
    """Launch B3 on CUDA tensors: ``hist [E, 2, F, B, 3]``, ``table [E, cap,
    24]``, ``fmask [E, F]``, ``aux [E, 8]``, ``scal [E, 16]`` (all f32) ->
    ``(table', aux')``."""
    if hist.device.type != "cuda":
        raise ValueError(f"the split_iter kernel takes CUDA tensors, got "
                         f"{hist.device}")
    dev = hist.device
    if hist.dtype != torch.float32 or hist.dim() != 5 or hist.shape[1] != 2 \
            or hist.shape[4] != 3:
        raise TypeError(f"hist must be f32 [E, 2, F, B, 3], got {hist.dtype} "
                        f"{tuple(hist.shape)}")
    e, _, f, b, _ = hist.shape
    cap = table.shape[1] if table.dim() == 3 else -1
    for name, t, shape in (("table", table, (e, cap, NC)),
                           ("fmask", fmask, (e, f)), ("aux", aux, (e, AUX)),
                           ("scal", scal, (e, SCAL))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be f32 {shape}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, expected {dev}")
    if not 1 <= b <= MAX_BINS:
        raise ValueError(f"num_bins must lie in [1, {MAX_BINS}], got {b}")
    if max(cap, f * b) >= 1 << 24:
        raise ValueError("node ids and flat (feature, bin) indices must stay "
                         "exact in f32 (< 2**24)")
    if smem_bytes(f, b) > SMEM_LIMIT:
        raise ValueError(f"{f} features x {b} bins exceed one block's shared "
                         "memory")
    out_table = torch.empty_like(table)
    out_aux = torch.empty_like(aux)
    if e == 0:
        return out_table, out_aux
    ts = [t.contiguous() for t in (hist, table, fmask, aux, scal)]
    funcs = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = funcs["launch"](*(t.data_ptr() for t in ts), e, f, b, cap,
                              out_table.data_ptr(), out_aux.data_ptr(),
                              stream)
    if err != 0:
        msg = funcs["error"](err).decode()
        raise build.KernelLaunchError(f"split_iter launch failed: {msg} "
                                      f"(cudaError {err})")
    SPLIT_ITER_LAUNCHES.add()
    return out_table, out_aux
