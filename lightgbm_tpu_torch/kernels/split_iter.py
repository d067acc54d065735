"""ctypes binding of the split-iteration kernel (``csrc/split_iter.cu``, B3).

:func:`split_iter` checks its tensors, allocates the aux row, and launches
one thread block cluster per batch element (:func:`plan_split_iter` sizes
it) on the current CUDA stream without synchronising.  The kernel writes
the three changed rows into the node table IN PLACE and returns that same
tensor: its one caller, the strict grower (``models/tree.py``
``grow_tree_strict``), drops the old table at once; a caller that keeps it
passes a clone.  A launch the card refuses raises
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
MAX_CLUSTER = 8                     # kMaxCluster: blocks of one element
SMEM_LIMIT = 232_448                # opt-in dynamic shared memory per block
# a block's (child, feature) pairs in shared memory at once: at most what
# lets two blocks share an SM
CHUNK_SMEM = 112 * 1024

SPLIT_ITER_LAUNCHES = LaunchCounter()

_bind_lock = threading.Lock()
_funcs = {}


def _bound():
    with _bind_lock:
        if not _funcs:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib = build.load(NAME)
            fn = lib.split_iter_launch
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
                           vp]
            fn.restype = ci
            err = lib.split_iter_error_string
            err.argtypes = [ci]
            err.restype = ctypes.c_char_p
            cols = lib.split_iter_table_columns
            cols.restype = ci
            most = lib.split_iter_max_cluster
            most.restype = ci
            if cols() != NC or most() != MAX_CLUSTER:
                raise build.KernelLaunchError(
                    "split_iter: the kernel's table layout disagrees with the "
                    "binding")
            smem = lib.split_iter_smem_bytes
            smem.argtypes = [ci, ci]
            smem.restype = ctypes.c_longlong
            if smem(256, 7) != smem_bytes(256, 7):
                raise build.KernelLaunchError(
                    "split_iter: the kernel's shared-memory layout disagrees "
                    "with the binding")
            _funcs.update(launch=fn, error=err)
        return _funcs


def smem_bytes(num_bins: int, chunk: int) -> int:
    """Dynamic shared memory of one block holding ``chunk`` (child,
    feature) pairs: their running sums, the sums before each block of 16
    bins, their totals and parent objectives."""
    nb = -(-num_bins // 16)
    return 4 * chunk * (3 * num_bins + 3 * nb + 3 + 1)


def plan_split_iter(e: int, num_features: int, num_bins: int,
                    sm_count: int):
    """``(cluster, chunk)`` of a B3 launch: blocks per element, and the
    (child, feature) pairs a block holds in shared memory at once.

    A batch of fewer elements than SMs spreads each element over a cluster
    of up to ``MAX_CLUSTER`` blocks (a divisor of its ``2F`` pairs, so that
    no block idles), about one block per SM in all; a block's share of the
    pairs goes through shared memory in chunks of at most ``CHUNK_SMEM``
    bytes (one chunk at the shapes the port trains: F = 6 or 28, B = 256).
    """
    pairs = 2 * num_features
    target = max(1, min(MAX_CLUSTER, pairs, -(-sm_count // max(e, 1))))
    cluster = max(c for c in range(1, target + 1) if pairs % c == 0)
    per = -(-pairs // cluster)
    chunk = max(1, min(per, CHUNK_SMEM // smem_bytes(num_bins, 1)))
    return cluster, chunk


def split_iter(hist: torch.Tensor, table: torch.Tensor, fmask: torch.Tensor,
               aux: torch.Tensor, scal: torch.Tensor):
    """Launch B3 on CUDA tensors: ``hist [E, 2, F, B, 3]``, ``table [E, cap,
    24]`` (contiguous; updated in place), ``fmask [E, F]``, ``aux [E, 8]``,
    ``scal [E, 16]`` (all f32) -> ``(table, aux')``."""
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
    if not table.is_contiguous():
        raise ValueError("table must be contiguous: the kernel updates it in "
                         "place")
    if not 1 <= b <= MAX_BINS:
        raise ValueError(f"num_bins must lie in [1, {MAX_BINS}], got {b}")
    if max(cap, f * b) >= 1 << 24:
        raise ValueError("node ids and flat (feature, bin) indices must stay "
                         "exact in f32 (< 2**24)")
    out_aux = torch.empty_like(aux)
    if e == 0:
        return table, out_aux
    cluster, chunk = plan_split_iter(e, f, b, _sm_count(dev))
    hist, fmask, aux, scal = (t.contiguous() for t in (hist, fmask, aux,
                                                        scal))
    funcs = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = funcs["launch"](hist.data_ptr(), table.data_ptr(),
                              fmask.data_ptr(), aux.data_ptr(),
                              scal.data_ptr(), e, f, b, cap, cluster, chunk,
                              out_aux.data_ptr(), stream)
    if err != 0:
        msg = funcs["error"](err).decode()
        raise build.KernelLaunchError(f"split_iter launch failed: {msg} "
                                      f"(cudaError {err})")
    SPLIT_ITER_LAUNCHES.add()
    return table, out_aux


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
