"""ctypes binding of the forest-predict kernel (``csrc/predict_forest.cu``).

:func:`forest_sums` checks its tensors, takes the kernel's node tables of
the ``ForestSoA`` (:func:`node_tables`: built on the first launch over it
and cached beside it), plans the launch (:func:`plan`) and launches on the
calling thread's current CUDA stream without synchronising.  A launch the
card refuses raises :class:`~.build.KernelLaunchError` at once.
``PREDICT_FOREST_LAUNCHES`` counts the launches, and nothing else counts
them.

The node tables are the kernel's own, never part of the ``ForestSoA`` the
reference packs: one 8-byte record per slot (a leaf's value, or left
child, right child, threshold and split feature; see
:func:`build_node_tables`) and the slot's ``leaf * scale`` in f32, 12
bytes a slot at every precision.  :func:`records_leaf_nodes` and
:func:`records_sums_plain` walk them in plain PyTorch, for the CPU tests.
A tree of any size walks: a block stages the top of its trees in shared
memory and reads deeper slots through L2.  The records hold trees of up to
``MAX_SLOTS`` slots (LightGBM's 131,072 leaves) and split features below
``FEATURE_NONE``.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from . import build

KERNEL = "predict_forest"
# constants of the source, checked against the library when it binds
MAX_CLUSTER = 8                      # kMaxCluster: blocks of a cluster
MAX_THREADS = 512                    # kMaxThreads: threads of a block
STAGED_CODES_LIMIT = 32 * 1024       # kStagedCodesLimit: a staged code tile
SMEM_LIMIT = 232_448                 # kSmemLimit: opt-in shared memory
SLOT_BITS = 18                       # kSlotBits: a child index
THR_SHIFT, FEAT_SHIFT = 36, 44       # kThrShift, kFeatShift
FEATURE_NONE = (1 << 19) - 1         # kFeatNone: a feature outside [0, F)
MAX_SLOTS = 1 << SLOT_BITS
LEAF_FLAG = 1 << 63                  # a leaf's record: flag | f32 value bits
# the plan's choices (measured in turns on an H100, PERF.md section 6)
TARGET_BLOCKS = 528                  # four blocks on each of 132 SMs
MIN_ROWS = 4                         # rows of a tile at least (or n)
MAX_ROWS = 512                       # rows of a tile at most
VALUE_BYTES = 16 * 1024              # a block's walk values of one round
RECORD_BYTES = 32 * 1024             # a block's staged records


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
            vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn = lib.predict_forest_launch
            fn.argtypes = [vp, ll, ci, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                           ci, ci, ci, vp, vp]
            fn.restype = ci
            err = lib.predict_forest_error_string
            err.argtypes = [ci]
            err.restype = ctypes.c_char_p
            smem = lib.predict_forest_smem_bytes
            smem.argtypes = [ci] * 6
            smem.restype = ll
            const = lib.predict_forest_constant
            const.argtypes = [ci]
            const.restype = ci
            want = (MAX_CLUSTER, MAX_THREADS, STAGED_CODES_LIMIT, SMEM_LIMIT,
                    SLOT_BITS, THR_SHIFT, FEAT_SHIFT, FEATURE_NONE)
            shapes = ((224, 28, 13, 256, 1, 8), (1, 2000, 13, 0, 0, 8),
                      (160, 28, 1, 640, 1, 3))
            if (tuple(const(i) for i in range(len(want))) != want
                    or any(smem(*s) != smem_bytes(*s) for s in shapes)):
                raise build.KernelLaunchError(
                    "the predict_forest library's constants or shared-"
                    "memory layout disagree with the binding")
            _funcs.update(launch=fn, error_string=err)
        return _funcs


def _align16(x: int) -> int:
    return (x + 15) & ~15


def smem_bytes(rows: int, num_features: int, trees: int, prefix: int,
               staged_codes, cluster: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes`` in the source):
    the staged codes, the round's values of the rows it owns, the staged
    records and an mbarrier."""
    codes = _align16(rows * num_features) if staged_codes else 0
    per = -(-rows // cluster)
    return (codes + _align16(4 * cluster * trees * per)
            + _align16(8 * trees * prefix) + 16)


class LaunchPlan(NamedTuple):
    """One launch: ``tiles`` row tiles of ``rows`` rows, each a cluster of
    ``cluster`` blocks of ``threads`` threads; in round k block q walks
    every row of its tile through trees ``t0 + (k * cluster + q) * trees``
    onwards (:func:`plan_trees`)."""

    route: str          # "staged": record prefixes in shared memory; "l2"
    rows: int
    tiles: int
    cluster: int
    trees: int          # trees of a block in one round
    rounds: int
    prefix: int         # record slots staged per tree (0 on the l2 route)
    staged_codes: bool  # the tile's codes in shared memory
    threads: int
    smem: int


@functools.lru_cache(maxsize=1024)
def plan(num_features: int, mp: int, window: int, n: int) -> LaunchPlan:
    """The launch for ``n`` rows of ``num_features`` codes over ``window``
    trees of ``mp`` node slots.

    Clusters of up to eight blocks split the window; tiles hold as many
    rows as keep about ``TARGET_BLOCKS`` blocks in the grid (at least
    ``MIN_ROWS``); a block's trees per round are as many as its walk values
    fit ``VALUE_BYTES`` (more rounds otherwise, so any window fits); the
    top ``prefix`` slots of each of its trees are staged within
    ``RECORD_BYTES`` (the slots are depth-major; whole trees where they
    fit), and walks read any deeper slot through L2."""
    if n < 1 or num_features < 1 or mp < 1 or window < 0:
        raise ValueError(f"no launch for n={n}, F={num_features}, mp={mp}, "
                         f"window={window}")
    per_block = max(1, -(-window // MAX_CLUSTER))
    cluster = max(1, -(-window // per_block))        # no rank left idle
    rows = max(min(MIN_ROWS, n), min(MAX_ROWS, n, n * cluster // TARGET_BLOCKS,
                                     cluster * MAX_THREADS))
    if rows >= 32:
        rows -= rows % 32
    trees = max(1, min(per_block, VALUE_BYTES // (4 * rows)))
    rounds = -(-window // (cluster * trees))
    prefix = 0
    if mp % 2 == 0:                      # 16-byte bulk copies
        prefix = min(mp, RECORD_BYTES // (8 * trees) // 2 * 2)
    staged_codes = rows * num_features <= STAGED_CODES_LIMIT
    walks = rows * min(trees, window) if window else 0
    threads = min(MAX_THREADS, max(32, -(-max(walks, -(-rows // cluster))
                                        // 32) * 32))
    return LaunchPlan(
        route="staged" if prefix else "l2", rows=rows, tiles=-(-n // rows),
        cluster=cluster, trees=trees, rounds=rounds, prefix=prefix,
        staged_codes=staged_codes, threads=threads,
        smem=smem_bytes(rows, num_features, trees, prefix, staged_codes,
                        cluster))


def plan_trees(p: LaunchPlan, t0: int, t1: int):
    """``(round, rank, first tree, trees)`` of every block of a cluster
    that walks trees, in the order a row's owner adds their values: the
    window's trees, each once, in tree order."""
    out = []
    for k in range(p.rounds):
        for q in range(p.cluster):
            first = t0 + (k * p.cluster + q) * p.trees
            count = max(0, min(p.trees, t1 - first))
            if count:
                out.append((k, q, first, count))
    return out


# ---------------------------------------------------------------------------
# the kernel's node tables
# ---------------------------------------------------------------------------
def build_node_tables(soa):
    """``(records, leaf_values)`` of a ``ForestSoA``, ``[Tp, Mp]`` int64
    and f32 on the tables' device.

    Leaf values are ``leaf * scale``, multiplied as
    :func:`forest_sums_plain` multiplies them.  A slot the walk never
    leaves (a leaf or a dead slot: both children itself) is a leaf record,
    ``LEAF_FLAG`` and its leaf value's bits.  Any other record packs left
    child, right child, threshold and split feature (the fields' shifts
    above); a threshold below 0 is stored as 255 with the right child in
    both child fields, one at or above 255 as 255, and a feature below 0
    as ``FEATURE_NONE``, so that ``code <= threshold`` on a uint8 code
    decides as the SoA's int32 compare does."""
    feat = soa.split_feature.cpu().numpy().astype(np.int64)
    thr = soa.split_bin.cpu().numpy().astype(np.int64)
    left = soa.left.cpu().numpy().astype(np.int64)
    right = soa.right.cpu().numpy().astype(np.int64)
    mp = feat.shape[1]
    if mp > MAX_SLOTS:
        raise ValueError(f"trees of {mp} node slots exceed the kernel's "
                         f"records ({MAX_SLOTS} slots)")
    for name, child in (("left", left), ("right", right)):
        if ((child < 0) | (child >= mp)).any():
            raise ValueError(f"ForestSoA.{name} holds a child outside "
                             f"[0, {mp})")
    if (feat >= FEATURE_NONE).any():
        raise ValueError(f"a split feature of {int(feat.max())} exceeds "
                         f"the kernel's records (< {FEATURE_NONE})")
    leafv = (soa.leaf.to(torch.float32) * soa.scale[:, None]).contiguous()
    never_left = thr < 0
    eff_left = np.where(never_left, right, left)
    th = np.where(never_left | (thr >= 255), 255, thr)
    slot = np.arange(mp)
    leaf = (eff_left == slot) & ((th == 255) | (right == slot))
    fe = np.where(feat < 0, FEATURE_NONE, feat)
    u = np.uint64
    rec = (eff_left.astype(u) | (right.astype(u) << u(SLOT_BITS))
           | (th.astype(u) << u(THR_SHIFT)) | (fe.astype(u) << u(FEAT_SHIFT)))
    bits = leafv.cpu().numpy().view(np.uint32).astype(u)
    rec = np.where(leaf, u(LEAF_FLAG) | bits, rec)
    records = torch.from_numpy(rec.view(np.int64)).to(soa.leaf.device)
    return records.contiguous(), leafv


_tables_lock = threading.Lock()
_tables = {}        # id(soa.left) -> (a weak ref to it, the SoA's other
#                     five tensors, the six versions, the node tables)


def node_tables(soa):
    """The cached :func:`build_node_tables` of ``soa``: built once per
    ``ForestSoA`` (rebuilt if one of its tensors was replaced or changed in
    place), and dropped when its ``left`` table is.  A hit takes no lock
    (it runs before every launch)."""
    left, rest = soa.left, (soa.split_feature, soa.split_bin, soa.right,
                            soa.leaf, soa.scale)
    versions = (left._version, rest[0]._version, rest[1]._version,
                rest[2]._version, rest[3]._version, rest[4]._version)
    key = id(left)
    hit = _tables.get(key)
    if (hit is not None and hit[0]() is left and hit[2] == versions
            and all(a is b for a, b in zip(hit[1], rest))):
        return hit[3]
    with _tables_lock:
        tables = build_node_tables(soa)
        if key not in _tables:
            weakref.finalize(left, _tables.pop, key, None)
        _tables[key] = (weakref.ref(left), rest, versions, tables)
        return tables


def records_leaf_nodes(records: torch.Tensor, bins: torch.Tensor, t0: int,
                       t1: int, depth_cap: int) -> torch.Tensor:
    """Slot each row reaches in trees ``[t0, t1)`` after at most
    ``depth_cap`` steps over the node records, ``[t1 - t0, n]`` int64: the
    kernel's walk in plain PyTorch (equal to ``forest_leaf_nodes``)."""
    n, f = bins.shape
    rec = records[t0:t1]
    mask = (1 << SLOT_BITS) - 1
    leaf = rec < 0                                         # LEAF_FLAG
    feat = (rec >> FEAT_SHIFT) & FEATURE_NONE
    thr = (rec >> THR_SHIFT) & 0xFF
    left, right = rec & mask, (rec >> SLOT_BITS) & mask
    bins_t = bins.to(torch.int64).t()                      # [F, n]
    node = torch.zeros((t1 - t0, n), dtype=torch.int64, device=bins.device)
    for _ in range(int(depth_cap)):
        fi = feat.gather(1, node)
        ok = fi < min(f, FEATURE_NONE)
        code = torch.where(ok, bins_t.gather(0, fi.clamp(0, f - 1)), 0)
        nxt = torch.where(code <= thr.gather(1, node),
                          left.gather(1, node), right.gather(1, node))
        node = torch.where(leaf.gather(1, node), node, nxt)
    return node


def records_sums_plain(records: torch.Tensor, leaf_values: torch.Tensor,
                       bins: torch.Tensor, t0: int, t1: int,
                       depth_cap: int) -> torch.Tensor:
    """The kernel's f32 ``[n]`` sums over the node tables in plain PyTorch:
    each walk's ``leaf * scale``, added in tree order."""
    acc = torch.zeros(bins.shape[0], dtype=torch.float32,
                      device=bins.device)
    if t1 <= t0 or bins.shape[0] == 0:
        return acc
    node = records_leaf_nodes(records, bins, t0, t1, depth_cap)
    vals = leaf_values[t0:t1].gather(1, node)
    for v in vals:
        acc = acc + v
    return acc


# ---------------------------------------------------------------------------
# the launch
# ---------------------------------------------------------------------------
def _check(soa, bins: torch.Tensor) -> None:
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise TypeError(f"bins must be a uint8 [n, F] tensor, got "
                        f"{bins.dtype} {tuple(bins.shape)}")
    shape = tuple(soa.split_feature.shape)
    for name in ("split_bin", "left", "right", "leaf"):
        if tuple(getattr(soa, name).shape) != shape:
            raise TypeError(f"ForestSoA.{name} must be {shape}, got "
                            f"{tuple(getattr(soa, name).shape)}")
    if soa.scale.dtype != torch.float32 or tuple(soa.scale.shape) != (
            shape[0],):
        raise TypeError("ForestSoA.scale must be float32 [Tp]")
    for t in (soa.split_feature, soa.split_bin, soa.left, soa.right,
              soa.leaf, soa.scale):
        if t.device != bins.device:
            raise ValueError(f"bins on {bins.device} but a ForestSoA table "
                             f"on {t.device}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, starting on a 16-byte boundary (the kernel copies codes
    16 bytes at a time and records by bulk copies)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def forest_sums(soa, bins: torch.Tensor, t0: int, t1: int,
                depth_cap: int) -> torch.Tensor:
    """Launch the kernel: f32 ``[n]`` sums of ``leaf * scale`` over trees
    ``[t0, t1)`` for the uint8 bins ``[n, F]`` on a CUDA device."""
    if bins.device.type != "cuda":
        raise ValueError(f"the predict_forest kernel takes CUDA tensors, got "
                         f"{bins.device}")
    _check(soa, bins)
    n, f = bins.shape
    tp, mp = soa.split_feature.shape
    t0, t1 = int(t0), int(t1)
    if not 0 <= t0 <= t1 <= tp:
        raise ValueError(f"tree window [{t0}, {t1}) outside [0, {tp}]")
    out = torch.empty(n, dtype=torch.float32, device=bins.device)
    if n == 0:
        return out
    records, leafv = node_tables(soa)
    p = plan(f, mp, t1 - t0, n)
    bins = _aligned(bins)
    funcs = _bound()
    with torch.cuda.device(bins.device):
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = funcs["launch"](bins.data_ptr(), n, f, records.data_ptr(),
                              leafv.data_ptr(), mp, t0, t1, int(depth_cap),
                              p.rows, p.cluster, p.trees, p.prefix,
                              int(p.staged_codes), p.threads,
                              out.data_ptr(), stream)
    if err != 0:
        msg = funcs["error_string"](err).decode()
        raise build.KernelLaunchError(
            f"predict_forest launch failed: {msg} (cudaError {err})")
    PREDICT_FOREST_LAUNCHES.add()
    return out
