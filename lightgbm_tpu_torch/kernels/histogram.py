"""ctypes bindings of the histogram kernels (``csrc/hist_fused.cu``, B1,
``csrc/hist_fused_int8.cu``, B1's int8 mode, ``csrc/hist_partition.cu``,
B2, ``csrc/hist_segstats.cu``, B6, and ``csrc/hist_fused_batched.cu``, B5).

:func:`hist_fused`, :func:`hist_partition`, :func:`hist_segstats` and
:func:`hist_fused_batched` check their tensors, plan the launch, allocate
the outputs and the scratch (row lists, work items, partials), and launch
on the current CUDA stream without synchronising.  A launch the card
refuses raises :class:`~.build.KernelLaunchError` at once.  ``HIST_FUSED_LAUNCHES``,
``HIST_PARTITION_LAUNCHES``, ``HIST_SEGSTATS_LAUNCHES`` and
``HIST_FUSED_BATCHED_LAUNCHES`` count the calls that launched, per mode
(``"f32"`` and ``"bf16"``; B1 also ``"int8"``), and nothing else counts
them.  They take CUDA tensors only: the plain PyTorch versions and the
dispatch on the tensor's device live in ``ops/histogram.py``.

B1 in int8 mode (:func:`hist_fused` with ``mode="int8"``) launches the
int8 library's passes (the channel maxima in one pass; for more than one
segment a count, a scan into work items and a scatter of the rows by
segment; an int32 shared histogram per (item, feature group) with the
statistics quantized in registers; the rescale; :func:`plan_int8` sizes
them, :func:`int8_passes_plain` repeats them in PyTorch).  More than
``INT8_ACC_ROW_LIMIT`` rows raise ``ValueError`` before any launch.

Sizing (B1 f32/bf16, B2): a block owns one work item and one feature
group, a warp per feature, as many features as let the block's f64
histogram ``[fg, B, S]`` and its two-stage ring of row tiles fit its
shared memory (28 at the north star: one group, one block per SM);
:func:`plan_rows` sizes the work items so that a call makes about one
round of resident blocks (a root's row ranges on the host; for more
segments the least size, the device sizing the items from the rows its
count finds), and :func:`rows_passes_plain` repeats the passes in PyTorch
for the CPU tests.  More than ``ROWS_MAX_SEGMENTS`` segments or
``ROWS_MAX_S`` statistics raise ``ValueError`` before any launch.  B5
partitions each element's rows by segment and gives a block one work item
(at most ``R`` positions of one segment) and a feature group
(:func:`plan_batched`); B6 gives a block a row chunk, a feature and a set of
32-channel groups (:func:`plan_segstats`).  :func:`batched_passes_plain` and
:func:`segstats_passes_plain` repeat B5's and B6's passes in PyTorch, in
the kernels' order, for the CPU tests.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from . import build
from .predict import LaunchCounter

FUSED, PARTITION, SEGSTATS = "hist_fused", "hist_partition", "hist_segstats"
BATCHED, INT8 = "hist_fused_batched", "hist_fused_int8"
INT8_THREADS = 512                  # kThreads in csrc/hist_fused_int8.cu
INT8_MAX_CHANNELS = 8               # kMaxS: statistics quantized in registers
# a block's shared histogram is zeroed and flushed once per work item:
# items hold at least this many rows per bin of it
INT8_ROWS_PER_CELL = 4
INT8_BLOCKS_PER_SM = 4              # int8 histogram blocks an SM holds
INT8_ROOT_BLOCKS_PER_SM = 2         # the same for one-segment calls
INT8_PART_ROWS = 4096               # rows a count/scatter block takes
# the count and scatter passes keep two i32 counters per segment in shared
# memory
INT8_MAX_SEGMENTS = 29_056
# B1 (f32/bf16) and B2: csrc/hist_rows.cuh and csrc/row_partition.cuh
ROWS_TILE = 256                     # kTile: rows per ring stage
ROWS_PART = 1024                    # kPartRows: rows a partition warp takes
ROWS_MAX_WARPS = 32                 # kMaxWarps: features per block
ROWS_MAX_S = 8                      # kMaxS: statistics summed in registers
WARPS, MAX_BINS = 8, 256            # B6's kWarps, kMaxBins
SMEM_LIMIT = 232_448                # opt-in dynamic shared memory per block
SMEM_PER_SM = 233_472               # shared memory of one SM (228 KB)
# the partition keeps one i32 counter per (warp, segment) in shared memory
ROWS_MAX_SEGMENTS = SMEM_LIMIT // (4 * 8)     # 7,264
BLOCKS_PER_SM = 8                   # blocks a launch aims to give each SM
B5_TILE = 512                       # kTile in csrc/hist_fused_batched.cu
B5_PART_ROWS = 1024                 # kPartRows: rows a partition warp takes
B5_WARPS = 8                        # kWarps: a B5 block's warps (features)
B6_LANES = 32                       # channels per group (hist_segstats.cu)
B6_CHUNK_ROWS = (8192, 4096, 2048, 1024, 512)  # row chunks a B6 block
                                    # sorts, largest first (kMaxChunkRows)

MODES = ("f32", "bf16")
HIST_FUSED_LAUNCHES = {m: LaunchCounter() for m in MODES + ("int8",)}
HIST_PARTITION_LAUNCHES = {m: LaunchCounter() for m in MODES}
HIST_SEGSTATS_LAUNCHES = {m: LaunchCounter() for m in MODES}
HIST_FUSED_BATCHED_LAUNCHES = {m: LaunchCounter() for m in MODES}

_bind_lock = threading.Lock()
_funcs = {}


def _bound():
    with _bind_lock:
        if not _funcs:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib = build.load(FUSED)
            ll = ctypes.c_longlong
            fn = lib.hist_fused_launch
            fn.argtypes = [vp, ll, ci, vp, ci, vp, ci, ci, ci, ci, ci, ci,
                           ci, ci] + [vp] * 9
            fn.restype = ci
            _funcs[FUSED] = fn
            lib_p = build.load(PARTITION)
            fn = lib_p.hist_partition_launch
            fn.argtypes = [vp, ci, ci, vp, vp, vp, ci, vp, vp, vp, ci, ci,
                           ci, ci, ci, ci, ci, ci] + [vp] * 11
            fn.restype = ci
            _funcs[PARTITION] = fn
            lib_s = build.load(SEGSTATS)
            fn = lib_s.hist_segstats_launch
            fn.argtypes = [vp, ci, ci, vp, ci, ci, ci, ci, ci, ci, ci, vp, vp,
                           vp]
            fn.restype = ci
            _funcs[SEGSTATS] = fn
            lib_b = build.load(BATCHED)
            fn = lib_b.hist_fused_batched_launch
            fn.argtypes = [vp, ci, ci, vp, ci, vp, ci, ci, ci, ci, ci, ci,
                           ci, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
            fn.restype = ci
            _funcs[BATCHED] = fn
            lib_i = build.load(INT8)
            fn = lib_i.hist_fused_int8_launch
            fn.argtypes = [vp, ll, ci, vp, ci, vp, ci, ci, ci, ci, ci, ci,
                           ci, vp, vp, vp, vp, vp, vp, vp, vp, vp]
            fn.restype = ci
            _funcs[INT8] = fn
            err = lib_i.hist_fused_int8_error_string
            err.argtypes = [ci]
            err.restype = ctypes.c_char_p
            _funcs[INT8 + "_error"] = err
            threads = lib_i.hist_fused_int8_threads
            threads.restype = ci
            chans = lib_i.hist_fused_int8_max_channels
            chans.restype = ci
            smem = lib_i.hist_fused_int8_smem_bytes
            smem.argtypes = [ci, ci, ci]
            smem.restype = ctypes.c_longlong
            if threads() != INT8_THREADS or \
                    chans() != INT8_MAX_CHANNELS or \
                    smem(3, 256, 28) != int8_smem_bytes(3, 256, 28):
                raise build.KernelLaunchError(
                    "hist_fused_int8: the kernel's block size or shared-"
                    "memory layout disagrees with the binding")
            for name, lib_ in ((FUSED, lib), (PARTITION, lib_p),
                               (SEGSTATS, lib_s), (BATCHED, lib_b)):
                err = getattr(lib_, f"{name}_error_string")
                err.argtypes = [ci]
                err.restype = ctypes.c_char_p
                _funcs[name + "_error"] = err
            for name, fn, want in (
                    (FUSED, lib.hist_fused_tile_rows, ROWS_TILE),
                    (FUSED, lib.hist_fused_part_rows, ROWS_PART),
                    (PARTITION, lib_p.hist_partition_tile_rows, ROWS_TILE),
                    (BATCHED, lib_b.hist_fused_batched_tile_rows, B5_TILE),
                    (BATCHED, lib_b.hist_fused_batched_part_rows,
                     B5_PART_ROWS),
                    (SEGSTATS, lib_s.hist_segstats_max_chunk_rows,
                     B6_CHUNK_ROWS[0])):
                fn.restype = ci
                if fn() != want:
                    raise build.KernelLaunchError(
                        f"{name}: the kernel's tile rows disagree with the "
                        "binding")
            smem = lib.hist_fused_smem_bytes
            smem.argtypes = [ci, ci, ci, ci, ci]
            smem.restype = ctypes.c_longlong
            if smem(28, 3, 256, 28, 1) != rows_smem_bytes(28, 3, 256, 28,
                                                          True) or \
                    smem(300, 2, 64, 30, 0) != rows_smem_bytes(300, 2, 64,
                                                               30, False):
                raise build.KernelLaunchError(
                    "hist_fused: the kernel's shared-memory layout disagrees "
                    "with the binding")
            smem = lib_b.hist_fused_batched_smem_bytes
            smem.argtypes = [ci, ci, ci]
            smem.restype = ctypes.c_longlong
            if smem(3, 256, 8) != batched_smem_bytes(3, 256, 8):
                raise build.KernelLaunchError(
                    "hist_fused_batched: the kernel's shared-memory layout "
                    "disagrees with the binding")
            smem = lib_s.hist_segstats_smem_bytes
            smem.argtypes = [ci]
            smem.restype = ctypes.c_longlong
            if smem(4096) != segstats_smem_bytes(4096):
                raise build.KernelLaunchError(
                    "hist_segstats: the kernel's shared-memory layout "
                    "disagrees with the binding")
        return _funcs


def _a16(x: int) -> int:
    return -(-x // 16) * 16


def rows_pitch(feat_group: int) -> int:
    """Bytes of a gathered row's codes in a ring stage
    (``hr::gather_pitch``): the 4-byte words that cover ``feat_group``
    codes from any byte of a word, an odd number of them."""
    return 4 * (((feat_group + 6) // 4) | 1)


def rows_smem_bytes(num_features: int, s: int, num_bins: int,
                    feat_group: int, bulk: bool) -> int:
    """Dynamic shared memory of one B1/B2 histogram block
    (``hr::smem_bytes``): the f64 histogram ``[fg, B, S]``, two ring
    stages (codes, statistics, segment ids, first-code offsets of
    ``ROWS_TILE`` rows) and two mbarriers."""
    p = rows_pitch(feat_group)
    code = ROWS_TILE * (num_features if bulk and num_features > p else p)
    stage = _a16(_a16(code) + _a16(4 * ROWS_TILE * s) + 5 * ROWS_TILE)
    return _a16(8 * feat_group * num_bins * s) + 2 * stage + 16


class RowsPlan(NamedTuple):
    """A B1 (f32/bf16) or B2 launch: ``feat_group`` features per block in
    ``groups`` groups, ``bulk`` copies of a root's tiles, ``rows`` per work
    item (for more than one segment the least: the device sizes them),
    ``slots`` item slots and the ``target`` blocks of one round."""
    feat_group: int
    groups: int
    bulk: bool
    rows: int
    slots: int
    target: int


def plan_rows(n: int, num_features: int, s: int, num_segments: int,
              num_bins: int, sm_count: int,
              partitioned: bool = None) -> RowsPlan:
    """The launch plan of B1 (f32/bf16) and B2.

    A block's feature group is as many features (a warp each, at most
    ``ROWS_MAX_WARPS``) as let its histogram and ring fit
    ``SMEM_LIMIT``, balanced over the features; ``target`` is the blocks
    that one round holds (by shared memory and threads per SM).  Work items
    hold whole tiles, at least one, and about ``n_call * groups / target``
    rows (a small call's few tiles spread over as many blocks, whose
    histograms' flush costs less than the tiles' latency in one block):
    one segment (a root) takes ``ceil(n / rows)`` row ranges sized here;
    more take ``min(ceil(n / least), ceil(target / groups)) + K``
    slots, which bound ``sum_k ceil(rows_k / R) <= v / R + K`` for the
    ``R >= v * groups / target`` that the device picks from the rows ``v``
    its count finds (unused slots exit).  ``partitioned`` (default: more
    than one segment) plans a call that partitions its rows, as B2 always
    does."""
    if partitioned is None:
        partitioned = num_segments > 1
    if s > ROWS_MAX_S:
        raise ValueError(f"the f32/bf16 histogram kernels take at most "
                         f"{ROWS_MAX_S} statistics, got {s}")
    fg = min(num_features, ROWS_MAX_WARPS)
    while fg > 1 and rows_smem_bytes(num_features, s, num_bins, fg,
                                     fg == num_features) > SMEM_LIMIT:
        fg -= 1
    if rows_smem_bytes(num_features, s, num_bins, fg,
                       fg == num_features) > SMEM_LIMIT:
        raise ValueError(f"{s} statistics x {num_bins} bins do not fit a "
                         "block's shared memory")
    groups = -(-num_features // fg)
    fg = -(-num_features // groups)
    bulk = groups == 1 and not partitioned
    smem = rows_smem_bytes(num_features, s, num_bins, fg, bulk)
    per_sm = max(1, min(SMEM_PER_SM // (smem + 1024),
                        2048 // (32 * fg), 32))
    target = per_sm * sm_count
    least = ROWS_TILE
    if not partitioned:
        rows = max(least, rows_item_rows(n, groups, target))
        slots = -(-n // rows)
    else:
        rows = least
        slots = min(-(-n // least), -(-target // groups)) + num_segments
    return RowsPlan(fg, groups, bulk, rows, slots, target)


def rows_item_rows(rows: int, groups: int, target: int,
                   num_segments: int = 0) -> int:
    """``rows * groups / t`` rounded up to a whole tile: the item size that
    spreads a call's ``rows`` over ``target`` blocks; ``t = target`` for a
    root's row ranges, ``max(target - K, target / 2)`` for a call that
    partitions its rows into ``K = num_segments`` segments, whose last
    items may be short (the kernel's scan computes the same from its
    counts, floored at the least size)."""
    t = target
    if num_segments:
        t = max(target - num_segments, -(-target // 2))
    r = -(-rows * groups // t)
    return -(-r // ROWS_TILE) * ROWS_TILE


def rows_items_plain(seg: torch.Tensor, num_segments: int,
                     plan: RowsPlan) -> dict:
    """B1's and B2's work items in PyTorch: ``order`` (position -> row:
    every row for one segment, else the rows of segments ``[0, K)``
    grouped by segment in row order), ``items`` ``[m, 3]`` = (segment, p0,
    p1) in slot order, and per segment its first item and item count
    (``item_first``, ``item_count``)."""
    n = seg.shape[0]
    k = int(num_segments)
    if k == 1:
        p0 = torch.arange(0, n, plan.rows, dtype=torch.int64)
        items = torch.stack([torch.zeros_like(p0), p0,
                             torch.clamp(p0 + plan.rows, max=n)], dim=1)
        return {"order": torch.arange(n), "items": items,
                "item_first": torch.zeros(1, dtype=torch.int64),
                "item_count": torch.tensor([p0.numel()])}
    seg = seg.to(torch.int64)
    valid = (seg >= 0) & (seg < k)
    order = torch.argsort(torch.where(valid, seg, k), stable=True)
    counts = torch.bincount(seg[valid], minlength=k)
    total = int(counts.sum())
    rows = max(plan.rows, rows_item_rows(total, plan.groups, plan.target,
                                         k))
    starts = torch.cumsum(counts, 0) - counts
    per = -(-counts // rows)
    kk = torch.repeat_interleave(torch.arange(k), per)
    j = torch.arange(kk.numel()) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    p0 = starts[kk] + j * rows
    items = torch.stack([kk, p0, torch.minimum(p0 + rows,
                                               starts[kk] + counts[kk])], 1)
    return {"order": order[:total], "items": items,
            "item_first": torch.cumsum(per, 0) - per, "item_count": per}


def rows_passes_plain(bins: torch.Tensor, stats: torch.Tensor,
                      seg: torch.Tensor, num_segments: int, num_bins: int,
                      mode: str, plan: RowsPlan) -> dict:
    """B1's and B2's histogram passes in PyTorch, in the kernels' order,
    for the CPU tests: the work items (:func:`rows_items_plain`), one f64
    partial per item of its rows' mode-rounded statistics (rows of other
    segments skipped in the one-segment mode), and per segment the f32
    cells: its one item's partial rounded, or its items' partials summed
    in item order and rounded once, or zeros (``out`` ``[K, F, B, S]``)."""
    n, f = bins.shape
    s = stats.shape[1]
    k = int(num_segments)
    st = stats.to(torch.bfloat16).to(torch.float32) if mode == "bf16" \
        else stats
    st = st.to(torch.float64)
    p = rows_items_plain(seg, k, plan)
    codes = bins.to(torch.int64)
    seg64 = seg.to(torch.int64)
    partials = []
    for kk, p0, p1 in p["items"].tolist():
        rows = p["order"][p0:p1]
        if k == 1:
            rows = rows[seg64[rows] == 0]
        part = torch.zeros((f * num_bins, s), dtype=torch.float64)
        for jf in range(f):
            c = codes[rows, jf]
            keep = c < num_bins
            part.index_add_(0, jf * num_bins + c[keep], st[rows[keep]])
        partials.append(part.view(f, num_bins, s))
    out = torch.zeros((k, f, num_bins, s), dtype=torch.float64)
    for kk in range(k):
        first, count = int(p["item_first"][kk]), int(p["item_count"][kk])
        for i in range(first, first + count):
            out[kk] += partials[i]
    return dict(p, out=out.to(torch.float32))


def int8_smem_bytes(s: int, num_bins: int, feat_group: int) -> int:
    """Dynamic shared memory of one int8 histogram block: its int32
    histogram ``[feat_group, B, S]``."""
    return 4 * feat_group * s * num_bins


def plan_int8(n: int, num_features: int, s: int, num_segments: int,
              num_bins: int, sm_count: int):
    """``(rows_per_item, feat_group, slots, target, part_blocks)`` of an
    int8 B1 launch.

    A block's shared histogram holds as many features as let
    ``INT8_BLOCKS_PER_SM`` blocks share an SM (``INT8_ROOT_BLOCKS_PER_SM``
    for one segment of enough rows, whose rows run in order; the groups
    balanced).  Work items of one segment make about ``target`` blocks
    (one round of resident blocks) over the call's rows, with at least
    ``INT8_ROWS_PER_CELL`` rows per bin of a histogram: for one segment the
    host sizes them from ``n`` (``rows_per_item``, ``slots = ceil(n / R)``
    row ranges); for more, ``rows_per_item`` is the least size and the
    device sizes them from the rows ``v`` its count finds
    (:func:`int8_item_rows`: ``R >= v * groups / target``), so ``slots =
    min(ceil(n / least), ceil(target / groups)) + K`` bounds ``sum_k
    ceil(rows_k / R) <= v / R + K`` (the few unused slots exit; the host
    never reads the counts).  ``part_blocks`` blocks of the count and
    scatter passes take ``INT8_PART_ROWS`` rows each, at most ``target``.
    """
    least = -(-INT8_ROWS_PER_CELL * num_bins // 32) * 32
    # one segment's rows run in order (every row's statistics quantized once
    # per feature group): fewer, wider blocks where there are rows enough
    # to give each of them a least-sized item; gathered rows want more
    wide = (num_segments == 1
            and -(-n // least) >= INT8_ROOT_BLOCKS_PER_SM * sm_count)
    per_sm = INT8_ROOT_BLOCKS_PER_SM if wide else INT8_BLOCKS_PER_SM
    room = SMEM_PER_SM // per_sm - 1024
    per = int8_smem_bytes(s, num_bins, 1)
    most = room // per if room >= per else SMEM_LIMIT // per
    if most < 1:
        raise ValueError(f"{s} statistics x {num_bins} bins do not fit an "
                         "int8 block's shared memory")
    f_groups = -(-num_features // most)
    feat_group = -(-num_features // f_groups)
    target = per_sm * sm_count
    if num_segments > 1:
        rows = min(least, max(32, -(-n // 32) * 32))
        slots = min(-(-n // rows), -(-target // f_groups)) + num_segments
    else:
        rows = max(1, min(int8_item_rows(n, least, f_groups, target), n))
        slots = -(-n // rows)
    part_blocks = max(1, min(-(-n // INT8_PART_ROWS), target))
    return rows, feat_group, slots, target, part_blocks


def int8_item_rows(rows: int, least: int, f_groups: int, target: int) -> int:
    """Rows of an int8 work item for a call whose segments hold ``rows``
    rows: ``rows * f_groups / target`` rounded up to 32, at least ``least``
    (the kernel's scan computes the same from its counts)."""
    r = -(-rows * f_groups // target)
    return max(least, -(-r // 32) * 32)


def int8_scale_plain(stats: torch.Tensor) -> torch.Tensor:
    """The int8 kernel's channel scale in PyTorch, in its steps: the largest
    bit pattern of ``|x|`` per channel (a float's sign bit cleared; non-
    negative floats order as their bits), reinterpreted, floored at 1e-30
    and divided by 127.  Equals ``quantize_int8``'s ``scale``."""
    n, s = stats.shape
    bits = stats.contiguous().view(torch.int32) & 0x7FFFFFFF
    top = (bits.amax(dim=0) if n else
           torch.zeros(s, dtype=torch.int32, device=stats.device))
    amax = top.view(torch.float32)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=stats.device)
    return torch.maximum(amax, tiny) / torch.full_like(amax, 127.0)


def int8_items_plain(seg: torch.Tensor, num_segments: int, rows: int,
                     f_groups: int = 1, target: int = 1):
    """The int8 kernel's work items in PyTorch: ``(list, items)`` with
    ``list`` the rows of segments ``[0, K)`` grouped by segment (the kernel
    orders them freely inside a segment) and ``items`` ``[m, 3]`` =
    (segment, begin, end) positions in ``list``; for one segment ``list`` is
    every row and the items are row ranges of ``rows``; for more, items of
    :func:`int8_item_rows` of the segments' rows (``rows`` the least)."""
    n = seg.shape[0]
    dev = seg.device
    if num_segments == 1:
        begin = torch.arange(0, n, rows, dtype=torch.int64, device=dev)
        end = torch.clamp(begin + rows, max=n)
        return (torch.arange(n, device=dev),
                torch.stack([torch.zeros_like(begin), begin, end], dim=1))
    seg = seg.to(torch.int64)
    valid = (seg >= 0) & (seg < num_segments)
    order = torch.argsort(torch.where(valid, seg, num_segments), stable=True)
    counts = torch.bincount(seg[valid], minlength=num_segments)
    rows = int8_item_rows(int(counts.sum()), rows, f_groups, target)
    starts = torch.cumsum(counts, 0) - counts
    per = -(-counts // rows)
    k = torch.repeat_interleave(torch.arange(num_segments, device=dev), per)
    j = torch.arange(k.numel(), device=dev) - torch.repeat_interleave(
        torch.cumsum(per, 0) - per, per)
    begin = starts[k] + j * rows
    end = torch.minimum(begin + rows, starts[k] + counts[k])
    return order[:int(counts.sum())], torch.stack([k, begin, end], dim=1)


def int8_passes_plain(bins: torch.Tensor, stats: torch.Tensor,
                      seg: torch.Tensor, num_segments: int, num_bins: int,
                      rows: int, feat_group: int,
                      target: int = 1) -> torch.Tensor:
    """The int8 kernel's passes in PyTorch, for the CPU tests: the scale
    (:func:`int8_scale_plain`), the work items (:func:`int8_items_plain`),
    one int64 histogram per (item, feature group) of its rows' quantized
    statistics (rows of other segments skipped in the one-segment mode),
    added into the ``[K, F, B, S]`` accumulator, then ``f32(sum) *
    scale``."""
    from ..ops.histogram import quantize_int8

    n, f = bins.shape
    s = stats.shape[1]
    k = int(num_segments)
    q = quantize_int8(stats)[0].to(torch.int64)
    scale = int8_scale_plain(stats)
    order, items = int8_items_plain(seg, k, rows, -(-f // feat_group),
                                    target)
    acc = torch.zeros((k, f, num_bins, s), dtype=torch.int64,
                      device=bins.device)
    seg64 = seg.to(torch.int64)
    for kk, p0, p1 in items.tolist():
        r = order[p0:p1]
        if k == 1:
            r = r[seg64[r] == 0]
        for f0 in range(0, f, feat_group):
            part = torch.zeros((min(feat_group, f - f0) * num_bins, s),
                               dtype=torch.int64, device=bins.device)
            for fl in range(part.shape[0] // num_bins):
                codes = bins[r, f0 + fl].to(torch.int64)
                ok = codes < num_bins
                part.index_add_(0, fl * num_bins + codes[ok], q[r][ok])
            acc[kk, f0:f0 + feat_group] += part.view(-1, num_bins, s)
    return acc.to(torch.int32).to(torch.float32) * scale


def segstats_smem_bytes(rows_per_chunk: int) -> int:
    """Dynamic shared memory of one B6 block (``b6::smem_bytes``): the
    chunk's keys and sorted positions (u16 each), the sort's tables and the
    warps' continued runs."""
    return (4 * rows_per_chunk + 4 * (WARPS * MAX_BINS + 2 * MAX_BINS)
            + 8 * WARPS * B6_LANES + 4 * (WARPS + 1))


def plan_segstats(n: int, num_features: int, channels: int, num_bins: int,
                  sm_count: int):
    """(rows_per_chunk, n_chunks, groups_per_set, n_sets) of a B6 launch.

    A block sorts one row chunk of one feature once and walks it for each
    32-channel group of its set.  Chunks are as large as still give
    ``BLOCKS_PER_SM`` blocks per SM (fewer sorts and partials); the
    channel groups are spread over as many sets as fill that grid."""
    groups = -(-channels // B6_LANES)
    target = BLOCKS_PER_SM * sm_count
    for rows in B6_CHUNK_ROWS:
        chunks = -(-n // rows)
        if chunks * num_features * groups >= target:
            break
    sets = min(groups, -(-target // (chunks * num_features)))
    per_set = -(-groups // sets)
    return rows, chunks, per_set, -(-groups // per_set)


def batched_smem_bytes(s: int, num_bins: int, feat_group: int) -> int:
    """Dynamic shared memory of one B5 histogram block
    (``b5::hist_smem_bytes``): the f64 histogram ``[F_g, B, S]`` and the
    tile's statistics."""
    return 8 * feat_group * num_bins * s + 4 * B5_TILE * s


def plan_batched(n: int, num_features: int, s: int, num_segments: int,
                 num_bins: int, sm_count: int, elements: int):
    """(R, cap, feat_group, part_chunks) of a B5 launch.

    A block's feature group is at most ``B5_WARPS`` features (a warp each),
    as many as let four histogram blocks share an SM (two, then one, where
    even a single feature needs more), balanced over the features; a work
    item holds at most ``R`` positions (whole tiles), cut so that the
    ``elements * n`` rows (an upper bound of the direct rows) make about
    four rounds of resident blocks; ``cap`` bounds the items of one
    element (``ceil(n / R) + K``); the partition takes chunks of
    ``B5_PART_ROWS`` rows."""
    if 4 * B5_WARPS * num_segments > SMEM_LIMIT:
        raise ValueError(f"{num_segments} segments exceed the partition's "
                         "shared memory")
    for per_sm in (4, 2, 1):
        room = min(SMEM_LIMIT, SMEM_PER_SM // per_sm - 1024)
        fg = min(num_features, B5_WARPS)
        while fg > 1 and batched_smem_bytes(s, num_bins, fg) > room:
            fg -= 1
        if batched_smem_bytes(s, num_bins, fg) <= room:
            break
    else:
        raise ValueError(f"{s} statistics x {num_bins} bins do not fit a "
                         "block's shared memory")
    groups = -(-num_features // fg)
    fg = -(-num_features // groups)
    want = 4 * per_sm * sm_count * B5_TILE
    r = B5_TILE * max(1, -(-elements * n * groups // want))
    return r, -(-n // r) + num_segments, fg, -(-n // B5_PART_ROWS)


def batched_passes_plain(bins: torch.Tensor, stats: torch.Tensor,
                         seg: torch.Tensor, num_segments: int, num_bins: int,
                         mode: str, r: int) -> dict:
    """B5's passes in PyTorch, in the kernel's order: the stable partition
    of each element's rows by segment (``order``, ``seg_start``
    ``[E, K + 1]``), the work items (element, segment, p0, p1) of at most
    ``r`` positions each, their rows gathered through the order into f64
    partials, and the reduce in item order (``out`` f32
    ``[E, K, F, B, S]``)."""
    n, f = bins.shape
    e, _, s = stats.shape
    k = int(num_segments)
    st = stats.to(torch.bfloat16).to(torch.float32) if mode == "bf16" \
        else stats
    seg = seg.to(torch.int64)
    ok = (seg >= 0) & (seg < k)
    key = torch.where(ok, seg, k)
    order, starts, items = [], [], []
    for el in range(e):
        # a stable counting sort by segment, out-of-range rows dropped
        counts = torch.bincount(key[el], minlength=k + 1)[:k]
        start = torch.zeros(k + 1, dtype=torch.int64)
        start[1:] = torch.cumsum(counts, 0)
        pos = start[key[el].clamp(max=k - 1)]
        rank = torch.zeros(n, dtype=torch.int64)
        for kk in range(k):
            rows = torch.nonzero(key[el] == kk).squeeze(1)
            rank[rows] = torch.arange(rows.numel())
        o = torch.empty(int(start[k]), dtype=torch.int64)
        o[(pos + rank)[ok[el]]] = torch.nonzero(ok[el]).squeeze(1)
        order.append(o)
        starts.append(start)
        for kk in range(k):
            for p0 in range(int(start[kk]), int(start[kk + 1]), r):
                items.append((el, kk, p0, min(int(start[kk + 1]), p0 + r)))
    acc = torch.zeros((e, k, f, num_bins, s), dtype=torch.float64)
    codes = bins.to(torch.int64)
    for el, kk, p0, p1 in items:
        rows = order[el][p0:p1]
        part = torch.zeros((f * num_bins, s), dtype=torch.float64)
        for j in range(f):
            c = codes[rows, j]
            keep = c < num_bins
            part.index_add_(0, j * num_bins + c[keep],
                            st[el, rows[keep]].to(torch.float64))
        acc[el, kk] += part.view(f, num_bins, s)
    return {"order": order, "seg_start": torch.stack(starts),
            "items": items, "out": acc.to(torch.float32)}


def segstats_passes_plain(bins: torch.Tensor, segstats: torch.Tensor,
                          num_bins: int, mode: str,
                          rows_per_chunk: int) -> dict:
    """B6's passes in PyTorch, in the kernel's order: per (row chunk,
    feature) the rows sorted stably by bin (codes >= B dropped) as
    ``order[chunk][feature]``, the sorted positions cut into ``WARPS``
    equal ranges whose runs of equal bins sum in f64 (a run continued from
    the previous range added after the others, in range order), and the
    chunks' partials summed in chunk order (``out`` f32 ``[F, B, Kc]``)."""
    n, f = bins.shape
    kc = segstats.shape[1]
    st = segstats.to(torch.bfloat16).to(torch.float32) if mode == "bf16" \
        else segstats
    st = st.to(torch.float64)
    codes = bins.to(torch.int64)
    out = torch.zeros((f, num_bins, kc), dtype=torch.float64)
    order = []
    for r0 in range(0, n, rows_per_chunk):
        r1 = min(n, r0 + rows_per_chunk)
        per_feature = []
        for j in range(f):
            c = codes[r0:r1, j]
            rows = torch.nonzero(c < num_bins).squeeze(1)
            srt = rows[torch.sort(c[rows], stable=True).indices]
            per_feature.append(srt)
            b = c[srt]
            placed = srt.numel()
            acc = torch.zeros((num_bins, kc), dtype=torch.float64)
            heads = []
            for w in range(WARPS):
                pa, pb = placed * w // WARPS, placed * (w + 1) // WARPS
                p = pa
                while p < pb:
                    q = p
                    while q < pb and b[q] == b[p]:
                        q += 1
                    run = st[r0 + srt[p:q]].sum(dim=0)
                    if p == 0 or b[p - 1] != b[p]:
                        acc[b[p]] = run
                    else:
                        heads.append((int(b[p]), run))
                    p = q
            for bb, run in heads:
                acc[bb] += run
            out[j] += acc
        order.append(per_feature)
    return {"order": order, "out": out.to(torch.float32)}


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name} must be {dtype} {tuple(shape)}, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _raise(name, err):
    msg = _funcs[name + "_error"](err).decode()
    raise build.KernelLaunchError(f"{name} launch failed: {msg} "
                                  f"(cudaError {err})")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (the kernels' bulk
    and 4-byte asynchronous copies): a copy when a view starts elsewhere."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check_segments(k: int) -> None:
    if k > ROWS_MAX_SEGMENTS:
        raise ValueError(f"the f32/bf16 histogram kernels take at most "
                         f"{ROWS_MAX_SEGMENTS:,} segments, got {k:,}")


def _rows_scratch(n: int, k: int, p: RowsPlan, dev, with_seg: bool):
    """One i32 scratch for B1's and B2's partition: ``(pointers, tensor)``
    with the pointers (B2's routed segments first), items int4
    ``[slots]``, counts ``[K, C]``, item_first and item_count ``[K]``,
    sizes ``[1]``, the row list ``[n]``, in the C entry points' order."""
    c = -(-n // ROWS_PART)
    multi = k > 1 or with_seg
    sizes = ([n] if with_seg else []) + [
        4 * p.slots if multi else 4, k * c if multi else 1, k, k, 1,
        n if multi else 1]
    sizes = [_a16(4 * x) // 4 for x in sizes]        # 16-byte aligned parts
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    ptrs, off = [], 0
    for size in sizes:
        ptrs.append(scratch.data_ptr() + 4 * off)
        off += size
    if with_seg:
        seg, items, counts, *rest = ptrs
        return [seg, counts, items, *rest], scratch
    items, counts, *rest = ptrs
    return [counts, items, *rest], scratch


def _mode_flag(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"histogram mode must be 'f32' or 'bf16', got "
                         f"{mode!r}")
    return int(mode == "bf16")


def hist_fused(bins: torch.Tensor, stats: torch.Tensor, seg: torch.Tensor,
               num_segments: int, num_bins: int, mode: str) -> torch.Tensor:
    """Launch B1: f32 ``[K, F, B, S]`` histogram of ``stats`` by
    (segment, feature, bin) for CUDA tensors (int8 mode: the quantized
    contract, :func:`hist_fused_int8`)."""
    if mode == "int8":
        return hist_fused_int8(bins, stats, seg, num_segments, num_bins)
    if bins.device.type != "cuda":
        raise ValueError(f"the hist_fused kernel takes CUDA tensors, got "
                         f"{bins.device}")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise TypeError("bins must be a uint8 [n, F] tensor")
    n, f = bins.shape
    s = stats.shape[1] if stats.dim() == 2 else -1
    _check("stats", stats, torch.float32, (n, s), dev)
    _check("seg", seg, torch.int32, (n,), dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must lie in [1, 256], got {num_bins}")
    flag = _mode_flag(mode)
    k = int(num_segments)
    _check_segments(k)
    out = torch.empty((k, f, num_bins, s), dtype=torch.float32, device=dev)
    if n == 0 or f == 0 or k == 0 or s == 0:
        return out.zero_()
    p = plan_rows(n, f, s, k, num_bins, _sm_count(dev))
    bins, stats, seg = _aligned(bins), _aligned(stats), _aligned(seg)
    ptrs, scratch = _rows_scratch(n, k, p, dev, with_seg=False)
    partial = torch.empty(p.slots * f * num_bins * s if p.slots > 1 or k > 1
                          else 1, dtype=torch.float64, device=dev)
    funcs = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = funcs[FUSED](bins.data_ptr(), n, f, stats.data_ptr(), s,
                           seg.data_ptr(), k, num_bins, flag, p.feat_group,
                           p.rows, p.slots, p.target, int(p.bulk), *ptrs,
                           partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        _raise(FUSED, err)
    HIST_FUSED_LAUNCHES[mode].add()
    return out


def hist_fused_int8(bins: torch.Tensor, stats: torch.Tensor,
                    seg: torch.Tensor, num_segments: int,
                    num_bins: int) -> torch.Tensor:
    """Launch B1's int8 mode: f32 ``[K, F, B, S]``, ``f32(int32 sum of the
    quantized stats) * scale`` per (segment, feature, bin, channel), for
    CUDA tensors."""
    from ..ops.histogram import check_int8_rows

    if bins.device.type != "cuda":
        raise ValueError(f"the hist_fused_int8 kernel takes CUDA tensors, "
                         f"got {bins.device}")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise TypeError("bins must be a uint8 [n, F] tensor")
    n, f = bins.shape
    s = stats.shape[1] if stats.dim() == 2 else -1
    _check("stats", stats, torch.float32, (n, s), dev)
    _check("seg", seg, torch.int32, (n,), dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must lie in [1, 256], got {num_bins}")
    check_int8_rows(n)
    k = int(num_segments)
    if s > INT8_MAX_CHANNELS:
        raise ValueError(f"the int8 kernel takes at most {INT8_MAX_CHANNELS} "
                         f"statistics, got {s}")
    if k > INT8_MAX_SEGMENTS:
        raise ValueError(f"the int8 kernel takes at most "
                         f"{INT8_MAX_SEGMENTS:,} segments, got {k:,}")
    out = torch.empty((k, f, num_bins, s), dtype=torch.float32, device=dev)
    if n == 0 or f == 0 or k == 0 or s == 0:
        return out.zero_()
    rows, f_group, slots, target, part_blocks = plan_int8(
        n, f, s, k, num_bins, _sm_count(dev))
    bins, stats, seg = bins.contiguous(), stats.contiguous(), seg.contiguous()
    # i32 scratch: amax bits [S], counts, cursor, items per segment [K]
    # each, the item table [slots, 3] and the row list [n]
    multi = k > 1
    sizes = (s, k, k, k, 3 * slots if multi else 1, n if multi else 1)
    scratch = torch.empty(sum(sizes), dtype=torch.int32, device=dev)
    ptrs, off = [], 0
    for size in sizes:
        ptrs.append(scratch.data_ptr() + 4 * off)
        off += size
    acc = torch.empty((k, f, num_bins, s), dtype=torch.int32, device=dev)
    funcs = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = funcs[INT8](bins.data_ptr(), n, f, stats.data_ptr(), s,
                          seg.data_ptr(), k, num_bins, rows, f_group, slots,
                          target, part_blocks, *ptrs,
                          acc.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        _raise(INT8, err)
    HIST_FUSED_LAUNCHES["int8"].add()
    return out


def hist_partition(bins: torch.Tensor, stats: torch.Tensor,
                   row_leaf: torch.Tensor, slot_of_node: torch.Tensor,
                   feat: torch.Tensor, thr: torch.Tensor,
                   direct_left: torch.Tensor, n_nodes: int, num_bins: int,
                   mode: str):
    """Launch B2 on CUDA tensors: ``(direct_hist f32 [W, F, B, 3],
    new_row_leaf i32 [n])``."""
    if bins.device.type != "cuda":
        raise ValueError(f"the hist_partition kernel takes CUDA tensors, got "
                         f"{bins.device}")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise TypeError("bins must be a uint8 [n, F] tensor")
    n, f = bins.shape
    w = feat.shape[0]
    _check("stats", stats, torch.float32, (n, 3), dev)
    _check("row_leaf", row_leaf, torch.int32, (n,), dev)
    _check("slot_of_node", slot_of_node, torch.int32,
           (slot_of_node.shape[0],), dev)
    _check("feat", feat, torch.int32, (w,), dev)
    _check("thr", thr, torch.int32, (w,), dev)
    _check("direct_left", direct_left, torch.uint8, (w,), dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must lie in [1, 256], got {num_bins}")
    flag = _mode_flag(mode)
    hist = torch.empty((w, f, num_bins, 3), dtype=torch.float32, device=dev)
    new_leaf = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return hist.zero_(), new_leaf
    if w == 0 or f == 0:
        # nothing splits: every row keeps its leaf
        return hist.zero_(), row_leaf.clone()
    _check_segments(w)
    p = plan_rows(n, f, 3, w, num_bins, _sm_count(dev), partitioned=True)
    tensors = [_aligned(t) for t in (bins, stats, row_leaf, slot_of_node,
                                     feat, thr, direct_left)]
    ptrs, scratch = _rows_scratch(n, w, p, dev, with_seg=True)
    partial = torch.empty(p.slots * f * num_bins * 3, dtype=torch.float64,
                          device=dev)
    funcs = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = funcs[PARTITION](
            tensors[0].data_ptr(), n, f, tensors[1].data_ptr(),
            tensors[2].data_ptr(), tensors[3].data_ptr(),
            tensors[3].shape[0], tensors[4].data_ptr(),
            tensors[5].data_ptr(), tensors[6].data_ptr(), w, int(n_nodes),
            num_bins, flag, p.feat_group, p.rows, p.slots, p.target, *ptrs,
            partial.data_ptr(), hist.data_ptr(), new_leaf.data_ptr(), stream)
    if err != 0:
        _raise(PARTITION, err)
    HIST_PARTITION_LAUNCHES[mode].add()
    return hist, new_leaf


def hist_segstats(bins: torch.Tensor, segstats: torch.Tensor, num_bins: int,
                  mode: str) -> torch.Tensor:
    """Launch B6: f32 ``[F, B, Kc]`` histogram of the pre-folded statistics
    ``segstats [n, Kc]`` by (feature, bin) for CUDA tensors."""
    if bins.device.type != "cuda":
        raise ValueError(f"the hist_segstats kernel takes CUDA tensors, got "
                         f"{bins.device}")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise TypeError("bins must be a uint8 [n, F] tensor")
    n, f = bins.shape
    kc = segstats.shape[1] if segstats.dim() == 2 else -1
    _check("segstats", segstats, torch.float32, (n, kc), dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must lie in [1, 256], got {num_bins}")
    flag = _mode_flag(mode)
    out = torch.empty((f, num_bins, kc), dtype=torch.float32, device=dev)
    if n == 0 or f == 0 or kc == 0:
        return out.zero_()
    rows, n_chunks, per_set, n_sets = plan_segstats(n, f, kc, num_bins,
                                                    _sm_count(dev))
    partial = torch.empty(n_chunks * f * num_bins * kc, dtype=torch.float64,
                          device=dev)
    bins, segstats = bins.contiguous(), segstats.contiguous()
    funcs = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = funcs[SEGSTATS](bins.data_ptr(), n, f, segstats.data_ptr(), kc,
                              num_bins, flag, rows, n_chunks, per_set, n_sets,
                              partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        _raise(SEGSTATS, err)
    HIST_SEGSTATS_LAUNCHES[mode].add()
    return out


def hist_fused_batched(bins: torch.Tensor, stats: torch.Tensor,
                       seg: torch.Tensor, num_segments: int, num_bins: int,
                       mode: str) -> torch.Tensor:
    """Launch B5: f32 ``[E, K, F, B, S]`` histograms of each element's
    ``stats [E, n, S]`` by (segment ``seg [E, n]``, feature, bin) over the
    shared ``bins [n, F]``, for CUDA tensors."""
    if bins.device.type != "cuda":
        raise ValueError(f"the hist_fused_batched kernel takes CUDA tensors, "
                         f"got {bins.device}")
    dev = bins.device
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise TypeError("bins must be a uint8 [n, F] tensor")
    n, f = bins.shape
    e, s = (stats.shape[0], stats.shape[2]) if stats.dim() == 3 else (-1, -1)
    _check("stats", stats, torch.float32, (e, n, s), dev)
    _check("seg", seg, torch.int32, (e, n), dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must lie in [1, 256], got {num_bins}")
    flag = _mode_flag(mode)
    k = int(num_segments)
    out = torch.empty((e, k, f, num_bins, s), dtype=torch.float32,
                      device=dev)
    if n == 0 or f == 0 or k == 0 or s == 0 or e == 0:
        return out.zero_()
    r, cap, fg, n_part = plan_batched(n, f, s, k, num_bins, _sm_count(dev),
                                      e)
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.empty(e * k * n_part, **i32)
    order = torch.empty(e * n, **i32)
    items = torch.empty(e * cap * 4, **i32)
    first = torch.empty(e * k, **i32)
    count = torch.empty(e * k, **i32)
    sizes = torch.empty(e, **i32)
    codes = torch.empty(e * f * n, dtype=torch.uint8, device=dev)
    ordered = torch.empty(e * n * s, dtype=torch.float32, device=dev)
    partial = torch.empty(e * cap * f * num_bins * s, dtype=torch.float64,
                          device=dev)
    bins, stats, seg = bins.contiguous(), stats.contiguous(), seg.contiguous()
    funcs = _bound()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = funcs[BATCHED](bins.data_ptr(), n, f, stats.data_ptr(), s,
                             seg.data_ptr(), e, k, num_bins, flag, r, cap, fg,
                             n_part, counts.data_ptr(), order.data_ptr(),
                             items.data_ptr(), first.data_ptr(),
                             count.data_ptr(), sizes.data_ptr(),
                             codes.data_ptr(), ordered.data_ptr(),
                             partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        _raise(BATCHED, err)
    HIST_FUSED_BATCHED_LAUNCHES[mode].add()
    return out
