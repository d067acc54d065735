"""Gradient/hessian histograms — the port of ``lightgbm_tpu/ops/histogram.py``
and of the two histogram kernels the default grower runs.

* :func:`hist_fused` — bins u8 ``[n, F]`` x stats f32 ``[n, S]`` x segment
  i32 ``[n]`` -> f32 ``[K, F, B, S]``; segments outside ``[0, K)`` add
  nothing.  The port of kernel B1 (``hist_fused_pallas``), as CUDA in
  ``csrc/hist_fused.cu``.
* :func:`hist_partition_fused` — one wave of the wave grower: route the rows
  of the splitting leaves to their children and histogram the rows that went
  to their split's smaller ("direct") child by wave rank.  The port of kernel
  B2 (``hist_partition_fused_pallas``), as CUDA in ``csrc/hist_partition.cu``.
* :func:`hist_segstats` — bins u8 ``[n, F]`` x pre-folded statistics f32
  ``[n, Kc]`` -> f32 ``[F, B, Kc]``, the route of the narrow batched
  histograms (:func:`compute_histograms_batched`: the roots and the strict
  grower's two children, over configs x folds x classes).  The port of
  kernel B6 (``hist_from_segstats_pallas``), as CUDA in
  ``csrc/hist_segstats.cu``.
* :func:`hist_fused_batched` — bins u8 ``[n, F]`` shared x stats f32
  ``[E, n, S]`` x segment i32 ``[E, n]`` -> f32 ``[E, K, F, B, S]``, the
  route of the wide batched histograms (``K * S >= 64``: every wave of the
  batched wave grower).  The port of kernel B5
  (``hist_fused_pallas_batched``), as CUDA in ``csrc/hist_fused_batched.cu``.

Each dispatches on the device of ``bins``: a CPU tensor takes the plain
PyTorch version beside it (:func:`hist_fused_plain`,
:func:`hist_partition_plain`, :func:`hist_segstats_plain`,
:func:`hist_fused_batched_plain`); a CUDA tensor launches the kernel or
raises.
There is no fallback from one to the other.  ``impl="plain"`` (the
reference's ``hist_impl="jnp"``) asks for the plain version explicitly, on
either device.

Modes: ``"bf16"`` rounds each statistic to bf16 (round to nearest even) and
sums in f32, as the TPU kernel's bf16 fold and the reference's XLA path do;
``"f32"`` (and the reference's explicit ``"f32x"``) sums the f32 statistics
in f32 — true f32, not the TPU kernel's hi/lo bf16 approximation.
``"int8"`` is not ported yet.

The kernels sum in f32 with Kahan compensation, in a fixed order; the plain
versions accumulate in f64 and round once.  Both land within a few f32 ulps
of the exact sum, so they agree to ``1e-6 * sum |x|`` per cell, and exactly
wherever every partial sum is exact (dyadic statistics).
"""

from __future__ import annotations

from typing import Optional

import torch

_F32 = torch.float32


def resolve_mode(hist_dtype: str) -> str:
    """The kernels' mode for a resolved ``hist_dtype``."""
    if hist_dtype in ("f32", "f32x"):
        return "f32"
    if hist_dtype == "bf16":
        return "bf16"
    if hist_dtype == "int8":
        raise NotImplementedError(
            "hist_dtype='int8' (quantized histograms) is not ported yet: "
            "ROADMAP slice 2 follow-up (B1's int8 mode)")
    raise NotImplementedError(
        f"hist_dtype={hist_dtype!r} is not ported: the port has 'f32' and "
        "'bf16' histograms")


def _stats_in_mode(stats: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return stats.to(torch.bfloat16).to(_F32)
    return stats


def hist_fused_plain(bins: torch.Tensor, stats: torch.Tensor,
                     seg: torch.Tensor, num_segments: int, num_bins: int,
                     mode: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_fused` (same contract):
    ``index_add_`` per feature into an f64 accumulator, rounded to f32."""
    n, f = bins.shape
    s = stats.shape[1]
    k = int(num_segments)
    st = _stats_in_mode(stats.to(_F32), mode)
    seg = seg.to(torch.int64)
    valid = (seg >= 0) & (seg < k)
    rows = torch.nonzero(valid).squeeze(1)
    acc = torch.zeros((k * f * num_bins, s), dtype=torch.float64,
                      device=bins.device)
    if rows.numel() > 0:
        st_v = st[rows].to(torch.float64)
        base = seg[rows] * (f * num_bins)
        codes = bins[rows].to(torch.int64)
        for j in range(f):
            acc.index_add_(0, base + j * num_bins + codes[:, j], st_v)
    return acc.to(_F32).view(k, f, num_bins, s)


def route_wave(bins, row_leaf, slot_of_node, feat, thr, direct_left,
               n_nodes: int):
    """The wave's row partition (plain PyTorch): ``(segment i64 [n],
    new_row_leaf i32 [n])`` — segment is the wave rank for rows that go to
    their split's direct child and -1 otherwise."""
    capacity = slot_of_node.shape[0]
    leaf = row_leaf.to(torch.int64)
    in_range = (leaf >= 0) & (leaf < capacity)
    slot = torch.where(in_range,
                       slot_of_node.to(torch.int64)[leaf.clamp(0, capacity - 1)],
                       torch.full_like(leaf, -1))
    sel = slot >= 0
    s_safe = slot.clamp(min=0)
    code = bins.gather(1, feat.to(torch.int64)[s_safe].unsqueeze(1))[:, 0]
    go_left = code.to(torch.int64) <= thr.to(torch.int64)[s_safe]
    child = n_nodes + 2 * s_safe + (~go_left).to(torch.int64)
    new_leaf = torch.where(sel, child, leaf).to(torch.int32)
    direct = go_left == (direct_left[s_safe] != 0)
    seg = torch.where(sel & direct, s_safe, torch.full_like(slot, -1))
    return seg, new_leaf


def hist_partition_plain(bins, stats, row_leaf, slot_of_node, feat, thr,
                         direct_left, n_nodes: int, num_bins: int,
                         mode: str = "f32"):
    """Plain PyTorch version of :func:`hist_partition_fused`."""
    seg, new_leaf = route_wave(bins, row_leaf, slot_of_node, feat, thr,
                               direct_left, n_nodes)
    hist = hist_fused_plain(bins, stats, seg, feat.shape[0], num_bins, mode)
    return hist, new_leaf


def hist_fused(bins, stats, seg, num_segments: int, num_bins: int,
               mode: str = "f32") -> torch.Tensor:
    """Kernel B1 on a CUDA tensor, its plain version on a CPU tensor."""
    if bins.device.type == "cpu":
        return hist_fused_plain(bins, stats, seg, num_segments, num_bins,
                                mode)
    from ..kernels.histogram import hist_fused as launch

    return launch(bins, stats, seg, num_segments, num_bins, mode)


def hist_partition_fused(bins, stats, row_leaf, slot_of_node, feat, thr,
                         direct_left, n_nodes: int, num_bins: int,
                         mode: str = "f32"):
    """Kernel B2 on CUDA tensors, its plain version on CPU tensors:
    ``(direct_hist f32 [W, F, B, 3], new_row_leaf i32 [n])``."""
    if bins.device.type == "cpu":
        return hist_partition_plain(bins, stats, row_leaf, slot_of_node, feat,
                                    thr, direct_left, n_nodes, num_bins, mode)
    from ..kernels.histogram import hist_partition as launch

    return launch(bins, stats, row_leaf, slot_of_node, feat, thr,
                  direct_left, n_nodes, num_bins, mode)


def hist_segstats_plain(bins: torch.Tensor, segstats: torch.Tensor,
                        num_bins: int, mode: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_segstats`: ``index_add_`` per
    feature into an f64 accumulator, rounded once to f32."""
    n, f = bins.shape
    st = _stats_in_mode(segstats.to(_F32), mode).to(torch.float64)
    acc = torch.zeros((f * num_bins, st.shape[1]), dtype=torch.float64,
                      device=bins.device)
    codes = bins.to(torch.int64)
    for j in range(f):
        acc.index_add_(0, j * num_bins + codes[:, j], st)
    return acc.to(_F32).view(f, num_bins, st.shape[1])


def hist_segstats(bins: torch.Tensor, segstats: torch.Tensor, num_bins: int,
                  mode: str = "f32") -> torch.Tensor:
    """bins u8 ``[n, F]`` x pre-folded statistics f32 ``[n, Kc]`` -> f32
    ``[F, B, Kc]``: kernel B6 on a CUDA tensor (the port of
    ``hist_from_segstats_pallas``, as CUDA in ``csrc/hist_segstats.cu``), its
    plain version on a CPU tensor."""
    if bins.device.type == "cpu":
        return hist_segstats_plain(bins, segstats, num_bins, mode)
    from ..kernels.histogram import hist_segstats as launch

    return launch(bins, segstats, num_bins, mode)


def hist_fused_batched_plain(bins: torch.Tensor, stats: torch.Tensor,
                             seg: torch.Tensor, num_segments: int,
                             num_bins: int, mode: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_fused_batched`: per element
    :func:`hist_fused_plain` (an f64 ``index_add_``, rounded once), so no
    ``[n, E*K*S]`` operand is ever folded."""
    return torch.stack([hist_fused_plain(bins, stats[e], seg[e], num_segments,
                                         num_bins, mode)
                        for e in range(stats.shape[0])])


def hist_fused_batched(bins: torch.Tensor, stats: torch.Tensor,
                       seg: torch.Tensor, num_segments: int, num_bins: int,
                       mode: str = "f32") -> torch.Tensor:
    """bins u8 ``[n, F]`` x stats f32 ``[E, n, S]`` x segment i32 ``[E, n]``
    -> f32 ``[E, K, F, B, S]``: kernel B5 on a CUDA tensor (the port of
    ``hist_fused_pallas_batched``), its plain version on a CPU tensor."""
    if bins.device.type == "cpu":
        return hist_fused_batched_plain(bins, stats, seg, num_segments,
                                        num_bins, mode)
    from ..kernels.histogram import hist_fused_batched as launch

    return launch(bins, stats, seg, num_segments, num_bins, mode)


# the reference's batched route: a batched call with num_segments * S lanes
# at or above this takes the batched fused kernel (B5), narrower ones the
# segstats fold (B6).  On the H100 the threshold is the reference's, kept
# until the card's measurement (PERF.md) says otherwise.
WIDE_SEGMENT_LANES = 64


def _check_impl(impl: str) -> None:
    if impl not in ("auto", "plain", "jnp"):
        raise ValueError(f"unknown hist_impl {impl!r}: expected 'auto' or "
                         "'plain'")


def segstats_rows(stats_t: torch.Tensor, seg_t: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Fold (segment one-hot x statistics) in row-major batch layout:
    ``stats_t [n, E, S]``, ``seg_t [n, E]`` -> ``[n, E * K * S]`` (channel
    ``(e * K + k) * S + s``; segments outside ``[0, K)`` fold to zeros).
    The reference's ``_segstats`` followed by its ``moveaxis``."""
    n, e, s = stats_t.shape
    iota = torch.arange(num_segments, dtype=seg_t.dtype, device=seg_t.device)
    onehot = (seg_t.unsqueeze(-1) == iota).to(stats_t.dtype)   # [n, E, K]
    return (onehot.unsqueeze(-1) * stats_t.unsqueeze(2)).reshape(
        n, e * num_segments * s)


def histograms_rows(bins: torch.Tensor, stats_t: torch.Tensor,
                    seg_t: Optional[torch.Tensor], num_segments: int,
                    num_bins: int, impl: str = "auto",
                    hist_dtype: str = "f32") -> torch.Tensor:
    """:func:`compute_histograms_batched` on the row-major layout the strict
    grower keeps (``stats_t [n, E, S]``, ``seg_t [n, E]``; ``seg_t=None``
    puts every row in segment 0): f32 ``[E, K, F, B, S]``."""
    mode = resolve_mode(hist_dtype)
    _check_impl(impl)
    n, e, s = stats_t.shape
    f = bins.shape[1]
    if num_segments * s >= WIDE_SEGMENT_LANES:
        seg = (torch.zeros((e, n), dtype=torch.int32, device=bins.device)
               if seg_t is None else seg_t.t().to(torch.int32).contiguous())
        return _batched_fused(bins, stats_t.transpose(0, 1).contiguous(), seg,
                              num_segments, num_bins, impl, mode)
    if seg_t is None and num_segments == 1:
        segstats = stats_t.reshape(n, e * s)
    else:
        segstats = segstats_rows(stats_t, seg_t, num_segments)
    if impl in ("plain", "jnp"):
        hists = hist_segstats_plain(bins, segstats, num_bins, mode)
    else:
        hists = hist_segstats(bins, segstats, num_bins, mode)
    return hists.view(f, num_bins, e, num_segments, s).permute(
        2, 3, 0, 1, 4).contiguous()


def compute_histograms_batched(bins: torch.Tensor, stats: torch.Tensor,
                               seg_id: torch.Tensor, num_segments: int,
                               num_bins: int, impl: str = "auto",
                               hist_dtype: str = "f32") -> torch.Tensor:
    """Batched histograms over a shared binned matrix (the reference's
    ``compute_histograms_batched``): bins ``[n, F]``, stats ``[E, n, S]``,
    seg_id ``[E, n]`` -> f32 ``[E, K, F, B, S]``.

    The reference's route: a wide-segment call (``K * S >= 64``, every wave
    of the batched wave grower) takes kernel B5, which folds each element's
    segments itself; a narrow one (the roots, the strict grower's two
    children) folds the batch's statistics into one ``[n, E*K*S]`` operand
    for kernel B6 (the reference's ``k_inner >= 64`` rule for that kernel is
    a TPU lane-width rule, so every narrow call takes it).  A CPU tensor
    takes the plain versions.
    """
    mode = resolve_mode(hist_dtype)
    _check_impl(impl)
    if num_segments * stats.shape[2] >= WIDE_SEGMENT_LANES:
        return _batched_fused(bins, stats.contiguous(),
                              seg_id.to(torch.int32).contiguous(),
                              num_segments, num_bins, impl, mode)
    return histograms_rows(bins, stats.transpose(0, 1), seg_id.transpose(0, 1),
                           num_segments, num_bins, impl, hist_dtype)


def _batched_fused(bins, stats, seg, num_segments, num_bins, impl, mode):
    if impl in ("plain", "jnp"):
        return hist_fused_batched_plain(bins, stats, seg, num_segments,
                                        num_bins, mode)
    return hist_fused_batched(bins, stats, seg, num_segments, num_bins, mode)


def compute_histograms(bins: torch.Tensor, stats: torch.Tensor,
                       seg_id: torch.Tensor, num_segments: int,
                       num_bins: int, impl: str = "auto",
                       hist_dtype: str = "f32") -> torch.Tensor:
    """Histogram of per-row statistics over (segment, feature, bin):
    f32 ``[num_segments, F, num_bins, S]`` (the reference's contract).
    ``impl="auto"`` is kernel B1 on a CUDA tensor (its plain version on a
    CPU tensor); ``impl="plain"`` (or ``"jnp"``) is the plain version."""
    mode = resolve_mode(hist_dtype)
    seg = seg_id.to(torch.int32)
    if impl in ("plain", "jnp"):
        return hist_fused_plain(bins, stats, seg, num_segments, num_bins,
                                mode)
    if impl != "auto":
        raise ValueError(f"unknown hist_impl {impl!r}: expected 'auto' or "
                         "'plain'")
    return hist_fused(bins, stats, seg, num_segments, num_bins, mode)
