"""Gradient/hessian histograms — the port of ``lightgbm_tpu/ops/histogram.py``
and of the two histogram kernels the default grower runs.

* :func:`hist_fused` — bins u8 ``[n, F]`` x stats f32 ``[n, S]`` x segment
  i32 ``[n]`` -> f32 ``[K, F, B, S]``; segments outside ``[0, K)`` add
  nothing.  The port of kernel B1 (``hist_fused_pallas``), as CUDA in
  ``csrc/hist_fused.cu`` (f32 and bf16) and ``csrc/hist_fused_int8.cu``
  (int8).
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
``hist_dtype="bf16sr"`` has no mode of its own: the growers round a
tree's statistics once with :func:`sr_round_bf16` and take bf16.
``"int8"`` is B1's quantized mode (:func:`quantize_int8`): each channel is
scaled to ``[-127, 127]`` by its largest magnitude over all ``n`` rows of
the call, rounded stochastically with a hash of the row index, summed
exactly in int32 and scaled back, ``f32(int32 sum) * scale`` — in CUDA in
``csrc/hist_fused_int8.cu``.  Wherever B1 or its plain version runs, int8
means that quantized contract, on either device and under ``impl="auto"``
and ``"plain"`` alike; the reference's XLA path runs int8 at full precision
on the CPU (``lightgbm_tpu/ops/histogram.py:85-87``), a fallback of
convenience the port does not copy.  The batched histograms
(:func:`compute_histograms_batched`, :func:`histograms_rows`) take int8 to
the full-precision segstats route (kernel B6 in f32 mode), as the
reference does by documented design: B5 and B6 have no quantized mode.
More than :data:`INT8_ACC_ROW_LIMIT` rows in one call raise ``ValueError``
before any launch (an int32 cell could wrap past it).

The f32 and bf16 kernels (B1, B2, B5, B6) sum in f64 in a fixed order
and round once; the plain versions accumulate in f64 and round once.  They
differ only where another f64 order changes a rounding, so they agree to
``1e-6 * sum |x|`` per cell, and exactly wherever every partial sum is
exact (dyadic statistics).  In int8 mode both sum integers exactly, so kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

_F32 = torch.float32

# int8 mode: quantized values reach |q| = 127, so an int32 cell is exact for
# up to 2^31 // 127 rows; the rows of one call bound every cell's count
INT8_ACC_ROW_LIMIT = (1 << 31) // 127          # 16,909,320
# the per-row stochastic rounding offset: a multiplicative hash of the row
# index, r = ((i * HASH_MUL + HASH_ADD) mod 2^32 >> 9) / 2^23 in [0, 1)
INT8_HASH_MUL, INT8_HASH_ADD = 2654435761, 974711


def resolve_mode(hist_dtype: str) -> str:
    """The kernels' mode for a resolved ``hist_dtype``."""
    if hist_dtype in ("f32", "f32x"):
        return "f32"
    if hist_dtype in ("bf16", "int8"):
        return hist_dtype
    raise NotImplementedError(
        f"hist_dtype={hist_dtype!r} is not ported: the histograms take "
        "'f32', 'bf16' and 'int8' ('bf16sr' is rounded by the growers, "
        "then 'bf16')")


def check_int8_rows(n: int) -> None:
    """Refuse an int8 histogram over more rows than an int32 cell holds
    exactly (before any launch)."""
    if n > INT8_ACC_ROW_LIMIT:
        raise ValueError(
            f"hist_dtype='int8' is limited to {INT8_ACC_ROW_LIMIT:,} rows "
            f"per device (got n={n:,}): quantized values reach |q|=127 and "
            "an int32 bin accumulator wraps past 2^31/127.  Use "
            "hist_dtype='bf16'.")


def quantize_int8(stats: torch.Tensor):
    """B1's int8 quantization of ``stats`` f32 ``[n, S]``: ``(q int8 [n, S],
    scale f32 [S])`` with ``scale = max(max_i |stats[i]|, 1e-30) / 127``
    over all ``n`` rows and ``q = clip(floor(stats / scale + r_i), -127,
    127)``, ``r_i`` the row index's hash in ``[0, 1)`` (unbiased:
    ``E[q] = stats / scale``)."""
    n, s = stats.shape
    st = stats.to(_F32)
    amax = (st.abs().amax(dim=0) if n else
            torch.zeros(s, dtype=_F32, device=st.device))
    tiny = torch.tensor(1e-30, dtype=_F32, device=st.device)
    # a tensor divisor: PyTorch's CUDA division by a scalar multiplies by
    # its reciprocal, which can differ from the quotient by an ulp
    scale = torch.maximum(amax, tiny) / torch.full_like(amax, 127.0)
    idx = torch.arange(n, dtype=torch.int64, device=st.device)
    h = (idx * INT8_HASH_MUL + INT8_HASH_ADD) & 0xFFFFFFFF
    r = (h >> 9).to(_F32) / float(1 << 23)
    q = torch.clamp(torch.floor(st / scale + r[:, None]), -127.0, 127.0)
    return q.to(torch.int8), scale


# hist_dtype="bf16sr": the per-element hash of sr_round_bf16
SR_HASH_MUL, SR_HASH_ADD, SR_HASH_SHIFT = 2654435761, 974711, 13


def sr_round_bf16(x: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Stochastically round f32 values to bf16-representable f32, as the
    reference's ``sr_round_bf16`` does: add a 16-bit hash of each element's
    row-major flat index to its f32 bit pattern and truncate the low 16
    bits (unbiased, idempotent on representable values); non-finite inputs,
    and values the carry would take past the largest finite, stay as they
    are.  The uint32 arithmetic runs in int64 masked to 32 bits; a
    transposed view hashes the index of its own (viewed) layout.  The
    leading ``batch_dims`` axes are not part of the hashed layout (each of
    their elements gets the same indices), as where an outer ``vmap``
    batches the reference's call."""
    x = x.to(_F32)
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    inner = x.shape[batch_dims:]
    idx = torch.arange(inner.numel(), dtype=torch.int64,
                       device=x.device).view(inner)
    h = (idx * SR_HASH_MUL + SR_HASH_ADD) & 0xFFFFFFFF
    q = (u + ((h >> SR_HASH_SHIFT) & 0xFFFF)) & 0xFFFF0000
    out = (q - ((q >> 31) << 32)).to(torch.int32).view(_F32)
    return torch.where(torch.isfinite(x) & torch.isfinite(out), out, x)


def _stats_in_mode(stats: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "bf16":
        return stats.to(torch.bfloat16).to(_F32)
    return stats


def hist_fused_plain(bins: torch.Tensor, stats: torch.Tensor,
                     seg: torch.Tensor, num_segments: int, num_bins: int,
                     mode: str = "f32") -> torch.Tensor:
    """Plain PyTorch version of :func:`hist_fused` (same contract):
    ``index_add_`` per feature into an f64 accumulator, rounded to f32; in
    int8 mode the quantized values into an int64 one, then ``f32(int32
    sum) * scale``."""
    n, f = bins.shape
    s = stats.shape[1]
    k = int(num_segments)
    int8 = mode == "int8"
    if int8:
        check_int8_rows(n)
        st, scale = quantize_int8(stats)
        acc_t = torch.int64
    else:
        st = _stats_in_mode(stats.to(_F32), mode)
        acc_t = torch.float64
    seg = seg.to(torch.int64)
    valid = (seg >= 0) & (seg < k)
    rows = torch.nonzero(valid).squeeze(1)
    acc = torch.zeros((k * f * num_bins, s), dtype=acc_t, device=bins.device)
    if rows.numel() > 0:
        st_v = st[rows].to(acc_t)
        base = seg[rows] * (f * num_bins)
        codes = bins[rows].to(torch.int64)
        for j in range(f):
            acc.index_add_(0, base + j * num_bins + codes[:, j], st_v)
    if int8:
        out = acc.to(torch.int32).to(_F32) * scale
    else:
        out = acc.to(_F32)
    return out.view(k, f, num_bins, s)


def route_wave(bins, row_leaf, slot_of_node, feat, thr, direct_left,
               n_nodes: int, cat=None, catmask=None):
    """The wave's row partition (plain PyTorch): ``(segment i64 [n],
    new_row_leaf i32 [n])`` — segment is the wave rank for rows that go to
    their split's direct child and -1 otherwise.  A row goes left iff its
    code is at most the split's threshold, or, for a categorical subset
    split (``cat`` bool ``[W]``), iff its code's bit in the split's row of
    ``catmask`` bool ``[W, B]`` is set."""
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
    if cat is not None:
        nb = catmask.shape[-1]
        bit = catmask.reshape(-1)[s_safe * nb + code.to(torch.int64)]
        go_left = torch.where(cat[s_safe], bit, go_left)
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
    mode = _batched_mode(hist_dtype)
    _check_impl(impl)
    n, e, s = stats_t.shape
    f = bins.shape[1]
    if hist_dtype != "int8" and num_segments * s >= WIDE_SEGMENT_LANES:
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
    a TPU lane-width rule, so every narrow call takes it).  int8 takes the
    narrow route at every width, at full precision (B6 in f32 mode), as the
    reference's int8 takes its XLA segstats path.  A CPU tensor takes the
    plain versions.
    """
    mode = _batched_mode(hist_dtype)
    _check_impl(impl)
    if hist_dtype != "int8" and \
            num_segments * stats.shape[2] >= WIDE_SEGMENT_LANES:
        return _batched_fused(bins, stats.contiguous(),
                              seg_id.to(torch.int32).contiguous(),
                              num_segments, num_bins, impl, mode)
    return histograms_rows(bins, stats.transpose(0, 1), seg_id.transpose(0, 1),
                           num_segments, num_bins, impl, hist_dtype)


def _batched_mode(hist_dtype: str) -> str:
    """The batched routes' mode: int8 runs at full precision there (B5 and
    B6 have no quantized mode; the reference's XLA segstats path is f32)."""
    mode = resolve_mode(hist_dtype)
    return "f32" if mode == "int8" else mode


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


# ---------------------------------------------------------------------------
# Histogram merges over a mesh (the reference's ops/histogram.py:314-513)
#
# Per-shard partial histograms ``[..., F, B, C]`` arrive as a list (one
# tensor a shard, ``parallel.mesh``) and merge by a collective.  Plain
# PyTorch on purpose: in the reference these are lax collectives, not
# Pallas kernels.  Every sum runs in a fixed order.
# ---------------------------------------------------------------------------

MERGE_MODES = ("psum", "reduce_scatter", "reduce_scatter_ring",
               "reduce_scatter_pipelined", "voting")


def histogram_psum(hists):
    """The full allreduce: every shard receives the whole merged
    histogram (:func:`histogram_merge` with ``mode="psum"``)."""
    return histogram_merge(hists, mode="psum")


def pad_feature_axis(hist: torch.Tensor, n_shards: int,
                     axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` to a multiple of ``n_shards`` (pad columns are
    all-zero histograms, masked out of every split scan)."""
    f = hist.shape[axis]
    f_pad = -(-f // n_shards) * n_shards
    if f_pad == f:
        return hist
    shape = list(hist.shape)
    shape[axis] = f_pad - f
    return torch.cat([hist, hist.new_zeros(shape)], dim=axis)


def merge_slice_width(num_features: int, n_shards: int,
                      mode: str = "reduce_scatter",
                      n_chunks: int = 1) -> int:
    """Per-shard feature-slice width a merge mode hands the scorer: F padded
    to a multiple of ``D`` (of ``D * n_chunks`` for the pipelined mode)
    over ``D``.  Size per-shard metadata with this, never ``ceil(F/D)``."""
    mult = n_shards * (n_chunks if mode == "reduce_scatter_pipelined"
                       else 1)
    f_pad = -(-num_features // mult) * mult
    return f_pad // n_shards


def ring_reduce_scatter(xs, n_shards: int, axis: int,
                        wire_dtype: str = "f32"):
    """Reduce-scatter as ``D - 1`` ring hops (``i -> i + 1``): chunk ``c``'s
    partial starts at shard ``c + 1`` and each hop adds the receiver's
    contribution, so shard ``i`` ends holding chunk ``i`` summed over all
    shards, in the owner's ``idx - 1 - k`` rotation (the reference's
    order).  ``axis`` must be padded to a shard multiple."""
    from .quantize import wire_transfer

    f_pad = xs[0].shape[axis]
    if f_pad % n_shards:
        raise ValueError("pad the feature axis first")
    f_loc = f_pad // n_shards
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def chunk(idx, k):
        return xs[idx].narrow(axis, ((idx - 1 - k) % n_shards) * f_loc,
                              f_loc)

    accs = [chunk(i, 0) for i in range(n_shards)]
    for k in range(1, n_shards):
        accs = [a + chunk(i, k) for i, a in enumerate(
            wire_transfer(accs, perm, wire_dtype, f_axis=axis))]
    return accs


def ring_reduce_scatter_pipelined(xs, n_shards: int, axis: int,
                                  n_chunks: int, wire_dtype: str = "f32"):
    """:func:`ring_reduce_scatter` split into ``n_chunks`` sub-rings along
    the feature axis, every hop ``k`` issued for all chunks before hop
    ``k + 1``; each column keeps the plain ring's rotation.  ``axis`` must
    be padded to a ``D * n_chunks`` multiple (:func:`merge_slice_width`)."""
    from .quantize import wire_transfer

    f_pad = xs[0].shape[axis]
    if f_pad % (n_shards * n_chunks):
        raise ValueError(
            "pad the feature axis to a shards*chunks multiple first")
    f_loc = f_pad // n_shards
    sub = f_loc // n_chunks
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]

    def piece(idx, c, k):
        return xs[idx].narrow(
            axis, ((idx - 1 - k) % n_shards) * f_loc + c * sub, sub)

    accs = [[piece(i, c, 0) for i in range(n_shards)]
            for c in range(n_chunks)]
    for k in range(1, n_shards):
        accs = [[a + piece(i, c, k) for i, a in enumerate(
            wire_transfer(acc_c, perm, wire_dtype, f_axis=axis))]
            for c, acc_c in enumerate(accs)]
    return [torch.cat([accs[c][i] for c in range(n_chunks)], dim=axis)
            for i in range(n_shards)]


def histogram_merge(hists, mode: str = "psum", n_shards: Optional[int] = None,
                    wire_dtype: str = "f32", n_chunks: int = 1):
    """Merge per-shard partial histograms ``[..., F, B, C]`` (a list, one a
    shard), the reference's ``histogram_merge``:

    * ``"psum"`` — every shard receives the whole merged histogram;
    * ``"reduce_scatter"`` — shard ``d`` receives its slice of F (padded to
      a shard multiple), summed in shard order;
    * ``"reduce_scatter_ring"`` — the same slices through
      :func:`ring_reduce_scatter`'s ``D - 1`` hops;
    * ``"reduce_scatter_pipelined"`` — the ring in ``n_chunks`` sub-rings
      (:func:`ring_reduce_scatter_pipelined`); F pads to a ``D * n_chunks``
      multiple.

    ``wire_dtype`` (``"f32"``/``"bf16"``/``"int8"``) compresses ring hops;
    a non-f32 wire with ``psum``/``reduce_scatter`` (no hop boundary) is a
    ``ValueError``, as in the reference.  Reduce-scatter modes return the
    local padded slices ``[..., F_pad / D, B, C]``."""
    from ..parallel.mesh import psum, psum_scatter
    from .quantize import WIRE_DTYPES

    hists = list(hists)
    n_shards = len(hists) if n_shards is None else int(n_shards)
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            f"unknown wire dtype {wire_dtype!r}; expected one of "
            f"{WIRE_DTYPES}")
    if wire_dtype != "f32" and mode in ("psum", "reduce_scatter"):
        raise ValueError(
            f"wire_dtype={wire_dtype!r} needs a ring merge mode with "
            f"explicit hop boundaries; {mode!r} is one fused collective")
    if mode == "psum":
        return psum(hists)
    axis = hists[0].dim() - 3
    if mode == "reduce_scatter_pipelined":
        n_chunks = max(int(n_chunks), 1)
        padded = [pad_feature_axis(h, n_shards * n_chunks, axis)
                  for h in hists]
        return ring_reduce_scatter_pipelined(padded, n_shards, axis,
                                             n_chunks, wire_dtype)
    padded = [pad_feature_axis(h, n_shards, axis) for h in hists]
    if mode == "reduce_scatter":
        return psum_scatter(padded, axis)
    if mode == "reduce_scatter_ring":
        return ring_reduce_scatter(padded, n_shards, axis, wire_dtype)
    raise ValueError(
        f"unknown histogram merge mode {mode!r}; expected 'psum', "
        "'reduce_scatter', 'reduce_scatter_ring', or "
        "'reduce_scatter_pipelined'")
