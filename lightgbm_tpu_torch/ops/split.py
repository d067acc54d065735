"""Best-split search over histograms — the port of ``lightgbm_tpu/ops/split.py``
(numeric splits).

A cumulative sum along the bin axis yields every candidate left partition's
(G, H, count) at once; the regularized gain is evaluated for every (feature,
bin) pair and a flat argmax picks the winner, the first occurrence on ties,
as ``jnp.argmax`` does.  :func:`find_best_split` takes a leading batch axis
where the reference ``vmap``s over the wave's children.  The arithmetic is the
reference's, op for op, in f32: the same histograms give the same winners and
bitwise the same child statistics.  Categorical subset splits, monotone
constraints and extra-trees are out of this slice.

"Op for op" includes rounding: the reference's XLA program on the CPU fuses
``a * b + c`` into one fused multiply-add where LLVM contracts it, so the
port rounds those sums once too (:func:`fma`).  Where it contracts depends
on the program, so the scan has two roundings (``arith``):

* ``"scan"`` — the reference's XLA split scan (the wave grower, the strict
  grower's root): path smoothing ``fma(parent, 1 - f, w * f)``, the leaf
  objective unfused;
* ``"kernel"`` — the reference's split-iteration kernel as compiled on the
  CPU (the strict grower's iterations, kernel B3's contract): the stored
  outputs' smoothing ``fma(w, f, parent * (1 - f))``, the gain's
  ``fma(parent, 1 - f, w * f)`` (XLA recomputes the outputs there), the
  objective's ``G*w + Y*w`` as ``fma(Y, w, G*w)`` with
  ``Y = (H + l2)/2 * w``.

The default is ``"scan"`` for scalar regularizers and ``"kernel"`` for
per-element ones.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

_F32 = torch.float32
NEG_INF = float("-inf")


class SplitContext(NamedTuple):
    """Regularization scalars: Python floats (rounded to f32 on use), or
    per-element f32 tensors ``[E]`` when a leading axis of ``E`` elements
    (configs x folds) is scanned at once (:meth:`per_element`).

    ``max_delta_step`` (<= 0 means unlimited) caps |leaf output|;
    ``path_smooth`` > 0 shrinks child outputs toward the parent's value by
    ``n / (n + path_smooth)``.  With per-element tensors both switches are
    decided per element on the device, as the reference's traced
    ``jnp.where`` decides them; each element's result equals what its
    scalar context gives.
    """

    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: float
    min_sum_hessian: float
    min_gain_to_split: float
    max_delta_step: float = 0.0
    path_smooth: float = 0.0

    @staticmethod
    def from_params(p) -> "SplitContext":
        return SplitContext(
            lambda_l1=float(p.lambda_l1),
            lambda_l2=float(p.lambda_l2),
            min_data_in_leaf=float(p.min_data_in_leaf),
            min_sum_hessian=float(p.min_sum_hessian_in_leaf),
            min_gain_to_split=float(p.min_gain_to_split),
            max_delta_step=float(p.max_delta_step),
            path_smooth=float(getattr(p, "path_smooth", 0.0)),
        )

    @staticmethod
    def per_element(ctxs, device) -> "SplitContext":
        """Stack scalar contexts into one of f32 ``[E]`` tensors."""
        return SplitContext(*(
            torch.tensor([float(c[i]) for c in ctxs], dtype=_F32,
                         device=device)
            for i in range(len(SplitContext._fields))))

    def broadcast_to(self, ndim: int) -> "SplitContext":
        """Per-element fields reshaped ``[E, 1, ...]`` to broadcast over
        arrays of ``ndim`` dims that lead with the element axis."""
        return SplitContext(*(
            v.reshape((-1,) + (1,) * (ndim - 1))
            if isinstance(v, torch.Tensor) else v for v in self))


@functools.lru_cache(maxsize=256)
def _scalar(value: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=_F32, device=device)


def _c(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar as an f32 tensor on ``like``'s device (the reference's
    ``jnp.float32`` scalars).  Cached per value and device, so the scan
    copies no scalar to the card per call; callers never write to it.  A
    per-element tensor passes through as it is."""
    if isinstance(value, torch.Tensor):
        return value
    return _scalar(float(value), like.device)


def _on(value: float) -> bool:
    """Whether a regularizer is on, decided on the host as the reference's
    ``jnp.float32(value) > 0`` does."""
    return bool(np.float32(value) > 0)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32, as a fused multiply-add rounds it
    (the f32 product is exact in f64, so only the sum rounds, and rounding
    an f64 sum to f32 lands on the fused result but for double-rounding ties
    of probability ~2**-29)."""
    return (a.double() * b.double() + c.double()).float()


def threshold_l1(g: torch.Tensor, l1) -> torch.Tensor:
    """Soft-threshold for L1 regularization (LightGBM ThresholdL1)."""
    return torch.sign(g) * torch.clamp(torch.abs(g) - _c(l1, g), min=0.0)


def leaf_output(sum_g, sum_h, ctx: SplitContext):
    """Optimal leaf value: -ThresholdL1(G) / (H + lambda_l2)."""
    return -threshold_l1(sum_g, ctx.lambda_l1) / (
        sum_h + _c(ctx.lambda_l2, sum_h) + _c(1e-15, sum_h))


def _arith(ctx: SplitContext, arith: Optional[str]) -> str:
    if arith is not None:
        return arith
    return "kernel" if isinstance(ctx.path_smooth, torch.Tensor) else "scan"


def leaf_objective_at(w, sum_g, sum_h, ctx: SplitContext,
                      arith: Optional[str] = None):
    """Objective contribution of a leaf forced to output ``w``:
    -2 * (G*w + (H + l2)/2 * w^2 + l1*|w|)."""
    l2 = _c(ctx.lambda_l2, sum_h)
    l1 = _c(ctx.lambda_l1, sum_h)
    if _arith(ctx, arith) == "kernel":
        y = 0.5 * (sum_h + l2) * w
        return -2.0 * (fma(y, w, sum_g * w) + l1 * torch.abs(w))
    return -2.0 * (sum_g * w + 0.5 * (sum_h + l2) * w * w
                   + l1 * torch.abs(w))


def _smooth(w, count, parent_out, ps, like, arith: str):
    """``w * factor + parent_out * (1 - factor)`` in the rounding of
    ``arith`` (see the module docstring)."""
    factor = count / (count + torch.maximum(ps, _c(1e-30, like)))
    if arith == "kernel":
        return fma(w, factor, parent_out * (1.0 - factor))
    return fma(parent_out, 1.0 - factor, w * factor)


def constrained_leaf_output(sum_g, sum_h, count, ctx: SplitContext,
                            lo, hi, parent_out, arith: Optional[str] = None):
    """Leaf output under path smoothing and max_delta_step: smooth toward the
    parent first, then clip to ``[lo, hi]`` (the monotone bounds, +-inf on
    this slice's path: Python floats, or tensors read from a node table)
    within +-max_delta_step."""
    arith = _arith(ctx, arith)
    w = leaf_output(sum_g, sum_h, ctx)
    ps, mds = ctx.path_smooth, ctx.max_delta_step
    if isinstance(ps, torch.Tensor) or isinstance(mds, torch.Tensor) \
            or isinstance(lo, torch.Tensor):
        ps, mds = _c(ps, sum_g), _c(mds, sum_g)
        w = torch.where(ps > 0, _smooth(w, count, parent_out, ps, sum_g,
                                        arith), w)
        cap = torch.where(mds > 0, mds, _c(float("inf"), mds))
        lo_t = torch.maximum(_c(lo, w), -cap)
        hi_t = torch.minimum(_c(hi, w), cap)
        return torch.minimum(torch.maximum(w, lo_t), hi_t)
    if _on(ps):
        w = _smooth(w, count, parent_out, _c(ps, sum_g), sum_g, arith)
    cap = float(np.float32(mds)) if _on(mds) else float("inf")
    return torch.minimum(torch.maximum(w, _c(max(lo, -cap), w)),
                         _c(min(hi, cap), w))


def split_gain_scan(lg, lh, lc, rg, rh, rc, tg, th, ctx: SplitContext,
                    lo, hi, p_out, arith: Optional[str] = None):
    """Regularized gain over the cumsum arrays; returns (gain, wl, wr)."""
    arith = _arith(ctx, arith)
    wl = constrained_leaf_output(lg, lh, lc, ctx, lo, hi, p_out, arith)
    wr = constrained_leaf_output(rg, rh, rc, ctx, lo, hi, p_out, arith)
    gl, gr = wl, wr
    if arith == "kernel":
        # the split-iteration kernel's XLA program recomputes the smoothed
        # outputs inside the gain and contracts them there as the scan does
        gl = constrained_leaf_output(lg, lh, lc, ctx, lo, hi, p_out, "scan")
        gr = constrained_leaf_output(rg, rh, rc, ctx, lo, hi, p_out, "scan")
    parent_obj = leaf_objective_at(p_out, tg, th, ctx, arith)
    gain = (leaf_objective_at(gl, lg, lh, ctx, arith)
            + leaf_objective_at(gr, rg, rh, ctx, arith) - parent_obj)
    return gain, wl, wr


def split_stats_valid(lc, rc, lh, rh, gain, ctx: SplitContext):
    """Data-driven validity mask (min_data / min_hessian / min_gain)."""
    return ((lc >= _c(ctx.min_data_in_leaf, lc))
            & (rc >= _c(ctx.min_data_in_leaf, rc))
            & (lh >= _c(ctx.min_sum_hessian, lh))
            & (rh >= _c(ctx.min_sum_hessian, rh))
            & (gain > _c(ctx.min_gain_to_split, gain)))


class BestSplit(NamedTuple):
    gain: torch.Tensor      # f32 [...] best gain (-inf if no valid split)
    feature: torch.Tensor   # i64 [...]
    bin: torch.Tensor       # i64 [...] go left iff code <= bin
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_c: torch.Tensor
    right_g: torch.Tensor
    right_h: torch.Tensor
    right_c: torch.Tensor
    left_out: torch.Tensor
    right_out: torch.Tensor


_SCAN_BLOCK = 16


def _running_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, one f32 add at a time."""
    outs = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        outs.append(outs[-1] + x[..., i])
    return torch.stack(outs, dim=-1)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in the order the
    reference's ``jnp.cumsum`` adds on the CPU: XLA rewrites the scan into
    blocks of 16 (a running sum inside each block, plus the running sum of
    the preceding blocks' totals, recursively), so every partial sum rounds
    exactly as there and the same histograms pick the same winners."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _running_sum(x)
    nb = -(-n // _SCAN_BLOCK)
    pad = nb * _SCAN_BLOCK - n
    xp = torch.nn.functional.pad(x, (0, pad)) if pad else x
    within = _running_sum(xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    inc = prefix_sum(within[..., -1])
    before = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], -1)
    out = within + before[..., None]
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _scan(hist: torch.Tensor, ctx: SplitContext, feature_mask, depth_ok,
          parent_out, lo=None, hi=None, arith=None):
    """Shared cumsum scan over ``hist [..., F, B, 3]``: masked gain
    ``[..., F, B]`` plus the operands the winner gathers need."""
    ctx = ctx.broadcast_to(hist.dim() - 1)
    cum = prefix_sum(hist.transpose(-1, -2)).transpose(-1, -2)
    total = cum[..., -1:, :]                            # [..., F, 1, 3]
    lg, lh, lc = cum[..., 0], cum[..., 1], cum[..., 2]
    tg, th, tc = total[..., 0], total[..., 1], total[..., 2]
    rg, rh, rc = tg - lg, th - lh, tc - lc
    if parent_out is None:
        p_out = leaf_output(tg, th, ctx)                # [..., F, 1]
    else:
        p_out = parent_out.reshape(parent_out.shape + (1, 1))
    lo = float("-inf") if lo is None else lo.reshape(lo.shape + (1, 1))
    hi = float("inf") if hi is None else hi.reshape(hi.shape + (1, 1))
    gain, wl, wr = split_gain_scan(lg, lh, lc, rg, rh, rc, tg, th, ctx,
                                   lo, hi, p_out, arith)
    valid = (split_stats_valid(lc, rc, lh, rh, gain, ctx)
             & (feature_mask[..., :, None] > 0))
    if depth_ok is not None:
        valid = valid & depth_ok.reshape(depth_ok.shape + (1, 1))
    gain = torch.where(valid, gain, _c(NEG_INF, gain))
    return gain, cum, total, wl, wr


def feature_best_gains(hist, ctx: SplitContext, feature_mask, depth_ok=None,
                       parent_out=None) -> torch.Tensor:
    """Per-feature best numeric split gain ``[..., F]`` over ``hist [...,
    F, B, 3]`` (invalid candidates score -inf)."""
    gain = _scan(hist, ctx, feature_mask, depth_ok, parent_out)[0]
    return gain.max(dim=-1).values


def find_best_split(hist: torch.Tensor, ctx: SplitContext,
                    feature_mask: torch.Tensor,
                    depth_ok: Optional[torch.Tensor] = None,
                    parent_out: Optional[torch.Tensor] = None,
                    lo: Optional[torch.Tensor] = None,
                    hi: Optional[torch.Tensor] = None,
                    arith: Optional[str] = None) -> BestSplit:
    """Scan histograms ``[..., F, B, 3]`` of (grad, hess, count) for each
    leaf's best (feature, bin) split.

    ``feature_mask`` is f32 ``[..., F]`` (1 = usable), ``depth_ok`` bool
    ``[...]`` (False disqualifies every split) and ``parent_out`` f32
    ``[...]`` the node's actual output (the gain baseline and the smoothing
    anchor; defaults to the unconstrained optimum); ``lo``/``hi`` f32
    ``[...]`` bound the child outputs (unbounded when None); ``arith``
    picks the rounding (module docstring).  A context of
    per-element tensors ``[E]`` applies element ``e``'s regularizers to
    ``hist[e]``.  Every field of the result has the leading shape ``[...]``.
    """
    gain, cum, total, wl, wr = _scan(hist, ctx, feature_mask, depth_ok,
                                     parent_out, lo, hi, arith)
    lead = gain.shape[:-2]
    num_features, num_bins = gain.shape[-2:]
    flat = gain.reshape(lead + (num_features * num_bins,))
    best = flat.max(dim=-1)
    # first occurrence of the max (jnp.argmax's tie-break); an all -inf
    # row yields index 0, as jnp.argmax does
    is_max = flat == best.values.unsqueeze(-1)
    idx = torch.argmax(is_max.to(torch.uint8), dim=-1)
    feat = idx // num_bins
    bin_idx = idx % num_bins
    g = idx.unsqueeze(-1)
    cum_flat = cum.reshape(lead + (num_features * num_bins, 3))
    win_l = torch.gather(cum_flat, -2,
                         g.unsqueeze(-1).expand(lead + (1, 3))).squeeze(-2)
    tot = torch.gather(total.reshape(lead + (num_features, 3)), -2,
                       feat.unsqueeze(-1).unsqueeze(-1).expand(lead + (1, 3))
                       ).squeeze(-2)
    win_r = tot - win_l
    wl_b = wl.expand(gain.shape).reshape(flat.shape)
    wr_b = wr.expand(gain.shape).reshape(flat.shape)
    return BestSplit(
        gain=best.values, feature=feat, bin=bin_idx,
        left_g=win_l[..., 0], left_h=win_l[..., 1], left_c=win_l[..., 2],
        right_g=win_r[..., 0], right_h=win_r[..., 1], right_c=win_r[..., 2],
        left_out=torch.gather(wl_b, -1, g).squeeze(-1),
        right_out=torch.gather(wr_b, -1, g).squeeze(-1))
