"""Best-split search over histograms — the port of ``lightgbm_tpu/ops/split.py``
(numeric threshold splits and categorical k-vs-rest subset splits).

A cumulative sum along the bin axis yields every candidate left partition's
(G, H, count) at once; the regularized gain is evaluated for every (feature,
bin) pair and a flat argmax picks the winner, the first occurrence on ties,
as ``jnp.argmax`` does.  :func:`find_best_split` takes a leading batch axis
where the reference ``vmap``s over the wave's children.  The arithmetic is the
reference's, op for op, in f32: the same histograms give the same winners and
bitwise the same child statistics.  With a :class:`CatInfo` the categorical
columns take LightGBM's gradient-ordered subset scan instead of thresholds
(plain PyTorch ops with no host read, as the reference computes it in XLA).
Monotone constraints (``mono``: a candidate whose clipped child outputs run
against its column's sign is invalid, and a constrained column takes no
subset split) and extra-trees (``rand_bins``: each column considers the one
scan position drawn for the node) mask candidates as the reference's scan
does, with the rounding ``arith`` picks.

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
  ``Y = (H + l2)/2 * w``;
* ``"cat"`` — the reference's scan in a program with categorical columns,
  where XLA fuses the numeric and the subset scans alike: the leaf
  objective as ``"kernel"`` contracts it, path smoothing as ``"scan"``
  (found by matching the reference's trees on exact sums; with
  ``path_smooth`` on, that program contracts the smoothing further and
  leaf values differ by ulps).

The default is ``"scan"`` for scalar regularizers and ``"kernel"`` for
per-element ones; the growers ask for ``"cat"`` when a :class:`CatInfo` is
given.
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
    if _arith(ctx, arith) in ("kernel", "cat"):
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
    parent first, then clip to ``[lo, hi]`` (the basic method's monotone
    bounds: Python floats, +-inf when unbounded, or tensors read from a
    node table) within +-max_delta_step."""
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


class CatInfo(NamedTuple):
    """Categorical split configuration of a dataset (the reference's
    ``CatInfo``): ``is_cat`` bool ``[F]`` (or ``[..., F]``, a mesh scorer's
    column pieces) marks the training columns (after
    EFB) that hold category codes; ``cat_smooth``, ``cat_l2`` and
    ``max_cat_threshold`` are upstream's regularizers of the k-vs-rest
    subset search, shared by every element of a batch."""

    is_cat: torch.Tensor
    cat_smooth: float
    cat_l2: float
    max_cat_threshold: int


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
    # categorical subset splits (None without a CatInfo)
    cat: Optional[torch.Tensor] = None       # bool [...] a k-vs-rest winner
    cat_mask: Optional[torch.Tensor] = None  # bool [..., B] bins going LEFT


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


def _cumsum_bins(hist: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``hist [..., F, B, 3]`` along the bin axis,
    in the reference's ``jnp.cumsum`` order (:func:`prefix_sum`)."""
    return prefix_sum(hist.transpose(-1, -2)).transpose(-1, -2)


def _masked_gain(cum, total, ctx_gain: SplitContext, ctx_valid: SplitContext,
                 p_out, lo, hi, arith, ok, mono=None):
    """Gain ``[..., F, B]`` of every prefix of ``cum`` (the left child's
    statistics; the right is ``total`` minus it) under ``ctx_gain``, -inf
    where ``ctx_valid``'s data checks or ``ok`` fail, or where the clipped
    outputs run against ``mono`` (f32 ``[F, 1]`` of -1/0/+1, None: off);
    returns ``(gain, wl, wr)``."""
    lg, lh, lc = cum[..., 0], cum[..., 1], cum[..., 2]
    tg, th, tc = total[..., 0], total[..., 1], total[..., 2]
    rg, rh, rc = tg - lg, th - lh, tc - lc
    gain, wl, wr = split_gain_scan(lg, lh, lc, rg, rh, rc, tg, th, ctx_gain,
                                   lo, hi, p_out, arith)
    valid = split_stats_valid(lc, rc, lh, rh, gain, ctx_valid) & ok
    if mono is not None:
        valid = valid & ((mono == 0) | (mono * (wr - wl) >= 0))
    return torch.where(valid, gain, _c(NEG_INF, gain)), wl, wr


def _scan(hist: torch.Tensor, ctx: SplitContext, feature_mask, depth_ok,
          parent_out, lo=None, hi=None, arith=None, mono=None,
          rand_bins=None):
    """Shared cumsum scan over ``hist [..., F, B, 3]``: masked gain
    ``[..., F, B]`` plus the operands the winner gathers need.  ``mono``
    (int ``[F]``) and ``rand_bins`` (int ``[..., F]``) as for
    :func:`find_best_split`."""
    ctx = ctx.broadcast_to(hist.dim() - 1)
    cum = _cumsum_bins(hist)
    total = cum[..., -1:, :]                            # [..., F, 1, 3]
    if parent_out is None:
        p_out = leaf_output(total[..., 0], total[..., 1], ctx)  # [..., F, 1]
    else:
        p_out = parent_out.reshape(parent_out.shape + (1, 1))
    lo = float("-inf") if lo is None else lo.reshape(lo.shape + (1, 1))
    hi = float("inf") if hi is None else hi.reshape(hi.shape + (1, 1))
    ok = feature_mask[..., :, None] > 0
    if depth_ok is not None:
        ok = ok & depth_ok.reshape(depth_ok.shape + (1, 1))
    if rand_bins is not None:
        # extra-trees: each column's one drawn position (in the subset scan,
        # a position of the sorted order)
        pos = torch.arange(hist.shape[-2], device=hist.device)
        ok = ok & (pos == rand_bins.to(hist.device)[..., None])
    m = None
    if mono is not None:
        # [F, 1], or [..., F, 1] for per-node columns (a voting candidate
        # set gathers each node's own)
        m = mono.to(device=hist.device, dtype=_F32)[..., None]
    gain, wl, wr = _masked_gain(cum, total, ctx, ctx, p_out, lo, hi, arith,
                                ok, m)
    return gain, cum, total, wl, wr, (ctx, p_out, lo, hi, ok, m)


def feature_best_gains(hist, ctx: SplitContext, feature_mask, depth_ok=None,
                       parent_out=None, lo=None, hi=None, mono=None,
                       rand_bins=None) -> torch.Tensor:
    """Per-feature best numeric split gain ``[..., F]`` over ``hist [...,
    F, B, 3]`` (invalid candidates score -inf); the arguments as
    :func:`find_best_split`'s."""
    gain = _scan(hist, ctx, feature_mask, depth_ok, parent_out, lo, hi,
                 None, mono, rand_bins)[0]
    return gain.max(dim=-1).values


def _cat_scan(hist, cat_info: CatInfo, total, gain_num, parts, parent_out,
              arith):
    """The reference's k-vs-rest subset scan over the categorical columns.

    Bins are ranked by ``g / (h + cat_smooth)`` (``+inf`` for bins with no
    rows, so they fall to the right child), ascending and descending on
    ``-g / (h + cat_smooth)``, each by a stable sort as ``jnp.argsort`` is;
    the usual prefix scan then runs in each order with ``lambda_l2 +
    cat_l2`` in the gain (the base regularizers decide validity) and a
    prefix of at most ``max_cat_threshold`` bins.  The descending scan wins
    a candidate only where its gain is strictly greater.  Both directions
    run as one batch on a leading axis of 2 (ascending first).  Returns the
    combined gain ``[..., F, B]`` (categorical columns take only subset
    splits, numeric ones only thresholds), where the descending scan won,
    and the operands the winner gathers need, ``(order, cum, wl, wr)``,
    each ``[2, ...]``."""
    ctx, p_out, lo, hi, ok, m = parts
    num_bins = hist.shape[-2]
    if isinstance(ctx.lambda_l2, torch.Tensor):
        l2_cat = ctx.lambda_l2 + _c(cat_info.cat_l2, ctx.lambda_l2)
    else:
        l2_cat = float(np.float32(ctx.lambda_l2)
                       + np.float32(cat_info.cat_l2))
    ctx_cat = ctx._replace(lambda_l2=l2_cat)
    p_out_cat = (leaf_output(total[..., 0], total[..., 1], ctx_cat)
                 if parent_out is None else p_out)
    g_, h_, c_ = hist[..., 0], hist[..., 1], hist[..., 2]
    raw_score = g_ / (h_ + _c(cat_info.cat_smooth, h_))
    inf = _c(float("inf"), raw_score)
    pos = torch.arange(num_bins, device=hist.device)
    ok_cat = ok & (pos < int(cat_info.max_cat_threshold))
    if m is not None:
        # a category set has no order to be monotone in: a constrained
        # column takes no subset split
        ok_cat = ok_cat & (m == 0)

    key = torch.where(c_ > 0, torch.stack([raw_score, -raw_score]), inf)
    order = torch.argsort(key, dim=-1, stable=True)           # [2, ..., F, B]
    shape2 = (2,) + hist.shape
    hist_s = torch.gather(hist.expand(shape2), -2,
                          order.unsqueeze(-1).expand(shape2))
    cum_s = _cumsum_bins(hist_s)
    gain, wl, wr = _masked_gain(cum_s, total, ctx_cat, ctx, p_out_cat, lo,
                                hi, arith, ok_cat)
    use_desc = gain[1] > gain[0]
    gain_all = torch.where(cat_info.is_cat.to(hist.device)[..., None],
                           torch.maximum(gain[0], gain[1]), gain_num)
    return gain_all, use_desc, (order, cum_s, wl, wr)


def find_best_split(hist: torch.Tensor, ctx: SplitContext,
                    feature_mask: torch.Tensor,
                    depth_ok: Optional[torch.Tensor] = None,
                    parent_out: Optional[torch.Tensor] = None,
                    lo: Optional[torch.Tensor] = None,
                    hi: Optional[torch.Tensor] = None,
                    arith: Optional[str] = None,
                    cat_info: Optional[CatInfo] = None,
                    mono: Optional[torch.Tensor] = None,
                    rand_bins: Optional[torch.Tensor] = None) -> BestSplit:
    """Scan histograms ``[..., F, B, 3]`` of (grad, hess, count) for each
    leaf's best (feature, bin) split.

    ``feature_mask`` is f32 ``[..., F]`` (1 = usable), ``depth_ok`` bool
    ``[...]`` (False disqualifies every split) and ``parent_out`` f32
    ``[...]`` the node's actual output (the gain baseline and the smoothing
    anchor; defaults to the unconstrained optimum); ``lo``/``hi`` f32
    ``[...]`` bound the child outputs (unbounded when None); ``arith``
    picks the rounding (module docstring).  A context of
    per-element tensors ``[E]`` applies element ``e``'s regularizers to
    ``hist[e]``.  With ``cat_info`` the categorical columns take the
    k-vs-rest subset scan (:func:`_cat_scan`), and the result's ``cat``
    flags a subset winner whose left bins are ``cat_mask`` (the bins whose
    rank in the winning order is at most ``bin``).  ``mono`` int ``[F]``
    (-1/0/+1, None: off) rejects a candidate whose clipped child outputs
    run against its column's sign, ``sign * (wr - wl) < 0`` (upstream's
    basic method), and gives a constrained column no subset split;
    ``rand_bins`` int ``[..., F]`` (None: off) keeps only the one scan
    position drawn for each column (``extra_trees``).  Every field of the
    result has the leading shape ``[...]``.
    """
    gain, cum, total, wl, wr, parts = _scan(hist, ctx, feature_mask,
                                            depth_ok, parent_out, lo, hi,
                                            arith, mono, rand_bins)
    if cat_info is not None:
        gain, use_desc, (order, cum_s, wl_s, wr_s) = _cat_scan(
            hist, cat_info, total, gain, parts, parent_out, arith)
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
    tot = torch.gather(total.reshape(lead + (num_features, 3)), -2,
                       feat.unsqueeze(-1).unsqueeze(-1).expand(lead + (1, 3))
                       ).squeeze(-2)
    g = idx.unsqueeze(-1)

    def winner(cum_x, wl_x, wr_x):
        """The left child's (g, h, c) and both outputs at ``idx``: one
        gather from the contiguous ``[..., F*B, 3]`` view."""
        cum_flat = cum_x.reshape(lead + (num_features * num_bins, 3))
        win_l = torch.gather(cum_flat, -2,
                             g.unsqueeze(-1).expand(lead + (1, 3))).squeeze(-2)
        wl_b = wl_x.expand(gain.shape).reshape(flat.shape)
        wr_b = wr_x.expand(gain.shape).reshape(flat.shape)
        return (win_l, torch.gather(wl_b, -1, g).squeeze(-1),
                torch.gather(wr_b, -1, g).squeeze(-1))

    win_l, out_l, out_r = winner(cum, wl, wr)
    cat = cat_mask = None
    if cat_info is not None:
        # take, not indexing: a 0-d index would be read back to the host
        is_cat = cat_info.is_cat.to(hist.device)
        if is_cat.dim() == 1:
            cat = torch.take(is_cat, feat)
        else:
            cat = is_cat.expand(lead + (num_features,)).gather(
                -1, feat.unsqueeze(-1)).squeeze(-1)
        desc_won = torch.gather(use_desc.reshape(flat.shape), -1,
                                g).squeeze(-1)
        va = winner(cum_s[0], wl_s[0], wr_s[0])
        vd = winner(cum_s[1], wl_s[1], wr_s[1])
        c3, d3 = cat.unsqueeze(-1), desc_won.unsqueeze(-1)
        win_l = torch.where(c3, torch.where(d3, vd[0], va[0]), win_l)
        out_l = torch.where(cat, torch.where(desc_won, vd[1], va[1]), out_l)
        out_r = torch.where(cat, torch.where(desc_won, vd[2], va[2]), out_r)
        fidx = feat.reshape(lead + (1, 1)).expand(lead + (1, num_bins))
        order_f = torch.where(desc_won.unsqueeze(-1),
                              torch.gather(order[1], -2, fidx).squeeze(-2),
                              torch.gather(order[0], -2, fidx).squeeze(-2))
        # each bin's rank in the winning order (argsort of the order)
        rank = torch.empty_like(order_f).scatter_(
            -1, order_f, torch.arange(num_bins, device=hist.device).expand(
                order_f.shape))
        cat_mask = cat.unsqueeze(-1) & (rank <= bin_idx.unsqueeze(-1))
    win_r = tot - win_l
    return BestSplit(
        gain=best.values, feature=feat, bin=bin_idx,
        left_g=win_l[..., 0], left_h=win_l[..., 1], left_c=win_l[..., 2],
        right_g=win_r[..., 0], right_h=win_r[..., 1], right_c=win_r[..., 2],
        left_out=out_l, right_out=out_r, cat=cat, cat_mask=cat_mask)
