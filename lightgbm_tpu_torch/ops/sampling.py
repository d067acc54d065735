"""Bagging and feature sampling — the port of ``lightgbm_tpu/ops/sampling.py``.

LightGBM semantics, as in the reference:

* bagging picks exactly ``floor(fraction * n_valid)`` rows, without
  replacement, from the currently valid rows;
* feature sampling picks ``max(1, round(fraction * n_avail))`` columns from
  the available set;
* ``fraction >= 1`` is a no-op (mask passthrough).

GOSS (Ke et al., NeurIPS 2017): :func:`goss_weights` re-weights rows
(multiclass) and :func:`goss_select` picks and compacts a single-class
round's rows; both select by :func:`approx_top_mask`, which reads nothing
back to the host.

The random draws come from :mod:`~lightgbm_tpu_torch.utils.random`, which
reproduces ``jax.random`` bit for bit, and every step below is the
reference's f32 arithmetic op by op (sorts are stable), so both packages draw
the same masks from the same keys.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.random import Key, fold_in, uniform, uniform_rows
from .split import fma

_F32 = torch.float32


_ONE_PLUS = float(np.float32(1.0 + 1e-6))


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(float(value), dtype=_F32, device=device)


def approx_top_mask(x: torch.Tensor, valid: torch.Tensor, k,
                    num_buckets: int = 2048, passes: int = 2
                    ) -> torch.Tensor:
    """bool ``[n]``: (approximately) the ``k`` largest valid ``x >= 0``,
    selecting exactly ``min(k, n_valid)`` rows by iterative histogram
    refinement (the reference's sort-free selection): bucket ``[lo, hi)``
    into ``num_buckets``, narrow to the bucket holding the k-th value, repeat;
    rows above the final bucket are all taken and rows inside it fill the
    remainder in row order.  ``k`` is an int or an integer tensor on ``x``'s
    device; one row of :func:`approx_top_mask_rows`, with no host read."""
    if not isinstance(k, torch.Tensor):
        k = torch.full((), int(k), dtype=torch.int64, device=x.device)
    return approx_top_mask_rows(x[None], valid[None], k.reshape(1),
                                num_buckets, passes)[0]


def sample_bag(key: Key, row_mask: torch.Tensor, fraction: float,
               n_valid: float) -> torch.Tensor:
    """Exact-count row bag within ``row_mask`` (f32 ``[n]`` in-bag
    indicator; passthrough when ``fraction >= 1``)."""
    dev = row_mask.device
    u = uniform(key, row_mask.shape[0], dev)
    valid = row_mask > 0
    frac = np.float32(fraction)
    k = int(np.floor(frac * np.float32(n_valid)))
    if not (k > 0 and frac < 1.0):
        return valid.to(_F32)
    # uniform keys have no heavy tail, so one refinement pass suffices
    take = approx_top_mask(torch.where(valid, 1.0 - u, 0.0), valid, k,
                           passes=1)
    return take.to(_F32)


def goss_amplification(top_rate: float, other_rate: float) -> float:
    """The sampled rows' weight ``(1 - a) / max(b, 1e-12)``, in f32 as the
    reference computes it from its f32 scalars."""
    a, b = np.float32(top_rate), np.float32(other_rate)
    return float((np.float32(1.0) - a) / np.maximum(b, np.float32(1e-12)))


def goss_weights(key: Key, g_abs: torch.Tensor, row_mask: torch.Tensor,
                 top_rate: float, other_rate: float,
                 n_valid: torch.Tensor) -> torch.Tensor:
    """GOSS row weighting (LightGBM ``GOSSStrategy::Bagging``): keep the
    ``floor(top_rate * n_valid)`` rows of largest ``|g|``, sample
    ``floor(other_rate * n_valid)`` of the other valid rows by ``1 - u``,
    and weight the sampled rows by :func:`goss_amplification`.

    ``n_valid`` is an f32 device scalar (the sum of the bag), so the counts
    are f32 products as in the reference, and nothing is read back to the
    host.  Returns f32 ``[n]`` weights (0 = dropped); ``row_mask``'s valid
    indicator when ``top_rate + other_rate >= 1``."""
    valid = row_mask > 0
    if np.float32(top_rate) + np.float32(other_rate) >= 1.0:
        return valid.to(_F32)
    a, b = float(np.float32(top_rate)), float(np.float32(other_rate))
    top_k = torch.floor(n_valid * a).to(torch.int64)
    other_k = torch.floor(n_valid * b).to(torch.int64)
    is_top = approx_top_mask(g_abs.abs(), valid, top_k)
    rest = valid & ~is_top
    u = uniform(key, row_mask.shape[0], row_mask.device)
    sampled = approx_top_mask(torch.where(rest, 1.0 - u, 0.0), rest, other_k)
    return is_top.to(_F32) + sampled.to(_F32) * goss_amplification(
        top_rate, other_rate)


def approx_top_mask_rows(x: torch.Tensor, valid: torch.Tensor,
                         k: torch.Tensor, num_buckets: int = 2048,
                         passes: int = 2) -> torch.Tensor:
    """:func:`approx_top_mask` for each row of ``x`` ``[E, n]`` with its own
    ``k`` (int64 ``[E]``), on the device (the reference's ``vmap`` of it).
    Nothing is read back to the host: ``k_eff``, the bucket ``tb`` and the
    range ``[lo, hi)`` stay device tensors, as in the reference's traced
    code."""
    dev = x.device
    e, n = x.shape
    valid = valid > 0 if valid.dtype != torch.bool else valid
    x = torch.where(valid, x, 0.0)
    lo = torch.zeros(e, dtype=_F32, device=dev)
    hi = torch.clamp(x.max(dim=1).values, min=1e-30) * _ONE_PLUS
    span = hi
    offsets = (torch.arange(e, device=dev) * num_buckets)[:, None]
    for p in range(passes):
        w = torch.clamp(span / num_buckets, min=1e-38)
        in_rng = valid & (x >= lo[:, None]) & (x < hi[:, None])
        code = ((x - lo[:, None]) / w[:, None]).to(torch.int32).clamp(
            0, num_buckets - 1)
        hist = torch.zeros(e * num_buckets, dtype=torch.int64, device=dev)
        hist.index_add_(0, (code.to(torch.int64) + offsets).reshape(-1),
                        in_rng.reshape(-1).to(torch.int64))
        cnt_ge = hist.view(e, num_buckets).flip(1).cumsum(1).flip(1)
        k_eff = k - (valid & (x >= hi[:, None])).sum(dim=1)
        tb = ((cnt_ge >= k_eff[:, None]).sum(dim=1) - 1).clamp(min=0).to(
            _F32)
        # the reference's jitted selection contracts lo + tb * w into a
        # fused multiply-add, and after the first pass (lo the constant 0)
        # also hi - lo = (tb + 1) * w - lo; rounding each once on every
        # device keeps the card's selection equal to the CPU's and to the
        # reference's
        lo, hi = fma(tb, w, lo), fma(tb + 1.0, w, lo)
        span = fma(tb + 1.0, w, -lo) if p == 0 else hi - lo
    above = valid & (x >= hi[:, None])
    sel_a = above & (above.to(torch.int64).cumsum(1) <= k[:, None])
    k_in = k - torch.minimum(above.sum(dim=1), k)
    inb = valid & (x >= lo[:, None]) & ~above
    return sel_a | (inb & (inb.to(torch.int64).cumsum(1) <= k_in[:, None]))


def sample_bag_rows(keys: torch.Tensor, row_mask: torch.Tensor,
                    fraction: torch.Tensor, n_valid: torch.Tensor
                    ) -> torch.Tensor:
    """Batched :func:`sample_bag` (the reference's ``vmap(sample_bag)``):
    int64 keys ``[E, 2]``, f32 ``row_mask [E, n]``, ``fraction [E]`` and
    ``n_valid [E]`` on one device -> f32 ``[E, n]``.  ``k = floor(fraction
    * n_valid)`` is taken in f32, as the traced reference takes it."""
    u = uniform_rows(keys, row_mask.shape[1])
    valid = row_mask > 0
    k = torch.floor(fraction.to(_F32) * n_valid.to(_F32)).to(torch.int64)
    take = approx_top_mask_rows(torch.where(valid, 1.0 - u, 0.0), valid, k,
                                passes=1)
    on = (k > 0) & (fraction < 1.0)
    return torch.where(on[:, None], take, valid).to(_F32)


def _compact_idx(mask: torch.Tensor, k: int):
    """The rows of ``mask`` in ascending order in a static ``[k]`` buffer
    (int64), and which slots were filled (f32 ``[k]``); unfilled slots point
    at row 0."""
    n, dev = mask.shape[0], mask.device
    pos = mask.to(torch.int64).cumsum(0) - 1
    slot = torch.where(mask & (pos < k), pos, k)
    idx = torch.zeros(k + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(n, device=dev))
    filled = torch.arange(k, device=dev) < mask.sum()
    return idx[:k], filled.to(_F32)


def goss_select(key: Key, g: torch.Tensor, bag: torch.Tensor,
                goss_k: Tuple[int, int], top_rate: float, other_rate: float):
    """The compacted GOSS selection of one single-class round (the
    reference's ``_goss_compact_round`` up to the tree): the ``k_top`` rows
    of largest ``|g|`` in ascending row order, then ``k_other`` of the other
    in-bag rows sampled by ``1 - uniform(fold_in(key, 0x7FFFFFFF))``.

    Returns ``(idx, wt, live)``: int64 row ids ``[k_top + k_other]``, their
    f32 weights (1 for a top row, :func:`goss_amplification` for a sampled
    one) and the f32 count indicator; a slot left unfilled points at row 0
    with weight and count 0.  The order of ``idx`` is the histograms'
    summation order.  Nothing is read back to the host."""
    k_top, k_other = goss_k
    valid = bag > 0
    is_top = approx_top_mask(torch.where(valid, g.abs(), 0.0), valid, k_top)
    rest = valid & ~is_top
    u = uniform(fold_in(key, 0x7FFFFFFF), bag.shape[0], bag.device)
    sampled = approx_top_mask(torch.where(rest, 1.0 - u, 0.0), rest,
                              k_other)
    top_idx, top_fill = _compact_idx(is_top, k_top)
    other_idx, other_fill = _compact_idx(sampled, k_other)
    idx = torch.cat([top_idx, other_idx])
    wt = torch.cat([top_fill, other_fill * goss_amplification(top_rate,
                                                              other_rate)])
    live = (bag[idx] > 0).to(_F32) * (wt > 0)
    return idx, wt * live, live


def sample_feature_mask_rows(keys: torch.Tensor, fraction: torch.Tensor,
                             num_features: int) -> torch.Tensor:
    """Batched :func:`sample_feature_mask` with no base mask: int64 keys
    ``[E, 2]`` and f32 ``fraction [E]`` -> f32 ``[E, num_features]``."""
    dev = keys.device
    frac = fraction.to(_F32)
    avail = _f32(float(num_features), dev)
    k = torch.clamp(torch.round(frac * avail), min=_f32(1.0, dev), max=avail)
    r = uniform_rows(keys, num_features)
    rank = torch.argsort(torch.argsort(r, dim=1, stable=True), dim=1,
                         stable=True)
    sampled = (rank.to(_F32) < k[:, None]).to(_F32)
    return torch.where((frac >= 1.0)[:, None], torch.ones_like(sampled),
                       sampled)


def sample_feature_mask(key: Key, fraction: float, num_features: int,
                        base_mask: torch.Tensor = None,
                        device="cpu") -> torch.Tensor:
    """Column subsample of ``max(1, round(fraction * n_avail))`` features
    drawn within ``base_mask``; f32 ``[num_features]``, passthrough of the
    base mask when ``fraction >= 1``."""
    if base_mask is None:
        base_mask = torch.ones(num_features, dtype=_F32, device=device)
    dev = base_mask.device
    on = base_mask > 0
    if np.float32(fraction) >= 1.0:
        return base_mask.to(_F32)
    frac = _f32(fraction, dev)
    avail = torch.maximum(on.to(_F32).sum(), _f32(1.0, dev))
    k = torch.clamp(torch.round(frac * avail), min=_f32(1.0, dev), max=avail)
    r = uniform(key, num_features, dev)
    r = torch.where(on, r, _f32(2.0, dev))
    rank = torch.argsort(torch.argsort(r, stable=True), stable=True)
    return (rank.to(_F32) < k).to(_F32) * on.to(_F32)
