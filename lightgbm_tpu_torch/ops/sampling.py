"""Bagging and feature sampling — the port of ``lightgbm_tpu/ops/sampling.py``.

LightGBM semantics, as in the reference:

* bagging picks exactly ``floor(fraction * n_valid)`` rows, without
  replacement, from the currently valid rows;
* feature sampling picks ``max(1, round(fraction * n_avail))`` columns from
  the available set;
* ``fraction >= 1`` is a no-op (mask passthrough).

The random draws come from :mod:`~lightgbm_tpu_torch.utils.random`, which
reproduces ``jax.random`` bit for bit, and every step below is the
reference's f32 arithmetic op by op (sorts are stable), so both packages draw
the same masks from the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.random import Key, uniform, uniform_rows

_F32 = torch.float32


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(float(value), dtype=_F32, device=device)


def approx_top_mask(x: torch.Tensor, valid: torch.Tensor, k: int,
                    num_buckets: int = 2048, passes: int = 2
                    ) -> torch.Tensor:
    """bool ``[n]``: (approximately) the ``k`` largest valid ``x >= 0``,
    selecting exactly ``min(k, n_valid)`` rows by iterative histogram
    refinement (the reference's sort-free selection): bucket ``[lo, hi)``
    into ``num_buckets``, narrow to the bucket holding the k-th value, repeat;
    rows above the final bucket are all taken and rows inside it fill the
    remainder in row order."""
    dev = x.device
    valid = valid > 0 if valid.dtype != torch.bool else valid
    x = torch.where(valid, x, _f32(0.0, dev))
    lo = _f32(0.0, dev)
    hi = (torch.maximum(x.max(), _f32(1e-30, dev))
          * _f32(1.0 + 1e-6, dev))
    k = int(k)
    for _ in range(passes):
        w = torch.maximum((hi - lo) / num_buckets, _f32(1e-38, dev))
        in_rng = valid & (x >= lo) & (x < hi)
        code = ((x - lo) / w).to(torch.int32).clamp(0, num_buckets - 1)
        hist = torch.bincount(code[in_rng].to(torch.int64),
                              minlength=num_buckets)
        cnt_ge = hist.flip(0).cumsum(0).flip(0)
        k_eff = k - int((valid & (x >= hi)).sum())
        tb = max(int((cnt_ge >= k_eff).sum()) - 1, 0)
        lo, hi = (lo + _f32(tb, dev) * w, lo + _f32(tb + 1, dev) * w)
    above = valid & (x >= hi)
    sel_a = above & (above.to(torch.int64).cumsum(0) <= k)
    k_in = k - min(int(above.sum()), k)
    inb = valid & (x >= lo) & ~above
    return sel_a | (inb & (inb.to(torch.int64).cumsum(0) <= k_in))


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
    take = approx_top_mask(torch.where(valid, 1.0 - u, _f32(0.0, dev)),
                           valid, k, passes=1)
    return take.to(_F32)


def approx_top_mask_rows(x: torch.Tensor, valid: torch.Tensor,
                         k: torch.Tensor, num_buckets: int = 2048,
                         passes: int = 2) -> torch.Tensor:
    """:func:`approx_top_mask` for each row of ``x`` ``[E, n]`` with its own
    ``k`` (int64 ``[E]``), on the device: the same f32 steps, with no host
    read (the reference's ``vmap`` of it)."""
    dev = x.device
    e, n = x.shape
    valid = valid > 0 if valid.dtype != torch.bool else valid
    x = torch.where(valid, x, _f32(0.0, dev))
    lo = torch.zeros(e, dtype=_F32, device=dev)
    hi = (torch.maximum(x.max(dim=1).values, _f32(1e-30, dev))
          * _f32(1.0 + 1e-6, dev))
    offsets = (torch.arange(e, device=dev) * num_buckets)[:, None]
    for _ in range(passes):
        w = torch.maximum((hi - lo) / num_buckets, _f32(1e-38, dev))
        in_rng = valid & (x >= lo[:, None]) & (x < hi[:, None])
        code = ((x - lo[:, None]) / w[:, None]).to(torch.int32).clamp(
            0, num_buckets - 1)
        hist = torch.zeros(e * num_buckets, dtype=torch.int64, device=dev)
        hist.index_add_(0, (code.to(torch.int64) + offsets).reshape(-1),
                        in_rng.reshape(-1).to(torch.int64))
        cnt_ge = hist.view(e, num_buckets).flip(1).cumsum(1).flip(1)
        k_eff = k - (valid & (x >= hi[:, None])).sum(dim=1)
        tb = ((cnt_ge >= k_eff[:, None]).sum(dim=1) - 1).clamp(min=0)
        lo, hi = lo + tb.to(_F32) * w, lo + (tb + 1).to(_F32) * w
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
    take = approx_top_mask_rows(
        torch.where(valid, 1.0 - u, _f32(0.0, u.device)), valid, k, passes=1)
    on = (k > 0) & (fraction < 1.0)
    return torch.where(on[:, None], take, valid).to(_F32)


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
