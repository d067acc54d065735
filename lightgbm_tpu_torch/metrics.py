"""Evaluation metrics — the port of ``lightgbm_tpu/metrics.py`` (the metrics
of the training slice).

All metrics are weighted means over f32 tensors on the training device
(weight 0 on padding rows), so a round's evaluation fetches one scalar per
metric.  Values follow the Python lightgbm convention (raw value plus a
``higher_better`` flag); the R binding's sign flip happens in ``cv``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

_F32 = torch.float32


class Metric(NamedTuple):
    name: str
    higher_better: bool
    # fn(transformed_pred, y, w) -> scalar tensor; w is 0 on padding rows
    fn: Callable


def _c(value, like):
    return torch.tensor(float(value), dtype=_F32, device=like.device)


def _wmean(values, w):
    return torch.sum(values * w) / torch.maximum(torch.sum(w), _c(1e-12, w))


def _l2(pred, y, w):
    return _wmean((pred - y) ** 2, w)


def _rmse(pred, y, w):
    return torch.sqrt(_l2(pred, y, w))


def _l1(pred, y, w):
    return _wmean(torch.abs(pred - y), w)


def _binary_logloss(p, y, w):
    p = torch.clamp(p, 1e-15, 1 - 1e-15)
    return _wmean(-(y * torch.log(p) + (1 - y) * torch.log(1 - p)), w)


def _binary_error(p, y, w):
    return _wmean(((p > 0.5) != (y > 0.5)).to(_F32), w)


def _auc(score, y, w):
    """Weighted ROC-AUC by the rank statistic: scores sorted ascending,
    ties share the mean of their group's negatives-below counts."""
    n = score.shape[0]
    order = torch.argsort(score, stable=True)
    s_sorted = score[order]
    y_sorted = y[order]
    w_sorted = w[order]
    pos_w = w_sorted * (y_sorted > 0.5)
    neg_w = w_sorted * (y_sorted <= 0.5)
    cum_neg = torch.cumsum(neg_w, 0)
    same_as_prev = torch.cat([torch.zeros(1, dtype=torch.bool,
                                          device=score.device),
                              s_sorted[1:] == s_sorted[:-1]])
    gid = torch.cumsum((~same_as_prev).to(torch.int64), 0) - 1
    before = torch.cat([torch.zeros(1, dtype=_F32, device=score.device),
                        cum_neg[:-1]])
    seg_start = torch.full((n,), float("inf"), dtype=_F32,
                           device=score.device).scatter_reduce(
        0, gid, before, reduce="amin")
    seg_end = torch.full((n,), float("-inf"), dtype=_F32,
                         device=score.device).scatter_reduce(
        0, gid, cum_neg, reduce="amax")
    neg_below = 0.5 * (seg_start[gid] + seg_end[gid])
    total_pos = torch.sum(pos_w)
    total_neg = torch.sum(neg_w)
    return torch.sum(pos_w * neg_below) / torch.maximum(
        total_pos * total_neg, _c(1e-12, score))


_METRICS: Dict[str, Metric] = {
    "l2": Metric("l2", False, _l2),
    "rmse": Metric("rmse", False, _rmse),
    "l1": Metric("l1", False, _l1),
    "binary_logloss": Metric("binary_logloss", False, _binary_logloss),
    "binary_error": Metric("binary_error", False, _binary_error),
    "auc": Metric("auc", True, _auc),
}

# the reference's other metric names: known, not ported yet
_LATER = ("huber", "poisson", "quantile", "mape", "gamma", "gamma_deviance",
          "tweedie", "cross_entropy", "multi_logloss", "multi_error", "ndcg",
          "map")


def get_metric(name: str, params=None) -> Metric:
    m = _METRICS.get(name)
    if m is not None:
        return m
    if name in _LATER:
        raise NotImplementedError(
            f"metric '{name}' is not ported yet: ROADMAP slice 3 (breadth "
            "of training)")
    raise ValueError(f"Unknown metric: {name}")
