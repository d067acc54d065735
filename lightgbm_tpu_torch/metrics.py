"""Evaluation metrics — the port of ``lightgbm_tpu/metrics.py``.

All metrics are weighted means over f32 tensors on the training device
(weight 0 on padding rows), so a round's evaluation fetches one scalar per
metric.  Values follow the Python lightgbm convention (raw value plus a
``higher_better`` flag); the R binding's sign flip happens in ``cv``.

Every metric reduces over the row axis, so ``pred [E, n]`` with weights
``[E, n]`` (``w * valid_mask`` per fold in fused cross-validation) gives one
value per element ``[E]``, each equal to the metric of that row alone; the
multiclass metrics (``multi_logloss``, ``multi_error``, in ``multiclass.py``)
take probabilities ``[..., n, K]``.  The ranking metrics (``ndcg@k``,
``map@k``) need the query groups and are evaluated by
``ranking.eval_ranking``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from .multiclass import multi_error, multi_logloss
from .objectives import link_exp

_F32 = torch.float32


class Metric(NamedTuple):
    name: str
    higher_better: bool
    # fn(transformed_pred, y, w) -> scalar tensor; w is 0 on padding rows
    fn: Callable


def _c(value, like):
    return torch.tensor(float(value), dtype=_F32, device=like.device)


def _wmean(values, w):
    return (torch.sum(values * w, dim=-1)
            / torch.maximum(torch.sum(w, dim=-1), _c(1e-12, w)))


def _l2(pred, y, w):
    return _wmean((pred - y) ** 2, w)


def _rmse(pred, y, w):
    return torch.sqrt(_l2(pred, y, w))


def _l1(pred, y, w):
    return _wmean(torch.abs(pred - y), w)


def _huber(pred, y, w, alpha=0.9):
    r = torch.abs(pred - y)
    loss = torch.where(r <= alpha, 0.5 * r * r, alpha * (r - 0.5 * alpha))
    return _wmean(loss, w)


def _binary_logloss(p, y, w):
    p = torch.clamp(p, 1e-15, 1 - 1e-15)
    return _wmean(-(y * torch.log(p) + (1 - y) * torch.log(1 - p)), w)


def _binary_error(p, y, w):
    return _wmean(((p > 0.5) != (y > 0.5)).to(_F32), w)


def _poisson_nll(mu, y, w):
    mu = torch.clamp(mu, min=1e-15)
    return _wmean(mu - y * torch.log(mu), w)


def _quantile(pred, y, w, alpha=0.9):
    r = y - pred
    return _wmean(torch.maximum(alpha * r, (alpha - 1) * r), w)


def _mape(pred, y, w):
    return _wmean(torch.abs(pred - y) / torch.clamp(torch.abs(y), min=1.0), w)


def _gamma_nll(mu, y, w):
    """Upstream's "gamma" metric: the negative log-likelihood at shape 1."""
    mu = torch.clamp(mu, min=1e-15)
    ys = torch.clamp(y, min=1e-15)
    return _wmean(torch.log(mu) + ys / mu, w)


def _gamma_deviance(mu, y, w):
    mu = torch.clamp(mu, min=1e-15)
    ys = torch.clamp(y, min=1e-15)
    return _wmean(2.0 * (torch.log(mu / ys) + ys / mu - 1.0), w)


def _tweedie_nll(mu, y, w, rho=1.5):
    mu = torch.clamp(mu, min=1e-15)
    a = y * link_exp((1.0 - rho) * torch.log(mu)) / (1.0 - rho)
    b = link_exp((2.0 - rho) * torch.log(mu)) / (2.0 - rho)
    return _wmean(-a + b, w)


def _auc(score, y, w):
    """Weighted ROC-AUC by the rank statistic: scores sorted ascending,
    ties share the mean of their group's negatives-below counts."""
    n = score.shape[-1]
    dev = score.device
    lead = score.shape[:-1]
    y = y.expand(score.shape)
    w = w.expand(score.shape)
    order = torch.argsort(score, dim=-1, stable=True)
    s_sorted = score.gather(-1, order)
    y_sorted = y.gather(-1, order)
    w_sorted = w.gather(-1, order)
    pos_w = w_sorted * (y_sorted > 0.5)
    neg_w = w_sorted * (y_sorted <= 0.5)
    cum_neg = torch.cumsum(neg_w, -1)
    same_as_prev = torch.cat([torch.zeros(lead + (1,), dtype=torch.bool,
                                          device=dev),
                              s_sorted[..., 1:] == s_sorted[..., :-1]], -1)
    gid = torch.cumsum((~same_as_prev).to(torch.int64), -1) - 1
    before = torch.cat([torch.zeros(lead + (1,), dtype=_F32, device=dev),
                        cum_neg[..., :-1]], -1)
    seg_start = torch.full(lead + (n,), float("inf"), dtype=_F32,
                           device=dev).scatter_reduce(
        -1, gid, before, reduce="amin")
    seg_end = torch.full(lead + (n,), float("-inf"), dtype=_F32,
                         device=dev).scatter_reduce(
        -1, gid, cum_neg, reduce="amax")
    neg_below = 0.5 * (seg_start.gather(-1, gid) + seg_end.gather(-1, gid))
    total_pos = torch.sum(pos_w, -1)
    total_neg = torch.sum(neg_w, -1)
    return torch.sum(pos_w * neg_below, -1) / torch.maximum(
        total_pos * total_neg, _c(1e-12, score))


_METRICS: Dict[str, Metric] = {
    "l2": Metric("l2", False, _l2),
    "rmse": Metric("rmse", False, _rmse),
    "l1": Metric("l1", False, _l1),
    "huber": Metric("huber", False, _huber),
    "poisson": Metric("poisson", False, _poisson_nll),
    "quantile": Metric("quantile", False, _quantile),
    "mape": Metric("mape", False, _mape),
    "gamma": Metric("gamma", False, _gamma_nll),
    "gamma_deviance": Metric("gamma_deviance", False, _gamma_deviance),
    "tweedie": Metric("tweedie", False, _tweedie_nll),
    "cross_entropy": Metric("cross_entropy", False, _binary_logloss),
    "binary_logloss": Metric("binary_logloss", False, _binary_logloss),
    "binary_error": Metric("binary_error", False, _binary_error),
    "auc": Metric("auc", True, _auc),
    "multi_logloss": Metric("multi_logloss", False, multi_logloss),
    "multi_error": Metric("multi_error", False, multi_error),
}

def get_metric(name: str, params=None) -> Metric:
    """The metric by name; with ``params``, huber and quantile bind
    ``alpha`` and tweedie ``tweedie_variance_power``, as the reference's
    lookup does; ``ndcg`` and ``map`` are the grouped metrics'
    ``ranking.get_ranking_metric`` entries."""
    if name in ("ndcg", "map"):
        from .ranking import get_ranking_metric
        return get_ranking_metric(name, params)
    m = _METRICS.get(name)
    if m is None:
        raise ValueError(f"Unknown metric: {name}")
    if params is not None and name in ("huber", "quantile"):
        alpha = float(params.alpha)
        return Metric(m.name, m.higher_better,
                      lambda p, y, w, a=alpha: m.fn(p, y, w, a))
    if params is not None and name == "tweedie":
        rho = float(params.tweedie_variance_power)
        return Metric(m.name, m.higher_better,
                      lambda p, y, w, r=rho: m.fn(p, y, w, r))
    return m
