"""Multiclass objectives and metrics — the port of
``lightgbm_tpu/multiclass.py``.

LightGBM's ``multiclass`` objective trains ``num_class`` trees per round on
softmax gradients; ``multiclassova`` trains K independent sigmoid binary
problems.  Raw scores are ``[..., n, K]``; the class axis is a batch axis of
the tree grower (``models/tree.py`` ``grow_trees_batched``), so K trees grow
at once over one binned matrix.  Every formula is the reference's, op for op
in f32: gradients ``p - onehot(y)`` with hessians ``2 * p * (1 - p)``
(LightGBM's factor-2 convention), and ``init_score`` the log class priors
(host numpy, once per training).
"""

from __future__ import annotations

import numpy as np
import torch

from .objectives import Objective, _f32, link_exp


class Multiclass(Objective):
    name = "multiclass"

    def __init__(self, params):
        super().__init__(params)
        self.num_class = int(params.num_class)
        if self.num_class < 2:
            raise ValueError("multiclass requires num_class >= 2")

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def init_score(self, y: np.ndarray, w: np.ndarray) -> np.ndarray:
        """Log class priors ``[K]`` (boost_from_average for softmax)."""
        if not self.params.boost_from_average:
            return np.zeros(self.num_class, np.float32)
        k = self.num_class
        pri = np.zeros(k, np.float64)
        for c in range(k):
            pri[c] = np.sum(w * (y == c))
        pri = np.maximum(pri / max(pri.sum(), 1e-12), 1e-12)
        return np.log(pri).astype(np.float32)

    def _onehot(self, y, like):
        return (y[..., None] == torch.arange(
            like.shape[-1], device=like.device)).to(like.dtype)

    def grad_hess(self, pred, y, w):
        """pred ``[..., n, K]`` raw; y ``[n]`` integer labels; w ``[n]``."""
        p = _softmax(pred)
        g = (p - self._onehot(y, p)) * w[..., None]
        h = torch.maximum(2.0 * p * (1.0 - p), _f32(1e-16, p)) * w[..., None]
        return g, h

    def transform(self, raw):
        return _softmax(raw)


class MulticlassOVA(Multiclass):
    """One-vs-all: K independent sigmoid binary problems."""

    name = "multiclassova"

    def grad_hess(self, pred, y, w):
        sig = _f32(self.params.sigmoid, pred)
        p = 1.0 / (1.0 + link_exp(-sig * pred))
        g = sig * (p - self._onehot(y, p)) * w[..., None]
        h = torch.maximum(sig * sig * p * (1.0 - p), _f32(1e-16, p)) \
            * w[..., None]
        return g, h

    def transform(self, raw):
        p = 1.0 / (1.0 + link_exp(-_f32(self.params.sigmoid, raw) * raw))
        return p / torch.clamp(class_sum(p), min=1e-12)


# XLA's CPU reduction adds up to this many classes of a row left to right;
# past it, in windows of this width
XLA_SEQUENTIAL_CLASSES = 32


def class_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the class axis, kept: XLA's CPU order on a CPU tensor (as
    ``link_exp`` copies XLA's ``exp``), ``torch.sum`` on the card.

    XLA adds at most ``XLA_SEQUENTIAL_CLASSES`` classes left to right in
    f32.  Past that its ``TreeReductionRewriter`` turns the reduce into a
    ``reduce-window`` of width and stride 32 over the classes padded with
    ``p = 32 * ceil(K / 32) - K`` zeros (``p // 2`` before, the rest
    after), each window added left to right from 0, then reduces the
    ``ceil(K / 32)`` window sums by the same rule."""
    k = x.shape[-1]
    if x.device.type != "cpu" or k == 0:
        return x.sum(dim=-1, keepdim=True)
    if k <= XLA_SEQUENTIAL_CLASSES:
        acc = x[..., 0]
        for c in range(1, k):
            acc = acc + x[..., c]
        return acc[..., None]
    w = XLA_SEQUENTIAL_CLASSES
    pad = w * -(-k // w) - k
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    xp = xp.reshape(*x.shape[:-1], -1, w)
    acc = torch.zeros(xp.shape[:-1], dtype=x.dtype)
    for c in range(w):
        acc = acc + xp[..., c]
    if acc.shape[-1] > w:
        return class_sum(acc)
    out = torch.zeros(acc.shape[:-1], dtype=x.dtype)
    for c in range(acc.shape[-1]):
        out = out + acc[..., c]
    return out[..., None]


def _softmax(x):
    x = x - x.max(dim=-1, keepdim=True).values
    e = link_exp(x)
    return e / class_sum(e)


def _wmean(values, w):
    return (torch.sum(values * w, dim=-1)
            / torch.clamp(torch.sum(w, dim=-1), min=1e-12))


def multi_logloss(prob, y, w):
    """Weighted mean of ``-log p[true class]`` over the row axis: prob
    ``[..., n, K]``, y ``[n]``, w ``[..., n]`` -> ``[...]``."""
    onehot = (y[..., None] == torch.arange(
        prob.shape[-1], device=prob.device)).to(prob.dtype)
    p_true = torch.clamp(torch.sum(prob * onehot, dim=-1), 1e-15, 1.0)
    return _wmean(-torch.log(p_true), w)


def multi_error(prob, y, w):
    wrong = (torch.argmax(prob, dim=-1) != y.to(torch.int64)).to(prob.dtype)
    return _wmean(wrong, w)
