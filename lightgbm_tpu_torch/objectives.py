"""Objectives — the port of ``lightgbm_tpu/objectives.py``.

Each objective has ``init_score`` (boost-from-average, host numpy, once per
training), ``grad_hess`` (per round, f32 tensors on the training device;
gradients and hessians already multiplied by the row weight) and its
raw-score -> prediction ``transform`` (serving).  All of it uses the
reference's own formulas op by op (``1 / (1 + exp(-x))`` rather than
``torch.sigmoid``), and every ``exp`` goes through :func:`link_exp`, so the
two packages agree bit for bit on CPU tensors.  ``regression_l1``,
``quantile`` and ``mape`` carry ``renew_alpha`` (and ``mape`` its
``renew_scale``): after each tree is grown its leaf values are refit to
weighted quantiles of the residuals (``models/tree.py``
``renew_leaf_values``).  ``lambdarank`` (and its aliases) is
``ranking.LambdaRank``.  A custom objective (``objective=callable``, or
``objective="none"`` with ``fobj``) is called as ``fobj(pred, y)`` on the
Booster's tensors (torch, on its device) and must return ``(grad, hess)``
tensors of the same shape; the row weights are applied after it.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from .config import Params
from .ops.split import fma


# XLA's CPU f32 exp (Cephes' single-precision exp, as XLA's CPU backend
# emits it): clamp, n = floor(x * log2(e) + 0.5) clamped to [-127, 127],
# x - n * ln2 in two parts, a degree-5 polynomial, times 2^n, every
# multiply-add fused (Cephes' decimal constants rounded to f32)
def _f32c(v: float) -> float:
    return float(np.float32(v))


_XLA_EXP_LO, _XLA_EXP_HI = _f32c(-87.8), _f32c(88.8)
_XLA_LOG2E = _f32c(1.44269504088896341)
_XLA_LN2_HI, _XLA_LN2_LO = _f32c(0.693359375), _f32c(-2.12194440e-4)
_XLA_EXP_POLY = tuple(_f32c(v) for v in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp`` bit for bit as XLA's CPU backend computes it (the
    reference's ``jnp.exp`` on the CPU; ``torch.exp`` differs from it on
    about 10 % of inputs by an ulp)."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32)

    x = x.to(torch.float32)
    x = torch.where(x < _XLA_EXP_LO, _XLA_EXP_LO, x)
    x = torch.where(x > _XLA_EXP_HI, _XLA_EXP_HI, x)
    n = torch.floor(fma(x, c(_XLA_LOG2E), c(0.5)))
    n = torch.where(n < -127.0, -127.0, n)
    n = torch.where(n > 127.0, 127.0, n)
    r = fma(n, c(-_XLA_LN2_HI), x)
    r = fma(n, c(-_XLA_LN2_LO), r)
    y = torch.full_like(r, _XLA_EXP_POLY[0])
    for p in _XLA_EXP_POLY[1:]:
        y = fma(y, r, c(p))
    y = fma(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


def link_exp(x: torch.Tensor) -> torch.Tensor:
    """The links' ``exp``: XLA's CPU arithmetic on a CPU tensor (as
    ``prefix_sum`` and ``fma`` copy it), ``torch.exp`` on the card."""
    return xla_exp_f32(x) if x.device.type == "cpu" else torch.exp(x)


# XLA's CPU f32 log (Cephes' single-precision logf): the mantissa in
# [sqrt(1/2), sqrt(2)) minus 1, a degree-8 polynomial with its multiply-adds
# fused, the exponent's ln 2 in two parts; ``y * x^3 + e * ln2_lo`` is
# contracted too
_XLA_LOG_SQRTHF = _f32c(0.707106781186547524)
_XLA_LOG_POLY = tuple(_f32c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_XLA_LOG_MIN_NORM = float(np.array(0x00800000, np.int32).view(np.float32))
# XLA's log2 is log times this constant
XLA_INV_LN2 = _f32c(1.0 / np.log(2.0))


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 natural ``log`` bit for bit as XLA's CPU backend computes it
    (``torch.log`` rounds correctly, XLA's differs on about 2 % of
    inputs); 0 and denormals give -inf, a negative or NaN input NaN."""
    def c(v):
        return torch.tensor(v, dtype=torch.float32)

    x = x.to(torch.float32)
    m_in = torch.clamp(x, min=_XLA_LOG_MIN_NORM)
    bits = m_in.view(torch.int32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _XLA_LOG_SQRTHF
    e = e - small.to(torch.float32)
    m = (m - 1.0) + torch.where(small, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = _XLA_LOG_POLY
    y = fma(m, c(p[0]), c(p[1]))
    y1 = fma(m, c(p[3]), c(p[4]))
    y2 = fma(m, c(p[6]), c(p[7]))
    y = fma(y, m, c(p[2]))
    y1 = fma(y1, m, c(p[5]))
    y2 = fma(y2, m, c(p[8]))
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, e * _XLA_LN2_LO)
    m = fma(x2, c(-0.5), m) + y
    out = fma(e, c(_XLA_LN2_HI), m)
    # denormals are flushed to zero
    out = torch.where((x >= 0.0) & (x < _XLA_LOG_MIN_NORM), float("-inf"),
                      out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0.0) | torch.isnan(x), float("nan"), out)


def link_log2(x: torch.Tensor) -> torch.Tensor:
    """``log2``: XLA's (its ``log`` times ``XLA_INV_LN2``) on a CPU tensor,
    ``torch.log2`` on the card."""
    if x.device.type == "cpu":
        return xla_log_f32(x) * XLA_INV_LN2
    return torch.log2(x)


def mul_add(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """``a * b + c``: fused (rounded once) on CPU tensors, where the
    reference's XLA CPU program contracts the multiply-add; two roundings
    on the card, as PyTorch computes it."""
    if a.device.type == "cpu":
        return fma(a, b, torch.as_tensor(c, dtype=torch.float32))
    return a * b + c


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + link_exp(-x))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


class Objective:
    name = "none"
    higher_better = False
    needs_group = False

    def __init__(self, params: Params):
        self.params = params

    def init_score(self, y: np.ndarray, w: np.ndarray) -> float:
        return 0.0

    def grad_hess(self, pred, y, w):
        raise NotImplementedError

    def transform(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw score -> user-facing prediction (e.g. sigmoid for binary)."""
        return raw


class RegressionL2(Objective):
    name = "regression"

    def init_score(self, y, w):
        if not self.params.boost_from_average:
            return 0.0
        return float(np.average(y, weights=np.maximum(w, 0)))

    def grad_hess(self, pred, y, w):
        return (pred - y) * w, w


def _weighted_quantile(y: np.ndarray, w: np.ndarray, alpha: float) -> float:
    """Host-side weighted alpha-quantile (alpha=0.5 -> weighted median):
    the boost-from-score base of the L1, quantile and MAPE objectives."""
    order = np.argsort(y)
    cw = np.cumsum(w[order])
    idx = np.searchsorted(cw, alpha * cw[-1])
    return float(y[order][min(idx, len(y) - 1)])


def _log_mean(y, w) -> float:
    """The log-link objectives' init score: log of the weighted mean."""
    mean = max(np.average(y, weights=np.maximum(w, 0)), 1e-9)
    return float(np.log(mean))


class RegressionL1(Objective):
    """MAE: sign gradients, then each tree's leaves renewed to the weighted
    median of their residuals (upstream ``RegressionL1loss``)."""

    name = "regression_l1"
    renew_alpha = 0.5

    def init_score(self, y, w):
        if not self.params.boost_from_average:
            return 0.0
        return _weighted_quantile(y, w, 0.5)

    def grad_hess(self, pred, y, w):
        return torch.sign(pred - y) * w, w


class Huber(Objective):
    name = "huber"

    def grad_hess(self, pred, y, w):
        delta = _f32(self.params.alpha, pred)
        g = torch.clamp(pred - y, -delta, delta)
        return g * w, w

    def init_score(self, y, w):
        if not self.params.boost_from_average:
            return 0.0
        return float(np.average(y, weights=np.maximum(w, 0)))


class Fair(Objective):
    name = "fair"

    def grad_hess(self, pred, y, w):
        c = _f32(self.params.fair_c, pred)
        r = pred - y
        g = c * r / (torch.abs(r) + c)
        h = c * c / (torch.abs(r) + c) ** 2
        return g * w, h * w


class Quantile(Objective):
    """Pinball loss; leaves renewed to the weighted alpha-quantile of their
    residuals (upstream ``RegressionQuantileloss``)."""

    name = "quantile"

    @property
    def renew_alpha(self):
        return float(self.params.alpha)

    def init_score(self, y, w):
        if not self.params.boost_from_average:
            return 0.0
        return _weighted_quantile(y, w, float(self.params.alpha))

    def grad_hess(self, pred, y, w):
        alpha = _f32(self.params.alpha, pred)
        g = torch.where(y > pred, -alpha, 1.0 - alpha)
        return g * w, w


class MAPE(Objective):
    """L1 on residuals scaled by ``1/max(1, |y|)`` (upstream
    ``RegressionMAPELOSS``): the scale rides on the gradients, hessians and
    the renewal's weights."""

    name = "mape"
    renew_alpha = 0.5

    @staticmethod
    def renew_scale(y):
        return 1.0 / torch.clamp(torch.abs(y), min=1.0)

    def init_score(self, y, w):
        if not self.params.boost_from_average:
            return 0.0
        return _weighted_quantile(y, w / np.maximum(np.abs(y), 1.0), 0.5)

    def grad_hess(self, pred, y, w):
        scale = self.renew_scale(y)
        return torch.sign(pred - y) * scale * w, scale * w


class _LogLink(Objective):
    """Raw score is log(mu): poisson, gamma and tweedie."""

    def init_score(self, y, w):
        return _log_mean(y, w)

    def transform(self, raw):
        return link_exp(raw)


class Poisson(_LogLink):
    name = "poisson"

    def grad_hess(self, pred, y, w):
        mu = link_exp(pred)
        h = link_exp(pred + _f32(self.params.poisson_max_delta_step, pred))
        return (mu - y) * w, h * w


class Gamma(_LogLink):
    """Gamma deviance: grad = 1 - y*exp(-s), hess = y*exp(-s)."""

    name = "gamma"

    def grad_hess(self, pred, y, w):
        e = link_exp(-pred)
        return (mul_add(-y, e, 1.0) * w,
                torch.maximum(y * e, _f32(1e-16, pred)) * w)


class Tweedie(_LogLink):
    """Tweedie deviance, variance power rho in (1, 2):
    grad = -y*exp((1-rho)s) + exp((2-rho)s)."""

    name = "tweedie"

    def __init__(self, params: Params):
        super().__init__(params)
        self.rho = float(params.tweedie_variance_power)

    def grad_hess(self, pred, y, w):
        rho = _f32(self.rho, pred)
        a = link_exp((1.0 - rho) * pred)
        b = link_exp((2.0 - rho) * pred)
        g = mul_add(-y, a, b)
        h = mul_add(-y * (1.0 - rho), a, (2.0 - rho) * b)
        return g * w, torch.maximum(h, _f32(1e-16, pred)) * w


class CrossEntropy(Objective):
    """Cross-entropy on continuous labels in [0, 1]: the logistic link
    without the ``sigmoid`` scale."""

    name = "cross_entropy"

    def init_score(self, y, w):
        if not self.params.boost_from_average:
            return 0.0
        pbar = float(np.average(y, weights=np.maximum(w, 1e-12)))
        pbar = min(max(pbar, 1e-12), 1 - 1e-12)
        return float(np.log(pbar / (1 - pbar)))

    def grad_hess(self, pred, y, w):
        p = sigmoid(pred)
        return (p - y) * w, torch.maximum(p * (1.0 - p),
                                          _f32(1e-16, pred)) * w

    def transform(self, raw):
        return sigmoid(raw)


class Binary(Objective):
    """Binary logloss on labels {0,1}; raw score is a logit, with
    ``sigmoid`` scaling, ``scale_pos_weight`` and ``is_unbalance``."""

    name = "binary"

    def __init__(self, params: Params):
        super().__init__(params)
        self.pos_weight = float(params.scale_pos_weight)

    def prepare(self, y: np.ndarray, w: np.ndarray) -> None:
        if self.params.is_unbalance:
            pos = float(np.sum(w * (y > 0.5)))
            neg = float(np.sum(w * (y <= 0.5)))
            self.pos_weight = neg / max(pos, 1.0) if pos > 0 else 1.0

    def init_score(self, y, w):
        self.prepare(y, np.asarray(w))
        if not self.params.boost_from_average:
            return 0.0
        pw = self.pos_weight
        sw = w * np.where(y > 0.5, pw, 1.0)
        pbar = np.average(y, weights=np.maximum(sw, 1e-12))
        pbar = min(max(pbar, 1e-12), 1 - 1e-12)
        return float(np.log(pbar / (1 - pbar)) / self.params.sigmoid)

    def grad_hess(self, pred, y, w):
        sig = _f32(self.params.sigmoid, pred)
        p = sigmoid(sig * pred)
        wy = w * torch.where(y > 0.5, _f32(self.pos_weight, pred),
                             _f32(1.0, pred))
        g = sig * (p - y)
        h = torch.maximum(sig * sig * p * (1.0 - p), _f32(1e-16, pred))
        return g * wy, h * wy

    def transform(self, raw):
        return sigmoid(_f32(self.params.sigmoid, raw) * raw)


class CustomObjective(Objective):
    """A user ``fobj(pred, y) -> (grad, hess)``; raw scores are served
    untransformed."""

    name = "custom"

    def __init__(self, params: Params, fobj: Callable):
        super().__init__(params)
        self.fobj = fobj

    def grad_hess(self, pred, y, w):
        g, h = self.fobj(pred, y)
        return g * w, h * w


_REGISTRY: Dict[str, type] = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": MAPE,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "cross_entropy": CrossEntropy,
    "binary": Binary,
}


def create_objective(params: Params) -> Objective:
    fobj = params.extra.get("fobj")
    if fobj is not None or params.objective == "none":
        if fobj is None:
            raise ValueError("objective='none' requires a custom fobj")
        return CustomObjective(params, fobj)
    if params.objective in ("multiclass", "multiclassova"):
        from .multiclass import Multiclass, MulticlassOVA
        cls = MulticlassOVA if params.objective == "multiclassova" else \
            Multiclass
        return cls(params)
    if params.objective == "lambdarank":
        from .ranking import LambdaRank
        return LambdaRank(params)
    cls = _REGISTRY.get(params.objective)
    if cls is None:
        raise ValueError(f"Unsupported objective: {params.objective}")
    return cls(params)
