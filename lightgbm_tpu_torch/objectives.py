"""Objectives — the port of ``lightgbm_tpu/objectives.py``.

Every objective has its raw-score -> prediction ``transform`` (serving).  The
two objectives of the training slice, :class:`RegressionL2` and
:class:`Binary`, also have ``init_score`` (boost-from-average, host numpy,
once per training) and ``grad_hess`` (per round, f32 tensors on the
training device; gradients and hessians already multiplied by the row
weight).  All of it uses the reference's own formulas op by op (``1 / (1 +
exp(-x))`` rather than ``torch.sigmoid``), so the two packages agree to f32
rounding.  :func:`create_objective` accepts every objective name the
reference registry accepts; the Booster refuses to train the others.
"""

from __future__ import annotations

from typing import Dict

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
        raise NotImplementedError(
            f"training with objective '{self.name}' is not ported yet: "
            "ROADMAP slice 3 (breadth of training)")

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


class RegressionL1(Objective):
    name = "regression_l1"


class Huber(Objective):
    name = "huber"


class Fair(Objective):
    name = "fair"


class Quantile(Objective):
    name = "quantile"


class MAPE(Objective):
    name = "mape"


class _LogLink(Objective):
    """Raw score is log(mu): poisson, gamma and tweedie."""

    def transform(self, raw):
        return torch.exp(raw)


class Poisson(_LogLink):
    name = "poisson"


class Gamma(_LogLink):
    name = "gamma"


class Tweedie(_LogLink):
    name = "tweedie"


class CrossEntropy(Objective):
    name = "cross_entropy"

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


class LambdaRank(Objective):
    name = "lambdarank"
    needs_group = True


class CustomObjective(Objective):
    """A user ``fobj`` model: raw scores are served untransformed."""

    name = "custom"


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
    "lambdarank": LambdaRank,
}


def create_objective(params: Params) -> Objective:
    fobj = params.extra.get("fobj")
    if fobj is not None or params.objective == "none":
        if fobj is None:
            raise ValueError("objective='none' requires a custom fobj")
        return CustomObjective(params)
    if params.objective in ("multiclass", "multiclassova"):
        from .multiclass import Multiclass, MulticlassOVA
        cls = MulticlassOVA if params.objective == "multiclassova" else \
            Multiclass
        return cls(params)
    cls = _REGISTRY.get(params.objective)
    if cls is None:
        raise ValueError(f"Unsupported objective: {params.objective}")
    return cls(params)
