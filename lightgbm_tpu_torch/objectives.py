"""Objective output transforms — the port's copy of the serving half of
``lightgbm_tpu/objectives.py``.

Serving needs only each objective's raw-score -> prediction ``transform``.
It runs on f32 tensors on the caller's device, with the reference's own
formulas (``1 / (1 + exp(-x))`` rather than ``torch.sigmoid``), so the two
packages agree to f32 rounding.  :func:`create_objective` accepts every
objective name the reference registry accepts.  ``grad_hess`` and
``init_score`` are training-side and wait for the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from .config import Params


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=like.device)


class Objective:
    name = "none"
    higher_better = False
    needs_group = False

    def __init__(self, params: Params):
        self.params = params

    def transform(self, raw: torch.Tensor) -> torch.Tensor:
        """Raw score -> user-facing prediction (e.g. sigmoid for binary)."""
        return raw


class RegressionL2(Objective):
    name = "regression"


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
    name = "binary"

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
