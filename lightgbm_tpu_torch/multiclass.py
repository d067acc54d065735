"""Multiclass output transforms — the port's copy of the serving half of
``lightgbm_tpu/multiclass.py``: softmax over ``[n, K]`` raw scores, or
normalised one-vs-all sigmoids.  Gradients wait for the training slice."""

from __future__ import annotations

import torch

from .objectives import Objective, _f32


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

    def transform(self, raw):
        return _softmax(raw)


class MulticlassOVA(Multiclass):
    """One-vs-all: K independent sigmoid binary problems."""

    name = "multiclassova"

    def transform(self, raw):
        p = 1.0 / (1.0 + torch.exp(-_f32(self.params.sigmoid, raw) * raw))
        return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-12)


def _softmax(x):
    x = x - x.max(dim=-1, keepdim=True).values
    e = torch.exp(x)
    return e / e.sum(dim=-1, keepdim=True)
