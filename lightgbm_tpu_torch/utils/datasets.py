"""Deterministic synthetic data — the port's copy of ``make_higgs_like``
from ``lightgbm_tpu/utils/datasets.py``.

Binary classification with the Higgs shape (N rows x 28 continuous
features), the repo's north-star configuration (``bench.py`` ``bench_higgs``).
Same seeds, same numpy streams, so both packages see identical rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_higgs_like(n: int = 1_000_000, num_features: int = 28,
                    seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Binary task with Higgs-like shape and ~0.5 class balance."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, num_features)).astype(np.float32)
    # the signal vector comes from its own fixed stream, so a validation set
    # made with another seed or size shares the labelling function
    w = np.random.default_rng(987654321).normal(0, 1, num_features)
    logits = (X @ w) * 0.6 + 0.8 * np.sin(X[:, 0] * 2) * X[:, 1] \
        + 0.5 * (X[:, 2] ** 2 - 1)
    p = 1 / (1 + np.exp(-logits))
    y = (rng.random(n) < p).astype(np.float32)
    return X, y
