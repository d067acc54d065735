"""Deterministic synthetic data — the port's copy of
``lightgbm_tpu/utils/datasets.py`` (what the port's entry points use).

* ``make_higgs_like`` — binary classification with the Higgs shape (N rows x
  28 continuous features), the repo's north-star configuration
  (``bench.py`` ``bench_higgs``);
* ``make_synthetic_diamonds`` — the diamonds log-price regression of the
  grid-search workflow (r/gridsearchCV.R:5-23): 53,940 rows, six features;
* ``iter_higgs_like_blocks`` — the Higgs-like task as ``(X, y)`` row
  blocks, never materialized (``Dataset.from_blocks``'s companion);
* ``train_test_split_bernoulli`` — that workflow's 85/15 Bernoulli split;
* ``make_boosting_curve`` — the bagging/boosting workflow's 1-D curve
  (examples/bagging_boosting.py).

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


def iter_higgs_like_blocks(n: int = 1_000_000, num_features: int = 28,
                           seed: int = 0, block_rows: int = 131_072):
    """Yield ``(X_block, y_block)`` pairs of the Higgs-like task without
    ever materializing the full matrix — the host-memory companion to
    ``Dataset.from_blocks``.

    Each block draws from its own ``default_rng((seed, b))`` stream, so a
    re-iterated generator yields identical blocks (``from_blocks`` needs two
    passes).  The signal vector ``w`` comes from the same fixed stream as
    :func:`make_higgs_like`, so the two share the labelling function, though
    not the row values.
    """
    w = np.random.default_rng(987654321).normal(0, 1, num_features)
    n_blocks = (n + block_rows - 1) // block_rows
    for b in range(n_blocks):
        nb = min(block_rows, n - b * block_rows)
        rng = np.random.default_rng((seed, b))
        X = rng.normal(0, 1, (nb, num_features)).astype(np.float32)
        logits = (X @ w) * 0.6 + 0.8 * np.sin(X[:, 0] * 2) * X[:, 1] \
            + 0.5 * (X[:, 2] ** 2 - 1)
        p = 1 / (1 + np.exp(-logits))
        y = (rng.random(nb) < p).astype(np.float32)
        yield X, y


def make_synthetic_diamonds(n: int = 53940, seed: int = 3928272):
    """``(X, log_price, feature_names)`` mirroring diamonds log-price:
    log_carat (continuous), cut/color/clarity (ordinal codes), depth, table
    (continuous); the target is a smooth nonlinear function of them plus
    Gaussian noise, with interactions a linear model cannot catch."""
    rng = np.random.default_rng(seed)
    carat = np.exp(rng.normal(-0.4, 0.6, n)).clip(0.2, 5.1)
    log_carat = np.log(carat)
    cut = rng.integers(1, 6, n).astype(np.float64)       # 1..5 ordered
    color = rng.integers(1, 8, n).astype(np.float64)     # 1..7
    clarity = rng.integers(1, 9, n).astype(np.float64)   # 1..8
    depth = rng.normal(61.75, 1.4, n).clip(43, 79)
    table = rng.normal(57.5, 2.2, n).clip(43, 95)
    log_price = (
        6.8
        + 1.7 * log_carat
        + 0.06 * cut
        + 0.08 * color
        + 0.10 * clarity
        + 0.07 * clarity * log_carat                        # interaction
        + 0.18 * np.sin(2.6 * log_carat)                    # curvature
        + 0.12 * np.cos(1.9 * log_carat + 0.6 * clarity)    # mixed wiggle
        - 0.05 * np.abs(depth - 61.75) * (log_carat > 0)
        - 0.01 * np.abs(table - 57.0)
        + rng.normal(0.0, 0.085, n)
    )
    X = np.column_stack([log_carat, cut, color, clarity, depth, table])
    names = ["log_carat", "cut", "color", "clarity", "depth", "table"]
    return X, log_price, names


def train_test_split_bernoulli(n: int, p_train: float = 0.85,
                               seed: int = 3928272):
    """The workflow's split: Bernoulli membership, not exact counts
    (r/gridsearchCV.R:21); ``(train_idx, test_idx)``."""
    rng = np.random.default_rng(seed)
    is_train = rng.random(n) < p_train
    return np.where(is_train)[0], np.where(~is_train)[0]


def make_boosting_curve(n: int = 1000, seed: int = 8657
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """``y = |x| + cos(x) + U(-0.05, 0.05)`` on ``x ~ U(-4, 4)``: the
    bagging/boosting notebook's data, drawn from numpy's legacy
    ``RandomState`` as its ``np.random.seed(8657)`` does.  Returns ``X``
    f64 ``[n, 1]`` and ``y`` f64 ``[n]``."""
    rs = np.random.RandomState(seed)
    x = rs.uniform(-4, 4, n)
    noise = rs.uniform(-0.05, 0.05, n)
    y = np.abs(x) + np.cos(x) + noise
    return x.reshape(-1, 1), y
