"""Bin-mapper persistence — the port's copy of the mapper half of
``lightgbm_tpu/utils/serialize.py``.

One JSON schema is shared by the packed serving artifact of both packages,
so a mapper written by either loads in the other.  The JSON text-model
loader (``booster_to_string`` and friends) is training-side and waits for
the training slice.
"""

from __future__ import annotations

import numpy as np


def mapper_to_dict(mapper) -> dict:
    """BinMapper (+ attached EFB bundler) -> JSON-ready dict."""
    return {
        "upper_bounds": [ub.tolist() for ub in mapper.upper_bounds],
        "nan_bin": mapper.nan_bin.tolist(),
        "n_bins": mapper.n_bins.tolist(),
        "is_categorical": mapper.is_categorical.astype(int).tolist(),
        "bundler": (None if mapper.bundler is None else {
            "groups": mapper.bundler.groups,
            "default_bins": mapper.bundler.default_bins.tolist(),
        }),
    }


def mapper_from_dict(bm: dict):
    from ..dataset import BinMapper, FeatureBundler

    mapper = BinMapper(
        [np.asarray(ub, np.float64) for ub in bm["upper_bounds"]],
        np.asarray(bm["nan_bin"], np.int32),
        np.asarray(bm["n_bins"], np.int32),
        np.asarray(bm["is_categorical"], bool),
    )
    if bm.get("bundler"):
        mapper.bundler = FeatureBundler(
            bm["bundler"]["groups"], mapper.n_bins,
            np.asarray(bm["bundler"]["default_bins"], np.int64))
    return mapper
