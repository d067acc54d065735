"""The binning schema's fingerprint — the one function of
``lightgbm_tpu/data/sketch.py`` that the port needs now (numpy only).

The reference module also holds the Greenwald-Khanna quantile sketch and
``StreamingBinMapperBuilder`` for out-of-core binning; those are not ported
yet: ROADMAP slice 5 (out-of-core training), item 11.
"""

from __future__ import annotations

import hashlib

import numpy as np


def schema_digest(mapper) -> str:
    """Stable fingerprint of a binning schema (checkpoint compatibility).

    A saved forest's ``split_bin`` thresholds and ``split_feature`` indices
    only mean anything under the exact binning they were trained with.
    Checkpoints store this digest instead of the full mapper: resume
    recomputes it from the offered Dataset and a mismatch is an
    *incompatible schema*, not corruption.  Covers the per-feature bound
    arrays bit for bit, the nan-bin layout, categorical flags and the EFB
    bundling (which remaps the training column space without touching
    ``upper_bounds``).  Equal to the reference's digest for the same
    binning, so checkpoints interchange.
    """
    h = hashlib.sha256()
    h.update(np.int64(mapper.num_features).tobytes())
    for ub in mapper.upper_bounds:
        h.update(np.int64(len(ub)).tobytes())
        h.update(np.ascontiguousarray(ub, np.float64).tobytes())
    h.update(np.ascontiguousarray(mapper.nan_bin, np.int32).tobytes())
    h.update(np.ascontiguousarray(mapper.n_bins, np.int32).tobytes())
    h.update(np.ascontiguousarray(mapper.is_categorical, bool).tobytes())
    b = getattr(mapper, "bundler", None)
    if b is not None:
        h.update(repr(b.groups).encode())
        h.update(np.ascontiguousarray(b.default_bins).tobytes())
    return h.hexdigest()
