"""One-pass mergeable streaming quantile sketch for out-of-core binning —
the port of ``lightgbm_tpu/data/sketch.py`` (host numpy, kept line for line:
the bounds must equal the reference's bit for bit, because checkpoints and
model files carry the binning schema's digest).

The in-memory :meth:`BinMapper.fit` needs the whole column resident to run
``np.unique`` / ``np.quantile``; under out-of-core training
(``Dataset.from_blocks``) the dataset arrives as row blocks and is never
materialized.  This module builds the SAME BinMapper from a single pass
over the blocks via a per-feature adaptive sketch with three regimes:

* **exact** — raw finite values buffered while the stream is small
  (``capacity`` rows, default 200k = the in-memory fit's own sampling
  threshold).  Finalizing from here calls the SHARED
  :func:`~lightgbm_tpu_torch.dataset.numeric_bin_bounds` on the
  concatenated buffer — bit-identical to the in-memory fit whenever total
  rows stay within ``min(capacity, 200_000)``.
* **distinct** — past capacity, columns with a bounded value vocabulary
  (``max_distinct``) collapse to exact ``(distinct, counts)`` tallies,
  exact at any n (the quantile path goes through
  :func:`~lightgbm_tpu_torch.dataset._weighted_quantile`).
* **gk** — genuinely continuous columns degrade to a Greenwald–Khanna
  summary: tuples ``(v, g, Δ)`` with ``cumsum(g)[i] <= rank(v_i) <=
  cumsum(g)[i] + Δ_i``.  Each incoming block is first reduced to its own
  exact ``eps/2``-rank summary (what makes the sketch mergeable), then
  inserted and compressed under ``g_i + Δ_i <= floor(2·eps_gk·n)``;
  quantile queries are rank-accurate to ``eps·n``.

NaN handling is exact in every regime (per-feature NaN counters), so the
nan-bin layout always matches the in-memory fit.  :func:`schema_digest` is
the binning schema's fingerprint that checkpoints carry.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from ..dataset import BinMapper, numeric_bin_bounds

_DEFAULT_CAPACITY = 200_000   # == BinMapper.fit's sample_cnt threshold
_DEFAULT_MAX_DISTINCT = 4096


def _merge_distinct(av, ac, bv, bc):
    """Merge two (distinct values, counts) tallies into one."""
    v = np.concatenate([av, bv])
    c = np.concatenate([ac, bc])
    order = np.argsort(v, kind="stable")
    v, c = v[order], c[order]
    new = np.r_[True, v[1:] != v[:-1]]
    idx = np.cumsum(new) - 1
    out_v = v[new]
    out_c = np.zeros(len(out_v), np.int64)
    np.add.at(out_c, idx, c)
    return out_v, out_c


class GKSummary:
    """Greenwald–Khanna quantile summary over a weighted value stream.

    Invariant: with ``rmin_i = cumsum(g)[i]``, the true rank of ``v_i``
    (count of stream values <= v_i) lies in ``[rmin_i, rmin_i + d_i]``.
    Compression merges neighbors while ``g_i + g_{i+1} + d_{i+1}`` stays
    under ``floor(2·eps·n)``; the first/last tuples are never merged away
    (exact min/max).
    """

    def __init__(self, eps: float):
        self.eps = float(eps)
        self.n = 0
        self.v = np.empty(0, np.float64)
        self.g = np.empty(0, np.int64)
        self.d = np.empty(0, np.int64)

    def insert_distinct(self, dv: np.ndarray, dc: np.ndarray) -> None:
        """Insert a sorted (distinct, counts) batch (a block's exact
        summary — within-batch ranks carry no uncertainty, so new tuples
        only inherit the OLD successor's interval).

        A batch tuple with ``dc > 1`` is a collapsed BAND: up to ``dc - 1``
        of its mass sits at values strictly below ``dv`` (the band's
        interior, discarded by :meth:`_FeatureSketch._block_summary`).
        Placing all of it at ``dv`` under-counts the true rank of any OLD
        tuple the band straddles, so those tuples' Δ is widened by the
        band's below-mass — keeping every interval HONEST (rank really is
        in ``[rmin, rmin + Δ]``; tests/test_torch_sketch.py checks
        it against the reference's), at the
        price that banding debt accumulates into Δ instead of silently
        into the answer."""
        dv = np.asarray(dv, np.float64)
        dc = np.asarray(dc, np.int64)
        if len(dv) == 0:
            return
        n1 = self.n + int(dc.sum())
        if self.n == 0:
            self.v, self.g = dv.copy(), dc.copy()
            self.d = np.zeros(len(dv), np.int64)
            self.n = n1
            self._compress()
            return
        pos = np.searchsorted(self.v, dv)
        match = (pos < len(self.v)) & (self.v[np.minimum(pos, len(self.v) - 1)]
                                       == dv)
        # new tuples inherit the PRE-widening successor interval (their own
        # old-stream uncertainty is the old summary's, not this batch's)
        nv, nc = dv[~match], dc[~match]
        nd = np.empty(0, np.int64)
        if len(nv):
            pos2 = np.searchsorted(self.v, nv)
            # below-min is NOT exact here (banding hides mass under the
            # first tuple's value), so it inherits tuple 0's interval like
            # any interior insert; above-max stays exact (block summaries
            # always keep the true block max)
            interior = pos2 < len(self.v)
            succ = np.minimum(pos2, len(self.v) - 1)
            nd = np.where(interior, self.g[succ] + self.d[succ] - 1,
                          0).astype(np.int64)
        # widen old tuples strictly inside a band: band i covers
        # (dv[i-1], dv[i]] and hides up to dc[i]-1 of mass below the old
        # tuple's value (an old tuple AT dv[i] is exact: all band mass
        # really is <= it)
        band = np.searchsorted(dv, self.v, side="left")
        inside = (band < len(dv)) & (dv[np.minimum(band, len(dv) - 1)]
                                     != self.v)
        self.d += np.where(inside,
                           dc[np.minimum(band, len(dv) - 1)] - 1, 0)
        if match.any():
            # exact value collision: fold the mass into the existing tuple
            # (its rank interval just shifts with the added mass)
            self.g[pos[match]] += dc[match]
        if len(nv):
            v = np.concatenate([self.v, nv])
            g = np.concatenate([self.g, nc])
            d = np.concatenate([self.d, nd])
            order = np.argsort(v, kind="stable")
            self.v, self.g, self.d = v[order], g[order], d[order]
        self.n = n1
        self._compress()

    def merge(self, other: "GKSummary") -> None:
        """Merge another summary into this one (tuples re-inserted as
        weighted values; the other's within-tuple uncertainty Δ is
        surrendered, adding up to its ``eps·n_other`` to the rank error —
        the documented merged bound is ``eps·n_self + eps·n_other``)."""
        if other.n == 0:
            return
        self.insert_distinct(other.v, other.g)

    def _compress(self) -> None:
        t = int(np.floor(2.0 * self.eps * self.n))
        m = len(self.v)
        if m <= 2 or t <= 0:
            return
        v, g, d = list(self.v), list(self.g), list(self.d)
        i = m - 2
        while i >= 1:
            if g[i] + g[i + 1] + d[i + 1] <= t:
                g[i + 1] += g[i]
                del v[i], g[i], d[i]
            i -= 1
        self.v = np.asarray(v, np.float64)
        self.g = np.asarray(g, np.int64)
        self.d = np.asarray(d, np.int64)

    def query(self, qs: np.ndarray) -> np.ndarray:
        """Values whose rank is near ``q·n``: picks the tuple whose honest
        rank interval ``[rmin, rmax]`` minimizes the worst-case distance
        ``max(r - rmin, rmax - r)`` — optimal given the intervals, and
        since consecutive intervals overlap within the compression
        threshold the realized error stays within the sketch ε
        (vectorized over ``qs``)."""
        if self.n == 0:
            return np.full(np.shape(qs), np.nan)
        r = np.asarray(qs, np.float64).reshape(-1) * self.n
        rmin = np.cumsum(self.g)
        rmax = rmin + self.d
        cost = np.maximum(r[:, None] - rmin[None, :],
                          rmax[None, :] - r[:, None])
        return self.v[np.argmin(cost, axis=1)].reshape(np.shape(qs))


class _FeatureSketch:
    """Adaptive per-feature sketch: exact buffer -> distinct tally -> GK."""

    def __init__(self, capacity: int, eps: float, max_distinct: int):
        self.capacity = int(capacity)
        self.eps = float(eps)
        self.max_distinct = int(max_distinct)
        self.mode = "exact"
        self.buffer: List[np.ndarray] = []
        self.n = 0                       # finite values seen
        self.nan_count = 0               # exact (nan-bin layout must match)
        self.distinct: Optional[np.ndarray] = None
        self.counts: Optional[np.ndarray] = None
        self.gk: Optional[GKSummary] = None

    def update(self, col: np.ndarray) -> None:
        col = np.asarray(col, np.float64)
        finite_mask = ~np.isnan(col)
        self.nan_count += int(len(col) - finite_mask.sum())
        vals = col[finite_mask]
        if len(vals) == 0:
            return
        self.n += len(vals)
        if self.mode == "exact":
            self.buffer.append(vals)
            if self.n > self.capacity:
                self._spill()
            return
        dv, dc = np.unique(vals, return_counts=True)
        if self.mode == "distinct":
            self.distinct, self.counts = _merge_distinct(
                self.distinct, self.counts, dv, dc.astype(np.int64))
            if len(self.distinct) > self.max_distinct:
                self._degrade_to_gk()
        else:
            self.gk.insert_distinct(*self._block_summary(dv, dc))

    def _spill(self) -> None:
        """exact -> distinct (bounded vocabulary) or GK (continuous)."""
        vals = np.concatenate(self.buffer)
        self.buffer = []
        dv, dc = np.unique(vals, return_counts=True)
        if len(dv) <= self.max_distinct:
            self.mode = "distinct"
            self.distinct, self.counts = dv, dc.astype(np.int64)
        else:
            self.mode = "gk"
            self.gk = GKSummary(self.eps / 2.0)
            self.gk.insert_distinct(*self._block_summary(dv, dc))

    def _degrade_to_gk(self) -> None:
        self.mode = "gk"
        self.gk = GKSummary(self.eps / 2.0)
        self.gk.insert_distinct(*self._block_summary(self.distinct,
                                                     self.counts))
        self.distinct = self.counts = None

    def _block_summary(self, dv: np.ndarray, dc: np.ndarray):
        """Exact eps/2-rank summary of one block's (distinct, counts):
        keep the last value of every ``floor(eps/2 · block_n)``-wide rank
        band (merged mass rides as that tuple's g; its own rank stays
        exact).  Bounds per-block insert work at ~2/eps tuples regardless
        of block cardinality — this is the mergeable-sketch step."""
        tot = int(dc.sum())
        band_w = max(1, int(np.floor(0.5 * self.eps * tot)))
        cum = np.cumsum(dc)
        band = (cum - 1) // band_w
        keep = np.r_[band[:-1] != band[1:], True]
        kv = dv[keep]
        kc = np.diff(np.r_[0, cum[keep]])
        return kv, kc.astype(np.int64)

    # -- finalize ----------------------------------------------------------
    def bounds(self, budget: int, min_data_in_bin: int) -> np.ndarray:
        if self.n == 0:
            return np.zeros(0)
        if self.mode == "exact":
            return numeric_bin_bounds(budget, min_data_in_bin,
                                      vals=np.concatenate(self.buffer))
        if self.mode == "distinct":
            return numeric_bin_bounds(budget, min_data_in_bin,
                                      distinct=self.distinct,
                                      counts=self.counts)
        # GK: the vocabulary is unbounded, so the few-distinct "mids" path
        # cannot apply — quantile bounds straight from the summary, rank-
        # accurate to eps·n (the documented streaming ε)
        budget_eff = budget
        if min_data_in_bin > 1:
            budget_eff = max(1, min(budget, self.n // min_data_in_bin))
        qs = np.linspace(0.0, 1.0, budget_eff + 1)[1:-1]
        ub = np.unique(self.gk.query(qs))
        if len(ub) > 1:
            ub = ub[np.concatenate(([True], np.diff(ub) > 0))]
        return np.asarray(ub, np.float64)


class StreamingBinMapperBuilder:
    """One-pass BinMapper construction from row blocks.

    >>> b = StreamingBinMapperBuilder(num_features=F)
    >>> for X_block in stream:
    ...     b.update(X_block)
    >>> mapper = b.finalize(max_bin=255, min_data_in_bin=3)

    Exactness contract (tests/test_torch_sketch.py holds it against the reference's): bit-identical to
    ``BinMapper.fit(X_full)`` when total rows <= ``min(capacity,
    200_000)``; bit-identical at ANY n for bounded-vocabulary columns
    (vs the unsampled fit); otherwise bin edges are quantiles with rank
    error <= ``eps``·n.
    """

    def __init__(self, num_features: int, capacity: int = _DEFAULT_CAPACITY,
                 eps: float = 1e-3, max_distinct: int = _DEFAULT_MAX_DISTINCT):
        if num_features <= 0:
            raise ValueError(f"num_features must be positive, got "
                             f"{num_features}")
        if not (0.0 < eps < 0.5):
            raise ValueError(f"eps must be in (0, 0.5), got {eps}")
        self.num_features = int(num_features)
        self.num_rows = 0
        self._sketches = [_FeatureSketch(capacity, eps, max_distinct)
                          for _ in range(self.num_features)]

    def update(self, X_block: np.ndarray) -> "StreamingBinMapperBuilder":
        X_block = np.asarray(X_block)
        if X_block.ndim == 1:
            X_block = X_block[:, None]
        if X_block.ndim != 2:
            raise ValueError(
                f"blocks must be 2-D [rows, F], got shape {X_block.shape}")
        if X_block.shape[1] != self.num_features:
            raise ValueError(
                f"ragged feature counts across blocks: expected "
                f"{self.num_features} features, got {X_block.shape[1]}")
        X_block = np.asarray(X_block, np.float64)
        for f in range(self.num_features):
            self._sketches[f].update(X_block[:, f])
        self.num_rows += X_block.shape[0]
        return self

    def finalize(self, max_bin: int = 255,
                 min_data_in_bin: int = 3) -> BinMapper:
        if self.num_rows == 0:
            raise ValueError("finalize() before any update() — the sketch "
                             "has seen no rows")
        bounds: List[np.ndarray] = []
        nan_bin = np.full(self.num_features, -1, dtype=np.int32)
        n_bins = np.ones(self.num_features, dtype=np.int32)
        for f, sk in enumerate(self._sketches):
            has_nan = sk.nan_count > 0
            budget = max_bin - (1 if has_nan else 0)
            ub = sk.bounds(budget, min_data_in_bin)
            nb = len(ub) + 1
            if has_nan:
                nan_bin[f] = nb
                nb += 1
            bounds.append(ub)
            n_bins[f] = nb
        return BinMapper(bounds, nan_bin, n_bins,
                         np.zeros(self.num_features, dtype=bool))


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
