"""Binned datasets — the port of ``lightgbm_tpu/dataset.py``.

The reference's :class:`BinMapper` (``fit``, ``transform``,
``to_dict``/``from_dict``), its Exclusive Feature Bundling
:class:`FeatureBundler` and the quantile helpers are kept byte for byte: bin
codes must be identical in both packages, since every split and every
prediction is routed on them.  Binning is O(n log n) scalar work per feature
and stays in numpy.

:class:`Dataset` (``lgb.Dataset``) holds the binned matrix as a uint8
``[n_pad, F]`` tensor on its device, rows padded to ``ROW_PAD_MULTIPLE``
with ``row_mask`` marking the real ones, exactly as the reference pads: the
bagging draw is ``uniform(key, (n_pad,))``, so the padding decides which rows
a seed bags.  Labels and weights ride alongside as f32 (weight 0 on padding).
``categorical_feature`` (indices or names) bins those columns one bin per
kept category, as the reference does, and :attr:`Dataset.col_is_categorical`
flags them among the training columns (EFB never bundles them).  Query
groups (``group=``, the ranking objectives' query sizes, in row order) stay
on the host, with per-row query ids (``group_id``, -1 on padding) on the
device.  :meth:`Dataset.save_binary` writes the binned dataset to one
``.npz`` in the reference's layout and ``Dataset(path)`` reads it back
(either package's file) without binning again.

:meth:`Dataset.from_blocks` builds a STREAMED dataset from row blocks
(out-of-core training): the bin mapper comes from one pass of the mergeable
quantile sketch (``data/sketch.py``) or from ``reference=``, the codes stay
on the host in a :class:`~.data.block_store.BlockStore` (``X_binned`` is
None), and only the O(n) vectors (labels, weights, the row mask) live on
the device, sized by the store's ``padded_rows``.  ``save_binary``,
``subset`` and valid sets refuse a streamed dataset, as the reference's do.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .config import parse_params
from .device import resolve_device

ROW_PAD_MULTIPLE = 256


class FeatureBundler:
    """Exclusive Feature Bundling (EFB) — LightGBM's sparse-feature trick.

    Mutually-exclusive sparse features (rarely non-default on the same row)
    are merged into one histogram column whose bin axis concatenates the
    members' non-default bin ranges; histogram passes then scale with the
    number of BUNDLES, not features (upstream ``FindGroups``/``EFB`` in
    dataset construction; SURVEY.md §2C EFB row, BASELINE.md Criteo config).

    Bundling is a pure host-side recoding at bin time (uint8 in, uint8
    out), so the device path is unchanged — the
    binned matrix just has fewer columns.  Splits are found on the merged
    bin axis directly; a threshold inside member f's range separates f's
    values (plus all earlier members on the left / later on the right),
    a strict superset of the per-member thresholds upstream scans.

    ``groups`` covers every original feature exactly once; singleton groups
    pass through unchanged.  Merged code layout per multi-feature group:
    bin 0 = every member at its default bin; member j's non-default bins
    occupy ``[offset_j, offset_j + n_bins_j - 2]`` (its default bin is
    squeezed out).  Conflicting rows (two members non-default — allowed up
    to ``max_conflict_rate``) keep the LAST member's value.
    """

    def __init__(self, groups: List[List[int]], member_bins: np.ndarray,
                 default_bins: np.ndarray):
        self.groups = [list(map(int, g)) for g in groups]
        self.member_bins = np.asarray(member_bins, np.int64)
        self.default_bins = np.asarray(default_bins, np.int64)
        self.offsets: List[Optional[np.ndarray]] = []
        self.col_bins: List[int] = []
        for g in self.groups:
            if len(g) == 1:
                self.offsets.append(None)
                self.col_bins.append(int(self.member_bins[g[0]]))
            else:
                offs, o = [], 1
                for f in g:
                    offs.append(o)
                    o += int(self.member_bins[f]) - 1
                self.offsets.append(np.asarray(offs, np.int64))
                self.col_bins.append(o)

    @property
    def num_columns(self) -> int:
        return len(self.groups)

    @property
    def max_col_bins(self) -> int:
        return max(self.col_bins)

    def merge(self, codes: np.ndarray) -> np.ndarray:
        """Original per-feature codes [n, F] -> bundled codes [n, B]."""
        out = np.zeros((codes.shape[0], len(self.groups)), np.uint8)
        for c, g in enumerate(self.groups):
            if len(g) == 1:
                out[:, c] = codes[:, g[0]]
                continue
            col = np.zeros(codes.shape[0], np.int64)
            for f, o in zip(g, self.offsets[c]):
                cf = codes[:, f].astype(np.int64)
                dflt = self.default_bins[f]
                nz = cf != dflt
                adj = cf - (cf > dflt)
                col = np.where(nz, o + adj, col)
            out[:, c] = col.astype(np.uint8)
        return out

    def split_to_original(self, cols: np.ndarray,
                          bins: np.ndarray) -> np.ndarray:
        """Map (bundled column, threshold bin) of tree splits back to the
        original feature index (for feature_importance).  A threshold
        inside member j's range is attributed to member j; bin 0 (the
        all-default slot) attributes to the first member."""
        cols = np.asarray(cols, np.int64)
        bins = np.asarray(bins, np.int64)
        out = np.empty_like(cols)
        for c, g in enumerate(self.groups):
            m = cols == c
            if not m.any():
                continue
            if len(g) == 1:
                out[m] = g[0]
            else:
                j = np.searchsorted(self.offsets[c], bins[m],
                                    side="right") - 1
                out[m] = np.asarray(g)[np.clip(j, 0, len(g) - 1)]
        return out

    @staticmethod
    def fit(codes: np.ndarray, n_bins: np.ndarray,
            max_conflict_rate: float = 0.0, max_merged_bins: int = 256,
            sparse_threshold: float = 0.8, sample: int = 50_000,
            exclude: Optional[np.ndarray] = None
            ) -> Optional["FeatureBundler"]:
        """Greedy conflict-bounded bundling (upstream FindGroups).

        Only sufficiently sparse features (default-bin frequency >=
        ``sparse_threshold``, LightGBM's kSparseThreshold) are candidates;
        returns None when no multi-feature bundle forms (bundling dense
        data would only distort histograms for zero gain).
        """
        n, num_features = codes.shape
        if num_features < 3:
            return None
        samp = codes[: min(n, sample)]
        ns = len(samp)
        default_bins = np.array(
            [np.bincount(samp[:, f], minlength=int(n_bins[f])).argmax()
             for f in range(num_features)], np.int64)
        nondef = samp != default_bins[None, :]
        nd_count = nondef.sum(axis=0)
        eligible = nd_count <= (1.0 - sparse_threshold) * ns
        if exclude is not None:
            eligible &= ~np.asarray(exclude, bool)
        budget = max_conflict_rate * ns

        order = np.argsort(-nd_count)
        bundles: List[dict] = []
        for f in order:
            f = int(f)
            if not eligible[f]:
                continue
            placed = False
            for b in bundles:
                extra = int(np.count_nonzero(b["occ"] & nondef[:, f]))
                if (b["conflicts"] + extra <= budget
                        and b["bins"] + int(n_bins[f]) - 1 <= max_merged_bins):
                    b["members"].append(f)
                    b["occ"] |= nondef[:, f]
                    b["conflicts"] += extra
                    b["bins"] += int(n_bins[f]) - 1
                    placed = True
                    break
            if not placed:
                bundles.append({"members": [f], "occ": nondef[:, f].copy(),
                                "conflicts": 0, "bins": 1 + int(n_bins[f]) - 1})
        multi = [b for b in bundles if len(b["members"]) > 1]
        if not multi:
            return None
        bundled_feats = {f for b in multi for f in b["members"]}
        groups = [[f] for f in range(num_features) if f not in bundled_feats]
        groups += [sorted(b["members"]) for b in multi]
        return FeatureBundler(groups, n_bins, default_bins)


def _weighted_quantile(distinct: np.ndarray, counts: np.ndarray,
                       qs: np.ndarray) -> np.ndarray:
    """``np.quantile(expanded, qs, method="linear")`` on weighted distinct
    values WITHOUT expanding them.

    Replicates numpy's linear interpolation bit-for-bit (virtual index
    ``h = q*(n-1)``, and numpy's ``_lerp`` computes ``b - (b-a)*(1-t)``
    when ``t >= 0.5`` instead of ``a + (b-a)*t`` — the branch matters for
    bitwise parity), so the streaming sketch's bounded-distinct path
    yields the SAME bounds the in-memory fit would have produced from the
    expanded sample (tests/test_sketch.py pins this against np.quantile).
    """
    n = int(counts.sum())
    cum = np.cumsum(counts)                 # value i ends at position cum[i]-1
    h = np.asarray(qs, np.float64) * (n - 1)
    lo = np.floor(h).astype(np.int64)
    gamma = h - lo
    hi = np.minimum(lo + 1, n - 1)
    v_lo = distinct[np.searchsorted(cum, lo, side="right")]
    v_hi = distinct[np.searchsorted(cum, hi, side="right")]
    d = v_hi - v_lo
    return np.where(gamma >= 0.5, v_hi - d * (1.0 - gamma),
                    v_lo + d * gamma)


def numeric_bin_bounds(budget: int, min_data_in_bin: int,
                       vals: Optional[np.ndarray] = None,
                       distinct: Optional[np.ndarray] = None,
                       counts: Optional[np.ndarray] = None) -> np.ndarray:
    """Numeric-feature bound finder shared by :meth:`BinMapper.fit` and the
    streaming sketch builder (``data.sketch``).

    Given either the raw finite sample ``vals`` or its ``(distinct,
    counts)`` summary, honors ``min_data_in_bin`` (budget cap + greedy
    sparse-bin merge) exactly as the historical in-memory fit did; the
    quantile path uses ``np.quantile`` when ``vals`` is available and the
    bit-equivalent :func:`_weighted_quantile` otherwise, so the streaming
    builder is bit-compatible with the in-memory fit whenever both see the
    same sample.
    """
    if distinct is None:
        distinct, counts = np.unique(vals, return_counts=True)
    n_vals = int(counts.sum())
    if n_vals == 0:
        return np.zeros(0)
    budget_eff = budget
    if min_data_in_bin > 1:
        budget_eff = max(1, min(budget, n_vals // min_data_in_bin))
    if len(distinct) <= budget_eff:
        mids = (distinct[:-1] + distinct[1:]) / 2.0
        if min_data_in_bin > 1 and len(distinct) > 1:
            # greedily merge adjacent sparse distinct values until each
            # bin reaches the floor
            keep, acc = [], 0
            for i in range(len(distinct) - 1):
                acc += counts[i]
                if acc >= min_data_in_bin and \
                        counts[i + 1:].sum() >= min_data_in_bin:
                    keep.append(mids[i])
                    acc = 0
            ub = np.asarray(keep)
        else:
            ub = mids
    else:
        qs = np.linspace(0.0, 1.0, budget_eff + 1)[1:-1]
        if vals is not None:
            ub = np.unique(np.quantile(vals, qs, method="linear"))
        else:
            ub = np.unique(_weighted_quantile(distinct, counts, qs))
        # drop near-duplicate bounds
        if len(ub) > 1:
            ub = ub[np.concatenate(([True], np.diff(ub) > 0))]
    return np.asarray(ub, dtype=np.float64)


class BinMapper:
    """Per-feature quantile binning table (LightGBM BinMapper equivalent).

    For each feature stores ascending ``upper_bounds`` such that raw value v
    maps to bin ``searchsorted(upper_bounds, v, side='left')``; the last bound
    is +inf.  NaN maps to the dedicated last bin (index ``n_bins-1``) when the
    feature has missing values, else NaN never occurs.
    """

    def __init__(self, upper_bounds: List[np.ndarray], nan_bin: np.ndarray,
                 n_bins: np.ndarray, is_categorical: Optional[np.ndarray] = None):
        self.upper_bounds = upper_bounds          # list of f64[n_bins_f - 1] finite bounds
        self.nan_bin = nan_bin                    # i32[F]: bin index for NaN (or -1)
        self.n_bins = n_bins                      # i32[F]: bins actually used per feature
        self.num_features = len(upper_bounds)
        self.is_categorical = (
            is_categorical if is_categorical is not None
            else np.zeros(self.num_features, dtype=bool)
        )
        self.bundler: Optional[FeatureBundler] = None  # EFB (attach post-fit)

    @property
    def max_num_bins(self) -> int:
        if self.bundler is not None:
            return self.bundler.max_col_bins
        return int(self.n_bins.max()) if len(self.n_bins) else 1

    @staticmethod
    def fit(
        X: np.ndarray,
        max_bin: int = 255,
        min_data_in_bin: int = 3,
        categorical: Sequence[int] = (),
        sample_cnt: int = 200_000,
        seed: int = 1,
    ) -> "BinMapper":
        """Build bin bounds per feature via (sampled) quantiles.

        Mirrors LightGBM's GreedyFindBin behavior loosely: distinct values get
        their own bins when few; otherwise equal-frequency quantile bins;
        a dedicated NaN bin is appended when the feature has missing values.
        """
        n, num_features = X.shape
        rng = np.random.default_rng(seed)
        if n > sample_cnt:
            idx = rng.choice(n, size=sample_cnt, replace=False)
        else:
            idx = slice(None)
        cat = set(int(c) for c in categorical)
        bounds: List[np.ndarray] = []
        nan_bin = np.full(num_features, -1, dtype=np.int32)
        n_bins = np.ones(num_features, dtype=np.int32)
        is_cat = np.zeros(num_features, dtype=bool)
        for f in range(num_features):
            col = np.asarray(X[idx, f], dtype=np.float64)
            has_nan = bool(np.isnan(col).any())
            vals = col[~np.isnan(col)]
            budget = max_bin - (1 if has_nan else 0)
            if f in cat:
                # categorical: one bin per kept category value (exact match
                # at transform time; unseen/rare values share the overflow
                # bin).  The grower finds gradient-ordered k-vs-rest SUBSET
                # splits over these bins (ops.split CatInfo path).
                is_cat[f] = True
                cats = np.unique(vals)
                if len(cats) > budget - 1:
                    uniq, cnts = np.unique(vals, return_counts=True)
                    cats = np.sort(uniq[np.argsort(-cnts)[: budget - 1]])
                ub = cats  # stores category VALUES for categorical features
            elif len(vals) == 0:
                ub = np.zeros(0)
            else:
                # honor min_data_in_bin (LightGBM GreedyFindBin) — shared
                # with the streaming sketch builder (data.sketch), which
                # must stay bit-compatible with this in-memory path
                ub = numeric_bin_bounds(budget, min_data_in_bin, vals=vals)
            ub = np.asarray(ub, dtype=np.float64)
            nb = len(ub) + 1
            if has_nan:
                nan_bin[f] = nb
                nb += 1
            bounds.append(ub)
            n_bins[f] = nb
        return BinMapper(bounds, nan_bin, n_bins, is_cat)

    def transform(self, X: np.ndarray) -> np.ndarray:
        """Map raw features to bin codes uint8[n, F] (bundled columns when
        EFB is active — the training and predict paths must agree)."""
        codes = self._transform_unbundled(X)
        if self.bundler is not None:
            return self.bundler.merge(codes)
        return codes

    def _transform_unbundled(self, X: np.ndarray) -> np.ndarray:
        n, num_features = X.shape
        assert num_features == self.num_features, (
            f"feature count mismatch: {num_features} vs {self.num_features}")
        out = np.empty((n, num_features), dtype=np.uint8)
        for f in range(num_features):
            col = np.asarray(X[:, f], dtype=np.float64)
            if self.is_categorical[f]:
                cats = self.upper_bounds[f]
                idx = np.searchsorted(cats, col).clip(0, max(len(cats) - 1, 0))
                if len(cats) > 0:
                    hit = cats[idx] == col
                    codes = np.where(hit, idx, len(cats))  # overflow bin
                else:
                    codes = np.zeros(n, dtype=np.int64)
            else:
                codes = np.searchsorted(self.upper_bounds[f], col, side="left")
            if self.nan_bin[f] >= 0:
                codes = np.where(np.isnan(col), self.nan_bin[f], codes)
            elif not self.is_categorical[f]:
                # no NaN seen at fit time: LightGBM converts missing to zero
                # (BinMapper::ValueToBin with missing_type=None),
                # i.e. NaN lands in the bin containing 0.0
                zero_bin = int(np.searchsorted(self.upper_bounds[f], 0.0,
                                               side="left"))
                codes = np.where(np.isnan(col), zero_bin, codes)
            # (categorical NaN already routed to the overflow bin above)
            out[:, f] = codes.astype(np.uint8)
        return out

    # -- persistence glue (single JSON schema shared by the model file and
    # the packed serving artifact — utils.serialize owns the layout) -------
    def bin_upper_bound(self, feature: int, bin_idx: int) -> float:
        """Raw-value threshold of ``bin <= bin_idx`` (for model dumps)."""
        ub = self.upper_bounds[feature]
        if bin_idx < len(ub):
            return float(ub[bin_idx])
        return float("inf")

    def to_dict(self) -> dict:
        from .utils.serialize import mapper_to_dict
        return mapper_to_dict(self)

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        from .utils.serialize import mapper_from_dict
        return mapper_from_dict(d)


def _to_2d_float_array(data: Any) -> np.ndarray:
    """Accept numpy / pandas / list-of-lists; return f64 ndarray [n, F]."""
    if hasattr(data, "to_numpy"):  # pandas DataFrame/Series
        data = data.to_numpy()
    arr = np.asarray(data)
    if arr.dtype == object:
        arr = arr.astype(np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    if arr.ndim != 2:
        raise ValueError(f"data must be 2-D, got shape {arr.shape}")
    return np.ascontiguousarray(arr, dtype=np.float64)


def _to_group(group: Any) -> Optional[np.ndarray]:
    return None if group is None else np.asarray(group, np.int64).reshape(-1)


def _to_1d_float_array(x: Any) -> np.ndarray:
    if hasattr(x, "to_numpy"):
        x = x.to_numpy()
    return np.asarray(x, dtype=np.float64).reshape(-1)


class Dataset:
    """``lgb.Dataset``: a lazily binned training set on one device.

    >>> dtrain = Dataset(X, label=y, device="cuda")
    >>> booster = train(params, dtrain, num_boost_round=200)

    ``device=None`` means the dataset's ``reference`` device when there is
    one, else ``"cuda"`` (raising :class:`~lightgbm_tpu_torch.device.
    NoDeviceError` without a card); the CPU only on ``device="cpu"``.
    Validation sets share the training set's bin mapper through
    ``reference=dtrain``, exactly as in LightGBM.
    """

    def __init__(self, data: Any, label: Any = None, weight: Any = None,
                 reference: Optional["Dataset"] = None,
                 params: Optional[Dict[str, Any]] = None,
                 device: Union[str, torch.device, None] = None, *,
                 init_score: Any = None, group: Any = None,
                 feature_name: Union[str, Sequence[str]] = "auto",
                 categorical_feature: Union[str, Sequence] = "auto",
                 free_raw_data: bool = False):
        if device is None and reference is not None:
            self.device = reference.device
        else:
            self.device = resolve_device(device)
        self.raw_data = data
        self._label = None if label is None else _to_1d_float_array(label)
        self._weight = None if weight is None else _to_1d_float_array(weight)
        self._group = _to_group(group)
        self._init_score = (None if init_score is None
                            else _to_1d_float_array(init_score))
        self.reference = reference
        self.params: Dict[str, Any] = dict(params or {})
        self.free_raw_data = free_raw_data
        self._feature_name_arg = feature_name
        self._categorical_feature_arg = categorical_feature
        self.bin_mapper: Optional[BinMapper] = None
        self._constructed = False
        self.num_data_: Optional[int] = None
        self.num_feature_: Optional[int] = None
        self.raw_num_feature_: Optional[int] = None
        self.feature_names: Optional[List[str]] = None
        self.X_binned: Optional[torch.Tensor] = None  # u8 [n_pad, F]
        self.y: Optional[torch.Tensor] = None         # f32 [n_pad]
        self.w: Optional[torch.Tensor] = None         # f32 [n_pad], 0 pad
        self.row_mask: Optional[torch.Tensor] = None  # f32 [n_pad] 1/0
        # int32 [n_pad] query ids for ranking (-1 on padding), None
        # without groups
        self.group_id: Optional[torch.Tensor] = None
        self._rank_eval_ctx = None    # ranking.RankEvalContext, built lazily

    # a streamed dataset (from_blocks) sets these; an in-memory one keeps
    # the codes in X_binned
    is_streamed = False
    block_store = None

    @classmethod
    def from_blocks(cls, blocks, label=None, *, weight=None,
                    params: Optional[Dict[str, Any]] = None,
                    feature_name: Union[str, Sequence[str]] = "auto",
                    reference: Optional["Dataset"] = None,
                    device: Union[str, torch.device, None] = None
                    ) -> "Dataset":
        """Build a STREAMED dataset from row blocks without materializing
        the raw matrix, the reference's ``from_blocks``: the device holds
        one ``[block_rows, F]`` transfer buffer per prefetched block, not
        the ``[n, F]`` matrix.

        ``blocks`` is a sequence of blocks or a zero-argument callable
        returning a fresh iterator (two passes are needed: the sketch fit,
        then binning); a one-shot generator is refused.  Each block is a
        2-D ``[rows, F]`` array or an ``(X, y)`` / ``(X, y, w)`` tuple; all
        blocks must agree on the feature count and dtype (ValueError
        otherwise).  ``max_bin``, ``min_data_in_bin``,
        ``stream_block_rows`` (a multiple of 256, default 131,072),
        ``stream_sketch_capacity`` and ``stream_sketch_eps`` come from
        ``params``.  The bin mapper is the one-pass sketch's
        (:class:`~.data.sketch.StreamingBinMapperBuilder`), bit-identical to
        the in-memory fit while the rows stay within the sketch capacity and
        the in-memory fit's 200,000-row sample.

        Streaming scope: numeric features, no EFB.  ``reference`` pins the
        binning schema: its fitted mapper is reused verbatim (no sketch
        pass), so growing data keeps the schema digest that continuation
        checks; it must be constructed and unbundled.  The O(n) vectors go
        to ``device`` (None: ``reference``'s device if given, else
        ``cuda``).
        """
        from .data import BlockStore, StreamingBinMapperBuilder

        if callable(blocks):
            make_iter = blocks
        elif hasattr(blocks, "__len__"):
            def make_iter():
                return iter(blocks)
        else:
            raise ValueError(
                "from_blocks needs two passes over the blocks (sketch fit, "
                "then binning) — pass a list/tuple or a zero-arg callable "
                "returning a fresh iterator, not a one-shot generator")

        def split_block(b, idx):
            ys = ws = None
            if isinstance(b, tuple):
                if len(b) == 2:
                    x, ys = b
                elif len(b) == 3:
                    x, ys, ws = b
                else:
                    raise ValueError(
                        f"block {idx}: tuples must be (X, y) or (X, y, w), "
                        f"got length {len(b)}")
            else:
                x = b
            x = np.asarray(x)
            if x.ndim == 1:
                x = x[:, None]
            if x.ndim != 2:
                raise ValueError(
                    f"block {idx}: blocks must be 2-D [rows, F], got shape "
                    f"{x.shape}")
            return x, ys, ws

        ref_dev = getattr(reference, "device", None)
        dev = (ref_dev if device is None and ref_dev is not None
               else resolve_device(device))
        p = parse_params(dict(params or {}), warn_unknown=False)
        block_rows = int(p.extra.get("stream_block_rows", 131072))
        if block_rows <= 0 or block_rows % ROW_PAD_MULTIPLE:
            raise ValueError(
                f"stream_block_rows={block_rows} must be a positive "
                f"multiple of {ROW_PAD_MULTIPLE}")

        ref_mapper = None
        if reference is not None:
            ref_mapper = getattr(reference, "bin_mapper", reference)
            if ref_mapper is None:
                raise ValueError(
                    "reference= Dataset has no fitted BinMapper — call "
                    "construct() on it (or train with it) first")
            if getattr(ref_mapper, "bundler", None) is not None:
                raise ValueError(
                    "reference= Dataset was built with EFB bundling, "
                    "which streamed datasets do not support — rebuild "
                    "the reference with enable_bundle=false")

        # pass 1: the streaming quantile sketch -> BinMapper (skipped when
        # a reference pins the schema; the loop still validates the blocks
        # and collects labels and weights)
        builder = None
        first_dtype = None
        y_parts: List[np.ndarray] = []
        w_parts: List[np.ndarray] = []
        blocks_have_y = blocks_have_w = False
        saw_block = False
        for idx, b in enumerate(make_iter()):
            x, ys, ws = split_block(b, idx)
            if not saw_block:
                saw_block = True
                first_dtype = x.dtype
                if ref_mapper is None:
                    builder = StreamingBinMapperBuilder(
                        x.shape[1],
                        capacity=int(p.extra.get("stream_sketch_capacity",
                                                 200_000)),
                        eps=float(p.extra.get("stream_sketch_eps", 1e-3)))
                blocks_have_y = ys is not None
                blocks_have_w = ws is not None
            if x.dtype != first_dtype:
                raise ValueError(
                    f"block {idx}: dtype {x.dtype} != block 0's "
                    f"{first_dtype} — blocks must agree on dtype")
            if (ys is not None) != blocks_have_y or \
                    (ws is not None) != blocks_have_w:
                raise ValueError(
                    f"block {idx}: inconsistent (X, y[, w]) tuple shape "
                    "across blocks")
            if builder is not None:
                builder.update(x)   # raises on ragged feature counts
            elif x.shape[1] != ref_mapper.num_features:
                raise ValueError(
                    f"block {idx}: {x.shape[1]} features != reference "
                    f"Dataset's {ref_mapper.num_features}")
            if ys is not None:
                y_parts.append(np.asarray(ys, np.float64).reshape(-1))
            if ws is not None:
                w_parts.append(np.asarray(ws, np.float64).reshape(-1))
        if not saw_block:
            raise ValueError("from_blocks: empty block iterator")
        if blocks_have_y and label is not None:
            raise ValueError(
                "labels supplied both per-block and via label= — pick one")
        mapper = (ref_mapper if ref_mapper is not None
                  else builder.finalize(max_bin=p.max_bin,
                                        min_data_in_bin=p.min_data_in_bin))

        # pass 2: bin each block and pack the codes on the host
        writer = BlockStore.writer(block_rows)
        for idx, b in enumerate(make_iter()):
            x, _, _ = split_block(b, idx)
            writer.append(mapper._transform_unbundled(
                np.ascontiguousarray(x, dtype=np.float64)))
        store = writer.finish()
        store.device = dev
        n, num_features = store.num_rows, store.num_features

        ds = cls.__new__(cls)
        ds.device = dev
        ds.raw_data = None
        ds._label = (np.concatenate(y_parts) if blocks_have_y
                     else None if label is None else _to_1d_float_array(label))
        ds._weight = (np.concatenate(w_parts) if blocks_have_w
                      else None if weight is None
                      else _to_1d_float_array(weight))
        ds._group = None
        ds._init_score = None
        ds.reference = None
        ds.params = dict(params or {})
        ds.free_raw_data = False
        ds._feature_name_arg = feature_name
        ds._categorical_feature_arg = None
        ds.bin_mapper = mapper
        ds.num_data_ = n
        ds.num_feature_ = num_features
        ds.raw_num_feature_ = num_features
        ds.feature_names = ds._resolve_feature_names(num_features)
        ds.X_binned = None
        ds.is_streamed = True
        ds.block_store = store
        ds.y = ds.w = ds.group_id = None
        ds._rank_eval_ctx = None
        # the O(n) vectors stay on the device, sized to the store's padded
        # extent so per-block slices never go ragged
        mask = np.zeros(store.padded_rows, np.float32)
        mask[:n] = 1.0
        ds.row_mask = torch.from_numpy(mask).to(dev)
        ds._put_targets()
        ds._constructed = True
        return ds

    # -- lightgbm-compatible introspection ---------------------------------
    def num_data(self) -> int:
        self.construct()
        return int(self.num_data_)

    def num_feature(self) -> int:
        """Original (pre-EFB) feature count."""
        self.construct()
        return int(self.raw_num_feature_ or self.num_feature_)

    def get_label(self) -> Optional[np.ndarray]:
        return self._label

    def set_label(self, label) -> "Dataset":
        self._label = None if label is None else _to_1d_float_array(label)
        if self._constructed and self._label is not None:
            self._put_targets()
        return self

    def get_weight(self) -> Optional[np.ndarray]:
        return self._weight

    def set_weight(self, weight) -> "Dataset":
        self._weight = None if weight is None else _to_1d_float_array(weight)
        if self._constructed:
            self._put_targets()
        return self

    def get_group(self) -> Optional[np.ndarray]:
        return self._group

    def set_group(self, group) -> "Dataset":
        self._group = _to_group(group)
        self._rank_eval_ctx = None
        if self._constructed:
            self._put_targets()
        return self

    def get_init_score(self) -> Optional[np.ndarray]:
        return self._init_score

    def set_init_score(self, init_score) -> "Dataset":
        self._init_score = (None if init_score is None
                            else _to_1d_float_array(init_score))
        return self

    def feature_num_bin(self, feature: int) -> int:
        """Number of bins a feature uses (LightGBM
        ``Dataset.feature_num_bin``), indexed by original feature."""
        self.construct()
        return int(self.bin_mapper.n_bins[int(feature)])

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self.feature_names)

    def get_field(self, name: str):
        return {"label": self._label, "weight": self._weight,
                "group": self._group, "init_score": self._init_score}[name]

    def set_field(self, name: str, value) -> "Dataset":
        return getattr(self, f"set_{name}")(value)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        """A validation set binned with this dataset's mapper, on its
        device."""
        return Dataset(data, label=label, weight=weight, group=group,
                       init_score=init_score, reference=self,
                       params=params or self.params)

    # -- construction -------------------------------------------------------
    def _resolve_feature_names(self, num_features: int) -> List[str]:
        fn = self._feature_name_arg
        if fn == "auto" or fn is None:
            if hasattr(self.raw_data, "columns"):
                return [str(c) for c in self.raw_data.columns]
            return [f"Column_{i}" for i in range(num_features)]
        names = list(fn)
        if len(names) != num_features:
            raise ValueError("feature_name length mismatch")
        return [str(c) for c in names]

    def _resolve_categorical(self, feature_names: List[str]) -> List[int]:
        """``categorical_feature`` as sorted, distinct column indices (names
        looked up in ``feature_names``; an unknown name raises
        ``ValueError``), as the reference resolves it."""
        cf = self._categorical_feature_arg
        if cf == "auto" or cf is None:
            return []
        out = []
        for c in cf:
            if isinstance(c, str):
                if c not in feature_names:
                    raise ValueError(
                        f"categorical_feature '{c}' not in feature names")
                out.append(feature_names.index(c))
            else:
                out.append(int(c))
        return sorted(set(out))

    def construct(self) -> "Dataset":
        if self._constructed:
            return self
        if isinstance(self.raw_data, str):
            # a path: reload a save_binary() file (LightGBM's
            # Dataset('train.bin') contract)
            path = self.raw_data
            if self.free_raw_data:
                self.raw_data = None
            self._load_binary(path)
            return self
        p = parse_params(self.params, warn_unknown=False)
        X = _to_2d_float_array(self.raw_data)
        n, num_features = X.shape
        self.num_data_ = n
        self.num_feature_ = num_features
        self.raw_num_feature_ = num_features
        self.feature_names = self._resolve_feature_names(num_features)
        cat_idx = self._resolve_categorical(self.feature_names)
        codes = None
        if self.reference is not None:
            self.reference.construct()
            self.bin_mapper = self.reference.bin_mapper
        if self.bin_mapper is None:
            self.bin_mapper = BinMapper.fit(
                X, max_bin=p.max_bin, min_data_in_bin=p.min_data_in_bin,
                categorical=cat_idx, seed=p.data_random_seed)
            raw_codes = self.bin_mapper._transform_unbundled(X)
            if p.enable_bundle:
                self.bin_mapper.bundler = FeatureBundler.fit(
                    raw_codes, self.bin_mapper.n_bins,
                    max_conflict_rate=p.max_conflict_rate,
                    exclude=self.bin_mapper.is_categorical)
            b = self.bin_mapper.bundler
            codes = raw_codes if b is None else b.merge(raw_codes)
        if codes is None:
            codes = self.bin_mapper.transform(X)
        self._from_codes(codes)
        return self

    def _from_codes(self, codes: np.ndarray) -> None:
        n, num_features = codes.shape
        self.num_data_ = n
        self.num_feature_ = num_features
        n_pad = -(-n // ROW_PAD_MULTIPLE) * ROW_PAD_MULTIPLE
        padded = np.zeros((n_pad, num_features), np.uint8)
        padded[:n] = codes
        self.X_binned = torch.from_numpy(padded).to(self.device)
        mask = np.zeros(n_pad, np.float32)
        mask[:n] = 1.0
        self.row_mask = torch.from_numpy(mask).to(self.device)
        self._put_targets()
        self._constructed = True

    def _put_targets(self) -> None:
        n, n_pad = self.num_data_, int(self.row_mask.shape[0])

        def padded(a: np.ndarray, what: str) -> torch.Tensor:
            a = np.asarray(a, np.float32)
            if len(a) != n:
                raise ValueError(f"{what} length {len(a)} != num_data {n}")
            out = np.zeros(n_pad, np.float32)
            out[:n] = a
            return torch.from_numpy(out).to(self.device)

        if self._label is not None:
            self.y = padded(self._label, "label")
        self.w = padded(np.ones(n) if self._weight is None else self._weight,
                        "weight")
        self._rank_eval_ctx = None
        if self._group is None:
            self.group_id = None
            return
        if self._group.sum() != n:
            raise ValueError("group sizes must sum to num_data")
        gid = np.full(n_pad, -1, np.int32)
        gid[:n] = np.repeat(np.arange(len(self._group)), self._group)
        self.group_id = torch.from_numpy(gid).to(self.device)

    def save_binary(self, filename: str) -> "Dataset":
        """Write the CONSTRUCTED (binned) dataset to one ``.npz`` file
        (LightGBM ``Dataset.save_binary``), the reference's layout: the bin
        codes, labels, weights, groups and ``init_score``, the bin mapper
        and the EFB bundle map, so ``Dataset(filename)`` reloads it in
        either package without the raw data or a binning pass.  A
        filename without the ``.npz`` suffix gets it."""
        import json

        from .utils.serialize import mapper_to_dict

        self.construct()
        if self.is_streamed:
            raise ValueError(
                "save_binary is not supported for streamed datasets — the "
                "binned codes live host-side in the BlockStore, not as one "
                "materialized matrix")
        if not filename.endswith(".npz"):
            filename += ".npz"  # numpy appends it anyway; keep load in sync
        n = self.num_data_
        payload = {
            "codes": self.X_binned[:n].cpu().numpy(),
            "mapper_json": np.frombuffer(
                json.dumps(mapper_to_dict(self.bin_mapper)).encode(),
                dtype=np.uint8),
            "feature_names": np.asarray(self.feature_names, dtype=object),
            "raw_num_feature": np.int64(self.raw_num_feature_
                                        or self.num_feature_),
        }
        for name, arr in (("label", self._label), ("weight", self._weight),
                          ("group", self._group),
                          ("init_score", self._init_score)):
            if arr is not None:
                payload[name] = np.asarray(arr)
        np.savez_compressed(filename, **payload)
        return self

    def _load_binary(self, filename: str) -> None:
        """Read a :meth:`save_binary` file (either package's) onto this
        Dataset's device; the constructor's label, weight, group and
        ``init_score`` take precedence over the stored ones."""
        import json
        import os

        from .utils.serialize import mapper_from_dict

        if not os.path.exists(filename) and not filename.endswith(".npz"):
            filename += ".npz"  # save_binary adds the suffix
        with np.load(filename, allow_pickle=True) as z:
            codes = z["codes"].astype(np.uint8)
            self.bin_mapper = mapper_from_dict(
                json.loads(bytes(z["mapper_json"]).decode()))
            self.feature_names = [str(s) for s in z["feature_names"]]
            self.raw_num_feature_ = int(z["raw_num_feature"])
            if self._label is None and "label" in z:
                self._label = _to_1d_float_array(z["label"])
            if self._weight is None and "weight" in z:
                self._weight = _to_1d_float_array(z["weight"])
            if self._group is None and "group" in z:
                self._group = _to_group(z["group"])
            if self._init_score is None and "init_score" in z:
                self._init_score = _to_1d_float_array(z["init_score"])
        self._from_codes(codes)

    def subset(self, used_indices, params=None) -> "Dataset":
        """Row subset sharing this dataset's bin mapper (the cv folds)."""
        self.construct()
        if self.is_streamed:
            raise ValueError(
                "subset is not supported for streamed datasets")
        used = np.asarray(used_indices, dtype=np.int64)
        codes = self.X_binned[: self.num_data_].cpu().numpy()[used]
        sub = Dataset.__new__(Dataset)
        sub.__dict__.update(self.__dict__)
        sub.raw_data = None
        sub.reference = None
        sub.params = dict(params or self.params)
        sub._label = None if self._label is None else self._label[used]
        sub._weight = None if self._weight is None else self._weight[used]
        sub._group = None                # a row subset has no query groups
        sub._init_score = (None if self._init_score is None
                           else self._init_score[used])
        sub._from_codes(codes)
        return sub

    @property
    def num_bins(self) -> int:
        """Bin-axis size of the histograms."""
        self.construct()
        return max(2, self.bin_mapper.max_num_bins)

    @property
    def col_is_categorical(self) -> np.ndarray:
        """Categorical flag per training column: after EFB a bundled column
        is never categorical (categoricals are excluded from bundling)."""
        self.construct()
        raw = self.bin_mapper.is_categorical
        b = self.bin_mapper.bundler
        if b is None:
            return np.asarray(raw, bool)
        return np.array([len(g) == 1 and bool(raw[g[0]]) for g in b.groups])

