"""GBDT boosting and the ``Booster`` — the port of ``lightgbm_tpu/models/gbdt.py``
on its plain single-device branch.

One boosting round: grad/hess of the objective -> bagging-masked stats ->
one tree from the wave grower or the strict best-first grower
(:func:`resolve_wave_width`) -> the train-score update, all on the
training Dataset's device.  A multiclass round grows the K class trees as
one batch over the shared binned matrix (the reference's ``vmap`` over the
class axis, ``mc_round_update``): the batched wave grower, or the batched
strict grower below 4,096 rows or 16 leaves; a round's tree then holds
``[K, M]`` node arrays and scores are ``[n, K]``.  The host drives the
rounds and reads only what decides control flow (one number per wave, the
pruned table of an exact-tail tree, the metrics a callback asks for).
Bagging and ``feature_fraction`` draw from the reference's counter-based
streams (``utils/random.py``), keyed by round index, so the same params and
seed give the same trees as the reference.

The objectives with leaf renewal (``regression_l1``, ``quantile``, ``mape``)
refit each single-class tree's leaves to weighted quantiles of the residuals
(:func:`~.tree.renew_leaf_values`) before the score update, as the
reference's round step does.

``boosting="goss"`` grows a single-class tree on its compacted rows (the
``k_top`` largest ``|g|`` and ``k_other`` sampled others, gathered into a
dense ``[k_top + k_other, F]`` matrix by :func:`~..ops.sampling.goss_select`,
which reads nothing back to the host) and updates every row's score by one
traversal; multiclass GOSS re-weights the rows instead.  Precision, wave
width and the int8 row limit resolve at the compacted row count.
``boosting="dart"`` drops trees by the reference's host draw
(:func:`dart_drops`), grows the round's tree from the scores without them
and rescales the new and the dropped trees' stored leaves in place.  All
share one round body (:meth:`Booster._round_body`, the reference's
``_round_fn``).

Categorical columns (``Dataset(categorical_feature=)``) take k-vs-rest
subset splits in every round kind: the Booster builds the dataset's
:class:`~..ops.split.CatInfo` once (:func:`build_cat_info`) and hands it
to each grower call, as the reference's ``cat_key`` does.

``objective="lambdarank"`` packs the training Dataset's query groups
into its objective at setup (``ranking.LambdaRank.set_group``) and takes
the exact wave tail; ``ndcg@k`` / ``map@k`` are evaluated per query group
(``ranking.eval_ranking``).

``monotone_constraints`` (basic method), ``interaction_constraints`` and
``extra_trees`` reach every round kind's grower as the reference's
``mono_key``, ``ic_key`` and ``nbins_key`` do: resolved once at setup onto
the training columns (:func:`resolve_monotone_constraints`,
:func:`resolve_interaction_constraints`, :func:`extra_trees_col_bins`),
held on the device, and handed to each grower call with the round key.

``linear_tree`` grows each tree on the binned codes as any round does and
then fits a ridge model in every leaf over its path features on the RAW
values (:func:`~.tree.fit_linear_leaves`, the reference's
``round_fn_linear``); the raw matrix goes to the device once at setup, and
valid sets and ``predict`` evaluate the leaves on theirs
(:func:`linear_tree_values`).  ``predict(pred_leaf=True)`` returns leaf
ordinals, ``predict(pred_contrib=True)`` exact TreeSHAP values
(``ops/shap.py``), and ``dump_model``/``trees_to_dataframe`` the
reference's nested and flat views.

Continuation follows the reference: ``train(init_model=)`` ingests a
Booster's or a model file's forest (:meth:`Booster.ingest_init_model`,
its leaves rescaled to the new learning rate), a loaded Booster's
``update(train_set)`` attaches the Dataset
(:meth:`Booster._attach_continuation`), and both replay the forest into
the train scores with the live round's update op
(:meth:`Booster._rebase_and_replay`), so a continued run grows the trees
of an uninterrupted one.  A continuation may change
``num_leaves``: a forest of mixed node capacities is padded to the largest
(:func:`~.tree.pad_tree`) wherever it is stacked (predict, DART's dropped
trees, serving).  :meth:`Booster.rollback_one_iter` takes the last round
back out of every score, and :meth:`Booster.refit` renews the leaves on
new data into a predict-only Booster.

What is outside the port so far raises a ``NotImplementedError`` naming the
ROADMAP slice and item that will port it: feature screening, streaming and
the distributed learners.

:meth:`Booster.checkpoint_state` / :meth:`Booster.restore_checkpoint_state`
carry the complete round state (forest, train scores, bag, base key,
counters) through ``training.checkpoint`` in the reference's file format, so
a run killed at any round resumes bit-identical, and checkpoints interchange
with the reference package.

:class:`HyperScalarsBatch` holds the same scalars as per-element tensors for
the fused cross-validation program (``models/fused.py``), where one batch
element is one (config, fold), or one (config, fold, class) multiclass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Params, default_metric_for_objective, parse_params
from ..dataset import Dataset
from ..device import resolve_device
from ..metrics import get_metric
from ..objectives import create_objective
from ..ops.histogram import INT8_ACC_ROW_LIMIT
from ..ops.predict import (forest_depth_cap, predict_forest_binned,
                           predict_leaf_nodes, predict_tree_binned)
from ..ops.sampling import goss_select, goss_weights, sample_bag
from ..ops.split import CatInfo, SplitContext, fma
from ..utils.random import fold_in, prng_key, split_on
from .feature_mask import compose_tree_mask
from .tree import (_PK, Tree, _tree_from_packed, fit_linear_leaves,
                   grow_tree, grow_trees_batched, pad_tree,
                   renew_leaf_values, stack_trees)

_F32 = torch.float32
_SLICE5 = "ROADMAP slice 5 (out-of-core training), item 11"
_SLICE6 = "ROADMAP slice 6 (multi-device), item 12"


def build_cat_info(train_set: Dataset, p: Params,
                   device) -> Optional[CatInfo]:
    """The dataset's :class:`~..ops.split.CatInfo` on ``device`` (None
    without categorical training columns): the reference's static
    ``cat_key`` (the columns, ``cat_smooth``, ``cat_l2``,
    ``max_cat_threshold``) built as its ``_build_cat_info`` builds it."""
    is_cat = np.asarray(train_set.col_is_categorical, bool)
    if not is_cat.any():
        return None
    return CatInfo(is_cat=torch.from_numpy(is_cat).to(device),
                   cat_smooth=float(p.cat_smooth), cat_l2=float(p.cat_l2),
                   max_cat_threshold=int(p.max_cat_threshold))


def resolve_monotone_constraints(p: Params, bin_mapper
                                 ) -> Optional[Tuple[int, ...]]:
    """``monotone_constraints`` (one sign per original feature) mapped onto
    the training columns through EFB, under the reference's rules
    (``_resolve_monotone_constraints``): a list of the wrong length, a
    constraint on a categorical feature and one on a feature of a
    multi-member bundle raise ``ValueError``.  None when no constraint is
    set."""
    mc = p.monotone_constraints
    if mc is None or not any(int(c) != 0 for c in mc):
        return None
    bm = bin_mapper
    if len(mc) != bm.num_features:
        raise ValueError(
            f"monotone_constraints has {len(mc)} entries for "
            f"{bm.num_features} features")
    for f, c in enumerate(mc):
        if c != 0 and bm.is_categorical[f]:
            raise ValueError(
                f"monotone constraint on categorical feature {f} is not "
                "supported (matching lightgbm)")
    b = bm.bundler
    if b is None:
        return tuple(int(c) for c in mc)
    train_mc = []
    for g in b.groups:
        if len(g) == 1:
            train_mc.append(int(mc[g[0]]))
        elif any(int(mc[f]) != 0 for f in g):
            raise ValueError(
                "monotone constraint on an EFB-bundled feature (bundle "
                f"members {g}); pass enable_bundle=False when constraining "
                "sparse features")
        else:
            train_mc.append(0)
    return tuple(train_mc)


def resolve_interaction_constraints(p: Params, bin_mapper
                                    ) -> Optional[Tuple[Tuple[int, ...],
                                                        ...]]:
    """``interaction_constraints`` (groups of original features) as group
    membership over the training columns, rows ``[NG][F]`` of 0/1, under
    the reference's rules (``_resolve_interaction_constraints``): a feature
    in no listed group becomes a group of its own; an EFB bundle column
    belongs to a group only if all its members do, a bundle of unlisted
    features is a group of its own, and one that mixes listed features
    across groups raises ``ValueError``, as does an index past the
    features.  None when no group is given."""
    ic = p.interaction_constraints
    if not ic:
        return None
    bm = bin_mapper
    f_orig = bm.num_features
    groups = [set(g) for g in ic]
    listed = set().union(*groups) if groups else set()
    bad = sorted(f for f in listed if not (0 <= f < f_orig))
    if bad:
        raise ValueError(
            f"interaction_constraints reference feature indices {bad} but "
            f"the dataset has {f_orig} features")
    for f in sorted(set(range(f_orig)) - listed):
        groups.append({f})
    b = bm.bundler
    cols = ([tuple(g) for g in b.groups] if b is not None
            else [(f,) for f in range(f_orig)])
    member = [[1 if all(f in g for f in col) else 0 for col in cols]
              for g in groups]
    for c, col in enumerate(cols):
        if any(member[g][c] for g in range(len(member))):
            continue
        if any(f in listed for f in col):
            raise ValueError(
                f"interaction_constraints split an EFB bundle (members "
                f"{list(col)}); pass params={{'enable_bundle': False}} on "
                "the Dataset when constraining sparse features")
        member.append([1 if i == c else 0 for i in range(len(cols))])
    return tuple(tuple(row) for row in member)


def extra_trees_col_bins(bin_mapper) -> Tuple[int, ...]:
    """Each training column's used-bin count, which bounds its extra-trees
    draw (the reference's ``nbins_key``): the bundler's per-column counts
    under EFB, else ``BinMapper.n_bins``."""
    b = bin_mapper.bundler
    colb = b.col_bins if b is not None else bin_mapper.n_bins
    return tuple(int(x) for x in colb)


def _class_tree(tree: Tree, c: int, axis: int = 0) -> Tree:
    """Class ``c``'s trees of a multiclass round (``axis=0``, fields
    ``[K, M]``) or forest (``axis=1``, fields ``[T, K, M]``)."""
    return Tree(*(None if f is None else f.select(axis, c) for f in tree))


def _predict_forest_mc(forest: Tree, bins: torch.Tensor, shrink, inits,
                       n_trees: int, depth_cap: int,
                       start_iteration: int = 0) -> torch.Tensor:
    """Raw scores ``[n, K]`` of a multiclass forest (fields ``[T, K, M]``):
    one forest replay per class (the reference's ``_predict_forest_mc``,
    shared by ``predict``, rf's train scores and DART's dropped trees)."""
    return torch.stack([predict_forest_binned(
        _class_tree(forest, c, axis=1), bins, shrink,
        float(inits[c]) if np.ndim(inits) else float(inits), n_trees,
        depth_cap, start_iteration=start_iteration)
        for c in range(int(forest.leaf_value.shape[1]))], dim=1)


def linear_tree_values(tree: Tree, bins: torch.Tensor, xraw: torch.Tensor,
                       depth_cap: int) -> torch.Tensor:
    """ONE linear tree's ``leaf constant + coef . raw path features`` per
    row, the reference's ``_linear_tree_pred_fn`` before the shrink:
    traversal on the binned codes, evaluation on the raw values, NaN and
    unused slots read as 0."""
    node = predict_leaf_nodes(tree, bins, depth_cap)
    feats = tree.linear_feat.to(torch.int64)[node]            # [n, K]
    xg = xraw.gather(1, feats.clamp(min=0))
    xg = torch.where((feats >= 0) & torch.isfinite(xg), xg,
                     torch.zeros((), dtype=_F32, device=xg.device))
    return tree.leaf_value[node] + (tree.linear_coef[node] * xg).sum(dim=1)


def _tree_to(tree: Tree, device) -> Tree:
    return Tree(*(None if f is None else f.to(device) for f in tree))


def leaf_sums(leaf: torch.Tensor, stats: torch.Tensor, capacity: int,
              row_chunk: int = 65536) -> torch.Tensor:
    """Per-node sums ``[capacity, S]`` of the rows' statistics ``[n, S]``
    by the node each row reached.  On CPU tensors one scatter-add in row
    order (the reference's ``.at[leaf].add``); on the card one-hot matmuls
    over row chunks added in chunk order, as ``_gram_sums`` does: no float
    atomics, so the sums are the same bits run to run."""
    n, s = stats.shape
    out = torch.zeros((capacity, s), dtype=_F32, device=stats.device)
    if stats.device.type == "cpu":
        return out.index_add_(0, leaf, stats)
    ids = torch.arange(capacity, dtype=leaf.dtype, device=stats.device)
    for r in range(0, n, row_chunk):
        onehot_t = (leaf[None, r:r + row_chunk] == ids[:, None]).to(_F32)
        out = out + onehot_t @ stats[r:r + row_chunk]
    return out


def refit_leaves(tree: Tree, leaf: torch.Tensor, g: torch.Tensor,
                 h: torch.Tensor, lambda_l2, decay
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One single-class tree's refit leaf values ``[M]`` and each row's new
    value ``[n]``, the reference's ``refit`` ``renew``: a leaf that new rows
    reach becomes ``decay * old + (1 - decay) * newton`` with the Newton
    step ``-sum g / (sum h + lambda_l2 + 1e-15)`` over those rows, with
    ``decay * old`` fused into the sum as XLA contracts the reference's
    jitted expression; the others keep their value."""
    one = torch.ones_like(g)
    sums = leaf_sums(leaf, torch.stack([g, h, one], dim=1),
                     int(tree.leaf_value.shape[0]))
    gs, hs, cnt = sums.unbind(1)
    newton = -gs / (hs + lambda_l2 + 1e-15)
    vals = torch.where(tree.is_leaf & (cnt > 0),
                       fma(decay, tree.leaf_value, (1.0 - decay) * newton),
                       tree.leaf_value)
    return vals, vals[leaf]


def raw_to_device(raw, n_pad: int, device) -> torch.Tensor:
    """A raw feature matrix as padded f32 ``[n_pad, F]`` on ``device``
    (zero rows past the data): what linear leaves read."""
    from ..dataset import _to_2d_float_array

    X = _to_2d_float_array(raw).astype(np.float32)
    if X.shape[0] < n_pad:
        X = np.concatenate(
            [X, np.zeros((n_pad - X.shape[0], X.shape[1]), np.float32)])
    return torch.from_numpy(np.ascontiguousarray(X)).to(device)


class HyperScalars(NamedTuple):
    """Per-config scalars of the round step (Python floats)."""

    learning_rate: float
    lambda_l1: float
    lambda_l2: float
    min_data_in_leaf: float
    min_sum_hessian: float
    min_gain_to_split: float
    max_depth: int
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    feature_fraction_bynode: float = 1.0

    @staticmethod
    def from_params(p: Params) -> "HyperScalars":
        return HyperScalars(
            learning_rate=float(p.learning_rate),
            lambda_l1=float(p.lambda_l1), lambda_l2=float(p.lambda_l2),
            min_data_in_leaf=float(p.min_data_in_leaf),
            min_sum_hessian=float(p.min_sum_hessian_in_leaf),
            min_gain_to_split=float(p.min_gain_to_split),
            max_depth=int(p.max_depth),
            max_delta_step=float(p.max_delta_step),
            path_smooth=float(p.path_smooth),
            feature_fraction_bynode=float(p.feature_fraction_bynode))

    def ctx(self) -> SplitContext:
        return SplitContext(
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian=self.min_sum_hessian,
            min_gain_to_split=self.min_gain_to_split,
            max_delta_step=self.max_delta_step,
            path_smooth=self.path_smooth)


class HyperScalarsBatch(NamedTuple):
    """Per-element scalars of the fused round step: f32 ``[E]`` tensors on
    one device (``max_depth`` too, as the kernels read it), one element per
    (config, fold) — the reference's batched ``HyperScalars``."""

    learning_rate: torch.Tensor
    lambda_l1: torch.Tensor
    lambda_l2: torch.Tensor
    min_data_in_leaf: torch.Tensor
    min_sum_hessian: torch.Tensor
    min_gain_to_split: torch.Tensor
    max_depth: torch.Tensor
    max_delta_step: torch.Tensor
    path_smooth: torch.Tensor
    feature_fraction_bynode: torch.Tensor

    @staticmethod
    def from_params(param_list, repeat: int, device) -> "HyperScalarsBatch":
        """Each config's scalars repeated ``repeat`` times (its folds)."""
        rows = [HyperScalars.from_params(p) for p in param_list]
        return HyperScalarsBatch(*(
            torch.tensor(np.repeat(np.asarray([float(h[i]) for h in rows],
                                              np.float32), repeat),
                         device=device)
            for i in range(len(HyperScalars._fields))))

    def ctx(self) -> SplitContext:
        return SplitContext(
            lambda_l1=self.lambda_l1, lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian=self.min_sum_hessian,
            min_gain_to_split=self.min_gain_to_split,
            max_delta_step=self.max_delta_step,
            path_smooth=self.path_smooth)


def resolve_hist_dtype(p: Params, n_rows: int) -> str:
    """Histogram precision: "auto" is bf16 from 2^19 rows, f32 below; an
    explicit ``hist_dtype="f32"`` resolves to "f32x", the exactness
    contract (both are true f32 in the port); ``"int8"`` is B1's quantized
    mode.  ``use_quantized_grad`` maps to bf16, as in the reference (its
    int8 path was the slower one on a TPU)."""
    if p.use_quantized_grad:
        return "bf16"
    d = p.extra.get("hist_dtype", "auto")
    if d != "auto":
        return "f32x" if d == "f32" else d
    return "bf16" if n_rows >= (1 << 19) else "f32"


def check_int8_row_limit(p: Params, n_rows: int, n_shards: int = 1) -> None:
    """Refuse ``hist_dtype='int8'`` before any launch when a device's rows
    exceed ``INT8_ACC_ROW_LIMIT``: an int32 histogram cell could wrap."""
    if resolve_hist_dtype(p, n_rows) != "int8":
        return
    per_shard = -(-n_rows // max(int(n_shards), 1))
    if per_shard > INT8_ACC_ROW_LIMIT:
        raise ValueError(
            f"hist_dtype='int8' with {per_shard:,} rows per device shard "
            f"(n={n_rows:,} over {n_shards} shard(s)) exceeds the exact "
            f"int32 accumulation limit of {INT8_ACC_ROW_LIMIT:,} rows — "
            f"histograms would silently wrap.  Use hist_dtype='bf16' or "
            f"train on more devices.")


def _exact_overgrow_target(num_leaves: int, width: int, over: float) -> int:
    """Wave-aligned overgrowth target for the exact tail: the greedy wave
    boundary closest to ``num_leaves * over`` in log space, bounded to
    ``(num_leaves, 2.5 * num_leaves]``."""
    target = max(num_leaves * over, num_leaves + 1)
    leaves, cand = 1, 1
    best = None
    while leaves < 2.5 * num_leaves:
        s = min(cand, width)
        leaves += s
        cand = min(cand * 2, leaves)
        if leaves > num_leaves:
            if best is None or (abs(math.log(leaves / target))
                                < abs(math.log(best / target))):
                best = leaves
    return best or int(math.ceil(target))


def resolve_wave_width(p: Params, n_rows: int) -> int:
    """The grower's splits per histogram pass, with the wave tail in its
    encoding (negative = greedy; >= 1024 = exact, ``overgrow_leaves * 1024
    + width``; else half).  Waves are the default at >= 4096 rows and >= 16
    leaves; ``grow_policy="leafwise"`` forces the strict grower (1)."""
    if p.grow_policy == "leafwise":
        return 1
    width = int(p.extra.get("wave_width", 0)) or min(42, p.num_leaves - 1)
    width = max(1, min(width, 512))
    rows_per_leaf = n_rows // max(p.num_leaves, 1)
    pointwise = p.objective not in ("lambdarank", "rank_xendcg", "none")
    default_tail = ("greedy" if pointwise and rows_per_leaf >= 1024
                    and n_rows < (1 << 19) else "exact")
    tail = str(p.extra.get("wave_tail", default_tail))
    if tail == "greedy":
        width = -width
    elif tail == "exact":
        over = float(p.extra.get("wave_overgrow", 2.0))
        width = _exact_overgrow_target(p.num_leaves, width, over) * 1024 \
            + width
    if p.grow_policy == "frontier":
        return width
    return width if (n_rows >= 4096 and p.num_leaves >= 16) else 1


def dart_drops(p: Params, i: int, n_trees: int) -> List[int]:
    """The trees DART round ``i`` drops, in ascending order, drawn on the
    host as the reference draws them: ``default_rng(drop_seed + seed +
    7919 i)``; no drop with probability ``skip_drop``, else each of the
    ``n_trees`` trees with probability ``drop_rate``, and at most
    ``max_drop`` of them (when positive) chosen without replacement."""
    rng = np.random.default_rng(p.drop_seed + p.seed + i * 7919)
    if not (n_trees > 0 and p.drop_rate > 0 and rng.random() >= p.skip_drop):
        return []
    dropped = [int(t) for t in np.flatnonzero(rng.random(n_trees)
                                              < p.drop_rate)]
    if p.max_drop > 0 and len(dropped) > p.max_drop:
        dropped = sorted(int(t) for t in rng.choice(dropped, p.max_drop,
                                                    replace=False))
    return dropped


def check_slice_scope(p: Params) -> None:
    """Refuse, by name, every training option this slice does not port."""
    def later(what: str, where: str):
        raise NotImplementedError(f"{what} is not ported yet: {where}")

    if p.feature_screen != "off":
        later(f"feature_screen='{p.feature_screen}'", _SLICE5)
    if p.tree_learner != "serial":
        later(f"tree_learner='{p.tree_learner}' (dp/fp meshes)", _SLICE6)


class Booster:
    """LightGBM-compatible Booster trained on its Dataset's device.

    ``Booster(params, train_set)`` trains on ``train_set.device``;
    ``Booster(model_file=...)`` / ``Booster(model_str=...)`` load a saved
    model (JSON text or packed ``.npz``) onto ``device`` (None = ``cuda``,
    the CPU only on ``device="cpu"``).
    """

    def __init__(self, params: Optional[Union[Dict[str, Any], Params]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        if model_file is not None or model_str is not None:
            from ..utils.serialize import load_booster_into

            self.device = resolve_device(device)
            load_booster_into(self, model_file=model_file,
                              model_str=model_str)
            return
        self.params = (params if isinstance(params, Params)
                       else parse_params(params))
        self.train_set = train_set
        self.device = (train_set.device if train_set is not None
                       and device is None else resolve_device(device))
        self.obj = create_objective(self.params)
        self.trees: List[Tree] = []
        self.best_iteration: int = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._valid: List[Tuple[str, Dataset, torch.Tensor]] = []
        self._iter = 0
        self.init_score_ = 0.0
        self._pred_train = None
        self._bag = None
        self._forest_cache = None
        self._base_lr = float(self.params.learning_rate)
        self._key = self._seed_key()
        if train_set is not None:
            self._setup_training()

    def _seed_key(self) -> np.ndarray:
        """``jax.random.PRNGKey(seed)`` of the reference (an int32 seed:
        high word 0), the base of the round keys; the checkpoint format
        carries it."""
        return np.asarray(prng_key(int(self.params.seed) % (1 << 32)),
                          np.uint32)

    # ------------------------------------------------------------------
    def _setup_training(self) -> None:
        ds = self.train_set
        p = self.params
        check_slice_scope(p)
        if ds.device != self.device:
            raise ValueError(f"the training Dataset lives on {ds.device}, "
                             f"the Booster on {self.device}")
        ds.construct()
        if ds.y is None:
            raise ValueError("training Dataset requires a label")
        y_host = ds.get_label()
        w_host = (ds.get_weight() if ds.get_weight() is not None
                  else np.ones(ds.num_data_))
        if hasattr(self.obj, "prepare"):
            self.obj.prepare(y_host, w_host)
        n_pad = int(ds.row_mask.shape[0])
        if getattr(self.obj, "needs_group", False):
            gs = ds.get_group()
            if gs is None:
                raise ValueError(
                    f"objective '{self.obj.name}' requires query group "
                    "information: Dataset(X, label=y, group=sizes)")
            self.obj.set_group(gs, y_host, n_pad, device=self.device)
        k = self._num_class
        if k > 1:
            if ds.get_init_score() is not None:
                raise NotImplementedError(
                    "per-row init_score with multiclass is not supported")
            self.init_score_ = np.asarray(self.obj.init_score(y_host, w_host),
                                          np.float32)           # [K]
            self._pred_train = self._init_scores(n_pad)
        elif ds.get_init_score() is not None:
            base = np.zeros(n_pad, np.float32)
            base[:ds.num_data_] = np.asarray(ds.get_init_score(), np.float32)
            self._pred_train = torch.from_numpy(base).to(self.device)
            self.init_score_ = 0.0
        else:
            self.init_score_ = float(self.obj.init_score(y_host, w_host))
            self._pred_train = torch.full((n_pad,), self.init_score_,
                                          dtype=_F32, device=self.device)
        self._bag = ds.row_mask
        self._hyper = HyperScalars.from_params(p)
        self._base_lr = float(p.learning_rate)
        self._num_bins = ds.num_bins
        self._w_eff = ds.w
        self._cat_info = build_cat_info(ds, p, self.device)
        # the constraints over the training columns, on the device once
        bm = ds.bin_mapper
        mono = resolve_monotone_constraints(p, bm)
        ic = resolve_interaction_constraints(p, bm)
        self._constraints = dict(
            mono=None if mono is None else torch.tensor(
                mono, dtype=torch.int32, device=self.device),
            ic_member=None if ic is None else torch.tensor(
                ic, dtype=torch.bool, device=self.device),
            extra_trees=bool(p.extra_trees),
            col_bins=torch.tensor(extra_trees_col_bins(bm),
                                  dtype=torch.int32, device=self.device)
            if p.extra_trees else None)
        self._xraw = None
        self._linear_k = None
        if p.linear_tree:
            self._setup_linear_tree()

    def _setup_linear_tree(self) -> None:
        """The raw feature matrix on the device for linear leaves, as the
        reference's ``_setup_linear_tree``: the ridge fit and the linear
        predictor read RAW values.  EFB must be off (a bundle column has
        no single raw value), and the Dataset must hold its raw matrix."""
        ds = self.train_set
        if ds.bin_mapper.bundler is not None:
            raise ValueError(
                "linear_tree with EFB bundling is not supported; construct "
                "the Dataset with params={'enable_bundle': False}")
        raw = ds.raw_data
        if raw is None or isinstance(raw, str):
            raise ValueError(
                "linear_tree needs the raw feature values: keep "
                "free_raw_data=False and build the Dataset from an "
                "in-memory matrix (not a saved binary)")
        self._xraw = raw_to_device(raw, int(ds.row_mask.shape[0]),
                                   self.device)
        self._linear_k = max(1, min(int(self.params.extra.get("linear_k", 8)),
                                    int(ds.num_feature_)))

    @property
    def _num_class(self) -> int:
        if self.params.objective in ("multiclass", "multiclassova"):
            return int(self.params.num_class)
        return 1

    def _init_scores(self, n: int) -> torch.Tensor:
        """The init score per row: ``[n]``, or ``[n, K]`` multiclass."""
        if self._num_class > 1:
            return torch.from_numpy(np.asarray(self.init_score_, np.float32)
                                    ).to(self.device).expand(
                                        n, self._num_class).clone()
        return torch.full((n,), float(self.init_score_), dtype=_F32,
                          device=self.device)

    @property
    def _depth_cap(self) -> int:
        """Traversal depth bound over every tree of the forest: from
        ``num_leaves``, or from a deeper ingested tree's own capacity."""
        caps = {int(t.split_feature.shape[-1]) for t in self.trees}
        cap = max([2 * self.params.num_leaves - 1, *caps])
        return (cap + 1) // 2

    # -- continuation ----------------------------------------------------
    def ingest_init_model(self, prev: "Booster") -> None:
        """Continue training from ``prev``'s forest (``train(init_model=)``),
        the reference's ``ingest_init_model``.  Stored leaves are raw (the
        CURRENT learning rate shrinks them at predict time), so the
        ingested trees are rescaled by ``prev_lr / cur_lr`` in f32 and
        keep their contribution."""
        p = self.params
        if p.boosting == "rf" or prev.params.boosting == "rf":
            raise NotImplementedError(
                "init_model continuation is not supported for rf boosting "
                "(averaged forests have no additive continuation)")
        if prev.num_model_per_iteration() != self._num_class:
            raise ValueError(
                "init_model has a different number of classes "
                f"({prev.num_model_per_iteration()} vs {self._num_class})")
        if not prev.trees:
            return
        # the ingested split_bin codes mean something only under the bin
        # mapper they were trained with
        if not self._same_binning(self.train_set.bin_mapper,
                                  prev._bin_mapper_for_predict()):
            raise ValueError(
                "init_model was trained with different feature binning than "
                "this Dataset; rebuild the Dataset with "
                "reference=<original training Dataset> (or identical data) "
                "before continuing training")
        prev_linear = prev.trees[0].linear_feat is not None
        if prev_linear != bool(p.linear_tree):
            raise ValueError(
                "init_model and the continuation must agree on linear_tree "
                f"(init_model linear={prev_linear}, params "
                f"linear_tree={p.linear_tree}) — a forest cannot mix "
                "constant and linear leaves")
        prev_lr = float(getattr(prev, "_base_lr", prev.params.learning_rate))
        scale = torch.tensor(prev_lr / self._base_lr, dtype=_F32,
                             device=self.device)
        self.trees = []
        for t in prev.trees:
            t = _tree_to(t, self.device)
            self.trees.append(t._replace(
                leaf_value=t.leaf_value * scale,
                linear_coef=(None if t.linear_coef is None
                             else t.linear_coef * scale)))
        self._iter = len(self.trees)
        self._forest_cache = None
        # restart from the PREVIOUS model's base score and replay its trees
        self._rebase_and_replay(prev.init_score_)

    @staticmethod
    def _same_binning(cur_m, prev_m) -> bool:
        """Whether two bin mappers describe the same training columns:
        equal bounds and equal EFB bundling (bundling remaps the columns
        without touching ``upper_bounds``)."""
        same = (len(cur_m.upper_bounds) == len(prev_m.upper_bounds) and all(
            len(a) == len(b) and np.allclose(a, b)
            for a, b in zip(cur_m.upper_bounds, prev_m.upper_bounds)))
        cur_b = getattr(cur_m, "bundler", None)
        prev_b = getattr(prev_m, "bundler", None)
        if (cur_b is None) != (prev_b is None):
            return False
        if cur_b is not None and (
                cur_b.groups != prev_b.groups
                or not np.array_equal(cur_b.default_bins,
                                      prev_b.default_bins)):
            return False
        return same

    def _rebase_and_replay(self, init_score) -> None:
        """``_pred_train`` rebuilt from ``init_score`` (the Dataset's per-row
        ``init_score`` on top, as upstream keeps both) with the forest
        replayed into it by the live round's update, ``fma(lr, value,
        pred)`` per tree in order, so the continued gradients are the
        uninterrupted run's bits."""
        ds = self.train_set
        self.init_score_ = init_score
        n_pad = int(ds.row_mask.shape[0])
        pred = self._init_scores(n_pad)
        if self._num_class == 1 and ds.get_init_score() is not None:
            base = np.zeros(n_pad, np.float32)
            base[:ds.num_data_] = np.asarray(ds.get_init_score(), np.float32)
            pred = pred + torch.from_numpy(base).to(self.device)
        if self.trees:
            shrink = torch.tensor(self._base_lr, dtype=_F32,
                                  device=self.device)
            # a tight traversal bound, read once: a row that reaches its
            # leaf earlier stays there
            depth = min(self._depth_cap,
                        forest_depth_cap(self._stacked_forest()))
            for tree in self.trees:
                pred = fma(shrink, self._tree_round_values(
                    tree, ds.X_binned, self._xraw, depth), pred)
        self._pred_train = pred

    def _attach_continuation(self, ds: Dataset) -> None:
        """Attach a training Dataset to a loaded Booster so ``update()``
        continues the saved model, the reference's ``_attach_continuation``:
        the Dataset must be binned as the model was, the training setup
        runs, and the forest is replayed into the train scores.  A bag
        drawn mid-``bagging_freq`` is not in the model file: resume from a
        training checkpoint where that matters."""
        ds.construct()
        prev_m = self._bin_mapper_for_predict()
        if prev_m is not None and not self._same_binning(ds.bin_mapper,
                                                         prev_m):
            raise ValueError(
                "this Booster was saved under a different feature binning "
                "than the offered Dataset (bin bounds / EFB bundling "
                "differ); rebuild the Dataset with reference=<original "
                "training Dataset> (or identical data) before continuing "
                "training")
        loaded_init, loaded_iter = self.init_score_, self._iter
        if ds.device != self.device:
            # training runs on the Dataset's device
            self.device = ds.device
            self.trees = [_tree_to(t, self.device) for t in self.trees]
        self.train_set = ds
        self._key = self._seed_key()
        self._setup_training()
        self._iter = loaded_iter
        self._forest_cache = None
        self._rebase_and_replay(loaded_init)

    def _sample_bag_and_fmask(self, i: int) -> torch.Tensor:
        """This round's bag (resampled on schedule into ``self._bag``) and
        feature mask, from streams keyed by the round index."""
        ds = self.train_set
        p = self.params
        if p.bagging_freq > 0 and p.bagging_fraction < 1.0 and \
                i % p.bagging_freq == 0:
            bkey = fold_in(prng_key(p.bagging_seed + p.seed), i)
            self._bag = sample_bag(bkey, ds.row_mask, p.bagging_fraction,
                                   float(ds.num_data_))
        n_cols = int(ds.num_feature_)
        if p.feature_fraction < 1.0:
            fkey = fold_in(prng_key(p.feature_fraction_seed + p.seed), i)
            return compose_tree_mask(fkey, p.feature_fraction, n_cols,
                                     device=self.device)
        return torch.ones(n_cols, dtype=_F32, device=self.device)

    # -- round step ------------------------------------------------------
    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """Run one boosting round (LightGBM ``Booster.update``).  ``fobj``
        is accepted and not used, as in the reference: a custom objective
        is given as ``objective=callable`` in the params."""
        if train_set is not None and train_set is not self.train_set:
            if self.train_set is None and self.trees:
                # a loaded model continuing: attach the Dataset and replay
                # the forest into the train scores, so the gradients go on
                # where the saved run stopped
                self._attach_continuation(train_set)
            else:
                self.train_set = train_set
                if self.device != train_set.device:
                    self.device = train_set.device
                self._setup_training()
        if self.train_set is None:
            raise ValueError("update() needs a training Dataset")
        check_int8_row_limit(self.params, self._eff_rows())
        if self.params.boosting == "dart":
            return self._dart_round()
        p = self.params
        i = self._iter
        fmask = self._sample_bag_and_fmask(i)
        tree, new_pred = self._round_body(self._pred_train, self._bag, fmask,
                                          self._round_key(i))
        if p.boosting != "rf":             # rf keeps _pred_train at the init
            self._pred_train = new_pred
            if p.learning_rate != self._base_lr:
                # a reset_parameter schedule: bake lr_i / base into the
                # stored values so the uniform predict-time shrink (base)
                # gives lr_i
                scale = torch.tensor(p.learning_rate / self._base_lr,
                                     dtype=_F32, device=self.device)
                tree = tree._replace(
                    leaf_value=tree.leaf_value * scale,
                    linear_coef=(None if tree.linear_coef is None
                                 else tree.linear_coef * scale))
        self._append_round(tree, self._shrink)
        return False

    def _round_key(self, i: int):
        """The round key ``fold_in(key, i)``: the grower's per-node draws
        and GOSS's sample are keyed by it."""
        return fold_in((int(self._key[0]), int(self._key[1])), i)

    def _goss_k(self) -> Optional[Tuple[int, int]]:
        """GOSS's ``(k_top, k_other)`` row counts, taken in float64 on the
        host as the reference takes them; None unless ``boosting='goss'``."""
        p = self.params
        if p.boosting != "goss":
            return None
        n = self.train_set.num_data_
        return int(p.top_rate * n), int(p.other_rate * n)

    def _eff_rows(self) -> int:
        """The rows a round's histograms see, which resolve its precision,
        wave width and int8 row limit: the compacted rows of a single-class
        GOSS round, else every (padded) row."""
        goss_k = self._goss_k()
        if goss_k is not None and self._num_class == 1:
            return goss_k[0] + goss_k[1]
        return int(self.train_set.row_mask.shape[0])

    def _round_body(self, pred: torch.Tensor, bag: torch.Tensor,
                    fmask: torch.Tensor, rkey) -> Tuple[Tree, torch.Tensor]:
        """One round's tree grown from the scores ``pred``, and the train
        scores after it (the reference's ``_round_fn``): plain and rf
        rounds, single-class GOSS on its compacted rows, multiclass GOSS by
        re-weighting, and DART's round from the dropped-tree scores.  rf
        returns ``pred`` unchanged."""
        ds = self.train_set
        p = self.params
        hyper = self._hyper
        eff_rows = self._eff_rows()
        g, h = self.obj.grad_hess(pred, ds.y, self._w_eff)
        lr = torch.tensor(hyper.learning_rate, dtype=_F32, device=self.device)
        grow = dict(hist_impl=p.extra.get("hist_impl", "auto"),
                    hist_dtype=resolve_hist_dtype(p, eff_rows),
                    cat_info=self._cat_info, **self._constraints)
        width = resolve_wave_width(p, eff_rows)
        bynode = p.feature_fraction_bynode < 1.0
        is_rf = p.boosting == "rf"
        goss_k = self._goss_k()
        k = self._num_class
        if k > 1:
            if goss_k is not None:
                # multiclass GOSS re-weights the rows by sum_c |g_c|
                g_abs = g[:, 0].abs()
                for c in range(1, k):
                    g_abs = g_abs + g[:, c].abs()
                bag = goss_weights(fold_in(rkey, 0x7FFFFFFF), g_abs, bag,
                                   p.top_rate, p.other_rate, bag.sum())
            # the K class trees as one batch (mc_round_update)
            stats_t = torch.stack([g * bag[:, None], h * bag[:, None],
                                   (bag > 0).to(_F32)[:, None].expand_as(g)],
                                  dim=-1)                      # [n, K, 3]
            if bynode or p.extra_trees:
                # the grower key split per class, as the reference keys it
                grow.update(keys=split_on(rkey, k, self.device))
            if bynode:
                grow.update(ff_bynode=torch.full(
                    (k,), hyper.feature_fraction_bynode, dtype=_F32,
                    device=self.device))
            P, n_leaves, row_leaf, catmask = grow_trees_batched(
                ds.X_binned, stats_t, fmask.expand(k, -1),
                SplitContext.per_element([hyper.ctx()] * k, self.device),
                torch.full((k,), float(hyper.max_depth), device=self.device),
                p.num_leaves, self._num_bins, width, **grow)
            tree = _tree_from_packed(P, n_leaves, catmask)  # [K, M] fields

            if is_rf:
                return tree, pred
            vals = P[..., _PK.LEAF_VALUE].gather(
                1, row_leaf.t().to(torch.int64))              # [K, n]
            return tree, fma(lr, vals.t(), pred)
        if bynode:
            grow.update(ff_bynode=hyper.feature_fraction_bynode)
        if bynode or p.extra_trees:
            grow.update(key=rkey)
        bins, y, w = ds.X_binned, ds.y, self._w_eff
        if goss_k is not None:
            # the tree grows on the compacted rows, in the selection's order
            idx, wt, live = goss_select(rkey, g, bag, goss_k, p.top_rate,
                                        p.other_rate)
            bins, y, w, pred_c = bins[idx], y[idx], w[idx], pred[idx]
            stats = torch.stack([g[idx] * wt, h[idx] * wt, live], dim=-1)
            rw = w * wt
        else:
            pred_c = pred
            stats = torch.stack([g * bag, h * bag, (bag > 0).to(_F32)],
                                dim=-1)
            rw = w * bag
        tree, row_leaf = grow_tree(bins, stats, fmask, hyper.ctx(),
                                   p.num_leaves, self._num_bins,
                                   hyper.max_depth, wave_width=width, **grow)
        if self._linear_k is not None:
            # linear leaves: the grown tree's leaves refit as ridge models
            # on the raw values (round_fn_linear; gbdt only, no renewal)
            tree, delta = fit_linear_leaves(
                tree, row_leaf, self._xraw, g, h, bag, p.linear_lambda,
                self._linear_k, int(p.extra.get("row_chunk", 131072)))
            return tree, fma(lr, delta, pred)
        renew_alpha = getattr(self.obj, "renew_alpha", None)
        if renew_alpha is not None:
            # L1/quantile/MAPE: leaves refit to weighted quantiles of the
            # residuals, before the score update (rf too)
            if hasattr(self.obj, "renew_scale"):
                rw = rw * self.obj.renew_scale(y)
            tree = renew_leaf_values(tree, row_leaf, y - pred_c, rw,
                                     renew_alpha)
        if is_rf:
            return tree, pred
        if goss_k is not None:
            # every row's score from a traversal of the tree grown on the
            # sampled rows: its depth is read once, as a tight cap
            return tree, fma(lr, predict_tree_binned(
                tree, ds.X_binned, forest_depth_cap(tree)), pred)
        return tree, fma(lr, tree.leaf_value[row_leaf.to(torch.int64)], pred)

    def _append_round(self, tree: Tree, shrink: float) -> None:
        """Store the round's tree and add it to every valid set's scores at
        ``shrink``."""
        self.trees.append(tree)
        self._forest_cache = None
        s = torch.tensor(shrink, dtype=_F32, device=self.device)
        self._add_to_valid(tree, s)
        self._iter += 1

    def _add_to_valid(self, tree: Tree, shrink: torch.Tensor) -> None:
        """Every valid set's scores plus ``shrink`` times one round's
        values."""
        for idx, (name, vds, vpred) in enumerate(self._valid):
            vals = self._tree_round_values(
                tree, vds.X_binned, getattr(vds, "_xraw_dev", None),
                (tree.capacity + 1) // 2)
            self._valid[idx] = (name, vds, vpred + shrink * vals)

    def _tree_round_values(self, tree: Tree, bins: torch.Tensor, xraw,
                           depth_cap: int) -> torch.Tensor:
        """One round's values per row: linear leaves evaluated on the raw
        values ``xraw``, else the leaf values (:meth:`_tree_values`)."""
        if tree.linear_feat is not None:
            return linear_tree_values(tree, bins, xraw, depth_cap)
        return self._tree_values(tree, bins, depth_cap)

    def _dart_round(self) -> bool:
        """One DART round (upstream ``dart.hpp``; Rashmi & Gilad-Bachrach,
        AISTATS 2015), as the reference's ``_dart_round``.

        :func:`dart_drops` picks the dropped trees, and the round's tree
        grows from the scores without them.  On a drop round the new tree's
        stored leaves are scaled by ``1 / ((k + 1) lr)`` and each dropped
        tree's by ``k / (k + 1)`` in place (``xgboost_dart_mode``:
        ``1 / (k + lr)`` and ``k / (k + lr)``), so the stored leaves carry
        the scales and any predictor of the forest serves the model.  The
        rescaling runs op by op, each rounded once, as the reference's eager
        ops outside its jitted round; no ``reset_parameter`` rate is baked
        into the stored leaves, as in the reference."""
        ds = self.train_set
        p = self.params
        i = self._iter
        fmask = self._sample_bag_and_fmask(i)
        dropped = dart_drops(p, i, len(self.trees))
        k = len(dropped)
        lr = np.float32(p.learning_rate)
        pred = self._pred_train
        if k > 0:
            # one stacked pass over the dropped trees, padded to the largest
            # capacity among them (a continuation may mix num_leaves)
            stack = stack_trees([self.trees[t] for t in dropped])
            depth = forest_depth_cap(stack)

            def dropped_sum(bins):
                """The dropped trees' summed raw values: one stacked forest
                pass (per class for multiclass stacks)."""
                if self._num_class > 1:
                    return _predict_forest_mc(stack, bins, 1.0, 0.0, k, depth)
                return predict_forest_binned(stack, bins, 1.0, 0.0, k, depth)

            drop_sum = dropped_sum(ds.X_binned)
            pred = pred - float(lr) * drop_sum
        tree, new_pred = self._round_body(pred, self._bag, fmask,
                                          self._round_key(i))
        if k > 0:
            if p.xgboost_dart_mode:
                new_scale = 1.0 / (k + float(p.learning_rate))
                drop_scale = k / (k + float(p.learning_rate))
            else:
                new_scale = 1.0 / ((k + 1.0) * float(p.learning_rate))
                drop_scale = k / (k + 1.0)
            new_s, drop_s = float(np.float32(new_scale)), \
                float(np.float32(drop_scale))
            tree = tree._replace(leaf_value=tree.leaf_value * new_s)
            new_pred = pred + (new_pred - pred) * new_s
            # the valid sets' change from the dropped trees' rescaling, from
            # their old leaf values
            vscale = float(lr * np.float32(drop_scale - 1.0))
            for idx, (name, vds, vpred) in enumerate(self._valid):
                self._valid[idx] = (name, vds,
                                    vpred + vscale * dropped_sum(vds.X_binned))
            for t in dropped:
                self.trees[t] = self.trees[t]._replace(
                    leaf_value=self.trees[t].leaf_value * drop_s)
            new_pred = new_pred + float(lr * np.float32(drop_scale)) * drop_sum
        self._pred_train = new_pred
        self._append_round(tree, float(lr))
        return False

    @property
    def _shrink(self) -> float:
        """The predict-time shrinkage: 1.0 for rf (its trees are averaged),
        else the base learning rate the stored leaves are scaled to."""
        return 1.0 if self.params.boosting == "rf" else float(self._base_lr)

    def _tree_values(self, tree: Tree, bins: torch.Tensor,
                     depth_cap) -> torch.Tensor:
        """One round's leaf values per row: ``[n]``, or ``[n, K]`` for a
        multiclass round (a tree per class)."""
        if self._num_class == 1:
            return predict_tree_binned(tree, bins, depth_cap)
        return torch.stack([predict_tree_binned(_class_tree(tree, c), bins,
                                                depth_cap)
                            for c in range(self._num_class)], dim=1)

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change the per-round hyper-parameters mid-training (LightGBM
        ``Booster.reset_parameter``, driven by the ``reset_parameter``
        callback); the shape-static ones cannot change on a live
        booster."""
        newp = parse_params(params, base=self.params)
        static = ["num_leaves", "max_bin", "objective", "boosting",
                  "num_class", "tree_learner", "grow_policy",
                  "max_cat_threshold", "extra_trees", "linear_tree"]
        if self.params.boosting == "goss":
            # GOSS's row counts are fixed for the run, as in the reference
            static += ["top_rate", "other_rate"]
        for f in static:
            if getattr(newp, f) != getattr(self.params, f):
                raise ValueError(
                    f"cannot reset shape-static parameter '{f}' on a "
                    "trained booster (it changes the compiled program)")
        self.params = newp
        self._hyper = HyperScalars.from_params(newp)
        return self

    def rollback_one_iter(self) -> "Booster":
        """Take the last round out (LightGBM ``rollback_one_iter``), the
        reference's: its tree leaves the forest and its values leave the
        train scores (rf keeps them at the init score) and every valid
        set's, a linear tree's through the linear predictor."""
        if not self.trees:
            return self
        depth = self._depth_cap
        tree = self.trees.pop()
        self._forest_cache = None
        self._iter -= 1
        neg = torch.tensor(-self._shrink, dtype=_F32, device=self.device)
        if self.params.boosting != "rf" and self._pred_train is not None:
            vals = self._tree_round_values(tree, self.train_set.X_binned,
                                           self._xraw, depth)
            # the reference's update: one multiply-add under XLA's
            # contraction for a single class, eager for [n, K]
            self._pred_train = (
                fma(neg, vals, self._pred_train) if self._num_class == 1
                else self._pred_train + neg * vals)
        self._add_to_valid(tree, neg)
        return self

    def refit(self, data, label, decay_rate: float = 0.9, weight=None,
              group=None, **kwargs) -> "Booster":
        """Refit the leaf values on new data, keeping every tree's structure
        (LightGBM ``Booster.refit``), the reference's ``refit``: tree by
        tree in order, each leaf the new rows reach becomes ``decay_rate *
        old + (1 - decay_rate) * newton``, the Newton step from the new
        rows' gradients at the refit ensemble's running score
        (:func:`refit_leaves`); a multiclass round refits its K trees at
        once.  A ranking model takes ``group=`` (the new rows' query
        sizes), for which a fresh objective packs its lambda layout.
        Returns a NEW predict-only Booster on this one's device; ``self``
        is untouched."""
        import copy

        if self.params.boosting in ("rf", "dart"):
            raise NotImplementedError(
                "refit supports additive boosting (gbdt/goss); rf averages "
                "trees and dart bakes dropout scales into leaf values")
        if self.trees and self.trees[0].linear_feat is not None:
            raise NotImplementedError(
                "refit with linear_tree is not supported (leaf models need "
                "re-solving, not Newton-constant renewal)")
        if kwargs:
            raise TypeError(f"refit got unsupported arguments: "
                            f"{sorted(kwargs)}")
        from ..dataset import _to_2d_float_array

        dev = self.device
        X = _to_2d_float_array(data)
        y_host = np.asarray(label, np.float32)
        y = torch.from_numpy(np.ascontiguousarray(y_host)).to(dev)
        w = (torch.ones_like(y) if weight is None else torch.from_numpy(
            np.ascontiguousarray(weight, np.float32)).to(dev))
        codes = torch.from_numpy(
            self._bin_mapper_for_predict().transform(X)).to(dev)
        p = self.params
        lam = torch.tensor(p.lambda_l2, dtype=_F32, device=dev)
        decay = torch.tensor(decay_rate, dtype=_F32, device=dev)
        lr = torch.tensor(self._base_lr, dtype=_F32, device=dev)
        obj = self.obj
        if getattr(obj, "needs_group", False):
            if group is None:
                raise ValueError(
                    "refit with a ranking objective requires group= "
                    "(query sizes of the refit data)")
            # a fresh lambda layout packed for the NEW rows
            obj = create_objective(p)
            obj.set_group(np.asarray(group, np.int64).reshape(-1), y_host,
                          int(y_host.reshape(-1).shape[0]), device=dev)
        elif group is not None:
            raise TypeError("refit got group= for a non-ranking objective")
        depth = self._depth_cap
        k = self._num_class
        pred = self._init_scores(int(codes.shape[0]))
        new_trees = []
        for tree in self.trees:
            g, h = obj.grad_hess(pred, y, w)
            if k == 1:
                leaf = predict_leaf_nodes(tree, codes, depth)
                vals, delta = refit_leaves(tree, leaf, g, h, lam, decay)
            else:
                per_class = [refit_leaves(
                    tc, predict_leaf_nodes(tc, codes, depth), g[:, c],
                    h[:, c], lam, decay)
                    for c, tc in ((c, _class_tree(tree, c))
                                  for c in range(k))]
                vals = torch.stack([v for v, _ in per_class])    # [K, M]
                delta = torch.stack([d for _, d in per_class], dim=1)
            new_trees.append(tree._replace(leaf_value=vals))
            # XLA fuses the reference's single-class update into one
            # multiply-add and leaves its transposed multiclass one eager
            pred = fma(lr, delta, pred) if k == 1 else pred + lr * delta
        out = copy.copy(self)
        out.trees = new_trees
        out._forest_cache = None
        out._valid = []
        # predict-only: the train scores and bag hold the OLD leaves
        out.train_set = None
        out._bin_mapper = self._bin_mapper_for_predict()
        out._feature_names = list(self.feature_name())
        out._pred_train = None
        out._bag = None
        return out

    def can_fuse_rounds(self) -> bool:
        """Whether the reference's ``update_many`` may scan rounds into one
        device program (its predicate: single-class, no mesh, no
        streaming, gbdt/rf/goss, no linear leaves, no screening, no valid
        set).  The port runs every round on the host loop either way."""
        p = self.params
        return (self._num_class == 1
                and p.boosting in ("gbdt", "rf", "goss")
                and not p.linear_tree
                and p.feature_screen == "off"
                and not self._valid)

    def update_many(self, k: int) -> None:
        """Run ``k`` rounds (the reference scans them into one device
        program; its docstring states the models are identical)."""
        for _ in range(max(int(k), 0)):
            self.update()

    def _screen_finite(self, i: int) -> None:
        """Gradient/hessian finiteness screen: one non-finite raw
        prediction makes every objective's g/h non-finite and the round
        would grow a garbage tree out of NaN stats that silently poisons
        the rest of the run.  Costs one scalar host sync per round.
        ``train_resumable(finite_screen=False)`` turns it off."""
        from ..faults import NonFiniteGradientError

        if not bool(torch.isfinite(self._pred_train).all()):
            raise NonFiniteGradientError(
                f"non-finite raw predictions entering round {i}: the "
                "gradient/hessian stats would be non-finite and the grown "
                "tree garbage — inspect labels/objective, or resume from "
                "the last good checkpoint (lightgbm_tpu_torch.training)",
                round_index=i)

    # -- checkpoint state ------------------------------------------------
    def checkpoint_state(self) -> tuple:
        """Complete training state as ``(arrays, meta)`` host payloads, in
        the reference's layout.

        Everything a bit-identical resume needs beyond the params: the
        forest (raw buffers, not the decimal text codec), the train scores
        and current bagging mask exactly as the next round consumes them
        (``[n_pad]``, or ``[n_pad, K]`` multiclass), the base key, round
        counters and the shrinkage base.  Every per-round draw (bagging,
        feature fraction) is re-derived from params + round index, so no
        random stream state beyond the base key exists.  The ``.cpu()``
        copies wait for the device work in flight.
        """
        if self.train_set is None or self._pred_train is None:
            raise ValueError(
                "checkpoint_state() needs an attached training Dataset — "
                "this booster holds no round state")
        from ..data.sketch import schema_digest
        from .tree import tree_to_arrays

        p = self.params
        params_dict = dataclasses.asdict(p)
        extra = dict(params_dict.pop("extra", None) or {})
        params_dict.update(extra)
        arrays = {
            "pred_train": self._pred_train.detach().cpu().numpy(),
            "bag": self._bag.detach().cpu().numpy(),
            "key": np.asarray(self._key, np.uint32),
        }
        init_meta = None
        if isinstance(self.init_score_, np.ndarray):
            arrays["init_score"] = np.asarray(self.init_score_, np.float32)
        else:
            init_meta = float(self.init_score_)
        for t_idx, t in enumerate(self.trees):
            for fname, arr in tree_to_arrays(t).items():
                arrays[f"tree{t_idx:05d}/{fname}"] = arr
        meta = {
            "params": params_dict,
            "iter": int(self._iter),
            "num_trees": len(self.trees),
            "base_lr": float(self._base_lr),
            "init_score": init_meta,
            "best_iteration": int(self.best_iteration),
            "streamed": False,
            "parallel": {"tree_learner": p.tree_learner},
            "schema_digest": schema_digest(self.train_set.bin_mapper),
        }
        return arrays, meta

    def restore_checkpoint_state(self, arrays, meta) -> None:
        """Inverse of :meth:`checkpoint_state` onto a booster already
        constructed with the SAME params and an equivalently-binned
        training Dataset (``training.checkpoint.resume_booster`` wraps the
        construction and the schema check).  Every tensor lands on the
        Booster's device; the stacked-forest cache is dropped."""
        from .tree import tree_from_arrays

        if "screen_ema" in arrays:
            raise NotImplementedError(
                "a checkpoint of a feature-screened run (screen_ema) is not "
                f"ported yet: {_SLICE5}")
        if meta.get("streamed"):
            raise NotImplementedError(
                "a checkpoint of a streamed (out-of-core) run is not ported "
                f"yet: {_SLICE5}")
        trees = []
        for t_idx in range(int(meta["num_trees"])):
            prefix = f"tree{t_idx:05d}/"
            fields = {k[len(prefix):]: v for k, v in arrays.items()
                      if k.startswith(prefix)}
            trees.append(tree_from_arrays(fields, device=self.device))
        self.trees = trees
        self._forest_cache = None
        self._iter = int(meta["iter"])
        self._base_lr = float(meta["base_lr"])
        self.best_iteration = int(meta["best_iteration"])
        self.init_score_ = (
            float(meta["init_score"]) if meta.get("init_score") is not None
            else np.asarray(arrays["init_score"], np.float32))

        def put(a):
            return torch.from_numpy(np.array(a, np.float32)).to(self.device)

        self._pred_train = put(arrays["pred_train"])
        self._bag = put(arrays["bag"])
        self._key = np.asarray(arrays["key"], np.uint32)

    # -- evaluation ------------------------------------------------------
    def _metric_names(self) -> List[str]:
        names = [m for m in self.params.metric if m != "none"]
        if not names:
            default = default_metric_for_objective(self.params.objective)
            if default != "none":
                names = [default]
        return names

    def _eval_on(self, pred_raw, ds: Dataset, name: str):
        names = self._metric_names()
        out = []
        # the ranking metrics need the query groups: they take the grouped
        # path on the raw scores, after the plain metrics, as the reference
        plain = [m for m in names if m not in ("ndcg", "map")]
        grouped = tuple(m for m in names if m in ("ndcg", "map"))
        if plain:
            t = self.obj.transform(pred_raw)
            for mname in plain:
                m = get_metric(mname, self.params)
                out.append((name, mname, float(m.fn(t, ds.y, ds.w)),
                            m.higher_better))
        if grouped:
            from ..ranking import eval_ranking

            for mname, val, hib in eval_ranking(
                    pred_raw, ds, self.params.eval_at,
                    self.params.label_gain, metrics=grouped):
                out.append((name, mname, val, hib))
        return out

    def _feval_results(self, feval, pred_raw, ds, name):
        if feval is None:
            return []
        fevals = feval if isinstance(feval, (list, tuple)) else [feval]
        pred_host = self.obj.transform(pred_raw).cpu().numpy()[:ds.num_data_]
        out = []
        for f in fevals:
            mname, val, hib = f(pred_host, ds)
            out.append((name, mname, float(val), bool(hib)))
        return out

    def eval_train(self, feval=None):
        pred = self._pred_train_effective()
        res = self._eval_on(pred, self.train_set, "training")
        return res + self._feval_results(feval, pred, self.train_set,
                                         "training")

    def eval_valid(self, feval=None):
        out = []
        for name, vds, vpred in self._valid:
            vp = self._rf_scale(vpred)
            out.extend(self._eval_on(vp, vds, name))
            out.extend(self._feval_results(feval, vp, vds, name))
        return out

    def _rf_scale(self, pred_raw):
        """rf's valid scores are sums over the trees at shrink 1.0: their
        mean over the rounds so far."""
        if self.params.boosting == "rf" and self._iter > 0:
            init = self.init_score_
            if isinstance(init, np.ndarray):
                init = torch.from_numpy(init).to(pred_raw.device)
            return (pred_raw - init) / self._iter + init
        return pred_raw

    def _pred_train_effective(self):
        """The train scores the metrics see: rf keeps ``_pred_train`` at the
        init score, so the mean over its trees is replayed (the plain
        forest replay, as the reference's)."""
        if self.params.boosting != "rf" or not self.trees:
            return self._pred_train
        forest = self._stacked_forest()
        bins = self.train_set.X_binned
        scale = torch.tensor(1.0 / self._iter, dtype=_F32, device=bins.device)
        if self._num_class > 1:
            return _predict_forest_mc(forest, bins, scale, self.init_score_,
                                      self._iter, self.params.num_leaves)
        return predict_forest_binned(forest, bins, scale,
                                     float(self.init_score_), self._iter,
                                     self.params.num_leaves)

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        data.construct()
        if data.y is None:
            raise ValueError(f"valid set '{name}' requires a label")
        if data.device != self.device:
            raise ValueError(f"valid set '{name}' lives on {data.device}, "
                             f"the Booster on {self.device}")
        vpred = self._init_scores(int(data.row_mask.shape[0]))
        shrink = torch.tensor(self._shrink, dtype=_F32, device=self.device)
        if getattr(self, "_linear_k", None) is not None:
            raw = data.raw_data
            if raw is None or isinstance(raw, str):
                raise ValueError(
                    "linear_tree valid sets need raw feature values "
                    "(free_raw_data=False, in-memory matrix)")
            data._xraw_dev = raw_to_device(raw, int(data.row_mask.shape[0]),
                                           self.device)
        for tree in self.trees:
            vpred = vpred + shrink * self._tree_round_values(
                tree, data.X_binned, getattr(data, "_xraw_dev", None),
                self._depth_cap)
        self._valid.append((name, data, vpred))
        return self

    # -- prediction ------------------------------------------------------
    def _stacked_forest(self) -> Tree:
        if self._forest_cache is None:
            if not self.trees:
                raise ValueError("no trees trained yet")
            # trees of mixed capacity (a continuation at another
            # num_leaves) are padded to the largest
            forest = stack_trees(self.trees)
            self._forest_depth = forest_depth_cap(forest)
            self._forest_cache = forest
        return self._forest_cache

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, start_iteration: int = 0,
                ntree_limit: Optional[int] = None,
                **kwargs) -> np.ndarray:
        """Predict on raw (unbinned) features; ``num_iteration`` (or its
        xgboost-style alias ``ntree_limit``) truncates to the first k trees
        (None: the best iteration when early stopping found one; <= 0: all
        trees), the staged-prediction contract.  An rf forest averages the
        trees it uses.  ``pred_leaf`` gives each tree's leaf ordinal
        ``[n, T*K]`` (iteration-major); ``pred_contrib`` exact TreeSHAP
        values ``[n, F+1]`` (``[n, K*(F+1)]`` multiclass) in raw-score
        space, the expected value in the last column (``ops/shap.py``)."""
        if isinstance(data, Dataset):
            raise TypeError("predict() expects a raw feature matrix, not a "
                            "Dataset (matching lightgbm)")
        if num_iteration is None:
            num_iteration = ntree_limit
        if num_iteration is None:
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0 else len(self.trees))
        elif num_iteration <= 0:
            num_iteration = len(self.trees)
        start_iteration = max(int(start_iteration), 0)
        num_iteration = min(num_iteration, len(self.trees) - start_iteration)
        from ..dataset import _to_2d_float_array

        X = _to_2d_float_array(data)
        codes = self._bin_mapper_for_predict().transform(X)
        bins = torch.from_numpy(codes).to(self.device)
        if pred_leaf:
            return self._pred_leaf(bins, start_iteration, num_iteration)
        linear = bool(self.trees) and self.trees[0].linear_feat is not None
        if pred_contrib:
            if linear:
                raise NotImplementedError(
                    "pred_contrib with linear_tree is not supported")
            return self._pred_contrib(bins, start_iteration, num_iteration)
        if linear:
            xr = torch.from_numpy(np.ascontiguousarray(
                X, dtype=np.float32)).to(self.device)
            raw = self._init_scores(bins.shape[0])
            shrink = torch.tensor(self._shrink, dtype=_F32,
                                  device=self.device)
            for t in range(start_iteration, start_iteration + num_iteration):
                raw = raw + shrink * linear_tree_values(
                    self.trees[t], bins, xr, self._depth_cap)
        elif not self.trees:
            raw = self._init_scores(bins.shape[0])
        else:
            forest = self._stacked_forest()
            lr = torch.tensor(self._shrink, dtype=_F32, device=self.device)
            depth = min(self._depth_cap, self._forest_depth)
            if self._num_class == 1:
                raw = predict_forest_binned(
                    forest, bins, lr, self.init_score_, num_iteration, depth,
                    start_iteration=start_iteration)
            else:
                raw = _predict_forest_mc(forest, bins, lr, self.init_score_,
                                         num_iteration, depth,
                                         start_iteration=start_iteration)
            if self.params.boosting == "rf" and num_iteration > 0:
                init = (self.init_score_ if self._num_class == 1 else
                        torch.from_numpy(np.asarray(
                            self.init_score_, np.float32)).to(raw.device))
                raw = (raw - init) / num_iteration + init
        if raw_score:
            return raw.cpu().numpy()
        return self.obj.transform(raw).cpu().numpy()

    def _pred_leaf(self, bins: torch.Tensor, start: int,
                   num: int) -> np.ndarray:
        """Leaf ordinals ``[n, num * K]``, iteration-major: the rank of the
        reached slot among the tree's leaf slots (``cumsum(is_leaf) - 1``),
        not the slot itself, as LightGBM's contract and the reference's."""
        k = self._num_class
        cols = []
        for t in range(start, start + num):
            for c in range(k):
                tree = self.trees[t] if k == 1 else \
                    _class_tree(self.trees[t], c)
                node = predict_leaf_nodes(tree, bins, self._depth_cap)
                ordinal = torch.cumsum(tree.is_leaf.to(torch.int32), 0) - 1
                cols.append(ordinal[node].to(torch.int32))
        if not cols:
            return np.zeros((bins.shape[0], 0), np.int32)
        return torch.stack(cols, dim=1).cpu().numpy()

    def _pred_contrib(self, bins: torch.Tensor, start: int,
                      num: int) -> np.ndarray:
        """Exact TreeSHAP contributions over the selected trees, per
        ORIGINAL feature (EFB bundle splits resolved through the bundle
        map); the bias column carries the trees' expected values plus the
        init score, so a row sums to its raw prediction.  rf divides by the
        tree count, as its prediction averages."""
        from ..ops.shap import forest_pred_contrib

        bm = self._bin_mapper_for_predict()
        p = self.params
        k = self._num_class
        sel = self.trees[start:start + num]
        if sel:
            # one node capacity for the whole selection
            cap = max(t.capacity for t in sel)
            sel = [pad_tree(t, cap) for t in sel]
        is_rf = p.boosting == "rf"
        shrink = np.full(len(sel), self._shrink, np.float32)
        outs = []
        for c in range(k):
            trees = [t if k == 1 else _class_tree(t, c) for t in sel]
            phi = forest_pred_contrib(trees, bins, bm.num_features, shrink,
                                      bundler=bm.bundler)
            if is_rf and len(sel) > 0:
                phi = phi / len(sel)
            init = (float(self.init_score_[c]) if k > 1
                    else float(np.float32(self.init_score_)))
            phi[:, -1] += init
            outs.append(phi)
        out = torch.cat(outs, dim=1) if k > 1 else outs[0]
        return out.cpu().numpy()

    def _bin_mapper_for_predict(self):
        if self.train_set is not None:
            return self.train_set.bin_mapper
        return self._bin_mapper

    # -- introspection ---------------------------------------------------
    def current_iteration(self) -> int:
        return self._iter

    def num_trees(self) -> int:
        return len(self.trees)

    def num_feature(self) -> int:
        if self.train_set is not None:
            return self.train_set.num_feature()
        return self._bin_mapper.num_features

    def feature_name(self) -> List[str]:
        if self.train_set is not None:
            return list(self.train_set.feature_names)
        return list(self._feature_names or [])

    def num_model_per_iteration(self) -> int:
        return self._num_class

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Per-feature split counts or total gains over the first
        ``iteration`` rounds (all when None or <= 0)."""
        k = len(self.trees) if (iteration is None or iteration <= 0) \
            else min(int(iteration), len(self.trees))
        out = np.zeros(self.num_feature(), dtype=np.float64)
        if k == 0:
            return (out.astype(np.int64) if importance_type == "split"
                    else out)
        forest = self._stacked_forest()

        def host(a):
            return a[:k].cpu().numpy().ravel()

        feats = host(forest.split_feature)
        gains = host(forest.split_gain)
        used = ~host(forest.is_leaf) & (host(forest.left) >= 0)
        bundler = getattr(self._bin_mapper_for_predict(), "bundler", None)
        if bundler is not None:
            feats = bundler.split_to_original(feats, host(forest.split_bin))
        vals = np.ones_like(gains) if importance_type == "split" else gains
        np.add.at(out, feats[used], vals[used])
        if importance_type == "split":
            return out.astype(np.int64)
        return out

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict[str, Any]:
        """Nested-dict model dump (LightGBM ``dump_model`` contract)."""
        from ..utils.serialize import dump_booster_dict

        return dump_booster_dict(self, num_iteration=num_iteration,
                                 start_iteration=start_iteration)

    def trees_to_dataframe(self):
        """Flat per-node pandas DataFrame (LightGBM ``trees_to_dataframe``):
        one row per node with tree_index / node_depth / node_index /
        children / parent / split_feature / split_gain / threshold /
        decision_type / value / count, node names in LightGBM's
        ``{tree}-S{split}`` / ``{tree}-L{leaf}`` convention."""
        import pandas as pd

        names = self.feature_name()
        rows: List[Dict[str, Any]] = []

        def walk(node: Dict[str, Any], tree_idx: int, depth: int,
                 parent: Optional[str]) -> str:
            is_leaf = "leaf_index" in node
            nid = (f"{tree_idx}-L{node['leaf_index']}" if is_leaf
                   else f"{tree_idx}-S{node['split_index']}")
            row = {
                "tree_index": tree_idx, "node_depth": depth,
                "node_index": nid, "left_child": None, "right_child": None,
                "parent_index": parent, "split_feature": None,
                "split_gain": None, "threshold": None,
                "decision_type": None,
                "value": node.get("leaf_value"),
                "count": int(node.get("leaf_count",
                                      node.get("internal_count", 0))),
            }
            rows.append(row)
            if not is_leaf:
                row["split_feature"] = names[node["split_feature"]]
                row["split_gain"] = node["split_gain"]
                row["threshold"] = node["threshold"]
                row["decision_type"] = node.get("decision_type", "<=")
                row["value"] = None
                row["left_child"] = walk(node["left_child"], tree_idx,
                                         depth + 1, nid)
                row["right_child"] = walk(node["right_child"], tree_idx,
                                          depth + 1, nid)
            return nid

        for ti, tinfo in enumerate(self.dump_model()["tree_info"]):
            walk(tinfo["tree_structure"], ti, 1, None)
        return pd.DataFrame(rows)

    # -- persistence -----------------------------------------------------
    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        from ..utils.serialize import save_booster

        save_booster(self, filename, num_iteration=num_iteration,
                     start_iteration=start_iteration)
        return self

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        from ..utils.serialize import booster_to_string

        return booster_to_string(self, num_iteration=num_iteration,
                                 start_iteration=start_iteration)

    def params_dict(self) -> dict:
        """The params as a plain dict (``extra`` dropped) for model files;
        ``learning_rate`` is the base rate the stored leaves are scaled
        to."""
        d = dataclasses.asdict(self.params)
        d.pop("extra", None)
        d["learning_rate"] = float(self._base_lr)
        return d
