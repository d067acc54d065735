"""Parameter schema — the port's copy of ``lightgbm_tpu/config.py``.

Speaks LightGBM's parameter vocabulary (names, aliases, defaults) exactly as
the JAX package does, so a packed model's ``params`` dict parses to the same
:class:`Params` in both packages (SURVEY.md §2B: the grid passes
``learning_rate``, ``num_leaves``, ``min_data_in_leaf``, ``feature_fraction``,
``bagging_fraction``, ``bagging_freq``, ``nthread`` straight through params).

Unknown parameters are tolerated with a warning (the reference rides ``nthread``
inside params and LightGBM silently accepts it).

The schema is kept whole, training fields included, so that artifacts written
by either package round-trip; ``device_type`` keeps its reference default.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence, Union

# ---------------------------------------------------------------------------
# Alias table (LightGBM's Config::ParameterAlias, re-derived from the public
# parameter docs — only the names plausibly reachable from the reference
# snippets and sklearn-style wrappers).
# ---------------------------------------------------------------------------
_ALIASES: Dict[str, str] = {
    # core
    "num_iterations": "num_iterations",
    "num_iteration": "num_iterations",
    "n_iter": "num_iterations",
    "num_tree": "num_iterations",
    "num_trees": "num_iterations",
    "num_round": "num_iterations",
    "num_rounds": "num_iterations",
    "nrounds": "num_iterations",
    "num_boost_round": "num_iterations",
    "n_estimators": "num_iterations",
    "max_iter": "num_iterations",
    "learning_rate": "learning_rate",
    "shrinkage_rate": "learning_rate",
    "eta": "learning_rate",
    "num_leaves": "num_leaves",
    "num_leaf": "num_leaves",
    "max_leaves": "num_leaves",
    "max_leaf": "num_leaves",
    "max_leaf_nodes": "num_leaves",
    "objective": "objective",
    "objective_type": "objective",
    "app": "objective",
    "application": "objective",
    "loss": "objective",
    "boosting": "boosting",
    "boosting_type": "boosting",
    "boost": "boosting",
    "max_depth": "max_depth",
    "tree_learner": "tree_learner",
    "tree": "tree_learner",
    "tree_type": "tree_learner",
    "tree_learner_type": "tree_learner",
    "num_threads": "num_threads",
    "num_thread": "num_threads",
    "nthread": "num_threads",
    "nthreads": "num_threads",
    "n_jobs": "num_threads",
    "device_type": "device_type",
    "device": "device_type",
    "seed": "seed",
    "random_seed": "seed",
    "random_state": "seed",
    "deterministic": "deterministic",
    # learning control
    "min_data_in_leaf": "min_data_in_leaf",
    "min_data_per_leaf": "min_data_in_leaf",
    "min_data": "min_data_in_leaf",
    "min_child_samples": "min_data_in_leaf",
    "min_samples_leaf": "min_data_in_leaf",
    "min_sum_hessian_in_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian_per_leaf": "min_sum_hessian_in_leaf",
    "min_sum_hessian": "min_sum_hessian_in_leaf",
    "min_hessian": "min_sum_hessian_in_leaf",
    "min_child_weight": "min_sum_hessian_in_leaf",
    "bagging_fraction": "bagging_fraction",
    "sub_row": "bagging_fraction",
    "subsample": "bagging_fraction",
    "bagging": "bagging_fraction",
    "bagging_freq": "bagging_freq",
    "subsample_freq": "bagging_freq",
    "bagging_seed": "bagging_seed",
    "bagging_fraction_seed": "bagging_seed",
    "feature_fraction": "feature_fraction",
    "sub_feature": "feature_fraction",
    "colsample_bytree": "feature_fraction",
    "feature_fraction_bynode": "feature_fraction_bynode",
    "sub_feature_bynode": "feature_fraction_bynode",
    "colsample_bynode": "feature_fraction_bynode",
    "feature_fraction_seed": "feature_fraction_seed",
    # r20 gain-informed feature screening (EMA-FS)
    "feature_screen": "feature_screen",
    "feature_screening": "feature_screen",
    "screen_features": "feature_screen",
    "screen_ema_decay": "screen_ema_decay",
    "screen_decay": "screen_ema_decay",
    "screen_keep_ratio": "screen_keep_ratio",
    "screen_keep": "screen_keep_ratio",
    "screen_refresh_rounds": "screen_refresh_rounds",
    "screen_refresh": "screen_refresh_rounds",
    "extra_trees": "extra_trees",
    "monotone_constraints": "monotone_constraints",
    "mc": "monotone_constraints",
    "monotone_constraint": "monotone_constraints",
    "monotonic_cst": "monotone_constraints",
    "monotone_constraints_method": "monotone_constraints_method",
    "monotone_constraining_method": "monotone_constraints_method",
    "mc_method": "monotone_constraints_method",
    "path_smooth": "path_smooth",
    "interaction_constraints": "interaction_constraints",
    "linear_tree": "linear_tree",
    "linear_trees": "linear_tree",
    "linear_lambda": "linear_lambda",
    "grow_policy": "grow_policy",
    "growth_policy": "grow_policy",
    "early_stopping_round": "early_stopping_round",
    "early_stopping_rounds": "early_stopping_round",
    "early_stopping": "early_stopping_round",
    "n_iter_no_change": "early_stopping_round",
    "early_stopping_min_delta": "early_stopping_min_delta",
    "first_metric_only": "first_metric_only",
    "max_delta_step": "max_delta_step",
    "lambda_l1": "lambda_l1",
    "reg_alpha": "lambda_l1",
    "l1_regularization": "lambda_l1",
    "lambda_l2": "lambda_l2",
    "reg_lambda": "lambda_l2",
    "lambda": "lambda_l2",
    "l2_regularization": "lambda_l2",
    "min_gain_to_split": "min_gain_to_split",
    "min_split_gain": "min_gain_to_split",
    "top_rate": "top_rate",
    "goss_top_rate": "top_rate",
    "other_rate": "other_rate",
    "goss_other_rate": "other_rate",
    "top_k": "top_k",
    "topk": "top_k",
    "verbosity": "verbosity",
    "verbose": "verbosity",
    "max_bin": "max_bin",
    "max_bins": "max_bin",
    "min_data_in_bin": "min_data_in_bin",
    "data_random_seed": "data_random_seed",
    "data_seed": "data_random_seed",
    "enable_bundle": "enable_bundle",
    "bundle": "enable_bundle",
    "efb": "enable_bundle",
    "is_enable_bundle": "enable_bundle",
    "max_conflict_rate": "max_conflict_rate",
    "cat_smooth": "cat_smooth",
    "cat_l2": "cat_l2",
    "max_cat_threshold": "max_cat_threshold",
    "drop_rate": "drop_rate",
    "rate_drop": "drop_rate",
    "max_drop": "max_drop",
    "skip_drop": "skip_drop",
    "xgboost_dart_mode": "xgboost_dart_mode",
    "uniform_drop": "uniform_drop",
    "drop_seed": "drop_seed",
    "use_missing": "use_missing",
    "zero_as_missing": "zero_as_missing",
    "boost_from_average": "boost_from_average",
    "use_quantized_grad": "use_quantized_grad",
    "quantized_grad": "use_quantized_grad",
    # objective-specific
    "num_class": "num_class",
    "num_classes": "num_class",
    "is_unbalance": "is_unbalance",
    "unbalance": "is_unbalance",
    "unbalanced_sets": "is_unbalance",
    "scale_pos_weight": "scale_pos_weight",
    "sigmoid": "sigmoid",
    "alpha": "alpha",
    "huber_delta": "alpha",
    "quantile_alpha": "alpha",
    "fair_c": "fair_c",
    "poisson_max_delta_step": "poisson_max_delta_step",
    "tweedie_variance_power": "tweedie_variance_power",
    "lambdarank_truncation_level": "lambdarank_truncation_level",
    "lambdarank_norm": "lambdarank_norm",
    "label_gain": "label_gain",
    # metric
    "metric": "metric",
    "metrics": "metric",
    "metric_types": "metric",
    "eval": "metric",  # the R binding's `eval=` arg (LightGBM R.ipynb:437)
    "eval_metric": "metric",
    "metric_freq": "metric_freq",
    "output_freq": "metric_freq",
    "is_provide_training_metric": "is_provide_training_metric",
    "training_metric": "is_provide_training_metric",
    "train_metric": "is_provide_training_metric",
    "eval_at": "eval_at",
    "ndcg_at": "eval_at",
    "ndcg_eval_at": "eval_at",
    "map_at": "eval_at",
    "map_eval_at": "eval_at",
}

_OBJECTIVE_ALIASES: Dict[str, str] = {
    "regression": "regression",
    "regression_l2": "regression",
    "l2": "regression",
    "mean_squared_error": "regression",
    "mse": "regression",
    "l2_root": "regression",
    "root_mean_squared_error": "regression",
    "rmse": "regression",
    "reg:linear": "regression",  # xgboost vocabulary (bagging_boosting.ipynb:121)
    "reg:squarederror": "regression",
    "regression_l1": "regression_l1",
    "l1": "regression_l1",
    "mean_absolute_error": "regression_l1",
    "mae": "regression_l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "tweedie": "tweedie",
    "cross_entropy": "cross_entropy",
    "xentropy": "cross_entropy",
    "binary": "binary",
    "binary_logloss": "binary",
    "binary:logistic": "binary",
    "multiclass": "multiclass",
    "softmax": "multiclass",
    "multi:softmax": "multiclass",
    "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova",
    "ova": "multiclassova",
    "ovr": "multiclassova",
    "lambdarank": "lambdarank",
    "rank_xendcg": "lambdarank",
    "xendcg": "lambdarank",
    "rank:pairwise": "lambdarank",
    "none": "none",
    "null": "none",
    "custom": "none",
    "na": "none",
}

_METRIC_ALIASES: Dict[str, str] = {
    "l2": "l2",
    "mse": "l2",
    "mean_squared_error": "l2",
    "regression": "l2",
    "regression_l2": "l2",
    "rmse": "rmse",
    "l2_root": "rmse",
    "root_mean_squared_error": "rmse",
    "l1": "l1",
    "mae": "l1",
    "mean_absolute_error": "l1",
    "regression_l1": "l1",
    "huber": "huber",
    "fair": "fair",
    "poisson": "poisson",
    "quantile": "quantile",
    "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma",
    "gamma_deviance": "gamma_deviance",
    "gamma-deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "cross_entropy": "cross_entropy",
    "xentropy": "cross_entropy",
    "binary_logloss": "binary_logloss",
    "binary": "binary_logloss",
    "logloss": "binary_logloss",
    "log_loss": "binary_logloss",
    "binary_error": "binary_error",
    "auc": "auc",
    "multi_logloss": "multi_logloss",
    "multiclass": "multi_logloss",
    "softmax": "multi_logloss",
    "multiclassova": "multi_logloss",
    "multi_error": "multi_error",
    "ndcg": "ndcg",
    "lambdarank": "ndcg",
    "rank_xendcg": "ndcg",
    "map": "map",
    "mean_average_precision": "map",
    "none": "none",
    "na": "none",
    "null": "none",
    "custom": "none",
}

# TPU-framework-specific knobs (not LightGBM vocabulary): ride in
# Params.extra without an unknown-parameter warning.
_FRAMEWORK_KEYS = {
    "hist_dtype",          # "f32" (default) | "bf16" MXU histogram inputs
    "hist_impl",           # "auto" | "jnp" | "pallas"
    "row_chunk",           # histogram row-chunk size
    "cv_segment_rounds",   # fused-cv rounds per device dispatch
    "fused_segment_rounds",  # update_many rounds per device dispatch
    "fobj",                # custom objective callable
    "wave_width",          # frontier grower: max splits per histogram pass
    "wave_tail",           # "exact" (strict order via overgrow+replay) |
                           # "greedy" (fewest passes) | "half" (near-strict)
    "wave_overgrow",       # exact tail: overgrowth factor (default 2.0)
    "linear_k",            # linear_tree: max path features per leaf model
    "histogram_merge",     # dp merge topology override: "psum" |
                           # "reduce_scatter" | "reduce_scatter_ring" |
                           # "reduce_scatter_pipelined" | "voting"
                           # (default follows tree_learner)
    "histogram_wire",      # ring-hop wire format: "f32" (default,
                           # parity-exact) | "bf16" | "int8" (2x/4x fewer
                           # ring bytes, quality-gated)
    "merge_chunks",        # pipelined merge: sub-chunks per shard slice
                           # whose ring hops overlap split scans (def. 4)
    "mesh_shape",          # dp device topology: "auto" (2-D rows x
                           # features when D>=8 and F>=64) | "1d" |
                           # explicit "RxC" e.g. "4x2"
    "stream_block_rows",   # out-of-core: rows per host block / transfer
                           # unit (multiple of 256; doubles as the
                           # streamed histogram row_chunk — def. 131072)
    "stream_sketch_capacity",  # streaming BinMapper: exact-buffer rows
                           # per feature before degrading to the GK
                           # sketch (def. 200k, matching the in-memory
                           # fit's sample_cnt)
    "stream_sketch_eps",   # GK sketch rank-error target (def. 1e-3)
    "stream_prefetch_blocks",  # out-of-core: device-put lookahead depth
                           # in blocks (def. 1 = double buffer; deeper
                           # pipelines modeled by stream_prefetch_time)
    "stream_dp_devices",   # streamed x dp: cap the row-mesh device count
                           # (def. 0 = all visible; elastic resume pins
                           # the writer's D here when shrinking a fleet)
    "checkpoint_rounds",   # fault-tolerant training (r13): auto-checkpoint
                           # cadence in rounds (def. 10 — <=5% overhead per
                           # analysis.budgets.CKPT_BUDGETS)
    "checkpoint_keep",     # checkpoints retained on disk (def. 2: newest
                           # + one fallback generation for torn writes)
    "finite_screen",       # gradient/hessian finiteness screen before each
                           # streamed/resumable round (def. true)
}

_BOOSTING_ALIASES: Dict[str, str] = {
    "gbdt": "gbdt",
    "gbrt": "gbdt",
    "goss": "goss",
    "rf": "rf",
    "random_forest": "rf",
    "dart": "dart",
}


@dataclasses.dataclass
class Params:
    """Canonical resolved parameters (LightGBM defaults)."""

    # core
    objective: str = "regression"
    boosting: str = "gbdt"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    tree_learner: str = "serial"  # serial | data | feature | voting
    num_threads: int = 0  # accepted & ignored: XLA owns parallelism (SURVEY §2C)
    device_type: str = "tpu"
    seed: int = 0
    deterministic: bool = False
    # learning control
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    bagging_seed: int = 3
    feature_fraction: float = 1.0
    feature_fraction_bynode: float = 1.0
    feature_fraction_seed: int = 2
    # gain-informed feature screening (r20, EMA-FS arXiv:2606.26337):
    # "ema" keeps per-feature gain EWMAs and grows screened rounds over
    # the hottest ceil(keep_ratio * F) columns, with a full-refresh
    # round every screen_refresh_rounds for exactness + cold-feature
    # rediscovery; "off" (default) is bit-identical to pre-r20 trees
    feature_screen: str = "off"
    screen_ema_decay: float = 0.9
    screen_keep_ratio: float = 0.25
    screen_refresh_rounds: int = 10
    extra_trees: bool = False
    # monotone constraints (basic method) + leaf-path smoothing
    monotone_constraints: Optional[List[int]] = None
    monotone_constraints_method: str = "basic"
    path_smooth: float = 0.0
    # feature groups allowed to interact within one branch (upstream
    # interaction_constraints); unlisted features become singleton groups
    interaction_constraints: Optional[List[List[int]]] = None
    # linear leaves (upstream ``linear_tree``): each leaf fits a ridge
    # model over (the first ``linear_k``, a framework key) path features
    linear_tree: bool = False
    linear_lambda: float = 0.0
    # leafwise = strict LightGBM best-first (one split per histogram pass);
    # frontier = wave growth with histogram subtraction (up to wave_width
    # splits per pass — the large-data fast path); auto picks by data size.
    grow_policy: str = "auto"
    early_stopping_round: int = 0
    early_stopping_min_delta: float = 0.0
    first_metric_only: bool = False
    max_delta_step: float = 0.0
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    top_rate: float = 0.2
    other_rate: float = 0.1
    # voting-parallel ballot size (upstream top_k): each shard nominates its
    # local top_k features by gain; the global top-2k by votes are merged
    top_k: int = 20
    verbosity: int = 1
    # dataset
    max_bin: int = 255
    min_data_in_bin: int = 3
    data_random_seed: int = 1
    enable_bundle: bool = True
    max_conflict_rate: float = 0.0
    use_missing: bool = True
    zero_as_missing: bool = False
    # categorical subset splits (upstream cat_smooth/cat_l2/max_cat_threshold)
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    # DART boosting (upstream dart.hpp knobs)
    drop_rate: float = 0.1
    max_drop: int = 50
    skip_drop: float = 0.5
    xgboost_dart_mode: bool = False
    uniform_drop: bool = False
    drop_seed: int = 4
    # quantized-gradient training (upstream use_quantized_grad): maps to
    # bf16 histogram inputs — the FAST reduced-precision mode on this chip.
    # A true int8 path (8-bit stochastic rounding + exact int32 MXU
    # accumulation) exists behind hist_dtype="int8" but measured SLOWER
    # than bf16 (Mosaic int8 relayouts force a 4x smaller row chunk)
    use_quantized_grad: bool = False
    # objective-specific
    boost_from_average: bool = True
    num_class: int = 1
    is_unbalance: bool = False
    scale_pos_weight: float = 1.0
    sigmoid: float = 1.0
    alpha: float = 0.9
    fair_c: float = 1.0
    poisson_max_delta_step: float = 0.7
    tweedie_variance_power: float = 1.5
    lambdarank_truncation_level: int = 30
    lambdarank_norm: bool = True
    label_gain: Optional[List[float]] = None
    # metric
    metric: List[str] = dataclasses.field(default_factory=list)
    metric_freq: int = 1
    is_provide_training_metric: bool = False
    eval_at: List[int] = dataclasses.field(default_factory=lambda: [1, 2, 3, 4, 5])
    # passthrough of anything unrecognized (kept for introspection)
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def copy(self) -> "Params":
        return dataclasses.replace(
            self,
            metric=list(self.metric),
            eval_at=list(self.eval_at),
            extra=dict(self.extra),
            monotone_constraints=(None if self.monotone_constraints is None
                                  else list(self.monotone_constraints)),
            interaction_constraints=(
                None if self.interaction_constraints is None
                else [list(g) for g in self.interaction_constraints]),
        )


_BOOL_FIELDS = {
    f.name for f in dataclasses.fields(Params) if f.type in ("bool", bool)
}
_INT_FIELDS = {f.name for f in dataclasses.fields(Params) if f.type in ("int", int)}
_FLOAT_FIELDS = {
    f.name for f in dataclasses.fields(Params) if f.type in ("float", float)
}


def _coerce(name: str, value: Any) -> Any:
    if name in _BOOL_FIELDS:
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes", "+")
        return bool(value)
    if name in _INT_FIELDS:
        return int(value)
    if name in _FLOAT_FIELDS:
        return float(value)
    return value


def _normalize_metric(value: Union[str, Sequence[str], None]) -> List[str]:
    if value is None:
        return []
    if isinstance(value, str):
        value = [v.strip() for v in value.split(",") if v.strip()]
    out: List[str] = []
    for m in value:
        key = str(m).lower()
        canon = _METRIC_ALIASES.get(key)
        if canon is None:
            warnings.warn(f"Unknown metric '{m}' ignored")
            continue
        if canon not in out:
            out.append(canon)
    return out


def parse_params(
    params: Optional[Dict[str, Any]] = None,
    *,
    base: Optional[Params] = None,
    warn_unknown: bool = True,
    **overrides: Any,
) -> Params:
    """Resolve a user param dict (LightGBM vocabulary) into a :class:`Params`.

    Later duplicates of the same canonical parameter win, matching LightGBM's
    "last alias wins" behavior.  Unknown keys are preserved in ``extra`` with a
    warning (the reference grid rows carry ``nthread`` through params —
    r/gridsearchCV.R:100 — which maps to the ignored ``num_threads``).
    """
    out = base.copy() if base is not None else Params()
    merged: Dict[str, Any] = {}
    for src in (params or {}), overrides:
        for k, v in src.items():
            if v is None:
                continue
            merged[k] = v
    # preset="parity": CPU-reference quality mode (VERDICT r3 #3).
    # TRUE-STRICT best-first order (grow_policy="leafwise") + EXACT f32
    # histograms (Precision.HIGHEST) on the XLA path.  Measured r4 at
    # Higgs-1M/100 rounds: AUC 0.89863 vs CPU-oracle 0.89841 — gap
    # -2.15e-4 +- 0.88e-4 paired-bootstrap SE, i.e. the parity preset
    # BEATS the oracle (the r3 8.1e-4 gap was entirely the half-tail's
    # departure from strict split order).  The XLA path also sidesteps
    # this worker's known Pallas fault under near-strict invocation
    # patterns (PERF.md), and strict on the jnp path costs ~2.4 s/round
    # at 1M rows.  Explicit user keys still win over preset defaults.
    preset = str(merged.pop("preset", "")).lower()
    if preset == "parity":
        merged.setdefault("grow_policy", "leafwise")
        merged.setdefault("hist_dtype", "f32")
        merged.setdefault("hist_impl", "jnp")
    elif preset:
        warnings.warn(f"Unknown preset '{preset}' ignored", stacklevel=2)
    for key, value in merged.items():
        canon = _ALIASES.get(str(key).lower())
        if canon is None:
            if warn_unknown and str(key).lower() not in _FRAMEWORK_KEYS:
                warnings.warn(f"Unknown parameter '{key}' ignored", stacklevel=2)
            out.extra[str(key)] = value
            continue
        if canon == "metric":
            out.metric = _normalize_metric(value)
        elif canon == "objective":
            if callable(value):
                out.extra["fobj"] = value
                out.objective = "none"
                continue
            ov = _OBJECTIVE_ALIASES.get(str(value).lower())
            if ov is None:
                raise ValueError(f"Unknown objective: {value!r}")
            out.objective = ov
        elif canon == "boosting":
            bv = _BOOSTING_ALIASES.get(str(value).lower())
            if bv is None:
                raise ValueError(f"Unknown boosting type: {value!r}")
            out.boosting = bv
        elif canon == "interaction_constraints":
            # accepts [[0,1],[2]] or LightGBM's string form "[0,1],[2]"
            if isinstance(value, str):
                import re as _re
                parsed = [[int(x) for x in grp.split(",") if x.strip()]
                          for grp in _re.findall(r"\[([^\]]*)\]", value)]
                if not parsed:
                    raise ValueError(
                        "interaction_constraints string must contain "
                        "bracketed groups like '[0,1],[2,3]', got "
                        f"{value!r}")
                value = parsed
            out.interaction_constraints = [
                [int(f) for f in grp] for grp in value]
        elif canon == "monotone_constraints":
            # accepts LightGBM's "+1,0,-1" string form or any int sequence
            if isinstance(value, str):
                value = [v.strip() for v in value.split(",") if v.strip()]
            out.monotone_constraints = [int(v) for v in value]
        elif canon in ("label_gain", "eval_at"):
            if isinstance(value, str):
                value = [float(v) for v in value.split(",")]
            setattr(out, canon, [int(v) if canon == "eval_at" else float(v) for v in value])
        else:
            setattr(out, canon, _coerce(canon, value))
    _validate(out)
    return out


def _validate(p: Params) -> None:
    if p.num_leaves < 2:
        raise ValueError(f"num_leaves must be >= 2, got {p.num_leaves}")
    if p.num_leaves > 131072:
        raise ValueError(f"num_leaves too large: {p.num_leaves}")
    if not (1 < p.max_bin <= 256):
        raise ValueError(f"max_bin must be in (1, 256], got {p.max_bin}")
    if not (0.0 < p.bagging_fraction <= 1.0):
        raise ValueError(f"bagging_fraction must be in (0, 1], got {p.bagging_fraction}")
    if not (0.0 < p.feature_fraction <= 1.0):
        raise ValueError(f"feature_fraction must be in (0, 1], got {p.feature_fraction}")
    if p.learning_rate <= 0:
        raise ValueError(f"learning_rate must be > 0, got {p.learning_rate}")
    if p.objective in ("multiclass", "multiclassova") and p.num_class < 2:
        raise ValueError("multiclass objective requires num_class >= 2")
    if p.grow_policy not in ("auto", "leafwise", "frontier"):
        raise ValueError(
            f"grow_policy must be auto/leafwise/frontier, got {p.grow_policy}")
    if p.tree_learner not in ("serial", "data", "feature", "voting"):
        raise ValueError(
            "tree_learner must be serial/data/feature/voting, got "
            f"{p.tree_learner!r}")
    if p.top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {p.top_k}")
    if p.feature_screen not in ("off", "ema"):
        raise ValueError(
            f"feature_screen must be off/ema, got {p.feature_screen!r}")
    if not (0.0 < p.screen_ema_decay < 1.0):
        raise ValueError(
            f"screen_ema_decay must be in (0, 1), got {p.screen_ema_decay}")
    if not (0.0 < p.screen_keep_ratio <= 1.0):
        raise ValueError(
            f"screen_keep_ratio must be in (0, 1], got "
            f"{p.screen_keep_ratio}")
    if p.screen_refresh_rounds < 1:
        raise ValueError(
            f"screen_refresh_rounds must be >= 1, got "
            f"{p.screen_refresh_rounds}")
    if p.monotone_constraints is not None:
        if any(c not in (-1, 0, 1) for c in p.monotone_constraints):
            raise ValueError(
                "monotone_constraints entries must be -1, 0, or 1, got "
                f"{p.monotone_constraints}")
        if p.monotone_constraints_method not in (
                "basic", "intermediate", "advanced"):
            raise ValueError(
                "monotone_constraints_method must be basic/intermediate/"
                f"advanced, got {p.monotone_constraints_method!r}")
        if p.monotone_constraints_method != "basic":
            warnings.warn(
                f"monotone_constraints_method="
                f"'{p.monotone_constraints_method}' falls back to 'basic' "
                "(the mid-point bound method); constraints are still "
                "enforced exactly, only split selection is more "
                "conservative")
    if p.path_smooth < 0:
        raise ValueError(f"path_smooth must be >= 0, got {p.path_smooth}")
    if p.objective == "tweedie" or "tweedie" in p.metric:
        if not (1.0 < p.tweedie_variance_power < 2.0):
            raise ValueError(
                "tweedie_variance_power must be in (1, 2), got "
                f"{p.tweedie_variance_power} (use objective='poisson' for "
                "rho=1 and 'gamma' for rho=2)")
    if p.linear_tree:
        if p.linear_lambda < 0:
            raise ValueError(
                f"linear_lambda must be >= 0, got {p.linear_lambda}")
        if p.boosting != "gbdt":
            raise NotImplementedError(
                f"linear_tree supports boosting='gbdt' only "
                f"(got {p.boosting!r})")
        if p.objective in ("multiclass", "multiclassova", "lambdarank"):
            raise NotImplementedError(
                f"linear_tree with objective={p.objective!r} is not "
                "supported yet")
    if p.boosting == "rf":
        if p.bagging_freq <= 0 or not (0.0 < p.bagging_fraction < 1.0):
            # LightGBM requires bagging for rf mode; default to sklearn-ish bootstrap
            p.bagging_freq = max(p.bagging_freq, 1)
            if p.bagging_fraction >= 1.0:
                p.bagging_fraction = 0.632  # P(row in bootstrap sample)
    if p.boosting == "goss":
        if p.bagging_fraction < 1.0 or p.bagging_freq > 0:
            # LightGBM: "Cannot use bagging in GOSS" — GOSS replaces bagging
            warnings.warn("bagging is disabled under boosting='goss' "
                          "(GOSS replaces bagging)")
            p.bagging_fraction = 1.0
            p.bagging_freq = 0
        if not (0.0 <= p.top_rate <= 1.0 and 0.0 < p.other_rate <= 1.0):
            raise ValueError(
                f"goss requires 0<=top_rate<=1 and 0<other_rate<=1, got "
                f"top_rate={p.top_rate}, other_rate={p.other_rate}")
        if p.top_rate + p.other_rate > 1.0:
            raise ValueError("goss requires top_rate + other_rate <= 1")
    if p.boosting == "dart":
        if not (0.0 <= p.drop_rate <= 1.0) or not (0.0 <= p.skip_drop <= 1.0):
            raise ValueError("dart requires 0<=drop_rate<=1 and "
                             "0<=skip_drop<=1")


def default_metric_for_objective(objective: str) -> str:
    """LightGBM's default metric when `metric`/`eval` is omitted.

    The reference sweep relies on this: with no ``eval`` arg the regression
    metric defaults to **l2 (MSE)** — proven by paramGrid.RData score
    magnitudes (SURVEY.md §2A row 5, r/gridsearchCV.R:108-115).
    """
    return {
        "regression": "l2",
        "regression_l1": "l1",
        "huber": "huber",
        "fair": "fair",
        "poisson": "poisson",
        "quantile": "quantile",
        "mape": "mape",
        "gamma": "gamma",
        "tweedie": "tweedie",
        "cross_entropy": "cross_entropy",
        "binary": "binary_logloss",
        "multiclass": "multi_logloss",
        "multiclassova": "multi_logloss",
        "lambdarank": "ndcg",
        "none": "none",
    }.get(objective, "l2")
