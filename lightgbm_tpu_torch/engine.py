"""Training entry points: ``train`` and ``cv`` — the port of
``lightgbm_tpu/engine.py``.

* ``train(params, dtrain, num_boost_round, ...)`` — r/gridsearchCV.R's
  ``lgb.train``;
* ``cv(params, dtrain, num_boost_round, nfold, early_stopping_rounds, ...)``
  with lockstep fold training, early stopping on the fold-mean metric, and
  ``best_iter`` / ``best_score`` where ``best_score`` follows the R binding's
  sign flip (higher is better).

Training runs on the training Dataset's device.  ``cv`` takes the
reference's route: a plain call (no callbacks, ``feval``,
``return_cvbooster``, ``eval_train_metric`` or ``verbose_eval``) trains all
folds at once in the fused program (``models/fused.py``), anything else one
Booster per fold.  A Dataset with query groups gets whole-query folds and
its ranking objective the per-fold route, each fold's groups cut from its
rows.  ``train(init_model=)`` continues a Booster or a saved model file
(:meth:`~.models.gbdt.Booster.ingest_init_model`): its trees come first
and the new rounds grow on from its scores.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

from .callback import (
    CallbackEnv,
    EarlyStopException,
    early_stopping,
    log_evaluation,
    record_evaluation,
)
from .config import default_metric_for_objective, parse_params
from .dataset import Dataset
from .metrics import get_metric
from .models.gbdt import Booster

_ConfigAliases = {
    "num_iterations": {"num_iterations", "num_iteration", "n_iter", "num_tree",
                       "num_trees", "num_round", "num_rounds", "nrounds",
                       "num_boost_round", "n_estimators", "max_iter"},
    "early_stopping_round": {"early_stopping_round", "early_stopping_rounds",
                             "early_stopping", "n_iter_no_change"},
}


def _resolve_num_rounds(params_dict: Optional[Dict], num_boost_round: int) -> int:
    if params_dict:
        for k, v in params_dict.items():
            if str(k).lower() in _ConfigAliases["num_iterations"] and v is not None:
                return int(v)
    return num_boost_round


def train(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    valid_sets: Optional[Union[Dataset, Sequence[Dataset]]] = None,
    valid_names: Optional[Sequence[str]] = None,
    feval: Optional[Callable] = None,
    init_model: Optional[Union[str, Booster]] = None,
    keep_training_booster: bool = False,
    callbacks: Optional[List[Callable]] = None,
    # deprecated-style conveniences kept for snippet parity
    early_stopping_rounds: Optional[int] = None,
    verbose_eval: Optional[Union[bool, int]] = None,
    evals_result: Optional[Dict] = None,
) -> Booster:
    """Train a GBDT (``lgb.train`` equivalent — r/gridsearchCV.R:57)."""
    p = parse_params(params)
    num_boost_round = _resolve_num_rounds(params, num_boost_round)
    if early_stopping_rounds is not None:
        p.early_stopping_round = int(early_stopping_rounds)

    if isinstance(train_set, np.ndarray):
        raise TypeError("train() expects a Dataset; wrap your matrix in "
                        "Dataset(X, label=y)")
    booster = Booster(p, train_set)
    if init_model is not None:
        prev = (init_model if isinstance(init_model, Booster)
                else Booster(model_file=init_model, device=train_set.device))
        booster.ingest_init_model(prev)

    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            name = (valid_names[i] if valid_names and i < len(valid_names)
                    else f"valid_{i}")
            if vs is train_set:
                continue  # training metrics handled via eval_train
            booster.add_valid(vs, name)

    cbs: List[Callable] = list(callbacks or [])
    if p.early_stopping_round > 0 and not any(
            getattr(c, "order", None) == 30 for c in cbs):
        cbs.append(early_stopping(p.early_stopping_round,
                                  first_metric_only=p.first_metric_only,
                                  verbose=p.verbosity > 0,
                                  min_delta=p.early_stopping_min_delta))
    if verbose_eval not in (None, False) and not any(
            getattr(c, "order", None) == 10
            and not getattr(c, "before_iteration", False) for c in cbs):
        period = 1 if verbose_eval is True else int(verbose_eval)
        cbs.append(log_evaluation(period))
    if evals_result is not None:
        cbs.append(record_evaluation(evals_result))
    cbs.sort(key=lambda c: getattr(c, "order", 50))

    eval_training = p.is_provide_training_metric or (
        valid_sets is not None and any(vs is train_set for vs in (valid_sets or [])))

    if not cbs and not eval_training and not booster._valid:
        booster.update_many(num_boost_round)
        return booster

    cbs_before = [c for c in cbs if getattr(c, "before_iteration", False)]
    cbs_after = [c for c in cbs if not getattr(c, "before_iteration", False)]

    results: List = []
    try:
        for i in range(num_boost_round):
            for cb in cbs_before:  # callbacks marked before_iteration
                cb(CallbackEnv(model=booster, params=booster.params,
                               iteration=i, begin_iteration=0,
                               end_iteration=num_boost_round,
                               evaluation_result_list=[]))
            booster.update()
            results = []
            if booster._valid or eval_training or cbs:
                if eval_training:
                    results.extend(booster.eval_train(feval))
                results.extend(booster.eval_valid(feval))
            env = CallbackEnv(model=booster, params=p, iteration=i,
                              begin_iteration=0, end_iteration=num_boost_round,
                              evaluation_result_list=results)
            for cb in cbs_after:
                cb(env)
    except EarlyStopException as e:
        booster.best_iteration = e.best_iteration
        booster.best_score = _score_dict(e.best_score)
    else:
        if booster._valid:
            booster.best_iteration = -1
            booster.best_score = _score_dict(results)
    return booster


def _score_dict(results) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for item in results or []:
        out.setdefault(item[0], {})[item[1]] = item[2]
    return out


class CVBooster:
    """Container of the per-fold boosters (lightgbm.CVBooster parity)."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration: int = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


class CVResult(dict):
    """cv() result: the lightgbm-python history dict, plus the R binding's
    ``best_iter`` / ``best_score`` fields read by the reference sweep
    (r/gridsearchCV.R:116-117: ``as.list(cvm)[c("best_iter", "best_score")]``).

    ``best_score`` is sign-flipped so that **higher is better** (−MSE/−RMSE
    for regression), matching LightGBM R.ipynb:443 and the negative scores
    stored in paramGrid.RData.
    """

    best_iter: int = -1
    best_score: float = float("nan")
    best_iteration: int = -1
    cvbooster: Optional[CVBooster] = None


def _make_folds(n: int, nfold: int, labels: Optional[np.ndarray],
                stratified: bool, shuffle: bool, seed: int,
                group_sizes: Optional[np.ndarray] = None):
    """The reference's seeded folds (numpy streams, so both packages cut
    the same folds); with ``group_sizes`` whole queries go to one fold."""
    rng = np.random.default_rng(seed)
    if group_sizes is not None:
        num_groups = len(group_sizes)
        gidx = rng.permutation(num_groups) if shuffle else np.arange(num_groups)
        bounds = np.concatenate([[0], np.cumsum(group_sizes)])
        folds = []
        for k in range(nfold):
            test_idx = np.concatenate(
                [np.arange(bounds[g], bounds[g + 1]) for g in gidx[k::nfold]])
            mask = np.zeros(n, bool)
            mask[test_idx] = True
            folds.append((np.where(~mask)[0], np.where(mask)[0]))
        return folds
    if stratified and labels is not None:
        order = np.argsort(labels, kind="stable")
        if shuffle:
            # shuffle within small strata blocks to keep class balance
            blocks = [order[i:i + nfold] for i in range(0, n, nfold)]
            order = np.concatenate([rng.permutation(b) for b in blocks])
        assignment = np.empty(n, np.int64)
        assignment[order] = np.arange(n) % nfold
    else:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        assignment = np.empty(n, np.int64)
        assignment[idx] = np.arange(n) % nfold
    return [(np.where(assignment != k)[0], np.where(assignment == k)[0])
            for k in range(nfold)]


def cv(
    params: Dict[str, Any],
    train_set: Dataset,
    num_boost_round: int = 100,
    folds: Optional[Iterable] = None,
    nfold: int = 5,
    stratified: bool = True,
    shuffle: bool = True,
    metrics: Optional[Union[str, Sequence[str]]] = None,
    feval: Optional[Callable] = None,
    seed: int = 0,
    callbacks: Optional[List[Callable]] = None,
    eval_train_metric: bool = False,
    return_cvbooster: bool = False,
    # snippet-parity conveniences (R binding arguments)
    early_stopping_rounds: Optional[int] = None,
    verbose_eval: Optional[Union[bool, int]] = None,
    show_stdv: bool = True,
) -> CVResult:
    """k-fold cross-validation trained in lockstep (``lgb.cv`` equivalent).

    Folds are **seeded** (LightGBM's R binding leaves them unseeded — the
    reference itself documents the resulting run-to-run drift, SURVEY.md §4
    item 2 — so we improve on it; pass a different ``seed`` to resample).
    """
    p = parse_params(params)
    num_boost_round = _resolve_num_rounds(params, num_boost_round)
    if early_stopping_rounds is not None:
        p.early_stopping_round = int(early_stopping_rounds)
    if metrics is not None:
        p = parse_params({"metric": metrics}, base=p)

    train_set.construct()
    n = train_set.num_data()
    labels = train_set.get_label()
    use_strat = stratified and p.objective in ("binary", "multiclass",
                                               "multiclassova")
    if folds is not None:
        if hasattr(folds, "split"):
            folds = list(folds.split(np.zeros(n), labels))
        else:
            folds = list(folds)
    else:
        folds = _make_folds(n, nfold, labels, use_strat, shuffle,
                            seed if seed else p.seed, train_set.get_group())

    # the fused route: every fold in one device loop, early stopping on the
    # device (the reference's engine.cv, same eligibility and assembly)
    from .models.fused import fused_cv_eligible, run_fused_cv_batch

    if (fused_cv_eligible(p, feval, callbacks, train_set)
            and not return_cvbooster and not eval_train_metric
            and verbose_eval in (None, False)):
        fold_masks = np.zeros((len(folds), n), dtype=bool)
        for k, (tr_idx, _) in enumerate(folds):
            fold_masks[k, np.asarray(tr_idx)] = True
        history, best_iters, best_raw, rounds_run, metric_name = \
            run_fused_cv_batch(train_set, [p], fold_masks, num_boost_round,
                               p.early_stopping_round,
                               seed if seed else p.seed)
        result = CVResult()
        hib = get_metric(metric_name, p).higher_better
        best_iter = int(best_iters[0])
        per_round = history[:, 0, :]                     # [T, K]
        upto = best_iter if p.early_stopping_round > 0 else rounds_run
        means = np.nanmean(per_round[:upto], axis=1)
        stdvs = np.nanstd(per_round[:upto], axis=1, ddof=1) \
            if per_round.shape[1] > 1 else np.zeros(upto)
        result[f"valid {metric_name}-mean"] = means.tolist()
        result[f"valid {metric_name}-stdv"] = stdvs.tolist()
        result.best_iter = best_iter
        result.best_iteration = best_iter
        raw = float(best_raw[0])
        result.best_score = raw if hib else -raw
        return result

    gs_all = train_set.get_group()
    qid = (np.repeat(np.arange(len(gs_all)), gs_all)
           if gs_all is not None else None)

    def _subset_groups(idx):
        """Group sizes of a whole-query row subset (runs of equal query id;
        group-aware folds keep queries contiguous)."""
        q = qid[np.asarray(idx)]
        edges = np.flatnonzero(np.concatenate([[True], q[1:] != q[:-1],
                                               [True]]))
        return np.diff(edges)

    cvb = CVBooster()
    for train_idx, test_idx in folds:
        dtr = train_set.subset(train_idx)
        dva = train_set.subset(test_idx)
        if qid is not None:
            dtr.set_group(_subset_groups(train_idx))
            dva.set_group(_subset_groups(test_idx))
        b = Booster(p.copy(), dtr)
        b.add_valid(dva, "valid")
        cvb.append(b)

    metric_names = [m for m in p.metric if m != "none"]
    if not metric_names:
        d = default_metric_for_objective(p.objective)
        metric_names = [d] if d != "none" else []

    cbs: List[Callable] = list(callbacks or [])
    if p.early_stopping_round > 0 and not any(
            getattr(c, "order", None) == 30 for c in cbs):
        cbs.append(early_stopping(p.early_stopping_round,
                                  first_metric_only=p.first_metric_only,
                                  verbose=p.verbosity > 0,
                                  min_delta=p.early_stopping_min_delta))
    if verbose_eval not in (None, False) and not any(
            getattr(c, "order", None) == 10
            and not getattr(c, "before_iteration", False) for c in cbs):
        period = 1 if verbose_eval is True else int(verbose_eval)
        cbs.append(log_evaluation(period, show_stdv=show_stdv))
    cbs.sort(key=lambda c: getattr(c, "order", 50))

    result = CVResult()
    history: Dict[str, List[float]] = {}
    agg_history: List[List] = []

    cv_before = [c for c in cbs if getattr(c, "before_iteration", False)]
    cbs = [c for c in cbs if not getattr(c, "before_iteration", False)]

    try:
        for i in range(num_boost_round):
            for b in cvb.boosters:
                for cb in cv_before:  # before_iteration callbacks, per fold
                    cb(CallbackEnv(model=b, params=b.params, iteration=i,
                                   begin_iteration=0,
                                   end_iteration=num_boost_round,
                                   evaluation_result_list=[]))
                b.update()
            # aggregate fold metrics
            per_metric: Dict[tuple, List[float]] = {}
            for b in cvb.boosters:
                rs = (b.eval_train(feval) if eval_train_metric else [])
                rs += b.eval_valid(feval)
                for name, metric, val, hib in rs:
                    per_metric.setdefault((name, metric, hib), []).append(val)
            agg = []
            for (name, metric, hib), vals in per_metric.items():
                mean = float(np.mean(vals))
                stdv = float(np.std(vals, ddof=1)) if len(vals) > 1 else 0.0
                agg.append((name, metric, mean, hib, stdv))
                history.setdefault(f"{name} {metric}-mean", []).append(mean)
                history.setdefault(f"{name} {metric}-stdv", []).append(stdv)
            agg_history.append(agg)
            env = CallbackEnv(model=cvb, params=p, iteration=i,
                              begin_iteration=0, end_iteration=num_boost_round,
                              evaluation_result_list=agg)
            for cb in cbs:
                cb(env)
    except EarlyStopException as e:
        result.best_iteration = e.best_iteration
        for k in history:
            history[k] = history[k][: e.best_iteration]

    result.update(history)
    # R-binding fields: best_iter + sign-flipped best_score on first metric
    valid_keys = [k for k in history if k.startswith("valid ") and
                  k.endswith("-mean")]
    if valid_keys and metric_names:
        key = f"valid {metric_names[0]}-mean"
        if key not in history:
            key = valid_keys[0]
        series = history[key]
        hib = get_metric(metric_names[0], p).higher_better
        if series:
            best_idx = int(np.argmax(series) if hib else np.argmin(series))
            result.best_iter = best_idx + 1
            raw = series[best_idx]
            result.best_score = raw if hib else -raw
            if result.best_iteration <= 0:
                result.best_iteration = result.best_iter
    cvb.best_iteration = result.best_iteration
    if return_cvbooster:
        result.cvbooster = cvb
        result["cvbooster"] = cvb
    return result
