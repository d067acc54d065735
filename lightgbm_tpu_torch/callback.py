"""Training callbacks — the port of ``lightgbm_tpu/callback.py``.

The reference's call sites exercise early stopping with
``early_stopping_rounds=5`` in every ``lgb.cv`` call (r/gridsearchCV.R).
Pure Python, the same code as the reference's: early stopping, evaluation
logging and recording, and the ``reset_parameter`` schedule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple


@dataclass
class CallbackEnv:
    model: Any                       # Booster or CVBooster
    params: Any
    iteration: int
    begin_iteration: int
    end_iteration: int
    # list of (dataset_name, metric_name, value, higher_better)
    # cv aggregates carry (name, metric, mean, higher_better, stdv)
    evaluation_result_list: List[Tuple]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Print evaluation results every ``period`` rounds."""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            parts = []
            for item in env.evaluation_result_list:
                if len(item) == 5 and show_stdv:
                    name, metric, mean, _, stdv = item
                    parts.append(f"{name}'s {metric}: {mean:g} + {stdv:g}")
                else:
                    name, metric, val = item[0], item[1], item[2]
                    parts.append(f"{name}'s {metric}: {val:g}")
            print(f"[{env.iteration + 1}]\t" + "\t".join(parts))

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    """Record evaluation history into the supplied dict (lightgbm parity)."""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result must be a dict")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for item in env.evaluation_result_list:
            eval_result.setdefault(item[0], {}).setdefault(item[1], [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for item in env.evaluation_result_list:
            eval_result.setdefault(item[0], {}).setdefault(item[1], []).append(
                item[2])

    _callback.order = 20
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """Stop training when no monitored metric improves for
    ``stopping_rounds`` consecutive rounds (LightGBM early_stopping callback:
    training continues while *any* tracked metric keeps improving).
    """
    best_score: List[float] = []
    best_iter: List[int] = []
    best_results: List[List[Tuple]] = []
    cmp_higher: List[bool] = []
    first_metric: List[str] = [""]
    enabled = [True]

    def _is_train_set(name: str, env: CallbackEnv) -> bool:
        return name == "training"

    def _init(env: CallbackEnv) -> None:
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            return
        first_metric[0] = env.evaluation_result_list[0][1]
        for item in env.evaluation_result_list:
            best_score.append(float("-inf") if item[3] else float("inf"))
            best_iter.append(0)
            best_results.append([])
            cmp_higher.append(bool(item[3]))

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        stop_candidates = []
        for i, item in enumerate(env.evaluation_result_list):
            name, metric, score = item[0], item[1], item[2]
            higher = cmp_higher[i]
            improved = (score > best_score[i] + min_delta if higher
                        else score < best_score[i] - min_delta)
            if improved:
                best_score[i] = score
                best_iter[i] = env.iteration
                best_results[i] = list(env.evaluation_result_list)
            if first_metric_only and metric != first_metric[0]:
                continue
            if _is_train_set(name, env):
                continue
            stop_candidates.append(i)
        if stop_candidates and all(
                env.iteration - best_iter[i] >= stopping_rounds
                for i in stop_candidates):
            i = stop_candidates[0]
            if verbose:
                print(f"Early stopping, best iteration is:\n"
                      f"[{best_iter[i] + 1}]\t"
                      + "\t".join(f"{it[0]}'s {it[1]}: {it[2]:g}"
                                  for it in best_results[i]))
            raise EarlyStopException(best_iter[i] + 1, best_results[i])
        if env.iteration == env.end_iteration - 1 and stop_candidates:
            i = stop_candidates[0]
            raise EarlyStopException(best_iter[i] + 1, best_results[i])

    _callback.order = 30
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Per-iteration parameter schedule (LightGBM ``reset_parameter``):
    each keyword is a list of length ``num_boost_round`` or a
    ``callable(iteration) -> value``.  It runs before each round, so round
    ``i`` trains with the scheduled values (``Booster.reset_parameter``);
    a shape-static parameter (num_leaves, max_bin, objective) raises."""

    def _callback(env: CallbackEnv) -> None:
        new = {}
        for key, spec in kwargs.items():
            value = (spec(env.iteration - env.begin_iteration)
                     if callable(spec) else spec[env.iteration
                                                - env.begin_iteration])
            new[key] = value
        env.model.reset_parameter(new)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback
