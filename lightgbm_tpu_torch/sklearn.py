"""scikit-learn style estimators — the port of ``lightgbm_tpu/sklearn.py``.

``LGBMModel``, ``LGBMRegressor``, ``LGBMClassifier`` (binary and multiclass,
``predict_proba``), ``LGBMRanker`` (``fit(group=, eval_group=, eval_at=)``)
and ``LGBMRandomForestRegressor``, the bagging side of
examples/bagging_boosting.py (``RandomForestRegressor(n_estimators,
max_leaf_nodes, max_features, random_state)``): ``boosting="rf"`` with
sklearn's ``max_features`` as ``feature_fraction_bynode``.  The estimators
follow the reference's parameters and resolve them to the same params, so
the same data and seed give the same models.  Like every entry point of the
port they run on ``cuda`` unless ``device="cpu"`` is given; the device goes
to the training ``Dataset``.  The module imports neither scikit-learn nor
anything else beyond numpy and the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from .dataset import Dataset
from .engine import train as _train
from .models.gbdt import Booster


class LGBMModel:
    """Base sklearn-style estimator."""

    _objective_default = "regression"

    def __init__(
        self,
        boosting_type: str = "gbdt",
        num_leaves: int = 31,
        max_depth: int = -1,
        learning_rate: float = 0.1,
        n_estimators: int = 100,
        subsample_for_bin: int = 200000,
        objective: Optional[str] = None,
        class_weight: Optional[Union[Dict, str]] = None,
        min_split_gain: float = 0.0,
        min_child_weight: float = 1e-3,
        min_child_samples: int = 20,
        subsample: float = 1.0,
        subsample_freq: int = 0,
        colsample_bytree: float = 1.0,
        reg_alpha: float = 0.0,
        reg_lambda: float = 0.0,
        random_state: Optional[int] = None,
        n_jobs: int = -1,
        importance_type: str = "split",
        device: Optional[str] = None,
        **kwargs: Any,
    ):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self.device = device
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self.best_iteration_: int = -1
        self.best_score_: Dict = {}

    # -- sklearn plumbing -------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        out = {
            k: getattr(self, k)
            for k in ("boosting_type", "num_leaves", "max_depth",
                      "learning_rate", "n_estimators", "subsample_for_bin",
                      "objective", "class_weight", "min_split_gain",
                      "min_child_weight", "min_child_samples", "subsample",
                      "subsample_freq", "colsample_bytree", "reg_alpha",
                      "reg_lambda", "random_state", "n_jobs",
                      "importance_type", "device")
        }
        out.update(self._other_params)
        return out

    def set_params(self, **params: Any) -> "LGBMModel":
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            else:
                self._other_params[k] = v
        return self

    def _resolved_params(self) -> Dict[str, Any]:
        p = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "num_iterations": self.n_estimators,
            "objective": self.objective or self._objective_default,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbosity": 0,
        }
        if self.random_state is not None:
            p["seed"] = int(self.random_state)
        p.update(self._other_params)
        return p

    # -- training ----------------------------------------------------------
    def fit(
        self,
        X,
        y,
        sample_weight=None,
        init_score=None,
        group=None,
        eval_set=None,
        eval_names=None,
        eval_sample_weight=None,
        eval_group=None,
        eval_metric=None,
        early_stopping_rounds: Optional[int] = None,
        callbacks: Optional[List[Callable]] = None,
    ) -> "LGBMModel":
        """Train on ``X``, ``y``; ``group``/``eval_group`` are the query
        sizes of the training and eval sets (ranking)."""
        y_arr = np.asarray(y, dtype=np.float64).reshape(-1)
        y_fit = self._process_label(y_arr)  # may learn classes_ first
        params = self._resolved_params()
        if eval_metric is not None:
            params["metric"] = eval_metric
        sw = self._class_sample_weight(y_arr, sample_weight)
        dtrain = Dataset(X, label=y_fit, weight=sw, group=group,
                         init_score=init_score, params=params,
                         device=self.device)
        valid_sets, valid_names = [], []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (Xv, yv) in enumerate(eval_set):
                wv = (eval_sample_weight[i]
                      if eval_sample_weight is not None else None)
                gv = eval_group[i] if eval_group is not None else None
                yv_arr = self._encode_label(
                    np.asarray(yv, np.float64).reshape(-1))
                valid_sets.append(Dataset(Xv, label=yv_arr, weight=wv,
                                          group=gv, reference=dtrain))
                valid_names.append(
                    eval_names[i] if eval_names else f"valid_{i}")
        self._Booster = _train(
            params, dtrain, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=valid_names or None,
            callbacks=callbacks, early_stopping_rounds=early_stopping_rounds)
        self.best_iteration_ = self._Booster.best_iteration
        self.best_score_ = self._Booster.best_score
        self.n_features_ = dtrain.num_feature()
        self.n_features_in_ = self.n_features_
        self.feature_name_ = dtrain.feature_names
        return self

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        """Encode training labels (may learn label state, e.g. classes_)."""
        return y

    def _encode_label(self, y: np.ndarray) -> np.ndarray:
        """Encode eval-set labels with the state learned from training."""
        return y

    def _class_sample_weight(self, y, sample_weight):
        return sample_weight

    # -- inference ----------------------------------------------------------
    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None, **kwargs) -> np.ndarray:
        self._check_fitted()
        return self._Booster.predict(X, raw_score=raw_score,
                                     num_iteration=num_iteration, **kwargs)

    def _check_fitted(self):
        if self._Booster is None:
            raise ValueError("Estimator not fitted; call fit first")

    # -- attributes ----------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def n_estimators_(self) -> int:
        self._check_fitted()
        return self._Booster.num_trees()


class LGBMRegressor(LGBMModel):
    _objective_default = "regression"

    def score(self, X, y, sample_weight=None) -> float:
        """sklearn's R^2."""
        y = np.asarray(y, np.float64).reshape(-1)
        p = self.predict(X)
        u = np.average((y - p) ** 2, weights=sample_weight)
        v = np.average((y - np.average(y, weights=sample_weight)) ** 2,
                       weights=sample_weight)
        return 1.0 - u / v


class LGBMClassifier(LGBMModel):
    _objective_default = "binary"

    def _process_label(self, y: np.ndarray) -> np.ndarray:
        self.classes_, y_enc = np.unique(y, return_inverse=True)
        self.n_classes_ = len(self.classes_)
        return y_enc.astype(np.float64)

    def _resolved_params(self) -> Dict[str, Any]:
        p = super()._resolved_params()
        if getattr(self, "n_classes_", 2) > 2:
            if self.objective is None:
                p["objective"] = "multiclass"
            p["num_class"] = self.n_classes_
        return p

    def _encode_label(self, y: np.ndarray) -> np.ndarray:
        # eval labels use the training class mapping (never re-learn it)
        idx = np.searchsorted(self.classes_, y)
        idx = np.clip(idx, 0, len(self.classes_) - 1)
        if not np.array_equal(self.classes_[idx], y):
            raise ValueError("eval_set contains labels unseen in training")
        return idx.astype(np.float64)

    def _class_sample_weight(self, y, sample_weight):
        if self.class_weight is None:
            return sample_weight
        classes, y_enc = np.unique(y, return_inverse=True)
        if self.class_weight == "balanced":
            counts = np.bincount(y_enc)
            cw = len(y) / (len(classes) * counts)
        else:
            cw = np.array([self.class_weight.get(c, 1.0) for c in classes])
        w = cw[y_enc]
        if sample_weight is not None:
            w = w * np.asarray(sample_weight, np.float64)
        return w

    def predict(self, X, raw_score: bool = False,
                num_iteration: Optional[int] = None, **kwargs) -> np.ndarray:
        proba = self.predict_proba(X, raw_score=raw_score,
                                   num_iteration=num_iteration, **kwargs)
        if raw_score or kwargs.get("pred_contrib") or \
                kwargs.get("pred_leaf"):
            return proba
        return self.classes_[np.argmax(proba, axis=1)]

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: Optional[int] = None,
                      **kwargs) -> np.ndarray:
        self._check_fitted()
        p = self._Booster.predict(X, raw_score=raw_score,
                                  num_iteration=num_iteration, **kwargs)
        if raw_score or kwargs.get("pred_contrib") or \
                kwargs.get("pred_leaf"):
            return p  # contributions / leaf ids pass through unchanged
        if p.ndim == 2:  # multiclass softmax probabilities
            return p
        return np.column_stack([1.0 - p, p])

    def score(self, X, y, sample_weight=None) -> float:
        y = np.asarray(y).reshape(-1)
        return float(np.average(self.predict(X) == y, weights=sample_weight))


class LGBMRanker(LGBMModel):
    """Ranking estimator: ``lambdarank`` over the query groups of
    ``fit(group=)``; ``predict`` returns raw scores to order each query
    by."""

    _objective_default = "lambdarank"

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_group=None, eval_metric=None,
            eval_at: Optional[Sequence[int]] = None,
            early_stopping_rounds: Optional[int] = None,
            callbacks: Optional[List[Callable]] = None) -> "LGBMRanker":
        """:meth:`LGBMModel.fit` with the ranking metrics' cut-offs
        ``eval_at`` (None keeps the params' ``eval_at``, 1 to 5 by
        default); ``eval_group`` holds one group array per ``eval_set``
        entry."""
        self._eval_at = None if eval_at is None else [int(k) for k in eval_at]
        return super().fit(
            X, y, sample_weight=sample_weight, init_score=init_score,
            group=group, eval_set=eval_set, eval_names=eval_names,
            eval_sample_weight=eval_sample_weight, eval_group=eval_group,
            eval_metric=eval_metric,
            early_stopping_rounds=early_stopping_rounds, callbacks=callbacks)

    def _resolved_params(self) -> Dict[str, Any]:
        p = super()._resolved_params()
        if getattr(self, "_eval_at", None) is not None:
            p["eval_at"] = list(self._eval_at)
        return p


class LGBMRandomForestRegressor(LGBMRegressor):
    """sklearn ``RandomForestRegressor``-shaped wrapper over rf boosting
    (``n_estimators``, ``max_leaf_nodes``, ``max_features``,
    ``random_state`` as examples/bagging_boosting.py passes them)."""

    def __init__(self, n_estimators: int = 100,
                 max_leaf_nodes: Optional[int] = None,
                 max_features: Union[float, int, str, None] = 1.0,
                 max_depth: Optional[int] = None,
                 min_samples_leaf: int = 1,
                 random_state: Optional[int] = None, **kwargs):
        num_leaves = max_leaf_nodes if max_leaf_nodes else 131072 // 2
        if max_depth is None:
            max_depth = -1
        super().__init__(
            boosting_type="rf",
            n_estimators=n_estimators,
            num_leaves=min(num_leaves, 4096),
            max_depth=max_depth,
            min_child_samples=min_samples_leaf,
            subsample=0.632,        # bootstrap-sized bag, no replacement
            subsample_freq=1,
            random_state=random_state,
            **kwargs,
        )
        self.max_features = max_features

    def _mtry_fraction(self, num_features: int) -> float:
        """sklearn's ``max_features``: an int is a count, a float a
        fraction, ``"sqrt"``/``"log2"`` the usual heuristics (so
        ``max_features=1`` means one feature, not all of them)."""
        mf = self.max_features
        if mf is None or mf == "auto":
            return 1.0
        if mf == "sqrt":
            return max(1, int(np.sqrt(num_features))) / num_features
        if mf == "log2":
            return max(1, int(np.log2(max(num_features, 2)))) / num_features
        if isinstance(mf, (int, np.integer)) and not isinstance(mf, bool):
            return min(1.0, mf / num_features)
        return float(mf)

    def fit(self, X, y, **kwargs):
        arr = np.asarray(X)
        num_features = arr.shape[1] if arr.ndim == 2 else 1
        self._other_params["feature_fraction_bynode"] = \
            self._mtry_fraction(num_features)
        return super().fit(X, y, **kwargs)
