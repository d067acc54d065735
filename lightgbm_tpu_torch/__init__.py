"""lightgbm_tpu_torch — the PyTorch + CUDA port of ``lightgbm_tpu``.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against; it imports torch and numpy, never jax and
nothing of ``lightgbm_tpu``.  Ported so far:

* serving — ``serving`` (PackedForest, PredictorRuntime, MicroBatcher,
  ModelBank), forest quantization (``ops.quantize``) and forest prediction
  (``ops.predict``) with its hand-written Hopper kernel
  (``csrc/predict_forest.cu``), and the CLI's ``task=serve``;
* single-device training — ``Dataset``, ``train``, ``cv`` and ``Booster``
  (objectives ``regression`` and ``binary``) on the default wave grower,
  with the hand-written Hopper histogram kernels ``csrc/hist_fused.cu`` and
  ``csrc/hist_partition.cu``, and on the strict best-first grower with the
  split-iteration kernel ``csrc/split_iter.cu``;
* ``cv`` on the reference's fused route (every fold of a call in one device
  loop, ``models/fused.py``) and the grid sweep (``sweep``,
  ``utils.sweep.run_grid_search``), with the batched histogram kernel
  ``csrc/hist_segstats.cu``;
* recovery — ``training`` (versioned, checksummed checkpoints that
  interchange with the reference's, ``train_resumable`` with its SIGTERM
  drain), the sweep's per-hyper-batch carry checkpoints, ``.RData`` sweep
  ledgers (``utils.rdata``) and the CLI's ``task=train checkpoint_dir=`` and
  ``task=sweep``;
* the bagging/boosting workflow — ``boosting="rf"``, per-node column
  sampling (``feature_fraction_bynode``), staged ``predict(ntree_limit=)``
  and the scikit-learn style estimators (``sklearn``: ``LGBMRegressor``,
  ``LGBMClassifier``, ``LGBMRandomForestRegressor``), loaded lazily as in
  the reference, like ``serving``;
* the remaining objectives (l1/quantile/mape leaf renewal, huber, fair,
  poisson, gamma, tweedie, cross_entropy, a custom ``fobj``), GOSS and DART,
  categorical features, and ranking: ``Dataset(group=)``,
  ``objective="lambdarank"`` (``ranking``), ``metric="ndcg"``/``"map"`` at
  ``eval_at``, whole-query ``cv`` folds and ``LGBMRanker``;
* constraints and randomized splits (``monotone_constraints``,
  ``interaction_constraints``, ``extra_trees``), linear leaves
  (``linear_tree``) and introspection: ``predict(pred_leaf=True)``,
  TreeSHAP ``predict(pred_contrib=True)`` (``ops.shap``), ``dump_model``,
  ``trees_to_dataframe`` and the plotting helpers (``plotting``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``::

    import lightgbm_tpu_torch as lgb
    dtrain = lgb.Dataset(X, label=y)              # device="cuda"
    booster = lgb.train({"objective": "binary"}, dtrain, 100)
"""

from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation, reset_parameter)
from .config import Params, parse_params
from .dataset import BinMapper, Dataset
from .device import NoDeviceError
from .engine import CVBooster, CVResult, cv, train
from .models.gbdt import Booster
from .models.tree import Tree
from .sweep import SweepLedger, SweepService, expand_grid, run_grid_search
from .training import train_resumable

__version__ = "0.3.0"

__all__ = [
    "BinMapper", "Booster", "CVBooster", "CVResult", "CallbackEnv",
    "Dataset", "EarlyStopException", "NoDeviceError", "Params",
    "SweepLedger", "SweepService", "Tree", "cv", "early_stopping",
    "expand_grid", "log_evaluation", "parse_params", "record_evaluation",
    "reset_parameter", "run_grid_search", "train", "train_resumable",
]

_SERVING = ("PackedForest", "PredictorRuntime", "MicroBatcher",
            "pack_booster")
_SKLEARN = ("LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
            "LGBMRandomForestRegressor")
_PLOTTING = ("plot_importance", "plot_metric", "create_tree_digraph",
             "plot_split_value_histogram")


def __getattr__(name):
    # the estimators, the serving runtime and the plotting helpers load on
    # first use (matplotlib only when a plot is drawn), as in the reference
    import importlib

    if name in ("serving", "sklearn", "faults", "plotting"):
        return importlib.import_module(f".{name}", __name__)
    if name in _SERVING:
        return getattr(importlib.import_module(".serving", __name__), name)
    if name in _SKLEARN:
        return getattr(importlib.import_module(".sklearn", __name__), name)
    if name in _PLOTTING:
        return getattr(importlib.import_module(".plotting", __name__), name)
    raise AttributeError(
        f"module 'lightgbm_tpu_torch' has no attribute '{name}'")
