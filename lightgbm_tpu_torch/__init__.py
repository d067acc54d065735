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
  ``task=sweep``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``::

    import lightgbm_tpu_torch as lgb
    dtrain = lgb.Dataset(X, label=y)              # device="cuda"
    booster = lgb.train({"objective": "binary"}, dtrain, 100)
"""

from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       log_evaluation, record_evaluation)
from .dataset import Dataset
from .device import NoDeviceError
from .engine import CVBooster, CVResult, cv, train
from .models.gbdt import Booster
from .sweep import SweepLedger, SweepService, expand_grid, run_grid_search
from .training import train_resumable

__version__ = "0.3.0"

__all__ = [
    "Booster", "CVBooster", "CVResult", "CallbackEnv", "Dataset",
    "EarlyStopException", "NoDeviceError", "SweepLedger", "SweepService",
    "cv", "early_stopping", "expand_grid", "log_evaluation",
    "record_evaluation", "run_grid_search", "train", "train_resumable",
]
