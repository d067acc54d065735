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
  ``csrc/hist_partition.cu``.

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

__version__ = "0.2.0"

__all__ = [
    "Booster", "CVBooster", "CVResult", "CallbackEnv", "Dataset",
    "EarlyStopException", "NoDeviceError", "cv", "early_stopping",
    "log_evaluation", "record_evaluation", "train",
]
