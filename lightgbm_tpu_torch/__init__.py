"""lightgbm_tpu_torch — the PyTorch + CUDA port of ``lightgbm_tpu``.

The port grows slice by slice beside the JAX package, which stays the
reference it is held against; it imports torch and numpy, never jax and
nothing of ``lightgbm_tpu``.  Ported so far: the serving path —
``serving`` (PackedForest, PredictorRuntime, MicroBatcher, ModelBank), edge
binning (``dataset.BinMapper``), forest quantization (``ops.quantize``) and
forest prediction (``ops.predict``) with its hand-written Hopper kernel
(``csrc/predict_forest.cu``), and the CLI's ``task=serve``
(``python -m lightgbm_tpu_torch``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
