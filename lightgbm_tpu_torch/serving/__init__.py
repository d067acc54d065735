"""lightgbm_tpu_torch.serving — batch inference on CUDA devices.

The port of ``lightgbm_tpu.serving``:

    from lightgbm_tpu_torch.serving import PackedForest, PredictorRuntime

    packed = PackedForest.load("model.npz")   # written by either package
    rt = PredictorRuntime(packed)             # device="cuda" by default
    preds = rt.predict(X)                     # bucketed, one kernel/class

    bank = ModelBank(warm_on_deploy=True)
    bank.deploy("fraud", "model_v1.npz")      # validate -> warm -> canary -> flip
    mb = bank.batcher("fraud", max_queue_depth=512)   # sheds with Overloaded
    bank.rollback("fraud")

See packed.py (format + ingest validation), runtime.py (bucket ladder and
the kernel path), queue.py (micro-batching + admission control), bank.py
(tenancy/hot swap/rollback), faults.py (deterministic fault injection),
stats.py (counters).  The CLI front end is ``python -m lightgbm_tpu_torch
task=serve input_model=...``; ``pack_booster`` freezes a trained Booster
into a PackedForest.  ``mesh_devices``/``shard_policy`` shard the
dispatches over a serving mesh (mesh.py: dp row sharding, tp tree sharding,
the ``choose_route`` chooser).
"""

from ..ops.quantize import FOREST_PRECISIONS, ThresholdBoundError
from .bank import ModelBank, SwapRejected
from .faults import SITES as FAULT_SITES
from .faults import FaultError, FaultInjector, FaultSpec
from .mesh import SHARD_POLICIES, ServingMesh, choose_route
from .packed import (PACKED_FORMAT_VERSION, PackedForest, PackedForestError,
                     pack_booster, packed_from_arrays)
from .queue import (SHED_POLICIES, MicroBatcher, Overloaded,
                    PendingPrediction, RequestTimeout)
from .runtime import PredictorRuntime, bucket_for, enable_persistent_cache
from .stats import ServingStats

__all__ = [
    "FAULT_SITES",
    "FOREST_PRECISIONS",
    "FaultError",
    "FaultInjector",
    "FaultSpec",
    "MicroBatcher",
    "ModelBank",
    "Overloaded",
    "PACKED_FORMAT_VERSION",
    "PackedForest",
    "PackedForestError",
    "PendingPrediction",
    "PredictorRuntime",
    "RequestTimeout",
    "SHARD_POLICIES",
    "SHED_POLICIES",
    "ServingMesh",
    "ServingStats",
    "SwapRejected",
    "ThresholdBoundError",
    "bucket_for",
    "choose_route",
    "enable_persistent_cache",
    "pack_booster",
    "packed_from_arrays",
]
