"""Fault-tolerant training — the port of ``lightgbm_tpu/training``.

Deterministic checkpoint/resume (:mod:`.checkpoint`) and the
preemption-safe resumable loop (:mod:`.loop`): a run killed at any round
(SIGTERM or injected fault) resumes bit-identical to the uninterrupted run,
and checkpoints interchange with the reference package's.
"""

from .checkpoint import (
    CKPT_FORMAT_VERSION,
    CheckpointError,
    CorruptCheckpointError,
    IncompatibleCheckpointError,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
    load_latest,
    resume_booster,
    save_checkpoint,
)
from .loop import PreemptionGuard, TrainResult, train_resumable

__all__ = [
    "CKPT_FORMAT_VERSION",
    "CheckpointError",
    "CorruptCheckpointError",
    "IncompatibleCheckpointError",
    "PreemptionGuard",
    "TrainResult",
    "latest_checkpoint",
    "list_checkpoints",
    "load_checkpoint",
    "load_latest",
    "resume_booster",
    "save_checkpoint",
    "train_resumable",
]
