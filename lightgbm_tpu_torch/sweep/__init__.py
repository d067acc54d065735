"""Grid search as a resumable service — the port of ``lightgbm_tpu/sweep``.

* :class:`~.scheduler.SweepScheduler` packs a config grid into fused-CV
  hyper-batches, bucketed by what shapes the fused program, and assigns
  them to device groups;
* :class:`~.service.SweepService` runs the plan hyper-batch by
  hyper-batch, with fault-injection hooks, a SIGTERM latch between segments
  (``training.loop.PreemptionGuard``) and per-hyper-batch carry
  checkpoints;
* :class:`~.ledger.SweepLedger` is the crash-safe resumable result ledger
  (``.RData`` or JSON).

``lightgbm_tpu_torch.utils.sweep`` re-exports ``expand_grid`` /
``SweepLedger`` / ``run_grid_search``.
"""

from .ledger import RESULT_COLUMNS, SENTINEL, SweepLedger, expand_grid
from .scheduler import SweepPlan, SweepScheduler, SweepUnit, fused_bucket_key
from ..training.loop import PreemptionGuard
from .service import SweepResult, SweepService, run_grid_search

__all__ = [
    "RESULT_COLUMNS", "SENTINEL", "SweepLedger", "expand_grid",
    "SweepPlan", "SweepScheduler", "SweepUnit", "fused_bucket_key",
    "PreemptionGuard", "SweepResult", "SweepService", "run_grid_search",
]
