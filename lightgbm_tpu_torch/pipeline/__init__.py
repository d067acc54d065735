"""Continuous model-freshness pipeline — the port of
``lightgbm_tpu/pipeline``.

Glues the training stack (streamed Datasets, resumable continuation) to
the serving stack (ModelBank canary + atomic flip) as one crash-anywhere
refresh loop, with model staleness — seconds from data arrival to
serving — as the measured SLO.
"""

from .daemon import (Arrival, ArrivalFeed, DirectoryFeed, RefreshDaemon,
                     latest_artifact)
from .staleness import (STAGES, RefreshRecord, SimClock, StalenessTracker,
                        wall_clock)

__all__ = [
    "Arrival", "ArrivalFeed", "DirectoryFeed", "RefreshDaemon",
    "latest_artifact", "STAGES", "RefreshRecord", "SimClock",
    "StalenessTracker", "wall_clock",
]
