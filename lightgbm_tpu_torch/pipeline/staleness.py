"""Model-staleness accounting for the refresh pipeline — the port of
``lightgbm_tpu/pipeline/staleness.py``.

**Model staleness** is the production freshness metric: seconds from a
row block ARRIVING to a model trained on it SERVING traffic.  No single
subsystem can measure it — the training loop knows when rounds ran, the
ModelBank knows when the flip landed, and neither knows when the data
arrived — so the tracker owns the timeline: the
:class:`RefreshDaemon` stamps every stage boundary of every generation
into one :class:`RefreshRecord` and the decomposition falls out as plain
differences on the daemon's (injectable, sim-friendly) clock.

Stage timeline per generation (the ``sweep_start``/``swept`` pair only
appears on retune generations — a sweep runs between data arrival
and the winner's training)::

    data_arrival [-> sweep_start -> swept] -> train_start -> trained
                 -> artifact_saved -> canaried -> serving

    staleness   = serving - data_arrival          (the SLO quantity)
    wait        = train_start - data_arrival      (daemon tick latency)
    tune        = swept - sweep_start             (grid sweep, retunes)
    train       = trained - train_start           (N continuation rounds)
    publish     = artifact_saved - trained        (pack + atomic write)
    deploy      = canaried - artifact_saved       (ingest + warm + canary)
    flip        = serving - canaried              (atomic swap + health)

The reference bounds the SLO offline with analytic freshness budgets
(train + warm + canary <= SLO at its shape) whose constants are a TPU's;
the port has no such model yet (ROADMAP item 17), so this module is the
measured side alone.  On the card the daemon stamps each boundary after
the stage's device work is done, so a leg holds its own kernels.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

STAGES = ("data_arrival", "sweep_start", "swept", "train_start",
          "trained", "artifact_saved", "canaried", "serving")

# terminal generation states the daemon records
_STATUSES = ("pending", "training", "preempted", "rejected",
             "rolled_back", "serving")


@dataclass
class RefreshRecord:
    """One generation's stage timeline + outcome."""

    generation: int
    attempts: int = 0
    status: str = "pending"
    rounds: int = 0
    version: Optional[str] = None
    error: Optional[str] = None
    stamps: Dict[str, float] = field(default_factory=dict)

    def stamp(self, stage: str, t: float) -> None:
        if stage not in STAGES:
            raise ValueError(f"unknown stage {stage!r}; expected one of "
                             f"{STAGES}")
        self.stamps[stage] = float(t)

    def staleness_s(self) -> Optional[float]:
        """serving - data_arrival, or None until the flip lands."""
        if "serving" not in self.stamps or "data_arrival" not in self.stamps:
            return None
        return self.stamps["serving"] - self.stamps["data_arrival"]

    def decomposition(self) -> Dict[str, float]:
        """Per-stage durations (seconds) for the stamps present."""
        out: Dict[str, float] = {}
        pairs = (("wait", "data_arrival", "train_start"),
                 ("tune", "sweep_start", "swept"),
                 ("train", "train_start", "trained"),
                 ("publish", "trained", "artifact_saved"),
                 ("deploy", "artifact_saved", "canaried"),
                 ("flip", "canaried", "serving"))
        for name, a, b in pairs:
            if a in self.stamps and b in self.stamps:
                out[name] = self.stamps[b] - self.stamps[a]
        s = self.staleness_s()
        if s is not None:
            out["staleness"] = s
        return out

    def as_dict(self) -> dict:
        return {"generation": self.generation, "attempts": self.attempts,
                "status": self.status, "rounds": self.rounds,
                "version": self.version, "error": self.error,
                "stamps": dict(self.stamps),
                "decomposition": self.decomposition(),
                "staleness_ms": (None if self.staleness_s() is None
                                 else self.staleness_s() * 1e3)}


class StalenessTracker:
    """Per-generation stage timestamps + SLO bookkeeping.

    The tracker never reads a clock itself — the daemon stamps explicit
    times from ITS clock, so a sim-clock run yields a fully
    deterministic staleness decomposition.
    """

    def __init__(self, slo_ms: Optional[float] = None):
        self.slo_ms = None if slo_ms is None else float(slo_ms)
        self.records: Dict[int, RefreshRecord] = {}

    def begin(self, generation: int) -> RefreshRecord:
        """Open (or re-open, on a retry) a generation's record."""
        rec = self.records.get(generation)
        if rec is None:
            rec = RefreshRecord(generation=generation)
            self.records[generation] = rec
        rec.attempts += 1
        return rec

    def record(self, generation: int) -> RefreshRecord:
        return self.records[generation]

    def stamp(self, generation: int, stage: str, t: float) -> None:
        self.records[generation].stamp(stage, t)

    def staleness_ms(self, generation: int) -> Optional[float]:
        s = self.records[generation].staleness_s()
        return None if s is None else s * 1e3

    def served(self) -> List[RefreshRecord]:
        return [r for r in self.records.values() if r.status == "serving"]

    def worst_staleness_ms(self) -> Optional[float]:
        vals = [r.staleness_s() for r in self.served()
                if r.staleness_s() is not None]
        return max(vals) * 1e3 if vals else None

    def breaches(self) -> List[int]:
        """Generations whose measured staleness exceeded the SLO."""
        if self.slo_ms is None:
            return []
        return sorted(r.generation for r in self.served()
                      if r.staleness_s() is not None
                      and r.staleness_s() * 1e3 > self.slo_ms)

    def snapshot(self) -> dict:
        return {
            "slo_ms": self.slo_ms,
            "generations": [self.records[g].as_dict()
                            for g in sorted(self.records)],
            "served": len(self.served()),
            "worst_staleness_ms": self.worst_staleness_ms(),
            "breaches": self.breaches(),
        }


class SimClock:
    """Manual virtual clock for deterministic pipeline runs:
    ``clock()`` reads, ``advance`` moves time forward.  The daemon charges modeled stage costs into it
    so a refresh run is bit-reproducible — no wall-clock leaks into the
    staleness decomposition."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance time backwards ({dt})")
        self.now += float(dt)
        return self.now


def wall_clock() -> float:
    """Default daemon clock (real deployments) — the ONE sanctioned
    wall-clock boundary in the pipeline; everything downstream takes an
    injected ``clock=``."""
    return time.monotonic()  # graftlint: GL008 — the injection boundary
