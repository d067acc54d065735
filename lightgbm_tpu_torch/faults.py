"""Deterministic fault injection — the port's copy of ``lightgbm_tpu/faults.py``.

Armed fault specs fire on exact hit counts at named sites, never
on wall-clock or randomness, so resilience claims are reproducible.  The
site registry is the reference's whole :data:`SITES` tuple, so a spec
written for either package arms in both.  The serving slice consults:

* ``device_predict`` — raises :class:`FaultError` inside
  ``PredictorRuntime._dispatch`` before the device work is enqueued;
* ``artifact_load`` — raises inside ``ModelBank`` artifact ingest;
* ``compile`` — returns a stall duration (seconds) added to the measured
  warm time in ``ModelBank.deploy``;
* ``clock`` — :meth:`FaultInjector.wrap_clock` adds a skew offset to an
  injectable time source.

Training (``training/``) consults:

* ``checkpoint_write`` — raises inside ``training.checkpoint`` after the
  tmp file is written and before the atomic rename, modeling a failed
  write; the prior checkpoint stays intact and the run goes on;
* ``gradient`` — consulted once per round by ``train_resumable``; a firing
  poisons the round's input predictions with NaN so the finiteness screen
  (:class:`NonFiniteGradientError`) stops the run before a tree grows.

Out-of-core training (``data/block_store.py``) consults, on every block
read of a streamed pass:

* ``block_read`` — raises before the block's integrity screen, modeling a
  transient host read error;
* ``device_put`` — raises before the block's host-to-device copy, modeling
  a transient transfer error.

Both are absorbed by the store's bounded retry; one that persists past it
surfaces as ``OOCBlockError(kind="read")`` naming the block.

The sweep service consults ``sweep_segment`` (between fused segments and
host-engine configs), ``sweep_record`` (before a ledger commit) and, through
its carry checkpoints, ``checkpoint_write``.

The refresh daemon (``pipeline/daemon.py``) consults the pipeline sites and
``sweep_promote``:

* ``data_arrival`` — before each tick drains its feed (a poll outage; the
  arrivals are kept and the next tick takes them);
* ``continue_train`` — after every round of a generation's training (a
  preemption; the retry resumes from the generation's checkpoint);
* ``artifact_push`` — after the artifact is packed and before its rename
  (the bytes are poisoned with NaN leaves, so the bank's ingest must
  reject them while the prior version serves);
* ``flip`` — after the canary passed (a health alarm: the bank rolls back
  and the daemon re-anchors on what serves);
* ``sweep_promote`` — between a completed retune sweep and the winner's
  training (retried next tick; the finished ledger makes the rerun a
  no-op).

A ``FaultInjector`` with no armed specs is a cheap no-op, so the hooks stay
wired in production configurations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

SERVING_SITES = ("device_predict", "artifact_load", "compile", "clock")
TRAINING_SITES = ("block_read", "device_put", "checkpoint_write", "gradient")
PIPELINE_SITES = ("data_arrival", "continue_train", "artifact_push", "flip")
SWEEP_SITES = ("sweep_segment", "sweep_record", "sweep_promote")
SITES = SERVING_SITES + TRAINING_SITES + PIPELINE_SITES + SWEEP_SITES


class FaultError(RuntimeError):
    """A deterministically injected fault."""


class StreamScopeError(ValueError):
    """A parameter the streamed (out-of-core) trainer does not cover.

    The per-block grower steps restate the strict and wave bodies without
    the categorical / monotone / extra-trees / interaction / bynode
    machinery: training anyway would be subtly DIFFERENT, not slower, so the
    fence is a hard typed error.  ``key`` names the exact offending
    parameter so callers (and tests) can assert on the field rather than
    parse prose.
    """

    def __init__(self, message: str, key: str = ""):
        super().__init__(message)
        self.key = key


class ScreenScopeError(ValueError):
    """A parameter gain-informed feature screening does not cover.

    Screened rounds grow trees in COMPACTED feature space and remap the
    winners; configs whose static per-column state (categorical sets,
    monotone signs, per-column bin counts, interaction groups, linear leaf
    designs, the feature-sharded learner) is indexed by GLOBAL column would
    train subtly differently, not merely slower, so the fence is a hard
    typed error.  ``key`` names the exact offending parameter, mirroring
    :class:`StreamScopeError`.
    """

    def __init__(self, message: str, key: str = ""):
        super().__init__(message)
        self.key = key


class NonFiniteGradientError(RuntimeError):
    """Diagnostic raised by the training finiteness screen.

    Non-finite raw predictions make every downstream gradient/hessian
    non-finite, and a tree grown from NaN stats silently poisons the
    whole forest — the screen raises THIS before the round runs instead
    of growing a garbage tree.  Carries the failing round index so the
    operator knows which checkpoint still precedes the corruption.
    """

    def __init__(self, message: str, round_index: int = -1):
        super().__init__(message)
        self.round_index = int(round_index)


@dataclass
class FaultSpec:
    """One armed failure: fire at ``site`` after ``after`` clean hits.

    ``times`` bounds how many consecutive hits fire (-1 = every hit
    forever).  ``stall_s`` is only meaningful at the ``compile`` site
    (returned, not raised); ``skew_s`` only at the ``clock`` site
    (applied by :meth:`FaultInjector.wrap_clock` while the spec has
    firings left).
    """

    site: str
    after: int = 0
    times: int = 1
    message: str = "injected fault"
    stall_s: float = 0.0
    skew_s: float = 0.0
    _fired: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} (known: {SITES})")

    def _active(self, site_hits: int) -> bool:
        if site_hits <= self.after:
            return False
        return self.times < 0 or self._fired < self.times


class FaultInjector:
    """Holds armed :class:`FaultSpec`s and counts every site hit.

    ``check(site)`` is the one call the stacks make: it counts the hit,
    fires the first matching armed spec, and either raises
    :class:`FaultError` (error sites) or returns a stall duration in
    seconds (the ``compile`` site; 0.0 when nothing fires).
    """

    def __init__(self, specs=()):
        self._specs: List[FaultSpec] = []
        self.hits: Dict[str, int] = {s: 0 for s in SITES}
        self.fired: Dict[str, int] = {s: 0 for s in SITES}
        for s in specs:
            self.arm(s)

    def arm(self, spec, **kw) -> FaultSpec:
        """Arm a spec (or build one from ``site=...`` keywords)."""
        if not isinstance(spec, FaultSpec):
            spec = FaultSpec(spec, **kw)
        self._specs.append(spec)
        return spec

    def disarm_all(self) -> None:
        self._specs.clear()

    def check(self, site: str) -> float:
        """Count one hit at ``site``; fire the first matching armed spec.

        Raises :class:`FaultError` for error sites; returns the stall
        seconds for the ``compile`` site (0.0 when no spec fires).
        """
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r} (known: {SITES})")
        self.hits[site] += 1
        for spec in self._specs:
            if spec.site != site or not spec._active(self.hits[site]):
                continue
            spec._fired += 1
            self.fired[site] += 1
            if site == "compile":
                return float(spec.stall_s)
            raise FaultError(f"{site}: {spec.message}")
        return 0.0

    def wrap_clock(self, clock):
        """A clock that adds the skew of every armed clock spec with
        firings left.  Each read counts a ``clock`` site hit, so
        ``after``/``times`` select exactly which reads see the skew."""

        def skewed() -> float:
            self.hits["clock"] += 1
            t = clock()
            for spec in self._specs:
                if spec.site == "clock" and spec._active(
                        self.hits["clock"]):
                    spec._fired += 1
                    self.fired["clock"] += 1
                    t += float(spec.skew_s)
            return t

        return skewed

    def snapshot(self) -> dict:
        return {
            "armed": len(self._specs),
            "hits": dict(self.hits),
            "fired": dict(self.fired),
        }

