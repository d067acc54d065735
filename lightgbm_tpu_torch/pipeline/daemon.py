"""The refresh daemon: continuous train -> canary -> hot-swap — the port of
``lightgbm_tpu/pipeline/daemon.py``.

``RefreshDaemon`` closes the production loop: new row blocks arrive, the
live model CONTINUES training N rounds through the resumable loop
(model-file continuation on a streamed ``Dataset.from_blocks``), the
result is published as a versioned PackedForest and pushed through the
ModelBank's ingest -> warm -> canary -> atomic flip, and every stage
boundary is stamped into a
:class:`~.staleness.StalenessTracker` so **model staleness**
(data-arrival -> serving) is a measured, budgeted quantity.

Design rules:

* **one schema forever** — generation 1's sketch-fit BinMapper is the
  reference for every later ``Dataset.from_blocks(reference=...)``, so
  the schema digest never drifts and continuation is always legal.
  Rebinning is a NEW pipeline, not a refresh.
* **crash-anywhere** — every stage is either atomic (tmp+rename
  artifact publish, one-assignment bank flip) or resumable (per
  generation checkpoint directory, ``train_resumable(resume=True)``).
  A preempted refresh retried on the next tick converges to the SAME
  flip bit-identically.
* **rejection is survivable** — a corrupt artifact push is rejected by
  the bank (ingest validation or canary) and the prior version keeps
  serving; the daemon re-publishes from its checkpoint on the next
  tick.  A post-flip ``flip`` fault rolls the bank back and re-anchors
  continuation on the reverted model.
* **deterministic time** — the daemon only reads its injectable clock;
  with a :class:`~.staleness.SimClock` plus ``stage_costs`` the whole
  run (and its staleness decomposition) is bit-reproducible.
* **stamps after the device** — on the card each stage's kernels are
  queued asynchronously, so every stamp follows a point where that
  stage's device work is done: one ``torch.cuda.synchronize`` after
  training, ``pack_booster``'s host copy before ``artifact_saved`` and
  the canary's read-back before ``canaried``.  A leg therefore holds its
  own kernels, not the previous stage's.

The daemon, its Datasets and the bank it builds run on ``device`` (the
card unless the caller passes ``device="cpu"``); training runs on its
Dataset's device.

Fault sites consulted (the port's ``faults`` registry):
``data_arrival`` (poll outage — retried, arrivals never lost),
``continue_train`` (preemption at a round boundary), ``artifact_push``
(torn publish — the artifact is poisoned so the bank MUST catch it),
``flip`` (post-flip health alarm -> rollback), ``sweep_promote``
(a crash between a completed sweep and the winner's promotion —
retried next tick, the finished ledger makes the re-run a fast no-op),
plus every site the wrapped subsystems already consult.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..dataset import Dataset
from ..device import resolve_device
from ..faults import FaultError, FaultInjector
from ..serving.bank import ModelBank, SwapRejected
from ..serving.packed import PackedForest, pack_booster
from ..training.loop import train_resumable
from .staleness import StalenessTracker, wall_clock

_ART_RE = re.compile(r"^model_g(\d{4,})\.npz$")


class Arrival(NamedTuple):
    """One delivered row block."""

    X: np.ndarray
    y: np.ndarray
    t_arrival: float


class ArrivalFeed:
    """Deterministic in-memory arrival source (tests / benches).

    ``push`` records a block with an explicit arrival time (defaults to
    the feed's clock); ``poll`` drains everything pushed so far.
    """

    def __init__(self, clock: Callable[[], float] = wall_clock):
        self.clock = clock
        self._pending: List[Arrival] = []

    def push(self, X, y, t_arrival: Optional[float] = None) -> None:
        t = self.clock() if t_arrival is None else float(t_arrival)
        self._pending.append(Arrival(np.asarray(X), np.asarray(y), t))

    def poll(self) -> List[Arrival]:
        out, self._pending = self._pending, []
        return out


class DirectoryFeed:
    """Watch a directory for ``*.npz`` block files (``X`` + ``y``
    arrays), the CLI ``task=refresh watch_dir=`` source.  Files are
    absorbed once, in sorted-name order; names containing ``.tmp`` are
    in-progress writes and skipped until renamed into place."""

    def __init__(self, watch_dir: str,
                 clock: Callable[[], float] = wall_clock):
        self.watch_dir = watch_dir
        self.clock = clock
        self._seen: set = set()

    def poll(self) -> List[Arrival]:
        if not os.path.isdir(self.watch_dir):
            return []
        out: List[Arrival] = []
        for name in sorted(os.listdir(self.watch_dir)):
            if not name.endswith(".npz") or ".tmp" in name \
                    or name in self._seen:
                continue
            with np.load(os.path.join(self.watch_dir, name),
                         allow_pickle=False) as z:
                if "X" not in z.files or "y" not in z.files:
                    raise ValueError(
                        f"{name}: block files need 'X' and 'y' arrays")
                out.append(Arrival(np.array(z["X"]), np.array(z["y"]),
                                   self.clock()))
            self._seen.add(name)
        return out


def latest_artifact(models_dir: str) -> Tuple[Optional[str], int]:
    """Newest COMPLETED versioned artifact ``(path, generation)`` in a
    daemon's models directory.  In-progress ``.tmp-`` siblings (an
    artifact publish torn mid-write) never match — the same skip
    contract as ``training.checkpoint.load_latest``."""
    best: Tuple[int, Optional[str]] = (0, None)
    if os.path.isdir(models_dir):
        for name in os.listdir(models_dir):
            m = _ART_RE.match(name)
            if m and int(m.group(1)) > best[0]:
                best = (int(m.group(1)), os.path.join(models_dir, name))
    return best[1], best[0]


class RefreshDaemon:
    """Drive the data-arrival -> train -> canary -> flip loop.

    Parameters
    ----------
    params : dict
        Training params (streamed scope; ``stream_block_rows`` sizes
        the BlockStore blocks).  Fixed for the daemon's lifetime.
    state_dir : str
        Root of the daemon's on-disk state: ``models/`` holds the
        versioned serving artifacts, ``ckpt/gen_NNNN/`` the
        per-generation training checkpoints.  A restarted daemon
        re-anchors on the newest completed artifact found here.
    feed : ArrivalFeed | DirectoryFeed
        Where new row blocks come from.
    bank : ModelBank, optional
        Serving bank to flip (one is built on the daemon's clock +
        injector when omitted).
    refresh_rounds / initial_rounds : int
        Boosting rounds added per refresh generation; generation 1
        trains ``initial_rounds`` (defaults to ``refresh_rounds``)
        from scratch.
    checkpoint_rounds : int
        Cadence of the auto-checkpoints inside each refresh.
    staleness_slo_ms : float, optional
        Measured-staleness SLO recorded by the tracker (breaches are
        reported, never enforced by the daemon — alerting is the
        operator's loop).
    clock / injector / stage_costs
        Injectable time source, shared fault registry, and optional
        per-stage simulated costs (seconds) charged into a
        ``SimClock`` — keys: ``dataset_build``, ``train_round``,
        ``sweep``, ``publish``, ``deploy``, ``flip``.
    sweep_grid / sweep_every
        The closed tune->serve loop: with a config grid and
        ``sweep_every=N``, every Nth data-bearing generation runs a
        checkpointed :class:`~lightgbm_tpu_torch.sweep.service.SweepService`
        over the accumulated data first, adopts the leaderboard winner
        into ``params``, COLD-trains it to the winner's best iteration,
        and promotes through the same publish -> canary -> atomic-flip
        path as a refresh (``retune()`` forces one immediately).
        ``sweep_rounds``/``sweep_nfold``/``sweep_early_stopping``
        bound the per-config CV; ``sweep_devices``/``sweep_hyper_batch``
        shape the scheduler mesh.
    device : str | torch.device, optional
        Where the Datasets, the training and the bank run (None: the
        card).
    """

    def __init__(self, params: dict, state_dir: str, *,
                 feed,
                 bank: Optional[ModelBank] = None,
                 model_name: str = "model",
                 refresh_rounds: int = 5,
                 initial_rounds: Optional[int] = None,
                 checkpoint_rounds: int = 5,
                 staleness_slo_ms: Optional[float] = None,
                 canary_rows: int = 8,
                 clock: Optional[Callable[[], float]] = None,
                 injector: Optional[FaultInjector] = None,
                 stage_costs: Optional[Dict[str, float]] = None,
                 keep_artifacts: int = 4,
                 sweep_grid: Optional[List[dict]] = None,
                 sweep_every: int = 0,
                 sweep_rounds: int = 50,
                 sweep_nfold: int = 3,
                 sweep_early_stopping: int = 5,
                 sweep_devices: int = 1,
                 sweep_hyper_batch: int = 36,
                 device=None):
        if refresh_rounds <= 0:
            raise ValueError(
                f"refresh_rounds must be positive, got {refresh_rounds}")
        if sweep_every > 0 and not sweep_grid:
            raise ValueError(
                "sweep_every > 0 requires a sweep_grid")
        if sweep_grid is not None and sweep_nfold < 2:
            raise ValueError(
                f"sweep_nfold must be >= 2, got {sweep_nfold}")
        if sweep_devices < 1:
            raise ValueError(
                f"sweep_devices must be >= 1, got {sweep_devices}")
        if keep_artifacts < 2:
            raise ValueError(
                "keep_artifacts must be >= 2 (the previous version must "
                "stay on disk for rollback re-anchoring)")
        self.device = resolve_device(device)
        self.params = dict(params)
        self.state_dir = state_dir
        self.models_dir = os.path.join(state_dir, "models")
        self.ckpt_root = os.path.join(state_dir, "ckpt")
        os.makedirs(self.models_dir, exist_ok=True)
        os.makedirs(self.ckpt_root, exist_ok=True)
        self.feed = feed
        self.model_name = model_name
        self.refresh_rounds = int(refresh_rounds)
        self.initial_rounds = int(initial_rounds if initial_rounds
                                  is not None else refresh_rounds)
        self.checkpoint_rounds = int(checkpoint_rounds)
        self.canary_rows = int(canary_rows)
        self.clock = clock if clock is not None else wall_clock
        self.injector = injector
        self.stage_costs = dict(stage_costs or {})
        self.keep_artifacts = int(keep_artifacts)
        self.bank = bank if bank is not None else ModelBank(
            canary_rows=self.canary_rows, faults=injector,
            clock=self.clock, device=self.device)
        self.tracker = StalenessTracker(slo_ms=staleness_slo_ms)
        self.poll_faults = 0
        self.sweep_grid = [dict(r) for r in sweep_grid] if sweep_grid \
            else None
        self.sweep_every = int(sweep_every)
        self.sweep_rounds = int(sweep_rounds)
        self.sweep_nfold = int(sweep_nfold)
        self.sweep_early_stopping = int(sweep_early_stopping)
        self.sweep_devices = int(sweep_devices)
        self.sweep_hyper_batch = int(sweep_hyper_batch)

        # guards the absorb-state (blocks/pending/retry/generation/live
        # pointers) against status()/snapshot() readers on other threads
        self._lock = threading.RLock()
        self._blocks: List[Tuple[np.ndarray, np.ndarray]] = []
        self._pending: List[Arrival] = []
        self._retry = False
        self._retry_mode: Optional[str] = None  # "refresh" | "sweep"
        self._flips_since_sweep = 0
        self._force_sweep = False
        self._ref_mapper = None
        self._live_path, self._gen = latest_artifact(self.models_dir)
        self._live_rounds = 0
        if self._live_path is not None:
            pf = PackedForest.load(self._live_path)
            self._live_rounds = pf.num_trees // max(pf.num_class, 1)
            self._ref_mapper = pf.bin_mapper
            if self.model_name not in self.bank.names():
                self.bank.deploy(self.model_name, self._live_path,
                                 version=f"g{self._gen:04d}")

    # -- clock charging ------------------------------------------------------
    def _charge(self, key: str) -> None:
        cost = self.stage_costs.get(key)
        adv = getattr(self.clock, "advance", None)
        if cost and adv is not None:
            adv(float(cost))

    # -- the loop ------------------------------------------------------------
    def tick(self) -> Optional[dict]:
        """One daemon iteration: absorb arrivals, refresh if there is
        anything to do.  Returns an event dict (``flipped`` /
        ``preempted`` / ``rejected`` / ``rolled_back`` / ``poll_fault``)
        or None when idle.  Chaos never escapes a tick — every injected
        fault becomes a recorded event and the next tick retries."""
        if self.injector is not None:
            try:
                # consulted BEFORE the drain so a firing poll outage
                # cannot lose already-delivered arrivals
                self.injector.check("data_arrival")
            except FaultError as e:
                with self._lock:
                    self.poll_faults += 1
                return {"event": "poll_fault", "error": str(e)}
        with self._lock:
            self._pending.extend(self.feed.poll())
        if not self._pending and not self._retry and not self._force_sweep:
            return None
        # a preempted generation finishes AS WHAT IT WAS before anything
        # new starts: a half-done retune must not be restarted as a
        # refresh (or vice versa) just because more data arrived
        if self._retry:
            if self._retry_mode == "sweep":
                return self._run_sweep()
            return self._run_refresh()
        if self._sweep_due():
            return self._run_sweep()
        return self._run_refresh()

    def _sweep_due(self) -> bool:
        if self._force_sweep:
            return True
        return bool(self.sweep_grid and self.sweep_every > 0
                    and self._flips_since_sweep >= self.sweep_every)

    def retune(self) -> Optional[dict]:
        """Force a sweep generation on the next data-bearing tick (the
        operator's "the hyperparameters have drifted" hook)."""
        with self._lock:
            if self.sweep_grid is None:
                raise ValueError("retune() needs a sweep_grid")
            self._force_sweep = True
        return self.tick()

    def run_until_idle(self, max_ticks: int = 64) -> List[dict]:
        """Tick until a fully idle tick (drained feed, no retry)."""
        events: List[dict] = []
        for _ in range(max_ticks):
            ev = self.tick()
            if ev is None:
                return events
            events.append(ev)
        raise RuntimeError(
            f"daemon did not go idle within {max_ticks} ticks "
            f"(last event: {events[-1] if events else None})")

    # -- one refresh generation ---------------------------------------------
    def _ckpt_dir(self, gen: int) -> str:
        return os.path.join(self.ckpt_root, f"gen_{gen:04d}")

    def _run_refresh(self) -> dict:
        gen = self._gen + 1
        rec = self.tracker.begin(gen)
        t_arr = min(a.t_arrival for a in self._pending) \
            if self._pending else rec.stamps.get("data_arrival",
                                                 self.clock())
        if "data_arrival" in rec.stamps:
            t_arr = min(t_arr, rec.stamps["data_arrival"])
        rec.stamp("data_arrival", t_arr)
        rec.status = "training"
        rec.stamp("train_start", self.clock())
        with self._lock:
            self._retry_mode = "refresh"

        blocks = self._blocks + [(a.X, a.y) for a in self._pending]
        ds = Dataset.from_blocks(blocks, params=dict(self.params),
                                 reference=self._ref_mapper,
                                 device=self.device)
        if self._ref_mapper is None:
            with self._lock:
                self._ref_mapper = ds.bin_mapper
        self._charge("dataset_build")

        target = self._live_rounds + (self.refresh_rounds
                                      if self._live_path is not None
                                      else self.initial_rounds)
        return self._train_publish_flip(gen, rec, ds, target,
                                        init_model=self._live_path)

    def _train_publish_flip(self, gen: int, rec, ds, target: int,
                            init_model: Optional[str]) -> dict:
        """The shared back half of a generation: train ``target`` rounds
        (continuation when ``init_model`` is set, cold otherwise — the
        retune path trains the winner from scratch because continuation
        under changed hyperparameters is not the model the sweep
        scored), then publish -> canary -> atomic flip, with every
        failure mode absorbed into a retryable event."""

        def _round_cb(_booster, _i) -> None:
            self._charge("train_round")
            if self.injector is not None:
                self.injector.check("continue_train")

        try:
            res = train_resumable(
                self.params, ds, target,
                checkpoint_dir=self._ckpt_dir(gen),
                checkpoint_rounds=self.checkpoint_rounds,
                resume=True, injector=self.injector,
                round_callbacks=[_round_cb],
                init_model=init_model)
        except FaultError as e:
            rec.status = "preempted"
            rec.error = str(e)
            with self._lock:
                self._retry = True
            return {"event": "preempted", "generation": gen,
                    "error": str(e)}
        if res.preempted or not res.completed:
            rec.status = "preempted"
            rec.error = "SIGTERM drain mid-refresh"
            with self._lock:
                self._retry = True
            return {"event": "preempted", "generation": gen,
                    "error": rec.error}
        rec.rounds = res.rounds_done
        # the train leg's device work is queued asynchronously on the card:
        # wait for it once here, so its kernels land in ``train`` and not in
        # the ``publish`` leg
        _device_done(self.device)
        rec.stamp("trained", self.clock())

        art = os.path.join(self.models_dir, f"model_g{gen:04d}.npz")
        version = f"g{gen:04d}"
        # pack_booster copies the forest to the host: the publish leg's
        # device work is done when it returns
        poisoned = self._publish(res.booster, art)
        self._charge("publish")
        rec.stamp("artifact_saved", self.clock())

        try:
            # the canary reads its scores back to the host before deploy
            # returns, which ends the deploy leg's device work
            report = self.bank.deploy(self.model_name, art,
                                      version=version)
        except SwapRejected as e:
            rec.status = "rejected"
            rec.error = f"{e.stage}: {e}"
            with self._lock:
                self._retry = True
            return {"event": "rejected", "generation": gen,
                    "stage": e.stage, "poisoned": poisoned,
                    "error": str(e)}
        self._charge("deploy")
        rec.stamp("canaried", self.clock())

        prev_path, prev_rounds = self._live_path, self._live_rounds
        if self.injector is not None:
            try:
                self.injector.check("flip")
            except FaultError as e:
                # post-flip health alarm: revert serving AND re-anchor
                # continuation on the reverted model so the next
                # generation trains from what actually serves
                rb = None
                try:
                    rb = self.bank.rollback(self.model_name)
                except SwapRejected:  # graftlint: GL011 — gen 1: no prior
                    pass
                rec.status = "rolled_back"
                rec.error = str(e)
                self._absorb(gen)
                shutil.rmtree(self._ckpt_dir(gen), ignore_errors=True)
                return {"event": "rolled_back", "generation": gen,
                        "rollback": rb, "error": str(e)}
        self._charge("flip")
        rec.stamp("serving", self.clock())
        rec.status = "serving"
        rec.version = version
        self._absorb(gen)
        with self._lock:
            self._live_path, self._live_rounds = art, res.rounds_done
            self._flips_since_sweep += 1
        shutil.rmtree(self._ckpt_dir(gen), ignore_errors=True)
        self._prune_artifacts()
        return {"event": "flipped", "generation": gen,
                "version": version, "rounds": res.rounds_done,
                "resumed_from": res.resumed_from,
                "staleness_ms": self.tracker.staleness_ms(gen),
                "report": report}

    # -- one sweep (retune) generation ----------------------------------------
    def _sweep_dir(self, gen: int) -> str:
        return os.path.join(self.state_dir, "sweep", f"gen_{gen:04d}")

    # sweep axes whose R/JSON round-trip may come back float-typed but
    # that params require integral
    _INT_AXES = ("num_leaves", "min_data_in_leaf", "bagging_freq",
                 "max_depth", "max_bin", "nthread")

    def _run_sweep(self) -> dict:
        """One retune generation: sweep the grid over ALL accumulated
        data, adopt the leaderboard winner, train and promote it through
        the standard publish -> canary -> flip path.

        Crash-anywhere mirrors the refresh contract: the sweep itself is
        a checkpointed :class:`SweepService` keyed to a PER-GENERATION
        directory (an old tune's completed ledger can never short-
        circuit a new tune), ``sweep_promote`` faults and SIGTERM drains
        return a retryable ``preempted`` event, and a retry re-enters as
        a sweep (``_retry_mode``) — a finished ledger makes the re-run a
        fast no-op that converges on the same winner."""
        from ..sweep.service import SweepService

        gen = self._gen + 1
        blocks = self._blocks + [(a.X, a.y) for a in self._pending]
        if not blocks:
            # a forced retune before any data exists: stay armed, sweep
            # on the first data-bearing tick instead
            return {"event": "no_data", "generation": gen}
        rec = self.tracker.begin(gen)
        t_arr = min(a.t_arrival for a in self._pending) \
            if self._pending else rec.stamps.get("data_arrival",
                                                 self.clock())
        if "data_arrival" in rec.stamps:
            t_arr = min(t_arr, rec.stamps["data_arrival"])
        rec.stamp("data_arrival", t_arr)
        rec.status = "training"
        rec.stamp("sweep_start", self.clock())
        with self._lock:
            self._retry_mode = "sweep"

        if self._ref_mapper is None:
            # no schema yet (a forced retune before any refresh):
            # establish the one-schema-forever mapper the canonical way
            ref = Dataset.from_blocks(blocks, params=dict(self.params),
                                      device=self.device)
            with self._lock:
                self._ref_mapper = ref.bin_mapper
        # the fused sweep program needs one device-resident code matrix,
        # not a BlockStore — densify under the pinned reference schema
        # (construction is lazy and keeps a preset mapper)
        ds = Dataset(np.concatenate([b[0] for b in blocks]),
                     label=np.concatenate([b[1] for b in blocks]),
                     params=dict(self.params), device=self.device)
        ds.bin_mapper = self._ref_mapper
        self._charge("dataset_build")

        sweep_dir = self._sweep_dir(gen)
        os.makedirs(sweep_dir, exist_ok=True)
        svc = SweepService(
            self.sweep_grid, ds, base_params=dict(self.params),
            num_boost_round=self.sweep_rounds, nfold=self.sweep_nfold,
            early_stopping_rounds=self.sweep_early_stopping,
            seed=gen,  # new data -> new folds; retries of gen reuse them
            ledger_path=os.path.join(sweep_dir, "ledger.json"),
            checkpoint_dir=os.path.join(sweep_dir, "ckpt"),
            n_devices=self.sweep_devices,
            hyper_batch=self.sweep_hyper_batch,
            injector=self.injector, clock=self.clock)
        res = svc.run()
        if res.preempted or not res.completed:
            rec.status = "preempted"
            rec.error = res.error or "sweep incomplete"
            with self._lock:
                self._retry = True
            return {"event": "preempted", "generation": gen,
                    "phase": "sweep", "units_done": res.units_done,
                    "error": rec.error}
        board = res.ledger.leaderboard()
        if not board:
            rec.status = "rejected"
            rec.error = "sweep produced no completed configs"
            self._absorb(gen)
            return {"event": "rejected", "generation": gen,
                    "stage": "sweep", "error": rec.error}
        if self.injector is not None:
            try:
                self.injector.check("sweep_promote")
            except FaultError as e:
                rec.status = "preempted"
                rec.error = str(e)
                with self._lock:
                    self._retry = True
                return {"event": "preempted", "generation": gen,
                        "phase": "sweep_promote", "error": str(e)}
        rec.stamp("swept", self.clock())
        self._charge("sweep")

        winner = board[0]
        from ..sweep.ledger import RESULT_COLUMNS
        cfg = {}
        for k, v in winner.items():
            if k in RESULT_COLUMNS or k == "nthread":
                continue
            if k in self._INT_AXES and isinstance(v, float) \
                    and v.is_integer():
                v = int(v)
            cfg[k] = v
        best_iter = max(int(winner["iteration"]), 1)
        with self._lock:
            self.params.update(cfg)
            self._force_sweep = False
        rec.stamp("train_start", self.clock())
        ev = self._train_publish_flip(gen, rec, ds, best_iter,
                                      init_model=None)
        if ev.get("event") == "flipped":
            with self._lock:
                self._flips_since_sweep = 0
            ev = dict(ev, event="retuned", winner=dict(cfg),
                      winner_score=float(winner["score"]),
                      sweep_units=res.units_total,
                      tune_s=rec.decomposition().get("tune"))
        return ev

    def _absorb(self, gen: int) -> None:
        """Commit the pending arrivals + generation number (the data was
        trained into generation ``gen`` whether it ended up serving or
        quarantined by a rollback)."""
        with self._lock:
            self._blocks.extend((a.X, a.y) for a in self._pending)
            self._pending = []
            self._retry = False
            self._retry_mode = None
            self._gen = gen

    def _publish(self, booster, art: str) -> bool:
        """Atomically write the versioned artifact (tmp + rename, the
        checkpoint ``.tmp-`` sibling convention).  An armed
        ``artifact_push`` fault models a torn/corrupted push: the bytes
        that land are POISONED (NaN leaves) so the bank's own
        validation — not the daemon — must catch them.  Returns whether
        the artifact was poisoned."""
        tmp = os.path.join(os.path.dirname(art),
                           f".tmp-{os.path.basename(art)}")
        poisoned = False
        try:
            pack_booster(booster).save(tmp)
            if self.injector is not None:
                try:
                    self.injector.check("artifact_push")
                except FaultError:
                    poisoned = True
                    _poison_artifact(tmp)
            os.replace(tmp, art)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return poisoned

    def _prune_artifacts(self) -> None:
        gens = sorted(
            (int(m.group(1)), os.path.join(self.models_dir, m.group(0)))
            for m in (_ART_RE.match(n)
                      for n in os.listdir(self.models_dir)) if m)
        for _, path in gens[:-self.keep_artifacts]:
            os.unlink(path)

    def snapshot(self) -> dict:
        """Tracker + bank state for operators / the bench."""
        return {
            "generation": self._gen,
            "live_artifact": self._live_path,
            "live_rounds": self._live_rounds,
            "pending_blocks": len(self._pending),
            "absorbed_blocks": len(self._blocks),
            "poll_faults": self.poll_faults,
            "flips_since_sweep": self._flips_since_sweep,
            "retry_mode": self._retry_mode,
            "staleness": self.tracker.snapshot(),
            "bank": self.bank.snapshot(),
        }


def _device_done(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _poison_artifact(path: str) -> None:
    """Corrupt a packed artifact's payload in place (NaN every leaf of
    tree 0) — structurally parseable, semantically poison, exactly what
    ingest validation / the canary exist to reject."""
    with np.load(path, allow_pickle=False) as z:
        data = {k: np.array(z[k]) for k in z.files}
    lv = data["leaf_value"]
    lv[0] = np.nan
    data["leaf_value"] = lv
    with open(path, "wb") as f:
        np.savez(f, **data)
