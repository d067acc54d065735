"""SweepService: resumable grid-search execution — the port of
``lightgbm_tpu/sweep/service.py``.

Take a config grid and a Dataset; run the :class:`~.scheduler.SweepScheduler`
plan hyper-batch by hyper-batch on the fused-CV program (or config by config
through ``engine.cv`` on the host engine); commit each hyper-batch's results
into the crash-safe :class:`~.ledger.SweepLedger`; with ``checkpoint_dir``,
save every hyper-batch's full carry after each segment through the
training checkpoint protocol (``training.checkpoint``).

**Kill-anywhere parity**: a SIGTERM (:class:`PreemptionGuard`, polled
between segments and units) or an injected fault (``sweep_segment`` between
segments, ``sweep_record`` after a hyper-batch finishes and before its
ledger commit, ``checkpoint_write`` inside a carry checkpoint) returns
instead of raising, and leaves durable state (unit carry checkpoints + the
atomically saved ledger) from which a rerun converges to a ledger FILE
byte-identical to the uninterrupted run's, on the JSON and the RData codec.
Three properties make that true: per-round random draws are keyed by round
index, the carry round-trips through numpy exactly (f32/i32/bool fields,
the reference's names and dtypes, so unit checkpoints interchange too), and
unit identity is content-derived (the same remaining work re-plans to the
same checkpoint directory).  A restore also re-checks the grid digest, so
a checkpoint of a different sweep definition restarts its unit instead.

``n_devices``/``group_size`` shape the plan's device groups (the
scheduler's greedy LPT); as in the reference, the groups are a plan: the
units run one after another on the Dataset's device, each ledger row
records its unit's ``group``, and the ``plan`` stats give the group count.

``run_grid_search`` is the entry point the examples call (``utils.sweep``
re-exports it).
"""

from __future__ import annotations

import os
import shutil
import time
import warnings
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np

from ..faults import FaultError, FaultInjector
from ..training.checkpoint import load_latest, save_state_checkpoint
from ..training.loop import PreemptionGuard
from .ledger import SweepLedger, grid_digest
from .scheduler import SweepScheduler, SweepUnit

SWEEP_ENGINES = ("auto", "fused", "host")


class SweepResult(NamedTuple):
    """Outcome of one :meth:`SweepService.run` invocation."""

    ledger: SweepLedger
    completed: bool            # every grid row recorded
    preempted: bool            # SIGTERM drain or injected fault mid-sweep
    error: Optional[str]       # the fault message when preempted by one
    engine: str                # "fused" or "host", post-eligibility
    units_total: int           # hyper-batches planned this run
    units_done: int            # hyper-batches committed this run
    resumed_units: int         # units restored from a carry checkpoint
    checkpoint_failures: int   # carry writes lost to injected/real faults
    stats: Dict[str, Any]      # per-bucket timings


class SweepService:
    """Execute a config grid as a scheduled, resumable sweep.

    Parameters
    ----------
    grid : list of config dicts (``expand_grid`` rows)
    train_set : Dataset
    base_params : dict, optional
        Params shared by every config (each grid row overlays it).
    num_boost_round / nfold / early_stopping_rounds / seed
        The ``engine.cv`` contract per config.  ``seed`` also fixes the
        fold assignment, so resumes re-derive identical folds.
    engine : "auto" | "fused" | "host"
        "fused"/"auto" run eligible grids as hyper-batched device loops and
        fall back to the host loop otherwise; "host" forces the serial
        per-config loop (the R workflow's shape).
    ledger_path : str, optional
        Resumable ledger location (codec by suffix: .RData or JSON).
    checkpoint_dir : str, optional
        Root for per-hyper-batch carry checkpoints (``unit_<uid>/``
        subdirectories, the training checkpoint file protocol).  Without
        it the sweep still resumes unit by unit through the ledger, but an
        interrupted unit restarts from round 0.
    n_devices / group_size / hyper_batch
        The configs x devices mesh shape handed to the scheduler.
    injector : FaultInjector, optional
        Consults ``sweep_segment`` / ``sweep_record`` here (and
        ``checkpoint_write`` inside the checkpoint writer).
    clock : callable, optional
        Injectable time source for the stats and the ledger's ``saved_at``.
    cv_fn : callable, optional
        Host-engine cv override (tests); forces the host path.
    """

    def __init__(self, grid: List[Dict[str, Any]], train_set, *,
                 base_params: Optional[Dict[str, Any]] = None,
                 num_boost_round: int = 1000,
                 nfold: int = 5,
                 early_stopping_rounds: int = 5,
                 seed: int = 0,
                 engine: str = "auto",
                 ledger_path: Optional[str] = None,
                 checkpoint_dir: Optional[str] = None,
                 n_devices: int = 1,
                 group_size: int = 1,
                 hyper_batch: int = 36,
                 injector: Optional[FaultInjector] = None,
                 clock: Callable[[], float] = time.monotonic,
                 verbose: bool = False,
                 cv_fn: Optional[Callable] = None):
        if engine not in SWEEP_ENGINES:
            raise ValueError(f"engine must be one of {SWEEP_ENGINES}, "
                             f"got {engine!r}")
        if nfold < 2:
            raise ValueError(f"nfold must be >= 2, got {nfold}")
        if not grid:
            raise ValueError("empty config grid")
        self.grid = [dict(cfg) for cfg in grid]
        self.train_set = train_set
        self.base_params = dict(base_params or {})
        self.num_boost_round = int(num_boost_round)
        self.nfold = int(nfold)
        self.early_stopping_rounds = int(early_stopping_rounds)
        self.seed = int(seed)
        self.engine = engine
        self.checkpoint_dir = checkpoint_dir
        self.n_devices = int(n_devices)
        self.group_size = int(group_size)
        self.injector = injector
        self.clock = clock
        self.verbose = verbose
        self.cv_fn = cv_fn
        self.scheduler = SweepScheduler(hyper_batch=hyper_batch)
        self.ledger = SweepLedger(self.grid, ledger_path, clock=clock)
        self._digest = grid_digest(
            self.grid, nfold=self.nfold, seed=self.seed,
            num_boost_round=self.num_boost_round,
            early_stopping_rounds=self.early_stopping_rounds)

    # -- driving -------------------------------------------------------------
    def run(self, guard: Optional[PreemptionGuard] = None) -> SweepResult:
        """Execute (or resume) the sweep under a preemption guard; returns
        instead of raising on preemption or injected faults."""
        g = guard if guard is not None else PreemptionGuard()
        with g:
            return self._run(g)

    def _fold_masks(self) -> np.ndarray:
        n = self.train_set.num_data()
        rng = np.random.default_rng(self.seed)
        assign = rng.permutation(n) % self.nfold
        return np.stack([assign != k for k in range(self.nfold)])

    def _parsed(self) -> list:
        from ..config import parse_params

        parsed = []
        for cfg in self.grid:
            params = dict(self.base_params)
            params.update(cfg)
            parsed.append(parse_params(params, warn_unknown=False))
        return parsed

    def _run(self, g: PreemptionGuard) -> SweepResult:
        from ..models.fused import fused_cv_eligible

        self.train_set.construct()
        parsed = self._parsed()
        use_fused = (self.engine in ("auto", "fused")
                     and self.cv_fn is None
                     and all(fused_cv_eligible(p, None, None,
                                               self.train_set)
                             for p in parsed))
        if not use_fused and self.engine == "fused" and self.cv_fn is None \
                and self.verbose:
            print("fused engine ineligible for this grid; "
                  "falling back to host loop")
        if use_fused:
            return self._run_fused(g, parsed)
        return self._run_host(g)

    def _result(self, *, preempted: bool, error: Optional[str], engine: str,
                units_total: int, units_done: int, stats: Dict[str, Any],
                resumed: int = 0, ckpt_failures: int = 0) -> SweepResult:
        completed = not self.ledger.pending()
        if completed and self.checkpoint_dir:
            # every unit is committed; the carry checkpoints are spent
            shutil.rmtree(self.checkpoint_dir, ignore_errors=True)
        return SweepResult(
            ledger=self.ledger, completed=completed, preempted=preempted,
            error=error, engine=engine, units_total=units_total,
            units_done=units_done, resumed_units=resumed,
            checkpoint_failures=ckpt_failures, stats=stats)

    # -- host engine ---------------------------------------------------------
    def _run_host(self, g: PreemptionGuard) -> SweepResult:
        from ..engine import cv as _cv

        cv_fn = self.cv_fn or _cv
        stats: Dict[str, Any] = {"buckets": [], "compile_s": 0.0,
                                 "exec_s": 0.0, "rounds_total": 0}
        done_now = 0
        pending = self.ledger.pending()

        def stop(err: str) -> SweepResult:
            return self._result(preempted=True, error=err, engine="host",
                                units_total=len(pending),
                                units_done=done_now, stats=stats)

        for i, cfg in enumerate(self.grid):
            if self.ledger.done(i):
                if self.verbose:
                    print(f"[{i + 1}/{len(self.grid)}] already done, "
                          "skipping")
                continue
            try:
                if self.injector is not None:
                    self.injector.check("sweep_segment")
            except FaultError as e:
                return stop(str(e))
            if self.verbose:
                print(f"[{i + 1}/{len(self.grid)}]")
            params = dict(self.base_params)
            params.update(cfg)
            fit = cv_fn(params, self.train_set,
                        num_boost_round=self.num_boost_round,
                        nfold=self.nfold,
                        early_stopping_rounds=self.early_stopping_rounds,
                        seed=self.seed, stratified=False)
            try:
                if self.injector is not None:
                    self.injector.check("sweep_record")
            except FaultError as e:
                return stop(str(e))
            self.ledger.record(i, fit.best_iter, fit.best_score)
            done_now += 1
            if g.requested:
                return stop("SIGTERM drain mid-sweep")
        return self._result(preempted=False, error=None, engine="host",
                            units_total=len(pending), units_done=done_now,
                            stats=stats)

    # -- fused engine --------------------------------------------------------
    def _unit_dir(self, unit: SweepUnit) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        return os.path.join(self.checkpoint_dir, f"unit_{unit.uid}")

    def _save_unit_ckpt(self, prog, carry, unit_dir: str,
                        unit: SweepUnit) -> int:
        """Checkpoint a unit's carry; 1 when the write was lost, else 0."""
        arrays = prog.carry_arrays(carry)
        meta = {"iter": int(arrays["r"]), "kind": "sweep_unit",
                "uid": unit.uid, "grid_digest": self._digest,
                "configs": [int(i) for i in unit.config_indices]}
        try:
            save_state_checkpoint(arrays, meta, unit_dir,
                                  injector=self.injector,
                                  keep_last=2)
        except (FaultError, OSError) as e:
            # same contract as the training loop: the tmp+rename protocol
            # kept the prior checkpoint; losing one write costs redo
            # rounds, never the sweep
            warnings.warn(f"sweep checkpoint write failed (prior "
                          f"checkpoint kept): {e}")
            return 1
        return 0

    def _restore_unit(self, prog, unit: SweepUnit, unit_dir: str):
        """The unit's newest valid carry on the program's device, or None
        (no checkpoint, or one of a different sweep definition)."""
        path, found = load_latest(unit_dir)
        for rej_path, why in found["rejected"]:
            warnings.warn(f"skipping corrupt sweep checkpoint "
                          f"{rej_path}: {why}")
        if path is None:
            return None
        meta = found["meta"]
        if meta.get("kind") != "sweep_unit" or meta.get("uid") != unit.uid \
                or meta.get("grid_digest") != self._digest:
            warnings.warn(
                f"discarding sweep checkpoint {path}: it belongs to a "
                "different sweep definition (grid/nfold/seed/rounds "
                "drift); restarting this hyper-batch from round 0")
            return None
        return prog.restore_carry(found["arrays"])

    def _run_fused(self, g: PreemptionGuard, parsed: list) -> SweepResult:
        from ..metrics import get_metric
        from ..models.fused import FusedCVProgram

        fold_masks = self._fold_masks()
        plan = self.scheduler.plan(
            parsed, self.train_set, done=[i for i in range(len(self.grid))
                                          if self.ledger.done(i)],
            n_devices=self.n_devices, group_size=self.group_size)
        stats: Dict[str, Any] = {"buckets": [], "compile_s": 0.0,
                                 "exec_s": 0.0, "rounds_total": 0,
                                 "plan": {"units": len(plan.units),
                                          "n_groups": plan.n_groups,
                                          "group_size": plan.group_size}}
        units_done = 0
        resumed_units = 0
        ckpt_failures = 0

        def bail(err: str) -> SweepResult:
            return self._result(preempted=True, error=err, engine="fused",
                                units_total=len(plan.units),
                                units_done=units_done, stats=stats,
                                resumed=resumed_units,
                                ckpt_failures=ckpt_failures)

        for unit in plan.units:
            key = unit.bucket_key
            if self.verbose:
                print(f"fused bucket num_leaves={key[0]} "
                      f"bagging_freq={key[1]}: "
                      f"{len(unit.config_indices)} configs x "
                      f"{self.nfold} folds (group {unit.group})")
            t0 = self.clock()
            prog = FusedCVProgram(
                self.train_set, [parsed[i] for i in unit.config_indices],
                fold_masks, self.num_boost_round,
                self.early_stopping_rounds, self.seed)
            unit_dir = self._unit_dir(unit)
            carry = None
            if unit_dir:
                carry = self._restore_unit(prog, unit, unit_dir)
                if carry is not None:
                    resumed_units += 1
            if carry is None:
                carry = prog.init()
            setup_s = self.clock() - t0
            t_exec = self.clock()
            seg = prog.segment_rounds
            while not prog.done(carry):
                try:
                    if self.injector is not None:
                        self.injector.check("sweep_segment")
                except FaultError as e:
                    return bail(str(e))
                seg_end = min((carry.r // seg + 1) * seg,
                              self.num_boost_round)
                carry = prog.step(carry, seg_end)
                if unit_dir:
                    ckpt_failures += self._save_unit_ckpt(
                        prog, carry, unit_dir, unit)
                if g.requested:
                    return bail("SIGTERM drain mid-sweep")
            try:
                if self.injector is not None:
                    self.injector.check("sweep_record")
            except FaultError as e:
                return bail(str(e))
            res = prog.finalize(carry)
            best_iters = res.best_iter.cpu().numpy()
            best_raw = res.best_score.cpu().numpy()
            hib = get_metric(prog.metric_name).higher_better
            for j, i in enumerate(unit.config_indices):
                raw = float(best_raw[j])
                self.ledger.rows[i]["iteration"] = int(best_iters[j])
                self.ledger.rows[i]["score"] = raw if hib else -raw
            self.ledger.save()
            if unit_dir:
                shutil.rmtree(unit_dir, ignore_errors=True)
            units_done += 1
            self._log_unit(stats, unit, t0, t_exec, setup_s, res.rounds_run)
            if g.requested:
                return bail("SIGTERM drain mid-sweep")
        return self._result(preempted=False, error=None, engine="fused",
                            units_total=len(plan.units),
                            units_done=units_done, stats=stats,
                            resumed=resumed_units,
                            ckpt_failures=ckpt_failures)

    def _log_unit(self, stats, unit: SweepUnit, t0: float, t_exec: float,
                  setup_s: float, rounds: int) -> None:
        el = self.clock() - t0
        exec_s = self.clock() - t_exec
        stats["buckets"].append(
            {"num_leaves": unit.bucket_key[0],
             "configs": len(unit.config_indices),
             "group": unit.group, "uid": unit.uid, "s": el,
             "rounds": rounds, "compile_s": setup_s, "exec_s": exec_s})
        stats["compile_s"] += setup_s
        stats["exec_s"] += exec_s
        stats["rounds_total"] += rounds
        if self.verbose:
            print(f"  bucket done in {el:.1f}s ({rounds} rounds run)")


def run_grid_search(
    grid: List[Dict[str, Any]],
    train_set,
    base_params: Optional[Dict[str, Any]] = None,
    num_boost_round: int = 1000,
    nfold: int = 5,
    early_stopping_rounds: int = 5,
    ledger_path: Optional[str] = None,
    seed: int = 0,
    verbose: bool = True,
    cv_fn: Optional[Callable] = None,
    engine: str = "fused",
) -> SweepLedger:
    """Execute the R workflow's sweep loop (r/gridsearchCV.R:104-119).

    Per config: 5-fold CV with early stopping; ``best_iter``/``best_score``
    written back into the ledger, which is saved after each hyper-batch.
    Re-running with the same ledger_path skips completed rows.

    ``engine="fused"`` (default) buckets configs sharing num_leaves,
    bagging_freq, the objective and the learning rate, and runs each
    bucket's cv trainings as one batched device loop (folds x configs,
    early stopping on the device); ``engine="host"`` runs the serial
    per-config loop.  The returned ledger carries the timing stats as
    ``sweep_stats``.
    """
    service = SweepService(
        grid, train_set, base_params=base_params,
        num_boost_round=num_boost_round, nfold=nfold,
        early_stopping_rounds=early_stopping_rounds, seed=seed,
        engine="host" if engine == "host" else "auto",
        ledger_path=ledger_path, verbose=verbose, cv_fn=cv_fn)
    result = service.run()
    ledger = result.ledger
    ledger.sweep_stats = result.stats
    return ledger
