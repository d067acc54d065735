"""ModelBank — multi-model tenancy with zero-downtime hot swap.

The port of ``lightgbm_tpu/serving/bank.py``.  One process, N resident
packed forests behind one bucket-ladder configuration (shared
``max_bucket``/``max_cache_entries``), each with its own persistent
:class:`ServingStats`.  Deploys are **validate-then-atomic-flip**:

1. ingest — load + structurally validate the ``.npz`` (or re-validate a
   passed-in forest); a corrupt artifact is rejected here and the old
   version never stops serving;
2. build — a fresh :class:`PredictorRuntime` over the new forest on the
   bank's device, writing into the model's existing stats object; a
   ``ThresholdBoundError`` (a field that does not narrow exactly at the
   requested precision) rejects here;
3. warm — optionally run the bucket ladder, with the measured
   (clock-injectable) duration checked against ``compile_timeout_s``;
4. canary — a deterministic batch through the NEW runtime, checked finite
   and against the forest's numpy oracle (the dequantized one for
   int8/bf16, plus the exact one against ``quant_error_bound``);
5. flip — one attribute assignment.  In-flight batches that already
   resolved the old runtime finish on it.

Every rejection raises :class:`SwapRejected` and leaves the active version
untouched; ``rollback()`` flips back to the previous resident version.  A
warm manifest records which models, versions and bucket programs were live,
so a restarted process replays it.  The bank runs on ``device="cuda"``
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..device import resolve_device
from ..ops.quantize import FOREST_PRECISIONS, ThresholdBoundError
from .faults import FaultError
from .packed import PackedForest, PackedForestError
from .runtime import (DEFAULT_CACHE_ENTRIES, DEFAULT_MAX_BUCKET,
                      SHARD_POLICIES, PredictorRuntime,
                      enable_persistent_cache)
from .stats import ServingStats

WARM_MANIFEST_VERSION = 1


class SwapRejected(RuntimeError):
    """A deploy failed validation/warm/canary; the old version still
    serves.  ``stage`` names the rejecting step."""

    def __init__(self, stage: str, message: str):
        super().__init__(f"swap rejected at {stage}: {message}")
        self.stage = stage


@dataclass
class _ModelVersion:
    runtime: PredictorRuntime
    packed: PackedForest
    version: str
    path: Optional[str]


@dataclass
class _ModelEntry:
    name: str
    stats: ServingStats
    active: _ModelVersion
    previous: Optional[_ModelVersion] = None
    history: List[dict] = field(default_factory=list)
    n_deploys: int = 0


class ModelBank:
    """N packed forests resident behind one bucket-ladder configuration.

    Args:
      max_bucket / max_cache_entries: shared PredictorRuntime knobs — the
        one bucket ladder every tenant serves.
      donate: accepted for the reference's API and ignored (see
        :class:`runtime.PredictorRuntime`).
      warm_on_deploy: run the ladder inside every deploy (before the
        flip).
      canary_rows: rows in the post-build canary batch (0 disables).
      canary_tol: max |device - numpy oracle| accepted by the canary.
      compile_timeout_s: abort the swap when warm+build exceeds this
        (measured via ``clock``; the stalled-compile failure mode).
      faults: optional FaultInjector threaded into every runtime
        (``device_predict``) and consulted at ``artifact_load`` and
        ``compile`` during deploys.
      clock: injectable time source for the compile-timeout measurement.
      cache_dir: accepted for the reference's API; a no-op (see
        :func:`runtime.enable_persistent_cache`).
      mesh_devices / shard_policy / forest_precision: runtime knobs shared
        by every tenant (see :class:`runtime.PredictorRuntime`).  A mesh
        stays atomic per tenant: one runtime owns all of a model's shard
        programs (dp shards, tp slices, the single-route ladder), so a hot
        swap or a rollback flips every shard of a model at once, and the
        canary and the numpy fallback check the mesh's own output.
      device: ``"cuda"`` (the default, ``None``) or ``"cpu"``.
    """

    def __init__(self, max_bucket: int = DEFAULT_MAX_BUCKET,
                 max_cache_entries: int = DEFAULT_CACHE_ENTRIES,
                 donate: Optional[bool] = None,
                 warm_on_deploy: bool = False,
                 canary_rows: int = 8,
                 canary_tol: float = 1e-5,
                 compile_timeout_s: Optional[float] = None,
                 faults=None,
                 clock=time.monotonic,
                 cache_dir: Optional[str] = None,
                 mesh_devices: int = 1,
                 shard_policy: str = "auto",
                 forest_precision: str = "f32",
                 device=None):
        if canary_rows < 0:
            raise ValueError("canary_rows must be >= 0")
        if shard_policy not in SHARD_POLICIES:
            raise ValueError(f"shard_policy must be one of "
                             f"{SHARD_POLICIES}, got {shard_policy!r}")
        if forest_precision not in FOREST_PRECISIONS:
            raise ValueError(f"forest_precision must be one of "
                             f"{FOREST_PRECISIONS}, got "
                             f"{forest_precision!r}")
        self.device = resolve_device(device)
        self.max_bucket = int(max_bucket)
        self.max_cache_entries = int(max_cache_entries)
        self.mesh_devices = int(mesh_devices)
        self.shard_policy = shard_policy
        self.forest_precision = forest_precision
        del donate                      # no buffer donation in the port
        self.warm_on_deploy = bool(warm_on_deploy)
        self.canary_rows = int(canary_rows)
        self.canary_tol = float(canary_tol)
        self.compile_timeout_s = compile_timeout_s
        self.faults = faults
        self.clock = clock
        self.persistent_cache = (enable_persistent_cache(cache_dir)
                                 if cache_dir else False)
        self.cache_dir = cache_dir
        # guards the resident-version table: deploys flip and undeploys
        # delete while reader threads (MicroBatcher resolvers) look up
        self._lock = threading.RLock()
        self._entries: Dict[str, _ModelEntry] = {}

    # -- lookup --------------------------------------------------------------
    def names(self) -> List[str]:
        return sorted(self._entries)

    def runtime(self, name: str) -> PredictorRuntime:
        """The ACTIVE runtime for ``name`` (the hot-swap resolution
        point — pass ``lambda: bank.runtime(name)`` to a MicroBatcher)."""
        return self._entry(name).active.runtime

    def version(self, name: str) -> str:
        return self._entry(name).active.version

    def predict(self, name: str, data, **kw) -> np.ndarray:
        return self.runtime(name).predict(data, **kw)

    def batcher(self, name: str, **kw):
        """A MicroBatcher bound to this model THROUGH the bank, so hot
        swaps take effect for queued traffic without re-queuing."""
        from .queue import MicroBatcher

        self._entry(name)                      # fail fast on unknown name
        return MicroBatcher(lambda: self.runtime(name), **kw)

    def _entry(self, name: str) -> _ModelEntry:
        e = self._entries.get(name)
        if e is None:
            raise KeyError(f"no model {name!r} deployed "
                           f"(resident: {self.names()})")
        return e

    # -- deploy / swap -------------------------------------------------------
    def deploy(self, name: str, source, version: Optional[str] = None,
               warm: Optional[bool] = None, warm_buckets=None,
               raw_score: bool = False,
               canary_X: Optional[np.ndarray] = None) -> dict:
        """Validate ``source`` and atomically flip ``name`` to it.

        ``source`` is a ``.npz`` path or a PackedForest.  On any
        rejection (ingest, stalled compile, failed canary) raises
        :class:`SwapRejected` with the prior version still serving.
        Returns a swap report dict (also appended to the model's
        history).
        """
        entry = self._entries.get(name)
        t0 = self.clock()
        report = {"model": name, "ok": False, "stage": "ingest",
                  "previous_version": (entry.active.version
                                       if entry else None)}
        try:
            packed, path = self._ingest(source)
            if entry is not None:
                nf_old = entry.active.packed.num_feature()
                nf_new = packed.num_feature()
                if nf_new != nf_old:
                    raise SwapRejected(
                        "ingest", f"feature count changed {nf_old} -> "
                        f"{nf_new}; traffic rows would be rejected")
            stats = entry.stats if entry is not None else ServingStats()
            report["stage"] = "build"
            try:
                rt = PredictorRuntime(
                    packed, max_bucket=self.max_bucket,
                    max_cache_entries=self.max_cache_entries,
                    stats=stats, faults=self.faults,
                    mesh_devices=self.mesh_devices,
                    shard_policy=self.shard_policy,
                    forest_precision=self.forest_precision,
                    device=self.device)
            except ThresholdBoundError as e:
                # a structural field does not narrow exactly at the
                # requested precision — never round thresholds; reject
                # and keep serving the prior (f32-or-otherwise) version
                raise SwapRejected("build", str(e)) from e
            report["stage"] = "warm"
            report["warmed"] = self._warm(rt, warm, warm_buckets,
                                          raw_score, t0)
            report["stage"] = "canary"
            report["canary"] = self._canary(rt, packed, raw_score,
                                            canary_X)
        except SwapRejected as e:
            report["error"] = str(e)
            report["stage"] = e.stage
            if entry is not None:
                entry.history.append(report)
            raise
        except (PackedForestError, FaultError, OSError) as e:
            msg = f"swap rejected at {report['stage']}: {e}"
            report["error"] = msg
            if entry is not None:
                entry.history.append(report)
            raise SwapRejected(report["stage"], str(e)) from e
        # -- atomic flip: one attribute assignment ---------------------------
        n = (entry.n_deploys if entry is not None else 0) + 1
        ver = version if version is not None else f"v{n}"
        new = _ModelVersion(rt, packed, ver, path)
        with self._lock:
            if entry is None:
                entry = _ModelEntry(name=name, stats=stats, active=new)
                self._entries[name] = entry
            else:
                entry.previous = entry.active
                entry.active = new
            entry.n_deploys = n
        # the stats object survives the swap; point its compile-cache
        # view at the ACTIVE runtime (PredictorRuntime.__init__ attached
        # the new one already — this is documentation of that fact)
        report.update(ok=True, stage="flipped", version=ver,
                      duration_s=self.clock() - t0)
        entry.history.append(report)
        return report

    def rollback(self, name: str) -> dict:
        """Flip back to the previous resident version (instant: its
        runtime and compiled programs never went away)."""
        with self._lock:
            entry = self._entry(name)
            if entry.previous is None:
                raise SwapRejected(
                    "rollback",
                    f"model {name!r} has no previous version")
            entry.active, entry.previous = entry.previous, entry.active
            entry.stats.attach_cache(entry.active.runtime.cache_info)
        report = {"model": name, "ok": True, "stage": "rolled_back",
                  "version": entry.active.version,
                  "previous_version": entry.previous.version}
        entry.history.append(report)
        return report

    def undeploy(self, name: str) -> None:
        with self._lock:
            self._entry(name)
            del self._entries[name]

    # -- deploy internals ----------------------------------------------------
    def _ingest(self, source):
        if isinstance(source, PackedForest):
            return source.validate(), None
        path = str(source)
        if self.faults is not None:
            try:
                self.faults.check("artifact_load")
            except FaultError as e:
                raise SwapRejected("ingest", str(e)) from e
        return PackedForest.load(path), path       # validates on ingest

    def _warm(self, rt: PredictorRuntime, warm, warm_buckets,
              raw_score: bool, t0: float) -> int:
        do_warm = self.warm_on_deploy if warm is None else bool(warm)
        stall_s = (self.faults.check("compile")
                   if self.faults is not None else 0.0)
        warmed = 0
        if do_warm or warm_buckets is not None:
            warmed = rt.warm(raw_score=raw_score, buckets=warm_buckets)
        elapsed = (self.clock() - t0) + stall_s
        if (self.compile_timeout_s is not None
                and elapsed > self.compile_timeout_s):
            raise SwapRejected(
                "warm", f"compile stalled: {elapsed * 1e3:.0f} ms > "
                f"timeout {self.compile_timeout_s * 1e3:.0f} ms")
        return warmed

    def _canary(self, rt: PredictorRuntime, packed: PackedForest,
                raw_score: bool, canary_X) -> dict:
        """A small batch through the NEW runtime, cross-checked against
        the forest's numpy oracle before any traffic sees it.

        Two gates for quantized runtimes: (1) device vs the DEQUANTIZED
        oracle (``rt.oracle`` — same leaf values the device widens to)
        at the usual ``canary_tol``, catching real device/arithmetic
        divergence unmasked by quantization error; (2) device vs the
        EXACT f32 oracle at ``canary_tol + rt.quant_error_bound`` — the
        arithmetic worst-case of the shrink, never looser: a forest
        whose quantization drift exceeds its own proven bound is
        corrupt, not imprecise.
        """
        if self.canary_rows == 0 and canary_X is None:
            return {"rows": 0, "skipped": True}
        if canary_X is None:
            nf = packed.num_feature()
            # deterministic spread across the binned range: the exact
            # values don't matter, agreement device-vs-oracle does
            base = np.linspace(-2.0, 2.0, self.canary_rows,
                               dtype=np.float64)
            canary_X = np.tile(base[:, None], (1, nf))
        canary_X = np.asarray(canary_X, np.float64)
        try:
            got = rt.predict(canary_X, raw_score=raw_score)
        except FaultError as e:
            raise SwapRejected("canary", f"device fault: {e}") from e
        codes = packed.bin_mapper.transform(canary_X)
        want = rt.oracle.predict_numpy(codes, raw_score=raw_score)
        if not np.all(np.isfinite(got)):
            raise SwapRejected("canary", "non-finite canary predictions")
        got64 = np.asarray(got, np.float64)
        err = float(np.max(np.abs(got64 - np.asarray(want, np.float64))))
        if err > self.canary_tol:
            raise SwapRejected(
                "canary", f"device-vs-oracle drift {err:.3e} > "
                f"tol {self.canary_tol:.1e}")
        report = {"rows": int(canary_X.shape[0]), "max_abs_err": err}
        if rt.forest_precision != "f32":
            exact = packed.predict_numpy(codes, raw_score=raw_score)
            qerr = float(np.max(np.abs(got64
                                       - np.asarray(exact, np.float64))))
            # the bound holds on RAW margins; transformed outputs only
            # contract (sigmoid/softmax Lipschitz < 1), so the raw bound
            # is a valid (conservative) gate either way
            qtol = self.canary_tol + rt.quant_error_bound
            if qerr > qtol:
                raise SwapRejected(
                    "canary", f"quantization drift {qerr:.3e} exceeds "
                    f"its own arithmetic bound {qtol:.3e} — artifact "
                    "or quantizer corrupt")
            report["quant_abs_err"] = qerr
            report["quant_error_bound"] = rt.quant_error_bound
        return report

    # -- reporting -----------------------------------------------------------
    def snapshot(self) -> dict:
        out = {"models": {}, "bucket_ladder": {
            "max_bucket": self.max_bucket,
            "max_cache_entries": self.max_cache_entries},
            "persistent_cache": bool(self.persistent_cache)}
        for name in self.names():
            e = self._entries[name]
            out["models"][name] = {
                "version": e.active.version,
                "previous_version": (e.previous.version
                                     if e.previous else None),
                "deploys": e.n_deploys,
                "swap_history": list(e.history),
                "stats": e.stats.snapshot(),
            }
        if self.faults is not None:
            out["faults"] = self.faults.snapshot()
        return out

    # -- warm manifest (restart-warm path) -----------------------------------
    def save_warm_manifest(self, path: str) -> str:
        """Record the live models + their bucket programs, so a restarted
        process can rebuild exactly the warm state."""
        models = []
        for name in self.names():
            e = self._entries[name]
            rt = e.active.runtime
            models.append({
                "name": name,
                "path": e.active.path,
                "version": e.active.version,
                "buckets": sorted({k[0] for k in rt._cache}),
                "raw_score": sorted({k[1] for k in rt._cache}),
            })
        payload = {"format_version": WARM_MANIFEST_VERSION,
                   "cache_dir": self.cache_dir, "models": models}
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
            f.write("\n")
        return path

    def restore_warm_manifest(self, path: str) -> dict:
        """Re-deploy + re-warm every manifest model that was saved from
        a file path.  Returns {"models": n, "compiled": n, "skipped":
        [names]} — skipped entries had no artifact path to reload."""
        with open(path) as f:
            payload = json.load(f)
        if int(payload.get("format_version", -1)) > WARM_MANIFEST_VERSION:
            raise ValueError(
                f"{path}: warm manifest v{payload['format_version']} is "
                f"newer than supported v{WARM_MANIFEST_VERSION}")
        n_models = compiled = 0
        skipped = []
        for m in payload.get("models", []):
            if not m.get("path"):
                skipped.append(m.get("name", "?"))
                continue
            buckets = m.get("buckets") or None
            raw_scores = m.get("raw_score") or [False]
            rep = self.deploy(m["name"], m["path"],
                              version=m.get("version"),
                              warm=bool(buckets), warm_buckets=buckets,
                              raw_score=bool(raw_scores[0]))
            rt = self.runtime(m["name"])
            for rs in raw_scores[1:]:
                rt.warm(raw_score=bool(rs), buckets=buckets)
            n_models += 1
            compiled += rep.get("warmed", 0)
        return {"models": n_models, "compiled": compiled,
                "skipped": skipped}
