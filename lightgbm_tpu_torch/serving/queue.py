"""Micro-batching front end — the port of ``lightgbm_tpu/serving/queue.py``.

Serving traffic arrives one request at a time, but the device wants full
buckets.  The MicroBatcher accumulates requests until ``max_batch`` are
waiting or the oldest has waited ``max_delay_ms``, then coalesces them into
ONE runtime dispatch and fans the results back out to the per-request
handles.

* **No wall-clock dependence** — the time source is injectable
  (``clock=``); ``pump()`` is the explicit scheduler step.
* **Per-request deadlines** — a request older than its ``timeout_ms`` is
  expired with :class:`RequestTimeout`; expiry is heap-ordered, so a flush
  costs O(log n) per request that actually expired.
* **Admission control** — ``max_queue_depth`` bounds the live queue and the
  ``deadline`` shed policy rejects requests whose predicted wait (batches
  ahead x an EWMA of dispatch times) exceeds their deadline, with a typed
  :class:`Overloaded` at submit time: shed before miss.
* **Graceful degradation** — when the batched device dispatch raises, the
  batch falls back to the numpy predictor (``PackedForest.predict_numpy``)
  per request and ``ServingStats.fallbacks`` counts it.  A run that must
  prove the device served every request asserts that count is 0.  A
  kernel that fails to build or launch (:class:`~..kernels.KernelError`)
  is not degraded around: the batch's requests fail with it and it
  propagates out of ``pump()``/``flush()``, so a broken kernel cannot be
  hidden behind host answers.
* **Hot swap** — ``runtime`` may be a zero-arg callable (a ModelBank
  resolver), re-resolved at every dispatch.

Dispatches run on the thread that calls ``pump()``/``flush()``, so the
kernel launches on that thread's current CUDA stream.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from ..kernels import KernelError

SHED_POLICIES = ("off", "depth", "deadline")


class RequestTimeout(Exception):
    """The request expired in the queue before a dispatch picked it up."""


class Overloaded(Exception):
    """Admission control rejected the request at submit time (queue full
    or predicted to miss its deadline before a dispatch reaches it)."""


class PendingPrediction:
    """Handle for one submitted row; filled in by a later pump()."""

    __slots__ = ("value", "error", "done")

    def __init__(self):
        self.value = None
        self.error: Optional[Exception] = None
        self.done = False

    def result(self):
        if not self.done:
            raise RuntimeError(
                "prediction not ready — drive MicroBatcher.pump()/flush()")
        if self.error is not None:
            raise self.error
        return self.value

    def _set(self, value=None, error: Optional[Exception] = None) -> None:
        self.value = value
        self.error = error
        self.done = True


_QUEUED, _TAKEN, _EXPIRED = 0, 1, 2


class _QueuedRequest:
    __slots__ = ("row", "pending", "enqueued_at", "deadline",
                 "num_iteration", "state")

    def __init__(self, row, pending, enqueued_at, deadline, num_iteration):
        self.row = row
        self.pending = pending
        self.enqueued_at = enqueued_at
        self.deadline = deadline          # absolute clock time or None
        self.num_iteration = num_iteration
        self.state = _QUEUED


class MicroBatcher:
    """Coalesce rows into bucket-sized runtime dispatches.

    Args:
      runtime: a PredictorRuntime, or a zero-arg callable returning the
        current one (re-resolved per dispatch; the hot-swap hook).
      max_batch: dispatch as soon as this many requests are queued.
      max_delay_ms: dispatch once the OLDEST queued request has waited
        this long, even if the batch is short.
      timeout_ms: default per-request deadline (None = no deadline).
      clock: monotonic time source, injectable for tests.
      raw_score: serve raw scores instead of transformed predictions.
      fallback_unbatched: on device-dispatch error, retry each request
        through the numpy predictor instead of failing the batch (never
        for a :class:`KernelError`, which propagates).
      max_queue_depth: bound on live queued requests; submissions beyond
        it are shed with :class:`Overloaded` (None = unbounded).
      shed_policy: "off" (admit everything), "depth" (depth bound only),
        or "deadline" (depth bound + predicted-miss shedding; default).
      service_time_hint_ms: seed for the dispatch-time EWMA the deadline
        policy predicts with; without it the model stays inactive until
        the first measured dispatch.
    """

    def __init__(self, runtime, max_batch: int = 128,
                 max_delay_ms: float = 5.0,
                 timeout_ms: Optional[float] = None,
                 clock=time.monotonic,
                 raw_score: bool = False,
                 fallback_unbatched: bool = True,
                 max_queue_depth: Optional[int] = None,
                 shed_policy: str = "deadline",
                 service_time_hint_ms: Optional[float] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES},"
                             f" got {shed_policy!r}")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (or None)")
        self._runtime_src = runtime
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.timeout_ms = timeout_ms
        self.clock = clock
        self.raw_score = bool(raw_score)
        self.fallback_unbatched = bool(fallback_unbatched)
        self.max_queue_depth = (None if max_queue_depth is None
                                else int(max_queue_depth))
        self.shed_policy = shed_policy
        self._ewma_dispatch_s = (0.0 if service_time_hint_ms is None
                                 else float(service_time_hint_ms) / 1e3)
        self.stats = self.runtime.stats
        # RLock: pump()/flush() hold it across the helpers below, and
        # each helper re-enters so every queue mutation is lock-guarded
        # even when the embedder calls a helper path directly
        self._lock = threading.RLock()
        self._q: "deque[_QueuedRequest]" = deque()
        self._exp_heap: list = []            # (deadline, seq, request)
        self._seq = itertools.count()
        self._live = 0                       # requests in state _QUEUED

    @property
    def runtime(self):
        rt = self._runtime_src
        return rt() if callable(rt) else rt

    # -- submission ----------------------------------------------------------
    def submit(self, row, timeout_ms: Optional[float] = None,
               num_iteration: Optional[int] = None) -> PendingPrediction:
        """Queue one feature row; returns its handle (resolved by pump).

        Sheds (handle resolved with :class:`Overloaded`) instead of
        queuing when admission control predicts the request cannot be
        served: queue at ``max_queue_depth``, or — under the
        ``deadline`` policy — predicted queue wait past its deadline.
        """
        row = np.asarray(row, np.float64).reshape(-1)
        nf = self.runtime.packed.num_feature()
        pending = PendingPrediction()
        if row.shape[0] != nf:
            pending._set(error=ValueError(
                f"row has {row.shape[0]} features, model expects {nf}"))
            return pending
        now = self.clock()
        tmo = self.timeout_ms if timeout_ms is None else timeout_ms
        deadline = None if tmo is None else now + float(tmo) / 1e3
        self.stats.record_request()
        with self._lock:
            shed_why = self._admission_check(now, deadline)
            if shed_why is not None:
                pending._set(error=Overloaded(shed_why))
                self.stats.record_shed()
                return pending
            req = _QueuedRequest(row, pending, now, deadline,
                                 num_iteration)
            self._q.append(req)
            self._live += 1
            if deadline is not None:
                heapq.heappush(self._exp_heap,
                               (deadline, next(self._seq), req))
        return pending

    def _admission_check(self, now: float,
                         deadline: Optional[float]) -> Optional[str]:
        """None = admit; otherwise the Overloaded reason."""
        if self.shed_policy == "off":
            return None
        if (self.max_queue_depth is not None
                and self._live >= self.max_queue_depth):
            return (f"queue full: {self._live} live requests >= "
                    f"max_queue_depth={self.max_queue_depth}")
        if (self.shed_policy == "deadline" and deadline is not None
                and self._ewma_dispatch_s > 0.0):
            wait = self.predicted_wait_s()
            if now + wait > deadline:
                return (f"predicted queue wait {wait * 1e3:.1f} ms "
                        f"exceeds deadline "
                        f"{(deadline - now) * 1e3:.1f} ms away")
        return None

    def predicted_wait_s(self) -> float:
        """Modeled time until a newly admitted request is dispatched:
        full batches ahead of it (plus its own) at the EWMA dispatch
        time, plus the coalescing delay when its batch won't be full."""
        if self._ewma_dispatch_s <= 0.0:
            return 0.0
        batches = self._live // self.max_batch + 1
        fill_wait = (0.0 if (self._live + 1) >= self.max_batch
                     else self.max_delay_s)
        return batches * self._ewma_dispatch_s + fill_wait

    def pending_count(self) -> int:
        return self._live

    # -- scheduling ----------------------------------------------------------
    def pump(self) -> int:
        """One scheduler step: expire overdue requests, dispatch due
        batches.  Returns the number of batches dispatched."""
        now = self.clock()
        with self._lock:
            self._expire(now)
            dispatched = 0
            # full batches always go, regardless of delay
            while self._live >= self.max_batch:
                self._dispatch(self._take(self.max_batch), now)
                dispatched += 1
            # short batch goes once the oldest request has waited long
            # enough
            self._drop_settled_head()
            if self._q and (now - self._q[0].enqueued_at) >= \
                    self.max_delay_s:
                self._dispatch(self._take(self._live), now)
                dispatched += 1
        return dispatched

    def flush(self) -> int:
        """Dispatch everything still queued (shutdown / end-of-stream)."""
        now = self.clock()
        with self._lock:
            self._expire(now)
            dispatched = 0
            while self._live:
                self._dispatch(
                    self._take(min(self._live, self.max_batch)), now)
                dispatched += 1
            self._q.clear()
            self._exp_heap.clear()
        return dispatched

    # -- internals -----------------------------------------------------------
    def _take(self, k: int):
        out = []
        with self._lock:
            while self._q and len(out) < k:
                r = self._q.popleft()
                if r.state == _QUEUED:
                    r.state = _TAKEN
                    self._live -= 1
                    out.append(r)
        return out

    def _drop_settled_head(self) -> None:
        # expired/taken tombstones at the head are dead; each is popped
        # at most once over its lifetime
        with self._lock:
            while self._q and self._q[0].state != _QUEUED:
                self._q.popleft()

    def _expire(self, now: float) -> None:
        # heap-ordered eviction: pop only the requests whose deadline has
        # actually passed — bounded per flush by the expired count, not
        # the queue length
        expired = 0
        with self._lock:
            while self._exp_heap and self._exp_heap[0][0] < now:
                _, _, r = heapq.heappop(self._exp_heap)
                if r.state != _QUEUED:
                    continue                   # already dispatched
                r.state = _EXPIRED
                self._live -= 1
                r.pending._set(error=RequestTimeout(
                    f"request expired after "
                    f"{(now - r.enqueued_at) * 1e3:.1f} ms in queue"))
                expired += 1
        if expired:
            self.stats.record_timeout(expired)

    def _dispatch(self, batch, now: float) -> None:
        if not batch:
            return
        runtime = self.runtime            # resolve once per dispatch —
        # the atomic hot-swap point for queued traffic
        t0 = self.clock()
        # requests sharing a truncation setting coalesce; mixed settings
        # split into sub-batches (rare — serving traffic is homogeneous)
        by_k = {}
        for r in batch:
            by_k.setdefault(r.num_iteration, []).append(r)
        for num_it, group in by_k.items():
            X = np.stack([r.row for r in group])
            self.stats.record_batch(
                queue_latency_s=max(0.0, now - group[0].enqueued_at))
            try:
                preds = runtime.predict(X, num_iteration=num_it,
                                        raw_score=self.raw_score)
            except KernelError as e:
                # a defect, not a transient fault: fail the whole batch
                # and raise rather than answer on the host
                for r in batch:
                    if not r.pending.done:
                        r.pending._set(error=e)
                raise
            except Exception:
                self._fallback(runtime, group, num_it)
                continue
            for i, r in enumerate(group):
                r.pending._set(value=preds[i])
        dt = self.clock() - t0
        if dt > 0.0:
            # EWMA of dispatch time feeds the deadline shed predictor;
            # measured through the injectable clock so mocked-clock tests
            # (dt == 0) keep the model inactive
            with self._lock:
                self._ewma_dispatch_s = (
                    dt if self._ewma_dispatch_s <= 0.0
                    else 0.7 * self._ewma_dispatch_s + 0.3 * dt)

    def _fallback(self, runtime, group, num_it) -> None:
        """Device dispatch failed: unbatched numpy predict per request.

        Uses the runtime's ``oracle`` forest (dequantized leaf values
        for int8/bf16 runtimes), so degraded-mode answers match what the
        device would have produced instead of silently reverting to the
        exact f32 model mid-incident.  ``oracle`` is a lazily built,
        cached property: the f32 leaf table materializes on the FIRST
        fallback (or canary) and only then — swaps that never degrade
        never pay it.
        """
        if not self.fallback_unbatched:
            for r in group:
                r.pending._set(error=RuntimeError(
                    "batched device dispatch failed and fallback is "
                    "disabled"))
            return
        packed = getattr(runtime, "oracle", None) or runtime.packed
        mapper = packed.bin_mapper
        self.stats.record_fallback(len(group))
        for r in group:
            try:
                codes = mapper.transform(r.row[None, :])
                out = packed.predict_numpy(codes, num_iteration=num_it,
                                           raw_score=self.raw_score)
                r.pending._set(value=out[0])
            except Exception as e:               # noqa: BLE001
                r.pending._set(error=e)
