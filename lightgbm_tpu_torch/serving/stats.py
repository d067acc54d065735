"""Serving counters — the port of ``lightgbm_tpu/serving/stats.py``.

Per-bucket traffic, dispatch-cache, padding and latency counters, kept free
of torch and of the runtime so the queue, the runtime and the CLI all write
into one ServingStats, and a snapshot is a plain JSON-able dict with the
reference's keys.  ``predict_kernel_launches`` and ``fused_path.dispatches``
mean on the card what they mean in the reference: launches of the forest
predict kernel (one per class per dispatch) and dispatches on that path.

Latency quantiles come from a bounded per-bucket reservoir (last
``RESERVOIR`` dispatch latencies).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

RESERVOIR = 2048


def _quantile(values, q: float) -> Optional[float]:
    if not values:
        return None
    s = sorted(values)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return float(s[idx])


class _BucketStats:
    __slots__ = ("rows", "dispatches", "cache_hits", "cache_misses",
                 "padded_rows", "latencies")

    def __init__(self):
        self.rows = 0               # real (unpadded) rows served
        self.dispatches = 0         # device program invocations
        self.cache_hits = 0         # dispatch-program LRU hits
        self.cache_misses = 0       # LRU misses (each one is a build)
        self.padded_rows = 0        # wasted rows from bucket rounding
        self.latencies = deque(maxlen=RESERVOIR)

    def snapshot(self, bucket: int) -> dict:
        total = self.rows + self.padded_rows
        return {
            "bucket": bucket,
            "rows": self.rows,
            "dispatches": self.dispatches,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "padded_rows": self.padded_rows,
            "padding_waste": (self.padded_rows / total if total else 0.0),
            "latency_p50_ms": _ms(_quantile(self.latencies, 0.50)),
            "latency_p99_ms": _ms(_quantile(self.latencies, 0.99)),
        }


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else v * 1e3


class ServingStats:
    """Aggregates serving counters; all methods are cheap and allocation-
    light (hot-path safe).  Safe under concurrent writers: every mutation
    and the snapshot hold one internal lock, so the load generator's and
    the drain path's snapshots are consistent even when the runtime, the
    queue, and a stats poller live on different threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: Dict[int, _BucketStats] = {}
        self.requests = 0            # queue-level submitted requests
        self.batched_dispatches = 0  # queue-level coalesced dispatches
        self.timeouts = 0            # requests expired before dispatch
        self.sheds = 0               # admission-control Overloaded rejects
        self.fallbacks = 0           # graceful-degradation numpy predicts
        self.route_dispatches: Dict[str, int] = {}  # single/dp/tp counts
        # forest-predict kernel counters, counted per dispatch
        self.predict_kernel_launches = 0  # kernel launches (1/class)
        self.fused_dispatches = 0    # dispatches on the fused device path
        self.legacy_dispatches = 0   # dispatches on the legacy path
        self.queue_latencies = deque(maxlen=RESERVOIR)
        self._cache_info = None      # zero-arg callable set by the runtime

    def attach_cache(self, provider) -> None:
        """Register a zero-arg callable returning compile-cache counters;
        its dict lands under ``compile_cache`` in every snapshot (keeps
        this module free of the runtime while the serve CLI still prints
        ONE shutdown dict).  A hot swap re-attaches the new runtime's
        provider to the same ServingStats, so per-model counters persist
        across versions while the cache view tracks the active one."""
        with self._lock:
            self._cache_info = provider

    def _b(self, bucket: int) -> _BucketStats:
        bs = self._buckets.get(bucket)
        if bs is None:
            bs = self._buckets[bucket] = _BucketStats()
        return bs

    # -- runtime-side ------------------------------------------------------
    def record_dispatch(self, bucket: int, rows: int, padded: int,
                        latency_s: float, route: str = "single",
                        kernel_launches: int = 0,
                        fused: bool = False) -> None:
        with self._lock:
            bs = self._b(bucket)
            bs.rows += rows
            bs.dispatches += 1
            bs.padded_rows += padded
            bs.latencies.append(latency_s)
            self.route_dispatches[route] = \
                self.route_dispatches.get(route, 0) + 1
            self.predict_kernel_launches += kernel_launches
            if fused:
                self.fused_dispatches += 1
            else:
                self.legacy_dispatches += 1

    def record_cache(self, bucket: int, hit: bool) -> None:
        with self._lock:
            bs = self._b(bucket)
            if hit:
                bs.cache_hits += 1
            else:
                bs.cache_misses += 1

    # -- queue-side --------------------------------------------------------
    def record_request(self, n: int = 1) -> None:
        with self._lock:
            self.requests += n

    def record_batch(self, queue_latency_s: float) -> None:
        with self._lock:
            self.batched_dispatches += 1
            self.queue_latencies.append(queue_latency_s)

    def record_timeout(self, n: int = 1) -> None:
        with self._lock:
            self.timeouts += n

    def record_shed(self, n: int = 1) -> None:
        with self._lock:
            self.sheds += n

    def record_fallback(self, n: int = 1) -> None:
        with self._lock:
            self.fallbacks += n

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "requests": self.requests,
                "batched_dispatches": self.batched_dispatches,
                "timeouts": self.timeouts,
                "sheds": self.sheds,
                "fallbacks": self.fallbacks,
                "route_dispatches": dict(self.route_dispatches),
                "predict_kernel_launches": self.predict_kernel_launches,
                "fused_path": {
                    "dispatches": self.fused_dispatches,
                    "legacy_dispatches": self.legacy_dispatches,
                },
                "queue_latency_p50_ms": _ms(_quantile(self.queue_latencies,
                                                      0.50)),
                "queue_latency_p99_ms": _ms(_quantile(self.queue_latencies,
                                                      0.99)),
                "buckets": [self._buckets[b].snapshot(b)
                            for b in sorted(self._buckets)],
            }
            provider = self._cache_info
        # outside the lock: the provider reads runtime-side counters and
        # must not nest under ours
        if provider is not None:
            out["compile_cache"] = provider()
        return out
