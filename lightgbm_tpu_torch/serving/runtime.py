"""PredictorRuntime — batch inference over a PackedForest on one device.

The port of ``lightgbm_tpu/serving/runtime.py`` on its ``single`` route.
The runtime:

* bins raw rows on the edge (host numpy) with the packed bin bounds — the
  same ``BinMapper`` search the trainer used;
* rounds every batch UP to a power-of-two bucket and pads with masked rows,
  and streams batches larger than ``max_bucket`` through in full-bucket
  chunks;
* keeps one dispatch program per key ``(bucket, raw_score, route)`` in a
  bounded LRU with the reference's ``cache_info()`` counters.  PyTorch runs
  eagerly, so a program is a Python closure over the resident tables and
  "building" one compiles nothing; ``warm()`` still runs every program of
  the ladder once, which also builds the kernel library on first use;
* keeps the forest resident on the device: every non-categorical forest is
  packed per class into ``ops.predict.ForestSoA`` tables in the compact
  storage dtypes of its ``forest_precision`` (f32 | bf16 | int8), and a
  dispatch is ONE launch of the forest-predict kernel per class
  (``kernel_launches_per_dispatch``).  Categorical forests take the legacy
  plain-PyTorch traversal over a widened ``Tree`` (``fused_predict`` is
  False there), with the same external semantics;
* exposes ``oracle``, a lazily built numpy PackedForest carrying the
  dequantized leaf values (the canary's and the queue fallback's
  reference), and ``quant_error_bound``, the worst-case |quantized - exact|
  served margin.

The runtime runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no card it raises.  On the CPU the same dispatch
programs call the kernel's plain PyTorch version.  Multi-device serving
(``mesh_devices > 1``) is a later slice and raises here.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quantize import (FOREST_PRECISIONS, packed_model_bytes,
                            quantize_forest, to_device_tree, widen_tree)
from .packed import PackedForest
from .stats import ServingStats

DEFAULT_MAX_BUCKET = 1 << 14          # 16384-row dispatches
DEFAULT_CACHE_ENTRIES = 12
SHARD_POLICIES = ("auto", "dp", "tp")


def bucket_for(n: int, max_bucket: int) -> int:
    """Smallest power-of-two >= n, capped at max_bucket."""
    if n <= 1:
        return 1
    return min(1 << (int(n - 1).bit_length()), max_bucket)


def enable_persistent_cache(cache_dir: str) -> bool:
    """No-op kept for the reference's API: the port compiles no program per
    bucket (its one kernel library is cached under ``build/kernels``), so
    there is no compilation cache to point anywhere.  Returns False."""
    del cache_dir
    return False


class PredictorRuntime:
    """Serve a packed forest at fixed bucket shapes on one device.

    Args:
      packed: a validated PackedForest (``PackedForest.load`` validates).
      max_bucket: largest single-dispatch row count (power of two);
        bigger batches are chunked.
      max_cache_entries: LRU bound on live dispatch programs.
      donate: accepted for the reference's API and ignored: the port
        stages each batch in a fresh device tensor, so there is nothing to
        donate.
      faults: optional FaultInjector consulted at the ``device_predict``
        site before every dispatch.
      mesh_devices: must be 1; multi-device serving is a later slice.
      shard_policy: ``auto`` | ``dp`` | ``tp``, validated and otherwise
        ignored: only the ``single`` route exists on one device.
      forest_precision: ``f32`` | ``bf16`` | ``int8`` resident forest.
        Raises ``ops.quantize.ThresholdBoundError`` when a structural field
        cannot be narrowed EXACTLY.
      device: ``"cuda"`` (the default, ``None``) or ``"cpu"``.
    """

    def __init__(self, packed: PackedForest,
                 max_bucket: int = DEFAULT_MAX_BUCKET,
                 max_cache_entries: int = DEFAULT_CACHE_ENTRIES,
                 donate: Optional[bool] = None,
                 stats: Optional[ServingStats] = None,
                 faults=None,
                 mesh_devices: int = 1,
                 shard_policy: str = "auto",
                 forest_precision: str = "f32",
                 clock=time.perf_counter,
                 device=None):
        if max_bucket < 1 or (max_bucket & (max_bucket - 1)):
            raise ValueError(f"max_bucket must be a power of two, got "
                             f"{max_bucket}")
        if shard_policy not in SHARD_POLICIES:
            raise ValueError(f"shard_policy must be one of "
                             f"{SHARD_POLICIES}, got {shard_policy!r}")
        if forest_precision not in FOREST_PRECISIONS:
            raise ValueError(f"forest_precision must be one of "
                             f"{FOREST_PRECISIONS}, got "
                             f"{forest_precision!r}")
        if int(mesh_devices) != 1:
            raise ValueError(
                f"mesh_devices={mesh_devices}: multi-device serving is not "
                "ported yet (a later slice of the port); use mesh_devices=1")
        self.device = resolve_device(device)
        self.packed = packed
        self.max_bucket = int(max_bucket)
        self.max_cache_entries = int(max_cache_entries)
        self.stats = stats if stats is not None else ServingStats()
        self.faults = faults
        self.clock = clock
        self.forest_precision = forest_precision
        del donate                      # no buffer donation in the port
        # the SoA kernel is the default device path; categorical subset
        # splits keep the legacy traversal (the SoA has no cat-mask table)
        self.fused_predict = packed.is_cat_split is None
        self._q = None
        if forest_precision == "f32":
            self.quant_error_bound = 0.0
        else:
            self._q = quantize_forest(
                packed.split_feature, packed.split_bin, packed.left,
                packed.right, packed.leaf_value, packed.is_leaf,
                forest_precision, is_cat_split=packed.is_cat_split,
                cat_mask=packed.cat_mask)
            # served margins scale the raw tree sum by shrink
            self.quant_error_bound = (self._q.error_bound
                                      * abs(packed.shrink))
        self._oracle = None
        self._oracle_lock = threading.Lock()
        self._forest = None
        self._leaf_scale = None
        self._soa = None                # per-class ForestSoA (kernel path)
        if self.fused_predict:
            self._soa = self._build_soa()
        elif forest_precision == "f32":
            self._forest = packed.to_tree(self.device)
        else:
            self._forest, self._leaf_scale = to_device_tree(self._q,
                                                            self.device)
        self.forest_nbytes = packed_model_bytes(
            packed.num_trees, packed.capacity, packed.num_class,
            forest_precision)
        # forest-predict kernel launches per dispatch (per class; 0 on
        # the legacy path) — mirrored into every record_dispatch
        self.kernel_launches_per_dispatch = (
            packed.num_class if self.fused_predict else 0)
        self._obj = packed._objective()
        self._cache: "OrderedDict[tuple, object]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.num_compiles = 0                      # lifetime program builds
        self.warmed_buckets = 0                    # programs run by warm()
        self.warmed_keys: set = set()   # full (bucket, raw, route) keys
        self.buckets = [1 << i
                        for i in range(self.max_bucket.bit_length())]
        self.stats.attach_cache(self.cache_info)

    @property
    def oracle(self) -> PackedForest:
        """Numpy reference forest for the canary gates and the queue's
        graceful-degradation fallback, built lazily on first access: a
        quantized runtime's f32 leaf table exists only here, never in
        device memory."""
        if self._oracle is None:
            with self._oracle_lock:
                if self._oracle is None:
                    self._oracle = (
                        self.packed if self._q is None
                        else dataclasses.replace(
                            self.packed,
                            leaf_value=self._q.dequantized_leaf_values()))
        return self._oracle

    def _build_soa(self):
        """Per-class ``ForestSoA`` tables on the device, in the compact
        storage dtypes of the runtime's precision."""
        from ..ops.predict import pack_forest_soa

        p, q = self.packed, self._q
        nc = p.num_class
        soas = []
        for c in range(nc):
            ci = c if nc > 1 else None
            if q is None:
                pick = (lambda a: np.asarray(a)) if ci is None else (
                    lambda a: np.asarray(a)[:, ci])
                feat, thr = pick(p.split_feature), pick(p.split_bin)
                left, right = pick(p.left), pick(p.right)
                leaf, isl = (pick(p.leaf_value).astype(np.float32),
                             pick(p.is_leaf))
                scale = None
            else:
                feat, thr, left, right, leaf, isl, scale = \
                    q.class_arrays(ci)
            soas.append(pack_forest_soa(
                feat, thr, left, right, leaf, isl,
                precision=self.forest_precision, leaf_scale=scale,
                device=self.device))
        return soas

    # -- public API ----------------------------------------------------------
    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        """Predict on RAW features (binned on the edge, then dispatched)."""
        from ..dataset import _to_2d_float_array

        X = _to_2d_float_array(data)
        codes = self.packed.bin_mapper.transform(X)
        return self.predict_binned(codes, num_iteration=num_iteration,
                                   raw_score=raw_score)

    def predict_binned(self, codes: np.ndarray,
                       num_iteration: Optional[int] = None,
                       raw_score: bool = False) -> np.ndarray:
        """Predict on pre-binned codes (integer ``[n, F]``, values in
        ``[0, 255]``)."""
        k = self.packed._resolve_k(num_iteration)
        codes = _as_codes(codes)
        n = codes.shape[0]
        if n == 0:
            width = (self.packed.num_class,) if self.packed.num_class > 1 \
                else ()
            return np.zeros((0,) + width, np.float32)
        outs = []
        for lo in range(0, n, self.max_bucket):
            outs.append(self._dispatch(codes[lo:lo + self.max_bucket], k,
                                       raw_score))
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def cache_info(self) -> dict:
        with self._cache_lock:
            keys = list(self._cache)
        return {
            "entries": len(keys),
            "max_entries": self.max_cache_entries,
            "num_compiles": self.num_compiles,
            "warmed_buckets": self.warmed_buckets,
            "buckets_live": sorted({k[0] for k in keys}),
            "mesh_devices": 1,
            "forest_precision": self.forest_precision,
            "shard_programs": sum(1 for k in keys if k[2] != "single"),
            "routes_live": sorted({k[2] for k in keys}),
            "fused_path": bool(self.fused_predict),
            "kernel_launches_per_dispatch":
                self.kernel_launches_per_dispatch,
            "warmed_keys": len(self.warmed_keys),
        }

    def route_for(self, bucket: int) -> str:
        """The dispatch route of a bucket: ``single`` on one device."""
        del bucket
        return "single"

    def warm(self, raw_score: bool = False, buckets=None) -> int:
        """Run every bucket program of the ladder once before traffic.

        Dispatches one fully-masked all-zeros uint8 batch per bucket over
        the full key ``(bucket, raw_score, route)`` and records the keys in
        ``warmed_keys``.  When the ladder exceeds the LRU bound only the
        LARGEST ``max_cache_entries`` buckets are warmed.  Returns the
        number of programs built.
        """
        todo = list(buckets) if buckets is not None else list(self.buckets)
        if len(todo) > self.max_cache_entries:
            todo = todo[-self.max_cache_entries:]
        bundler = getattr(self.packed.bin_mapper, "bundler", None)
        n_cols = (bundler.num_columns if bundler is not None
                  else self.packed.num_feature())
        before = self.num_compiles
        for b in todo:
            key = (b, bool(raw_score), self.route_for(b))
            fn = self._get_fn(*key)
            fn(torch.zeros((b, n_cols), dtype=torch.uint8,
                           device=self.device),
               torch.zeros(b, dtype=torch.float32, device=self.device), 1)
            self.warmed_keys.add(key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmed_buckets += len(todo)
        return self.num_compiles - before

    # -- internals -----------------------------------------------------------
    def _dispatch(self, codes: np.ndarray, k: int,
                  raw_score: bool) -> np.ndarray:
        if self.faults is not None:
            self.faults.check("device_predict")   # may raise FaultError
        t0 = self.clock()
        n = codes.shape[0]
        bucket = bucket_for(n, self.max_bucket)
        pad = bucket - n
        if pad:
            codes = np.concatenate(
                [codes, np.zeros((pad, codes.shape[1]), codes.dtype)])
        route = self.route_for(bucket)
        fn = self._get_fn(bucket, raw_score, route)
        bins = torch.from_numpy(codes).to(self.device)
        mask = (torch.arange(bucket, device=self.device) < n).to(
            torch.float32)
        out = fn(bins, mask, k)[:n].cpu().numpy()   # waits for the device
        self.stats.record_dispatch(
            bucket, rows=n, padded=pad,
            latency_s=self.clock() - t0, route=route,
            kernel_launches=self.kernel_launches_per_dispatch,
            fused=self.fused_predict)
        return out

    def _get_fn(self, bucket: int, raw_score: bool,
                route: str = "single"):
        key = (bucket, bool(raw_score), route)
        with self._cache_lock:
            fn = self._cache.get(key)
            hit = fn is not None
            if hit:
                self._cache.move_to_end(key)
            else:
                fn = self._build_fn(raw_score)
                self.num_compiles += 1
                self._cache[key] = fn
                while len(self._cache) > self.max_cache_entries:
                    self._cache.popitem(last=False)        # evict LRU
        self.stats.record_cache(bucket, hit=hit)
        return fn

    def _build_fn(self, raw_score: bool):
        """One dispatch program over the resident tables.

        ``num_it`` is an argument, so every staged-prediction variant
        shares the program.  Padded rows are valid bin codes (zeros) that
        traverse normally; the row mask zeroes their outputs after the
        transform.  On the kernel path the body is ONE forest-predict
        launch per class; categorical forests take the legacy traversal,
        which widens quantized tables per dispatch.
        """
        from ..ops.predict import (map_node_arrays, predict_forest,
                                   predict_forest_binned)

        packed = self.packed
        quantized = self.forest_precision != "f32"
        nc = packed.num_class
        shrink = float(packed.shrink)
        inits = np.asarray(packed.init_score, np.float32)
        inits_t = torch.as_tensor(inits, device=self.device)
        depth_cap = packed.depth_cap
        is_rf = packed.params.get("boosting") == "rf"
        obj = self._obj

        def finalize(raw, mask, num_it):
            if is_rf:
                if nc > 1:
                    raw = ((raw - inits_t[None, :]) / max(num_it, 1)
                           + inits_t[None, :])
                else:
                    raw = (raw - inits_t[0]) / max(num_it, 1) + inits_t[0]
            out = raw if raw_score else obj.transform(raw)
            return out * (mask[:, None] if nc > 1 else mask)

        if self.fused_predict:
            soas = self._soa

            def fn(bins, mask, num_it):
                cols = [predict_forest(soas[c], bins, shrink,
                                       float(inits[c]), num_it, depth_cap)
                        for c in range(nc)]
                raw = torch.stack(cols, dim=1) if nc > 1 else cols[0]
                return finalize(raw, mask, num_it)
        else:
            forest, leaf_scale = self._forest, self._leaf_scale

            def fn(bins, mask, num_it):
                f = widen_tree(forest, leaf_scale) if quantized else forest
                if nc > 1:
                    cols = [predict_forest_binned(
                        map_node_arrays(f, lambda a, c=c: a[:, c]), bins, shrink, float(inits[c]),
                        num_it, depth_cap) for c in range(nc)]
                    raw = torch.stack(cols, dim=1)
                else:
                    raw = predict_forest_binned(
                        f, bins, shrink, float(inits[0]), num_it, depth_cap)
                return finalize(raw, mask, num_it)

        return fn


def _as_codes(codes) -> np.ndarray:
    """Bin codes as a C-contiguous uint8 ``[n, F]`` array (the dtype the
    edge transform produces and the kernel reads)."""
    codes = np.asarray(codes)
    if codes.dtype != np.uint8:
        if codes.size and (codes.min() < 0 or codes.max() > 255):
            raise ValueError("bin codes must lie in [0, 255]")
        codes = codes.astype(np.uint8)
    return np.ascontiguousarray(codes)
