"""PredictorRuntime — batch inference over a PackedForest.

The port of ``lightgbm_tpu/serving/runtime.py``.  The runtime:

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

With ``mesh_devices > 1`` the dispatches shard over a serving mesh
(:mod:`.mesh`): the route (``single`` | ``dp`` | ``tp``, chosen per bucket
by ``mesh.choose_route``) is the third component of the program key, and
``warm()`` runs the route each bucket resolves to.  dp splits the bucket's
rows over the shards (bit-identical to single); tp gives each shard a slice
of the padded forest's trees (one kernel launch per shard and class) and
``psum``s the partial margins.  The shards' tree slices are built once per
runtime and kept, so the kernel's node tables are built once per slice.

The runtime runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; with no card it raises.  On the CPU the same dispatch
programs call the kernel's plain PyTorch version.
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
from .mesh import SHARD_POLICIES, ServingMesh, choose_route
from .packed import PackedForest
from .stats import ServingStats

DEFAULT_MAX_BUCKET = 1 << 14          # 16384-row dispatches
DEFAULT_CACHE_ENTRIES = 12


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
    """Serve a packed forest at fixed bucket shapes.

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
      mesh_devices: shard dispatches over this many devices (a power of
        two; 1 = the single route).  The devices are the visible CUDA
        devices, or virtual shards on ``device`` under
        ``parallel.set_virtual_devices``.
      shard_policy: ``auto`` | ``dp`` | ``tp`` — see
        :func:`.mesh.choose_route`.
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
        self.device = resolve_device(device)
        self.shard_policy = shard_policy
        self.mesh = (ServingMesh(mesh_devices, base=self.device)
                     if int(mesh_devices) > 1 else None)
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
        self._dp_tables = None          # built once: per-shard tables
        self._tp_padded = None          # built once: [(tree, scale)], t/D
        self._tp_soa = None             # built once: [shard][class], t/D
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
            "mesh_devices": self.mesh.devices if self.mesh else 1,
            "forest_precision": self.forest_precision,
            "shard_programs": sum(1 for k in keys if k[2] != "single"),
            "routes_live": sorted({k[2] for k in keys}),
            "fused_path": bool(self.fused_predict),
            "kernel_launches_per_dispatch":
                self.kernel_launches_per_dispatch,
            "warmed_keys": len(self.warmed_keys),
        }

    def route_for(self, bucket: int) -> str:
        """The dispatch route this bucket resolves to — deterministic, and
        shared by ``_dispatch`` and ``warm()``."""
        if self.mesh is None:
            return "single"
        return choose_route(self.shard_policy, bucket,
                            self.packed.num_trees, self.mesh.devices)

    def warm(self, raw_score: bool = False, buckets=None) -> int:
        """Run every bucket program of the ladder once before traffic.

        Dispatches one fully-masked all-zeros uint8 batch per bucket over
        the full key ``(bucket, raw_score, route)`` — the route the
        chooser resolves the bucket to, so with a mesh the shard programs
        (and the shards' node tables) are built here, not on the first
        request — and records the keys in ``warmed_keys``.  When the ladder exceeds the LRU bound only the
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
                fn = self._build_fn(raw_score, route)
                self.num_compiles += 1
                self._cache[key] = fn
                while len(self._cache) > self.max_cache_entries:
                    self._cache.popitem(last=False)        # evict LRU
        self.stats.record_cache(bucket, hit=hit)
        return fn

    def _tp_parts(self):
        """Each shard's slice of the tree-padded stacked ``Tree`` (legacy
        route) and ``trees_per_device``, built once and shared by every tp
        program."""
        if self._tp_padded is None:
            from .mesh import pad_forest_for_tp, shard_forest

            forest, scale, t_loc = pad_forest_for_tp(
                self._forest, self._leaf_scale, self.mesh.devices)
            self._tp_padded = (shard_forest(self.mesh, forest, scale, t_loc),
                               t_loc)
        return self._tp_padded

    def _tp_soa_parts(self):
        """Each shard's slice of every per-class SoA, padded to a multiple
        of (tree chunk x devices), and ``trees_per_device``: built once
        and kept for the runtime's life, so the kernel's node tables of a
        slice are built once (on the first tp dispatch or in ``warm()``)."""
        if self._tp_soa is None:
            from .mesh import pad_soa_for_tp, shard_soas

            padded = [pad_soa_for_tp(s, self.mesh.devices)
                      for s in self._soa]
            t_loc = padded[0][1]
            self._tp_soa = (shard_soas(self.mesh, [p[0] for p in padded],
                                       t_loc), t_loc)
        return self._tp_soa

    def _build_fn(self, raw_score: bool, route: str = "single"):
        """One dispatch program over the resident tables.

        ``num_it`` is an argument, so every staged-prediction variant
        shares the program.  Padded rows are valid bin codes (zeros) that
        traverse normally; the row mask zeroes their outputs after the
        transform.  On the kernel path the body is ONE forest-predict
        launch per class; categorical forests take the legacy traversal,
        which widens quantized tables per dispatch.

        Routes (:mod:`.mesh`): ``single`` is that body; ``dp`` runs the
        same body on each shard's rows (bit-identical outputs); ``tp``
        sums each shard's tree slice, ``psum``s the tree sums and applies
        the learning rate and init (as the single route does), the rf
        adjust, the transform and the mask to the sum.
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
            init = inits_t.to(raw.device)
            if is_rf:
                if nc > 1:
                    raw = ((raw - init[None, :]) / max(num_it, 1)
                           + init[None, :])
                else:
                    raw = (raw - init[0]) / max(num_it, 1) + init[0]
            out = raw if raw_score else obj.transform(raw)
            return out * (mask[:, None] if nc > 1 else mask)

        if route == "tp":
            from .mesh import tp_raw_margins, tp_raw_margins_fused

            if self.fused_predict:
                shards, t_loc = self._tp_soa_parts()
                sum_fn = tp_raw_margins_fused(self.mesh, shards, t_loc,
                                              depth_cap, nc)
            else:
                shards, t_loc = self._tp_parts()
                sum_fn = tp_raw_margins(self.mesh, shards, t_loc, depth_cap,
                                        nc, widen=quantized)

            def fn(bins, mask, num_it):
                # the single route's init + shrink * sum, on the psum
                raw = (inits_t[None, :] if nc > 1 else inits_t[0]) \
                    + shrink * sum_fn(bins, num_it)
                return finalize(raw, mask, num_it)

            return fn

        def body(soas, forest, leaf_scale):
            """The single-route program over tables on one device."""
            if soas is not None:
                def fn(bins, mask, num_it):
                    cols = [predict_forest(soas[c], bins, shrink,
                                           float(inits[c]), num_it,
                                           depth_cap) for c in range(nc)]
                    raw = torch.stack(cols, dim=1) if nc > 1 else cols[0]
                    return finalize(raw, mask, num_it)
                return fn

            def fn(bins, mask, num_it):
                f = widen_tree(forest, leaf_scale) if quantized else forest
                if nc > 1:
                    cols = [predict_forest_binned(
                        map_node_arrays(f, lambda a, c=c: a[:, c]), bins,
                        shrink, float(inits[c]), num_it, depth_cap)
                        for c in range(nc)]
                    raw = torch.stack(cols, dim=1)
                else:
                    raw = predict_forest_binned(
                        f, bins, shrink, float(inits[0]), num_it, depth_cap)
                return finalize(raw, mask, num_it)
            return fn

        if route == "dp":
            from .mesh import dp_shard

            return dp_shard(self.mesh, [body(*t) for t in self._dp_parts()])
        return body(self._soa, self._forest, self._leaf_scale)

    def _dp_parts(self):
        """The resident tables on every shard's device, ``[(soas, forest,
        leaf_scale)]``, built once (``Tensor.to`` moves nothing for a
        shard on the runtime's own device)."""
        if self._dp_tables is None:
            from ..parallel.mesh import place_tables

            def on(dev):
                soas = None if self._soa is None else [
                    place_tables(s, dev, host=("is_leaf",))
                    for s in self._soa]
                forest = (None if self._forest is None
                          else place_tables(self._forest, dev))
                scale = (None if self._leaf_scale is None
                         else self._leaf_scale.to(dev))
                return soas, forest, scale

            self._dp_tables = [on(dev) for dev in self.mesh.mesh.devices]
        return self._dp_tables


def _as_codes(codes) -> np.ndarray:
    """Bin codes as a C-contiguous uint8 ``[n, F]`` array (the dtype the
    edge transform produces and the kernel reads)."""
    codes = np.asarray(codes)
    if codes.dtype != np.uint8:
        if codes.size and (codes.min() < 0 or codes.max() > 255):
            raise ValueError("bin codes must lie in [0, 255]")
        codes = codes.astype(np.uint8)
    return np.ascontiguousarray(codes)
