"""Per-phase profiling counters — the port of ``lightgbm_tpu/utils/profiling.py``.

The reference's only instrumentation is ``system.time`` wall clocks
(r/gridsearchCV.R:57,70); LightGBM's C++ has internal chrono counters around
bin construction / histogram / split / partition.  A round on the card is a
chain of kernel launches and plain ops, so ``profile_training`` times each
phase as its own call on the actual data (same shapes, same dtypes, same
kernels: B1 for the histogram pass, B1 and B2 in the tree), plus whole
rounds through ``Booster.update_many``, and reports rows/s.

Timing on the card is by CUDA events around each call, the median of three
calls after a first one that is left out (it pays the kernels' build and
the allocator's warm-up); on the CPU it is ``time.perf_counter``.

``torch.profiler`` integration: pass ``trace_dir`` to wrap the timed rounds
in ``torch.profiler.profile`` and export a Chrome trace there.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional

import torch

TIMED_CALLS = 3


def _elapsed_s(fn: Callable[[], Any], device: torch.device) -> float:
    """Seconds of one call: CUDA events on the card (host launch time and
    the device tail included), ``perf_counter`` on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _timeit(fn: Callable[[], Any], device: torch.device,
            reps: int = TIMED_CALLS) -> float:
    """Median seconds per call, the first call left out."""
    _elapsed_s(fn, device)
    times = sorted(_elapsed_s(fn, device) for _ in range(reps))
    return times[len(times) // 2]


def profile_training(params: Dict[str, Any], X, y,
                     num_boost_round: int = 20,
                     trace_dir: Optional[str] = None,
                     device=None) -> Dict[str, Any]:
    """Phase breakdown + throughput for one training configuration.

    Returns a dict with seconds per phase (one call each, timed by CUDA
    events on the card):
      bin_construct   host-side quantile binning of X (one-time cost)
      histogram_pass  one (grad,hess,count) histogram over all rows
      split_scan      one full split-gain scan over (segments,features,bins)
      partition       one row->leaf partition update
      tree_grow       one full tree (all split iterations or waves)
      round           one boosting round (a fresh Booster, one update)
      train_total     num_boost_round rounds via update_many
      rows_per_s      training throughput over train_total
    ``device`` None is the card.
    """
    from ..config import parse_params
    from ..dataset import Dataset
    from ..device import resolve_device
    from ..models.gbdt import (Booster, HyperScalars, resolve_hist_dtype,
                               resolve_wave_width)
    from ..models.tree import decode_wave_width, grow_tree
    from ..ops.histogram import compute_histograms
    from ..ops.split import find_best_split

    dev = resolve_device(device)
    report: Dict[str, Any] = {}

    t0 = time.perf_counter()
    ds = Dataset(X, label=y, device=dev)
    ds.construct()
    report["bin_construct_s"] = time.perf_counter() - t0

    p = parse_params(params)
    n_pad = int(ds.row_mask.shape[0])
    hd = resolve_hist_dtype(p, n_pad)
    ww = resolve_wave_width(p, n_pad)
    hyper = HyperScalars.from_params(p)
    impl = p.extra.get("hist_impl", "auto")
    stats = torch.stack([ds.y, torch.ones_like(ds.y), ds.row_mask], dim=-1)
    # real rows -> segment 0; padding -> out-of-range (contributes nothing)
    seg = torch.where(ds.row_mask > 0.5, 0, 2).to(torch.int32)
    bins = ds.X_binned
    num_bins = ds.num_bins

    def hist_pass():
        return compute_histograms(bins, stats, seg, 2, num_bins, impl, hd)

    report["histogram_pass_s"] = _timeit(hist_pass, dev)

    hist = hist_pass()
    fmask = torch.ones(ds.num_feature_, dtype=torch.float32, device=dev)
    seg_fmask = fmask.expand(hist.shape[0], -1)
    report["split_scan_s"] = _timeit(
        lambda: find_best_split(hist, hyper.ctx(), seg_fmask), dev)

    col = bins[:, 0].to(torch.int32)
    row_leaf = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    report["partition_s"] = _timeit(
        lambda: torch.where(row_leaf == 0, torch.where(col <= 17, 1, 2),
                            row_leaf), dev)

    report["tree_grow_s"] = _timeit(
        lambda: grow_tree(bins, stats, fmask, hyper.ctx(), p.num_leaves,
                          num_bins, p.max_depth, hist_impl=impl,
                          hist_dtype=hd, wave_width=ww), dev)

    def train_rounds(k):
        b = Booster(p.copy(), ds)
        b.update_many(k)
        return b

    prof = None
    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    train_rounds(1)                      # the build and warm-up call
    report["round_s"] = _elapsed_s(lambda: train_rounds(1), dev)
    report["train_total_s"] = _elapsed_s(
        lambda: train_rounds(num_boost_round), dev)
    if prof is not None:
        prof.__exit__(None, None, None)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, "profile_training.trace.json"))

    report["num_boost_round"] = num_boost_round
    report["rows"] = ds.num_data_
    report["rows_per_s"] = ds.num_data_ * num_boost_round / \
        report["train_total_s"]
    # "f32x" is the internal explicit-f32 routing token — report the
    # user-facing name
    report["hist_dtype"] = "f32" if hd == "f32x" else hd
    # the tail policy rides in the encoding of the static width — surface
    # it as named fields, not the raw encoded int
    w_dec, tail, over = decode_wave_width(ww)
    report["wave_width"] = w_dec
    report["wave_tail"] = tail
    if over is not None:
        report["wave_overgrow_leaves"] = over
    return report
