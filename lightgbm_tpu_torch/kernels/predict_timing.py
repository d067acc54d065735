"""Time B4, the forest-predict kernel (``csrc/predict_forest.cu``), on the
card, and the serving path's host time around it.

    python3 lightgbm_tpu_torch/kernels/predict_timing.py [--package DIR]
        [--set NAME=VALUE ...] [--forests NAME,...] [--no-serving]

On seed-made leaf-wise forests (``_timing.make_forest``: ragged trees,
dead-slot garbage, a single-leaf tree) over 28 columns of 255 bins: the
north-star forest (100 trees x 127 leaves), a 1,000-tree forest of 127
leaves (the tuned ``gridsearch_cv`` refit's size), three trees of 8,191
leaves (16,384 node slots) and 10 trees of 127 leaves (the trained models
``chip_smoke.py`` serves: ten rounds, one tree a class), at f32, bf16 and
int8, at buckets 1, 128, 1,024 and 16,384 of seed-made uniform codes.  Per
case: whether the kernel equals ``forest_sums_plain`` bit for bit and the
output's digest, the node visits (internal nodes on the rows' paths), the
device ms per launch (CUDA events, median of 11 runs of 5 launches queued
behind a spin kernel), the byte bound (the bins and the output once, and
8 bytes for each node record the rows' paths read and 4 for each leaf
value a cut walk reads, at 3.35 TB/s; ``_timing.walk_counts``), the walk
bound (visits x 2 lane loads / 32 lanes, one warp-wide load per clock on
each SM, at the card's ``clocks.max.sm``) and the device microseconds of
each kernel and copy of one launch (``torch.profiler``, mean over 5
launches).  ``--forests`` names the forests to time (all four by default).

Unless ``--no-serving``, per precision on the north-star forest: the host
ms per ``forest_sums`` call at buckets 1, 128 and 16,384 over 200 calls,
up to the last call's return and up to one synchronise after it, the
microseconds of a cached node-table lookup
(where the version has one), and a ``MicroBatcher`` (``max_batch=128``,
``max_delay_ms=2``) over a ``PredictorRuntime`` answering 4,096 single-row
requests submitted and pumped one by one, as ``chip_smoke.py`` phase 3
does: queue latency p50/p99 and the 128-row dispatches' latency p50/p99.

``--package DIR`` times the ``lightgbm_tpu_torch`` under ``DIR`` instead of
this checkout's (to compare two versions in one call, unpack the other into
an ignored directory and run both in turns: old, new, new, old); a version
that refuses a forest records the error.  ``--set NAME=VALUE`` overrides a
constant of the plan in ``kernels/predict.py`` (an integer) for a variant.
Prints the card's name and power limit and one ``RESULT`` JSON line.
Needs a CUDA card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
import timeit

import numpy as np
import torch

if __package__:
    from . import _timing as T
else:                   # run as a file: this directory is on sys.path
    import _timing as T

MAX_BIN = 255
NUM_FEATURES = 28
BUCKETS = (1, 128, 1024, 16384)
PRECISIONS = ("f32", "bf16", "int8")
FORESTS = {"north_star": (100, 127), "trees_1000": (1000, 127),
           "leaves_8191": (3, 8191), "trees_10": (10, 127)}


def host_ms(fn, runs=200):
    """Host wall ms per call of ``runs`` calls: up to the last call's
    return (the wrapper's own time while the card keeps up with the queue)
    and up to the synchronise after it (as ``chip_smoke.py`` phase 4's
    ``kernel_host_ms``)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / runs * 1e3, (t2 - t0) / runs * 1e3


def serving(kp, dev):
    """Host time around B4 on the north-star forest and a MicroBatcher's
    latencies over 4,096 single-row requests, per precision."""
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.serving import (MicroBatcher, PredictorRuntime,
                                            packed_from_arrays)
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    trees, leaves = FORESTS["north_star"]
    X, _ = make_higgs_like(50_000, NUM_FEATURES, seed=0)
    mapper = BinMapper.fit(X, max_bin=MAX_BIN)
    arrays = T.make_forest(11 + leaves + trees, trees, leaves, mapper.n_bins)
    meta = {"shrink": 0.1, "init_score": [0.0], "num_class": 1,
            "best_iteration": -1,
            "params": {"objective": "binary", "num_leaves": leaves},
            "bin_mapper": mapper.to_dict()}
    packed = packed_from_arrays(arrays, meta)
    codes = torch.from_numpy(mapper.transform(X[:max(BUCKETS)])).to(dev)
    out = {}
    for prec in PRECISIONS:
        rt = PredictorRuntime(packed, max_bucket=max(BUCKETS), device=dev,
                              forest_precision=prec)
        rt.warm()
        soa, depth = rt._soa[0], packed.depth_cap
        row = {}
        for b in (1, 128, max(BUCKETS)):
            bins = codes[:b].contiguous()
            row[f"wrapper_ms_{b}"], row[f"kernel_host_ms_{b}"] = host_ms(
                lambda: kp.forest_sums(soa, bins, 0, trees, depth))
        if hasattr(kp, "node_tables"):
            kp.node_tables(soa)
            row["node_tables_us"] = timeit.timeit(
                lambda: kp.node_tables(soa), number=10_000) / 10_000 * 1e6
        batcher = MicroBatcher(rt, max_batch=128, max_delay_ms=2.0)
        pend = []
        for r in X[:4096]:
            pend.append(batcher.submit(r))
            batcher.pump()
        batcher.flush()
        for p in pend:
            p.result()
        snap = rt.stats.snapshot()
        b128 = [b for b in snap["buckets"] if b["bucket"] == 128][0]
        row.update(queue_latency_p50_ms=snap["queue_latency_p50_ms"],
                   queue_latency_p99_ms=snap["queue_latency_p99_ms"],
                   dispatch_128_p50_ms=b128["latency_p50_ms"],
                   dispatch_128_p99_ms=b128["latency_p99_ms"],
                   dispatches=snap["batched_dispatches"])
        out[prec] = row
        print("serving", prec, json.dumps(row), flush=True)
    return out


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--set", action="append", default=[])
    ap.add_argument("--forests", default=",".join(FORESTS))
    ap.add_argument("--no-serving", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("predict_timing: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    from lightgbm_tpu_torch.kernels import predict as kp
    from lightgbm_tpu_torch.ops.predict import forest_sums_plain

    if not kp.__file__.startswith(root):
        raise SystemExit(f"imported {kp.__file__}, not the package under "
                         f"{root}")
    for item in args.set:
        name, value = item.split("=")
        if not hasattr(kp, name):
            raise SystemExit(f"kernels/predict.py has no {name}")
        setattr(kp, name, int(value))
    if hasattr(kp, "plan"):
        kp.plan.cache_clear()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = float(smi("clocks.max.sm").splitlines()[0])
    out = {"package": root, "set": args.set, "sms": sms,
           "clock_max_sm_mhz": clock, "cases": {}}
    rng = np.random.default_rng(7)
    all_bins = torch.from_numpy(rng.integers(
        0, MAX_BIN, (max(BUCKETS), NUM_FEATURES)).astype(np.uint8)).to(dev)
    col_bins = np.full(NUM_FEATURES, MAX_BIN)
    forests = {k: FORESTS[k] for k in args.forests.split(",")}
    for fname, (trees, leaves) in forests.items():
        arrays = T.make_forest(11 + leaves + trees, trees, leaves, col_bins)
        depth = T.depth_cap_of(arrays)
        for prec in PRECISIONS:
            soa = T.soa_for(arrays, prec, dev)
            for b in BUCKETS:
                bins = all_bins[:b].contiguous()
                key = f"{fname}_{prec}_{b}"
                call = (lambda: kp.forest_sums(soa, bins, 0, trees, depth))
                want = forest_sums_plain(soa, bins, trees, depth)
                visits, records, cut = T.walk_counts(soa, bins, depth, trees)
                row = {"forest": fname, "precision": prec, "bucket": b,
                       "trees": trees, "leaves": leaves, "depth_cap": depth,
                       "node_visits": visits, "records_read": records,
                       "cut_leaves_read": cut,
                       "byte_bound_ms": T.byte_bound_ms(b, NUM_FEATURES,
                                                        records, cut),
                       "walk_bound_ms": T.walk_bound_ms(visits, sms, clock)}
                try:
                    got = call()
                    torch.cuda.synchronize()
                except (ValueError, RuntimeError) as e:
                    row["refused"] = f"{type(e).__name__}: {e}"
                    out["cases"][key] = row
                    print(key, json.dumps(row), flush=True)
                    continue
                if hasattr(kp, "plan"):
                    row["plan"] = kp.plan(NUM_FEATURES,
                                          soa.split_feature.shape[1],
                                          trees, b)._asdict()
                row.update(
                    equal=bool(torch.equal(got, want)),
                    sha=hashlib.sha256(got.cpu().numpy().tobytes())
                    .hexdigest()[:16],
                    ms=T.device_ms(call),
                    device_us=T.device_us_by_kernel(call))
                out["cases"][key] = row
                print(key, f"{row['ms']:.4f} ms", "equal" if row["equal"]
                      else "DIFFERS", flush=True)
    if not args.no_serving:
        out["serving"] = serving(kp, dev)
    print("RESULT", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
