"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero (and prints no result line)
without them, or when any check fails.  It drives the port only
(``lightgbm_tpu_torch``) and imports nothing of JAX or ``lightgbm_tpu``.

Phases:

1. the card's name and power limit, torch/CUDA versions, and the build of
   every kernel from ``lightgbm_tpu_torch/csrc`` (nvcc's ptxas report);
2. each kernel against its plain PyTorch version on the card, on the same
   inputs (rtol 1e-5, atol 1e-6; exactly on a dyadic-leaf forest): the
   forest-predict kernel at f32, bf16 and int8 over a full-width forest
   (100 trees x 127 leaves, 28 columns, 255 bins, ragged leaf-wise trees
   with dead-slot garbage and a single-leaf tree) and awkward shapes,
   among them rows of 256, 257 and 2,000 columns (codes staged in shared
   memory up to 256 columns, read from global memory past that);
3. the main path, once per forest precision, with every launch counter set
   to 0 just before and read just after: bin ``make_higgs_like`` rows with
   ``BinMapper.fit``, save a seed-made full-width forest to ``.npz``,
   ``ModelBank.deploy`` it by path with warm and canary, serve 4,096
   single-row requests through ``MicroBatcher`` and one 1,000,000-row
   ``PredictorRuntime.predict`` (16,384-row chunks), check answers against
   ``PackedForest.predict_numpy`` on a sample, assert that no dispatch fell
   back or took the legacy path, and ``!swap``/``!rollback`` through the
   CLI's ``_serve`` on in-memory streams;
4. each kernel against its plain version once more on the main path's own
   tables and binned ``make_higgs_like`` rows, at the buckets the main path
   launches (128 from the batcher, 16,384 from batch scoring); then times
   on the card (CUDA events, median of 25 runs of 10 back-to-back launches
   queued behind a spin kernel) of each kernel and its plain version at
   every bucket of the ladder, with the kernel's bound; the whole table
   goes to ``build/chip_smoke/chip_smoke_report.json``.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

SEED = 20261016
RTOL, ATOL = 1e-5, 1e-6
PRECISIONS = ("f32", "bf16", "int8")
NUM_TREES, NUM_LEAVES, NUM_FEATURES, MAX_BIN = 100, 127, 28, 255
LEARNING_RATE = 0.1
CAPACITY = 2 * NUM_LEAVES - 1
BIG_ROWS, SINGLE_REQUESTS, MAX_BUCKET = 1_000_000, 4096, 1 << 14
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# the f32 rate outside the tensor cores, the closest listed rate for the
# kernel's integer compares and f32 multiply-adds
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12
# spin cycles that keep the card busy while the host enqueues timed calls
SPIN_CYCLES = 20_000_000
KERNEL_SOURCE = "lightgbm_tpu_torch/csrc/predict_forest.cu"
REPLACES = "lightgbm_tpu/ops/predict.py:257"


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# seed-made forests
# ---------------------------------------------------------------------------
def grow_tree(rng, n_leaves, capacity, col_bins, leaf_fn):
    """One leaf-wise tree: split a random open leaf until ``n_leaves``;
    children take the next two ids, as the grower's do.  Dead slots keep
    the grower's sentinels plus garbage values that must never leak."""
    feat = np.zeros(capacity, np.int32)
    thr = np.zeros(capacity, np.int32)
    left = -np.ones(capacity, np.int32)
    right = -np.ones(capacity, np.int32)
    leaf = rng.normal(size=capacity).astype(np.float32)   # internal garbage
    is_leaf = np.zeros(capacity, bool)
    open_leaves, n_nodes = [0], 1
    while len(open_leaves) < n_leaves and n_nodes + 2 <= capacity:
        i = open_leaves.pop(int(rng.integers(len(open_leaves))))
        f = int(rng.integers(len(col_bins)))
        feat[i] = f
        thr[i] = int(rng.integers(0, max(int(col_bins[f]) - 1, 1)))
        left[i], right[i] = n_nodes, n_nodes + 1
        open_leaves += [n_nodes, n_nodes + 1]
        n_nodes += 2
    for i in open_leaves:
        is_leaf[i] = True
        leaf[i] = leaf_fn()
    leaf[n_nodes:] = 777.0
    return feat, thr, left, right, leaf, is_leaf


def make_forest(seed, num_trees, num_leaves, col_bins, leaf_fn=None):
    """Stacked node arrays of a ragged forest: most trees full-width, some
    stopped early (dead slots), one single-leaf tree."""
    rng = np.random.default_rng(seed)
    leaf_fn = leaf_fn or (lambda: np.float32(rng.normal(0.0, 0.5)))
    cap = 2 * num_leaves - 1
    trees = []
    for t in range(num_trees):
        n = num_leaves
        if t == num_trees // 2:
            n = 1
        elif rng.random() < 0.2:
            n = int(rng.integers(2, num_leaves))
        trees.append(grow_tree(rng, n, cap, col_bins, leaf_fn))
    names = ("split_feature", "split_bin", "left", "right", "leaf_value",
             "is_leaf")
    return {k: np.stack(v) for k, v in zip(names, zip(*trees))}


def soa_for(arrays, precision, device):
    from lightgbm_tpu_torch.ops.predict import pack_forest_soa
    from lightgbm_tpu_torch.ops.quantize import quantize_forest

    a = arrays
    if precision == "f32":
        return pack_forest_soa(a["split_feature"], a["split_bin"], a["left"],
                               a["right"], a["leaf_value"], a["is_leaf"],
                               precision="f32", device=device)
    q = quantize_forest(a["split_feature"], a["split_bin"], a["left"],
                        a["right"], a["leaf_value"], a["is_leaf"], precision)
    feat, thr, left, right, leaf, isl, scale = q.class_arrays(None)
    return pack_forest_soa(feat, thr, left, right, leaf, isl,
                           precision=precision, leaf_scale=scale,
                           device=device)


def depth_cap_of(arrays):
    from types import SimpleNamespace

    from lightgbm_tpu_torch.ops.predict import forest_depth_cap

    return forest_depth_cap(SimpleNamespace(left=arrays["left"],
                                            right=arrays["right"]))


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    from lightgbm_tpu_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build(["predict_forest"])
    log(f"kernel build: {json.dumps(secs)} "
        f"(wall {time.perf_counter() - t0:.2f} s)")
    for name, text in build.BUILD_LOG.items():
        log(f"--- nvcc {name} ---\n{text.strip()}")
    return card, secs


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version on the card
# ---------------------------------------------------------------------------
def compare(soa, bins, lr, init, num_it, depth, start, exact, what):
    from lightgbm_tpu_torch.ops.predict import (predict_forest,
                                                predict_forest_plain)

    got = predict_forest(soa, bins, lr, init, num_it, depth, start)
    want = predict_forest_plain(soa, bins, lr, init, num_it, depth, start)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if exact:
        check(torch.equal(got, want), f"{what}: not exact (max err {err})")
    else:
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{what}: max abs err {err} beyond rtol {RTOL} atol {ATOL}")
    return err


def phase_kernel_vs_plain(dev):
    rng = np.random.default_rng(SEED)
    col_bins = np.full(NUM_FEATURES, MAX_BIN)
    errs = {p: 0.0 for p in PRECISIONS}
    full = make_forest(SEED + 1, NUM_TREES, NUM_LEAVES, col_bins)
    odd = make_forest(SEED + 2, 37, 31, col_bins)          # T % chunk != 0
    k = np.random.default_rng(SEED + 3)
    # dyadic leaves k/128 with |k| <= 127, one |k| = 127 leaf per tree, so
    # the int8 scale is exactly 1/128: every sum is exact in f32
    dyadic = make_forest(SEED + 3, 64, NUM_LEAVES, col_bins,
                         leaf_fn=lambda: np.float32(
                             k.integers(-127, 128) / 128.0))
    isl = dyadic["is_leaf"]
    first = np.argmax(isl, axis=1)
    dyadic["leaf_value"][np.arange(isl.shape[0]), first] = 127.0 / 128.0
    # rows wider than the kernel stages in shared memory (256 columns)
    wide = {f: make_forest(SEED + f, 24, 31, np.full(f, MAX_BIN))
            for f in (256, 257, 2000)}
    cases = [("full", full, NUM_FEATURES, [2048, 3001, 127, 1]),
             ("odd-trees", odd, NUM_FEATURES, [3001, 129]),
             ("dyadic", dyadic, NUM_FEATURES, [4096, 3001])] + [
                 (f"wide-{f}", arrays, f, [300])
                 for f, arrays in wide.items()]
    for prec in PRECISIONS:
        for name, arrays, f, ns in cases:
            soa = soa_for(arrays, prec, dev)
            depth = depth_cap_of(arrays)
            t = arrays["leaf_value"].shape[0]
            for n in ns:
                bins = torch.from_numpy(rng.integers(
                    0, MAX_BIN, (n, f)).astype(np.uint8)).to(dev)
                windows = [(t, 0), (t // 3, 0), (t // 2, t // 4), (1, t - 1),
                           (t + 50, 0), (5, t + 3)]
                for num_it, start in windows:
                    what = f"{prec} {name} n={n} window=({num_it},{start})"
                    e = compare(soa, bins, LEARNING_RATE, 0.25, num_it, depth,
                                start, name == "dyadic", what)
                    errs[prec] = max(errs[prec], e)
            # a depth cap below the forest's depth cuts every walk alike
            bins = torch.from_numpy(rng.integers(
                0, MAX_BIN, (513, f)).astype(np.uint8)).to(dev)
            errs[prec] = max(errs[prec], compare(
                soa, bins, LEARNING_RATE, 0.0, t, max(depth // 2, 1), 0,
                name == "dyadic", f"{prec} {name} short depth cap"))
        log(f"phase 2 {prec}: kernel == plain version over "
            f"{len(cases)} forests (max abs err {errs[prec]:.3e})")
    return errs


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def build_model(workdir):
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.serving import packed_from_arrays
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    t0 = time.perf_counter()
    X, y = make_higgs_like(BIG_ROWS, NUM_FEATURES, seed=0)
    mapper = BinMapper.fit(X, max_bin=MAX_BIN)
    arrays = make_forest(SEED + 10, NUM_TREES, NUM_LEAVES, mapper.n_bins)
    pbar = float(np.mean(y))
    meta = {"shrink": LEARNING_RATE,
            "init_score": [float(np.log(pbar / (1.0 - pbar)))],
            "num_class": 1, "best_iteration": -1,
            "params": {"objective": "binary", "num_leaves": NUM_LEAVES,
                       "learning_rate": LEARNING_RATE, "max_bin": MAX_BIN,
                       "num_iterations": NUM_TREES},
            "bin_mapper": mapper.to_dict()}
    packed = packed_from_arrays(arrays, meta)
    path = os.path.join(workdir, "higgs_forest.npz")
    packed.save(path)
    # a second artifact for !swap: same shape, other leaf values
    arrays2 = dict(arrays, leaf_value=arrays["leaf_value"] * 0.5)
    path2 = os.path.join(workdir, "higgs_forest_v2.npz")
    packed_from_arrays(arrays2, meta).save(path2)
    log(f"model: {NUM_TREES} trees x {NUM_LEAVES} leaves (capacity "
        f"{CAPACITY}), {NUM_FEATURES} features, {MAX_BIN} bins, depth cap "
        f"{packed.depth_cap}; data {BIG_ROWS} rows "
        f"({time.perf_counter() - t0:.1f} s to make and bin)")
    return X, path, path2


def serve_cli(path, path2, precision, rows):
    from lightgbm_tpu_torch.__main__ import _serve

    lines = [",".join(f"{v:.6f}" for v in r) for r in rows[:3]]
    text = "\n".join(lines + [f"!swap {path2}"] + lines + ["!rollback"]
                     + lines + ["!stats"]) + "\n"
    out, err = io.StringIO(), io.StringIO()
    rc = _serve(path, {"forest_precision": precision, "max_batch": "1",
                       "canary_rows": "8"},
                stdin=io.StringIO(text), stdout=out, stderr=err)
    check(rc == 0, f"_serve exit {rc}")
    preds = [float(v) for v in out.getvalue().split()]
    log_text = err.getvalue()
    check(len(preds) == 9 and all(np.isfinite(preds)),
          f"_serve answered {out.getvalue()!r}")
    check("swapped default -> v2" in log_text, f"no swap ack: {log_text!r}")
    check("rolled back default -> v1" in log_text,
          f"no rollback ack: {log_text!r}")
    check(np.allclose(preds[:3], preds[6:], rtol=0, atol=0),
          "rollback did not restore the first version's answers")
    check(not np.allclose(preds[:3], preds[3:6]),
          "swap did not change the answers")


def phase_main_path(precision, X, path, path2):
    from lightgbm_tpu_torch.kernels.predict import PREDICT_FOREST_LAUNCHES
    from lightgbm_tpu_torch.serving import ModelBank

    PREDICT_FOREST_LAUNCHES.reset()
    t0 = time.perf_counter()
    bank = ModelBank(max_bucket=MAX_BUCKET, warm_on_deploy=True,
                     canary_rows=64, forest_precision=precision)
    rep = bank.deploy("higgs", path)
    check(rep["ok"], f"deploy failed: {rep}")
    t_deploy = time.perf_counter() - t0
    rt = bank.runtime("higgs")
    check(str(rt.device).startswith("cuda"), f"runtime on {rt.device}")

    batcher = bank.batcher("higgs", max_batch=128, max_delay_ms=2.0)
    single = X[:SINGLE_REQUESTS]
    t0 = time.perf_counter()
    pend = []
    for row in single:
        pend.append(batcher.submit(row))
        batcher.pump()
    batcher.flush()
    t_single = time.perf_counter() - t0
    single_out = np.array([p.result() for p in pend], np.float32)

    t0 = time.perf_counter()
    rt.packed.bin_mapper.transform(X)
    t_bin = time.perf_counter() - t0
    t0 = time.perf_counter()
    big_out = rt.predict(X)
    t_big = time.perf_counter() - t0
    launches = PREDICT_FOREST_LAUNCHES.count

    stats = rt.stats.snapshot()
    check(stats["fallbacks"] == 0, f"fallbacks {stats['fallbacks']}")
    check(stats["fused_path"]["legacy_dispatches"] == 0,
          f"legacy dispatches {stats['fused_path']['legacy_dispatches']}")
    want_launches = (stats["predict_kernel_launches"]
                     + rt.warmed_buckets * rt.kernel_launches_per_dispatch)
    check(launches == want_launches and launches > 0,
          f"kernel launches {launches}, expected {want_launches}")
    check(big_out.shape == (BIG_ROWS,) and np.isfinite(big_out).all(),
          "1M-row predict: wrong shape or non-finite")
    check(bool(((big_out > 0) & (big_out < 1)).all()),
          "binary predictions outside (0, 1)")

    rng = np.random.default_rng(SEED + 20)
    sample = rng.choice(BIG_ROWS, 2000, replace=False)
    codes = rt.packed.bin_mapper.transform(X[sample])
    want = rt.oracle.predict_numpy(codes, raw_score=False)
    err_big = float(np.abs(big_out[sample] - want).max())
    want_single = rt.oracle.predict_numpy(
        rt.packed.bin_mapper.transform(single), raw_score=False)
    err_single = float(np.abs(single_out - want_single).max())
    exact = rt.packed.predict_numpy(codes, raw_score=False)
    err_exact = float(np.abs(big_out[sample] - exact).max())
    check(err_big <= 1e-5 and err_single <= 1e-5,
          f"device vs numpy oracle: {err_big:.3e} / {err_single:.3e}")
    check(err_exact <= 1e-5 + rt.quant_error_bound,
          f"device vs exact f32 forest {err_exact:.3e} beyond the "
          f"quantization bound {rt.quant_error_bound:.3e}")

    PREDICT_FOREST_LAUNCHES.reset()
    serve_cli(path, path2, precision, X[SINGLE_REQUESTS:])
    cli_launches = PREDICT_FOREST_LAUNCHES.count
    check(cli_launches > 0, "the CLI phase launched no kernel")
    result = {
        "precision": precision, "launches": launches + cli_launches,
        "deploy_s": t_deploy, "warmed_programs": rep["warmed"],
        "single_requests": SINGLE_REQUESTS, "single_s": t_single,
        "batched_dispatches": stats["batched_dispatches"],
        "queue_latency_p50_ms": stats["queue_latency_p50_ms"],
        "queue_latency_p99_ms": stats["queue_latency_p99_ms"],
        "big_rows": BIG_ROWS, "big_s": t_big, "big_binning_s": t_bin,
        "big_rows_per_s": BIG_ROWS / t_big,
        "max_abs_err_vs_oracle": max(err_big, err_single),
        "max_abs_err_vs_exact": err_exact,
        "quant_error_bound": rt.quant_error_bound,
        "fallbacks": stats["fallbacks"],
        "legacy_dispatches": stats["fused_path"]["legacy_dispatches"],
        "cli_launches": cli_launches,
    }
    log(f"phase 3 {precision}: {json.dumps(result)}")
    return result, rt


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------
def time_ms(fn, runs=25, inner=10):
    """Device ms per call: median over ``runs`` of CUDA events around
    ``inner`` back-to-back calls.  A spin kernel enqueued first keeps the
    card busy while the host enqueues the calls, so the events time the
    calls' device work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        for _ in range(inner):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / inner)
    return float(np.median(per))


def host_ms(fn, runs=200):
    """Host wall ms per call, synchronised once at the end (the rate the
    host can issue calls, device work overlapped)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e3


def node_depths(soa):
    """Depth of every node slot ``[Tp, Mp]`` (root 0) from the SoA."""
    left = soa.left.cpu().numpy().astype(np.int64)
    right = soa.right.cpu().numpy().astype(np.int64)
    tp, mp = left.shape
    depth = np.zeros((tp, mp), np.int64)
    rows = np.arange(tp)
    for node in range(mp):          # depth-major: parents precede children
        internal = left[:, node] != node
        d = depth[:, node] + 1
        depth[rows[internal], left[internal, node]] = d[internal]
        depth[rows[internal], right[internal, node]] = d[internal]
    return torch.from_numpy(depth).to(soa.left.device)


def bound_ms(soa, bins, depth_cap, t):
    """Least time for the work: bytes (bins and tables read once, output
    written once) over HBM peak, and operations (per internal node on a
    row's path: one compare and one select; per row and tree: one multiply
    and one add) over the f32 non-tensor peak.  Returns (ms, bound_by,
    node_visits)."""
    from lightgbm_tpu_torch.ops.predict import forest_leaf_nodes

    n, f = bins.shape
    nodes = forest_leaf_nodes(soa, bins, depth_cap)[:t]
    visits = int(node_depths(soa)[:t].gather(1, nodes).sum())
    per_node = sum(x.element_size() for x in (
        soa.split_feature, soa.split_bin, soa.left, soa.right, soa.leaf))
    table = soa.split_feature.shape[1] * t * per_node + 4 * t
    nbytes = n * f + 4 * n + table
    ops = 2 * visits + 2 * n * t
    b_ms, o_ms = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations",
            visits)


def phase_times(runtimes, X):
    from lightgbm_tpu_torch.kernels.predict import forest_sums
    from lightgbm_tpu_torch.ops.predict import forest_sums_plain

    table, breakdown = [], []
    head, path_errs = {}, {}
    for prec, rt in runtimes.items():
        soa = rt._soa[0]
        depth = rt.packed.depth_cap
        t = rt.packed.num_trees
        codes = rt.packed.bin_mapper.transform(X[:MAX_BUCKET])
        all_bins = torch.from_numpy(codes).to(rt.device)
        # the kernel against its plain version on the main path's own
        # tables and rows, at the buckets the main path launches
        path_errs[prec] = 0.0
        for b in (128, MAX_BUCKET):
            for num_it in (t, t // 2):
                path_errs[prec] = max(path_errs[prec], compare(
                    soa, all_bins[:b].contiguous(), float(rt.packed.shrink),
                    float(rt.packed.init_score[0]), num_it, depth, 0, False,
                    f"{prec} main-path tables, bucket {b}, {num_it} trees"))
        log(f"phase 4 {prec}: kernel == plain version on the main path's "
            f"tables at buckets 128 and {MAX_BUCKET} (max abs err "
            f"{path_errs[prec]:.3e})")
        for b in rt.buckets:
            bins = all_bins[:b].contiguous()
            k_ms = time_ms(lambda: forest_sums(soa, bins, 0, t, depth))
            k_host = host_ms(lambda: forest_sums(soa, bins, 0, t, depth))
            p_ms = time_ms(lambda: forest_sums_plain(soa, bins, t, depth),
                           runs=21, inner=1)
            b_ms, by, visits = bound_ms(soa, bins, depth, t)
            row = {"precision": prec, "bucket": b, "kernel_ms": k_ms,
                   "kernel_host_ms": k_host, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
                   "node_visits": visits, "rows_per_s": b / k_ms * 1e3}
            table.append(row)
            if b == MAX_BUCKET:
                head[prec] = row
        # where a launch's time goes: no trees (launch and bin staging),
        # every tree with one step (table staging), every tree in full
        for b in (1, MAX_BUCKET):
            bins = all_bins[:b].contiguous()
            parts = {"bucket": b, "precision": prec,
                     "no_trees_ms": time_ms(
                         lambda: forest_sums(soa, bins, 0, 0, depth)),
                     "one_step_ms": time_ms(
                         lambda: forest_sums(soa, bins, 0, t, 1)),
                     "full_ms": time_ms(
                         lambda: forest_sums(soa, bins, 0, t, depth))}
            breakdown.append(parts)
            log(f"phase 4 {prec} breakdown: {json.dumps(parts)}")
        log(f"phase 4 {prec}: " + ", ".join(
            f"{r['bucket']}:{r['kernel_ms']:.4f}/{r['kernel_host_ms']:.4f}/"
            f"{r['plain_ms']:.3f}ms"
            for r in table if r["precision"] == prec))
    return table, breakdown, head, path_errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the lightgbm_tpu_torch package is missing "
              f"beside this script ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card, build_s = phase_device()
    errs = phase_kernel_vs_plain(dev)

    workdir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    X, path, path2 = build_model(workdir)
    main_path, runtimes = {}, {}
    for prec in PRECISIONS:
        main_path[prec], runtimes[prec] = phase_main_path(prec, X, path,
                                                          path2)
    table, breakdown, head, path_errs = phase_times(runtimes, X)

    kernels = []
    for prec in PRECISIONS:
        h = head[prec]
        kernels.append({
            "name": f"predict_forest_{prec}", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": main_path[prec]["launches"],
            "max_abs_err": path_errs[prec], "max_err": path_errs[prec],
            "phase2_max_abs_err": errs[prec],
            "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
            "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
            "library_ms": None, "bucket": MAX_BUCKET,
        })
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "kernel_vs_plain_max_abs_err": errs,
              "main_path_tables_max_abs_err": path_errs,
              "main_path": main_path,
              "times": table, "breakdown": breakdown, "kernels": kernels,
              "library_call": "none: no single PyTorch call computes forest "
                              "traversal",
              "total_s": time.perf_counter() - t_start}
    with open(os.path.join(workdir, "chip_smoke_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['total_s']:.1f} s; card {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
