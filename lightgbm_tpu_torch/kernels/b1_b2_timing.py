"""Time B1 (f32/bf16, ``csrc/hist_fused.cu``) and B2
(``csrc/hist_partition.cu``) on the card, pass by pass.

    python3 lightgbm_tpu_torch/kernels/b1_b2_timing.py [--package DIR]
        [--cases PATH] [--no-b5]

On ``make_higgs_like(1,000,000)`` binned to 255 bins, with the binary
round-1 statistics: B1 at the north-star root (one segment) and at three
two-segment calls of a real strict tree (grown once with the plain
versions: the root's split, whose children hold every row; the call whose
children hold the number of rows nearest the tree's mean; the last call
whose children hold at most 5,000 rows), each beside one ``index_add_``
of the rows in a segment into flat (segment, feature, bin) cells; B2 at
the widest wave of a real north-star tree (42 splits) and at its first
wave (one split, the root's); and, unless ``--no-b5``, B5 at the widest
wave of a north-star ``cv()`` round (5 folds), whose partition passes B1
and B2 share.  For each, at f32 and bf16: the max abs error against the
plain version, whether B2's routing equals ``route_wave``'s, the
output's digest, the rows in a segment (``m``), the device ms per launch
(CUDA events, median of 11 runs of 5 launches queued behind a spin
kernel), the byte bound of the data-dependent work (``4n + m (F + 12) +
K F B 12`` for B1; ``8n + r + m (F + 12) + W F B 12`` for B2, ``r`` the
rows of the splitting leaves, whose split code is read) and the device
microseconds of each kernel and copy of one launch (``torch.profiler``,
mean over 5 launches), which splits a call into its passes.

``--package DIR`` times the ``lightgbm_tpu_torch`` under ``DIR`` instead
of this checkout's (to compare two versions in one call, unpack the other
into an ignored directory and run both in turns: old, new, new, old).
``--cases PATH`` keeps the recorded inputs in that file (made by the first
run, read by the next), so runs in turns time the same inputs.  Prints the
card's name and power limit and one ``RESULT`` JSON line.  Needs a CUDA
card.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

if __package__:
    from . import _timing as T
else:                   # run as a file: this directory is on sys.path
    import _timing as T

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
LATE_ROWS = 5_000


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def record(dev):
    """The recorded inputs: bins, root statistics, the widest and the first
    wave of a plain-grown north-star tree, the strict tree's two-segment
    calls (early, middle, late) and the widest batched wave of a north-star
    ``cv()`` round."""
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.models.gbdt import (HyperScalars,
                                                resolve_wave_width)
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    X, y = make_higgs_like(1_000_000, 28, seed=0)
    mapper = BinMapper.fit(X, max_bin=255)
    bins = torch.from_numpy(mapper.transform(X)).to(dev)
    p = np.full(len(y), float(y.mean()))
    stats = torch.from_numpy(np.stack([p - y, p * (1 - p), np.ones(len(y))],
                                      1).astype(np.float32)).to(dev)
    pp = parse_params({"objective": "binary", "num_leaves": 127,
                       "learning_rate": 0.1, "min_data_in_leaf": 20,
                       "verbosity": -1})
    ctx = HyperScalars.from_params(pp).ctx()
    waves = []
    orig = T.hist_partition_plain

    def spy(*a):
        waves.append(a[:9])
        return orig(*a)

    T.hist_partition_plain = spy
    try:
        T.grow_tree(bins, stats, torch.ones(28, device=dev), ctx, 127, 256,
                    -1, hist_impl="plain", hist_dtype="f32",
                    wave_width=resolve_wave_width(pp, len(y)))
    finally:
        T.hist_partition_plain = orig
    widest = max(waves, key=lambda a: a[4].shape[0])
    first = waves[0]
    segs = []
    orig_ch = T.compute_histograms

    def spy_ch(b, st, seg, k, *a, **kw):
        if k == 2:
            segs.append(seg.to(torch.int8).clone())
        return orig_ch(b, st, seg, k, *a, **kw)

    T.compute_histograms = spy_ch
    try:
        T.grow_tree(bins, stats, torch.ones(28, device=dev), ctx, 127, 256,
                    -1, hist_impl="plain", hist_dtype="f32", wave_width=1)
    finally:
        T.compute_histograms = orig_ch
    m = np.array([int((s < 2).sum()) for s in segs])
    mid = int(np.argmin(np.abs(m - m.mean())))
    late = max(i for i in range(len(m)) if m[i] <= LATE_ROWS)
    strict = {"strict_early": segs[0].to(torch.int32),
              "strict_mid": segs[mid].to(torch.int32),
              "strict_late": segs[late].to(torch.int32)}
    return {"bins": bins, "stats": stats, "wave42": tuple(widest),
            "wave1": tuple(first), "strict": strict,
            "strict_rows": {"calls": len(m), "mean": float(m.mean()),
                            "picked": {"strict_early": int(m[0]),
                                       "strict_mid": int(m[mid]),
                                       "strict_late": int(m[late])}}}


def b5_wave(dev):
    """(bins, stats, seg, K) of the widest batched wave of one north-star
    ``cv()`` round (5 stratified folds, wave regime)."""
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.models.fused import FusedCVProgram
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    X, y = make_higgs_like(1_000_000, 28, seed=0)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 255}, device=dev)
    ds.construct()
    assign = np.random.default_rng(0).permutation(len(y)) % 5
    masks = np.stack([assign != k for k in range(5)])
    params = parse_params({"objective": "binary", "num_leaves": 127,
                           "learning_rate": 0.1, "min_data_in_leaf": 20,
                           "verbosity": -1, "hist_impl": "plain"})
    prog = FusedCVProgram(ds, [params], masks, 1, 0, 0)
    rec = {}
    orig = T.compute_histograms_batched

    def spy(b, st, seg, k, *a, **kw):
        if k > rec.get("k", 0):
            rec.update(k=k, args=(b, st.clone(), seg.clone(), k))
        return orig(b, st, seg, k, *a, **kw)

    T.compute_histograms_batched = spy
    try:
        prog.step(prog.init(), 1)
    finally:
        T.compute_histograms_batched = orig
    return rec["args"]


def bound_ms(nbytes):
    return nbytes / PEAK_BYTES_S * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--cases", default=None)
    ap.add_argument("--no-b5", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("b1_b2_timing: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    from lightgbm_tpu_torch.ops import histogram as H

    if not H.__file__.startswith(root):
        raise SystemExit(f"imported {H.__file__}, not the package under "
                         f"{root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    if args.cases and os.path.exists(args.cases):
        cases = torch.load(args.cases, map_location=dev)
    else:
        cases = record(dev)
        if not args.no_b5:
            cases["b5"] = b5_wave(dev)
        if args.cases:
            torch.save(cases, args.cases)
    bins, stats = cases["bins"], cases["stats"]
    n, f = bins.shape
    out = {"package": root, "strict_rows": cases["strict_rows"]}
    b1_cases = {"root": (torch.zeros(n, dtype=torch.int32, device=dev), 1)}
    b1_cases.update({k: (v, 2) for k, v in cases["strict"].items()})
    for name, (seg, k) in b1_cases.items():
        rows = torch.nonzero((seg >= 0) & (seg < k)).squeeze(1)
        m = int(rows.numel())
        flat = (((seg[rows].to(torch.int64) * f)[:, None]
                 + torch.arange(f, device=dev)) * 256
                + bins[rows].to(torch.int64)).reshape(-1)
        vals = stats[rows].repeat_interleave(f, dim=0)
        acc = torch.zeros(k * f * 256, 3, device=dev)
        lib = T.device_ms(lambda: acc.index_add_(0, flat, vals))
        del flat, vals, acc
        for mode in ("f32", "bf16"):
            got = H.hist_fused(bins, stats, seg, k, 256, mode)
            want = H.hist_fused_plain(bins, stats, seg, k, 256, mode)
            torch.cuda.synchronize()
            out[f"b1_{name}_{mode}"] = {
                "k": k, "m": m, "err": float((got - want).abs().max()),
                "sha": digest(got),
                "ms": T.device_ms(lambda: H.hist_fused(bins, stats, seg, k,
                                                       256, mode)),
                "bound_ms": bound_ms(4 * n + m * (f + 12)
                                     + k * f * 256 * 12),
                "index_add_ms": lib,
                "device_us": T.device_us_by_kernel(lambda: H.hist_fused(
                    bins, stats, seg, k, 256, mode))}
    for name in ("wave42", "wave1"):
        wave = cases[name]
        w = int(wave[4].shape[0])
        seg, want_leaf = H.route_wave(wave[0], *wave[2:8])
        m = int((seg >= 0).sum())
        leaf = wave[2].to(torch.int64)
        cap = wave[3].shape[0]
        in_split = (leaf >= 0) & (leaf < cap)
        r = int((wave[3].to(torch.int64)[leaf.clamp(0, cap - 1)][in_split]
                 >= 0).sum())
        for mode in ("f32", "bf16"):
            got, new_leaf = H.hist_partition_fused(*wave, mode)
            want, _ = H.hist_partition_plain(*wave, mode)
            torch.cuda.synchronize()
            out[f"b2_{name}_{mode}"] = {
                "w": w, "m": m, "err": float((got - want).abs().max()),
                "route_eq": bool(torch.equal(new_leaf, want_leaf)),
                "sha": digest(got),
                "ms": T.device_ms(lambda: H.hist_partition_fused(*wave,
                                                                 mode)),
                "bound_ms": bound_ms(8 * n + r + m * (f + 12)
                                     + w * f * 256 * 12),
                "device_us": T.device_us_by_kernel(
                    lambda: H.hist_partition_fused(*wave, mode))}
    if "b5" in cases:
        b5_bins, b5_stats, b5_seg, k = cases["b5"]
        for mode in ("f32", "bf16"):
            got = H.hist_fused_batched(b5_bins, b5_stats, b5_seg, k, 256,
                                       mode)
            want = H.hist_fused_batched_plain(b5_bins, b5_stats, b5_seg, k,
                                              256, mode)
            torch.cuda.synchronize()
            out[f"b5_wave_{mode}"] = {
                "k": k, "e": int(b5_stats.shape[0]),
                "err": float((got - want).abs().max()), "sha": digest(got),
                "ms": T.device_ms(lambda: H.hist_fused_batched(
                    b5_bins, b5_stats, b5_seg, k, 256, mode)),
                "device_us": T.device_us_by_kernel(
                    lambda: H.hist_fused_batched(b5_bins, b5_stats, b5_seg,
                                                 k, 256, mode))}
    print("RESULT", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
