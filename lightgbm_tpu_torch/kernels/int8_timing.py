"""Time B1's int8 mode (``csrc/hist_fused_int8.cu``) on the card.

    python3 lightgbm_tpu_torch/kernels/int8_timing.py [--package DIR]
        [--plan CASE:ROWS:FEAT_GROUP ...]

On ``make_higgs_like(1,000,000)`` binned to 255 bins, with the binary
round-1 statistics: B1 int8 at the north-star root (one segment), at the
widest wave of a real north-star tree (grown once with the plain versions;
its direct children as 42 segments), over the root split into two segments
(the strict grower's call) and at that wave cut to its first 20 and 5
segments (narrower waves), the root and the strict call over the first
100,000 rows alone, and the root with every row of feature 0 in one bin
(``skew``).  For each: whether the kernel equals its plain version bit for
bit, its output's digest, its rows in a segment, its device ms per launch
(CUDA events, median of 11 runs of 5 launches queued behind a spin kernel)
and the device microseconds of each kernel and copy of one launch
(``torch.profiler``, the mean over 5 launches), which split a call into
its passes.  ``--package DIR`` times the ``lightgbm_tpu_torch`` under
``DIR`` instead of this checkout's (to compare two versions in one call,
unpack the other into an ignored directory and run both in turns: old,
new, new, old).  Each ``--plan`` forces one launch plan of this
checkout's kernel for one case and times it too: rows per work item (for
more than one segment the least item size: the device sizes items from
the call's rows) and features per block (``kernels/histogram.py``
``plan_int8``).  Prints one ``RESULT`` JSON line.  Needs a CUDA card.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

if __package__:
    from . import _timing as T
else:                   # run as a file: this directory is on sys.path
    import _timing as T


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--plan", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_timing: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.kernels import histogram as KH
    from lightgbm_tpu_torch.models.gbdt import (HyperScalars,
                                                resolve_wave_width)
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    if not H.__file__.startswith(root):
        raise SystemExit(f"imported {H.__file__}, not the package under "
                         f"{root}")
    dev = torch.device("cuda")
    X, y = make_higgs_like(1_000_000, 28, seed=0)
    bins = torch.from_numpy(BinMapper.fit(X, max_bin=255).transform(X)).to(
        dev)
    p = np.full(len(y), float(y.mean()))
    stats = torch.from_numpy(np.stack([p - y, p * (1 - p), np.ones(len(y))],
                                      1).astype(np.float32)).to(dev)
    pp = parse_params({"objective": "binary", "num_leaves": 127,
                       "learning_rate": 0.1, "min_data_in_leaf": 20,
                       "verbosity": -1})
    rec = {}
    orig = T.hist_partition_plain

    def spy(*a):
        if a[4].shape[0] > rec.get("w", 0):
            rec["w"], rec["args"] = int(a[4].shape[0]), a[:9]
        return orig(*a)

    T.hist_partition_plain = spy
    try:
        T.grow_tree(bins, stats, torch.ones(28, device=dev),
                    HyperScalars.from_params(pp).ctx(), 127, 256, -1,
                    hist_impl="plain", hist_dtype="f32",
                    wave_width=resolve_wave_width(pp, len(y)))
    finally:
        T.hist_partition_plain = orig
    wave = rec["args"]
    seg_w = H.route_wave(wave[0], *wave[2:8])[0].to(torch.int32)
    i32 = torch.int32
    strict = torch.where(seg_w >= 0, 0, 1).to(i32)
    small = 100_000
    cases = {"root": (len(y), torch.zeros(len(y), dtype=i32, device=dev),
                      1),
             "wave": (len(y), seg_w, rec["w"]),
             "strict2": (len(y), strict, 2),
             "wave20": (len(y), torch.where(seg_w < 20, seg_w, -1).to(i32),
                        20),
             "wave5": (len(y), torch.where(seg_w < 5, seg_w, -1).to(i32), 5),
             # the first 100,000 rows alone: a smaller dataset's calls
             "root100k": (small, torch.zeros(small, dtype=i32, device=dev),
                          1),
             "strict100k": (small, strict[:small], 2)}

    skew_bins = bins.clone()
    skew_bins[:, 0] = 7

    def timed(n, seg, k, b=None):
        b = bins[:n] if b is None else b
        st = stats[:n]
        prof = T.device_us_by_kernel(lambda: H.hist_fused(b, st, seg, k, 256,
                                                          "int8"))
        want = H.hist_fused_plain(b, st, seg, k, 256, "int8")
        got = H.hist_fused(b, st, seg, k, 256, "int8")
        return {"eq": bool(torch.equal(got, want)),
                "rows": int(((seg >= 0) & (seg < k)).sum()),
                "ms": T.device_ms(lambda: H.hist_fused(b, st, seg, k, 256,
                                                       "int8")),
                "sha": hashlib.sha256(got.cpu().numpy().tobytes())
                .hexdigest()[:16], "device_us": prof}

    out = {"package": root, "wave_k": rec["w"]}
    for name, case in cases.items():
        out[name] = timed(*case)
    cases["skew"] = cases["root"] + (skew_bins,)
    out["skew"] = timed(*cases["skew"])
    real = KH.plan_int8 if args.plan else None
    for spec in args.plan:
        name, rows, fg = spec.split(":")
        n, k = cases[name][0], cases[name][2]
        slots = real(n, 28, 3, k, 256, 132)[2] if k > 1 else \
            -(-n // int(rows))
        # for more than one segment ROWS is the least item size
        KH.plan_int8 = lambda *a: (int(rows), int(fg), slots, *real(*a)[3:])
        try:
            out[f"{name}_plan_{rows}_{fg}"] = timed(*cases[name])
        finally:
            KH.plan_int8 = real
    print("RESULT", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
