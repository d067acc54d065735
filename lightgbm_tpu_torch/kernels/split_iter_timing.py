"""Time the split iteration (B3, ``csrc/split_iter.cu``) on the card.

    python3 lightgbm_tpu_torch/kernels/split_iter_timing.py [--package DIR]
        [--plan E:F:CLUSTER:CHUNK ...]

At the shapes the main paths give it, B = 256 and capacity 253: E = 1,
F = 28 (the strict Booster), E = 5, F = 6 (the example's ``cv()``) and
E = 20 and 40, F = 6 (the sweep's buckets).  For each: whether one launch
equals the plain version bit for bit (table and aux, the kernel run on a
clone of the table: the redesigned kernel updates it in place), the
outputs' digest, and the device ms per launch (CUDA events, median of 11
runs of 5 launches queued behind a spin kernel).  Beside them, an empty
kernel's ms in the same harness (``torch.cuda._sleep(0)``): the launch
floor no design removes.  ``--package DIR`` times the
``lightgbm_tpu_torch`` under ``DIR`` instead of this checkout's (to compare
two versions in one call: old, new, new, old).  Each ``--plan`` forces one
launch plan of this checkout's kernel (``kernels/split_iter.py``
``plan_split_iter``: blocks per element and pairs per shared-memory chunk)
at one shape and times it too.  Prints one ``RESULT`` JSON line.  Needs a
CUDA card.
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

SHAPES = ((1, 28), (5, 6), (20, 6), (40, 6))
BINS, CAPACITY = 256, 253


def inputs(rng, dev, e, f):
    """A mid-tree iteration: a random root split, then ``e`` elements'
    children histograms with per-element regularizers, as ``chip_smoke.py``
    phase 7 makes them."""
    from lightgbm_tpu_torch.models.tree import _packed_root_table
    from lightgbm_tpu_torch.ops.split import (SplitContext,
                                              constrained_leaf_output,
                                              find_best_split)

    def hists(lead):
        shape = tuple(lead) + (f, BINS)
        c = rng.integers(0, 6, shape).astype(np.float64)
        h = np.stack([rng.normal(size=shape),
                      rng.uniform(0, 0.25, shape) * (c > 0), c], axis=-1)
        return torch.from_numpy(h.astype(np.float32)).to(dev)

    def pick(vals):
        return torch.tensor(np.asarray(vals, np.float32)[
            rng.integers(0, len(vals), e)], device=dev)

    ctx = SplitContext(pick([0.0, 0.5]), pick([0.0, 1.0]),
                       pick([1.0, 20.0]), pick([1e-3]), pick([0.0, 0.1]),
                       pick([0.0, 0.3]), pick([0.0, 2.0]))
    fmask = torch.ones((e, f), device=dev)
    root = hists((e,)) * 4.0
    tot = root[:, 0].sum(dim=1)
    zero = torch.zeros(e, device=dev)
    out = constrained_leaf_output(tot[:, 0], tot[:, 1], tot[:, 2],
                                  ctx._replace(path_smooth=zero),
                                  float("-inf"), float("inf"), zero)
    best = find_best_split(root, ctx, fmask, None, out, arith="scan")
    table = _packed_root_table(CAPACITY, out, tot, best).contiguous()
    aux = torch.stack([zero, best.feature.float(), best.bin.float(),
                       torch.ones(e, device=dev), zero, zero, zero, zero],
                      dim=1)
    scal = torch.zeros((e, 16), device=dev)
    for i, v in enumerate(ctx):
        scal[:, i] = v
    scal[:, 7], scal[:, 8] = -1.0, 1.0
    return hists((e, 2)), table, fmask, aux, scal


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--plan", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_iter_timing: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    from lightgbm_tpu_torch.kernels import split_iter as KS
    from lightgbm_tpu_torch.models.tree import split_iter_plain

    if not KS.__file__.startswith(root):
        raise SystemExit(f"imported {KS.__file__}, not the package under "
                         f"{root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {"package": root,
           "empty_kernel_ms": T.device_ms(lambda: torch.cuda._sleep(0))}

    def timed(e, f):
        hist, table, fmask, aux, scal = inputs(rng, dev, e, f)
        want_t, want_a = split_iter_plain(hist, table, fmask, aux, scal)
        got_t, got_a = KS.split_iter(hist, table.clone(), fmask, aux, scal)
        torch.cuda.synchronize()
        eq = bool(torch.equal(got_t.view(torch.int32),
                              want_t.view(torch.int32))
                  and torch.equal(got_a.view(torch.int32),
                                  want_a.view(torch.int32)))
        digest = hashlib.sha256(got_t.cpu().numpy().tobytes()
                                + got_a.cpu().numpy().tobytes())
        work = table.clone()
        return {"eq": eq, "sha": digest.hexdigest()[:16],
                "ms": T.device_ms(lambda: KS.split_iter(hist, work, fmask, aux,
                                                        scal))}

    for e, f in SHAPES:
        out[f"E{e}_F{f}"] = timed(e, f)
    real = KS.plan_split_iter if args.plan else None
    for spec in args.plan:
        e, f, cluster, chunk = (int(v) for v in spec.split(":"))
        KS.plan_split_iter = lambda *a: (cluster, chunk)
        try:
            out[f"E{e}_F{f}_plan_{cluster}_{chunk}"] = timed(e, f)
        finally:
            KS.plan_split_iter = real
    print("RESULT", json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
