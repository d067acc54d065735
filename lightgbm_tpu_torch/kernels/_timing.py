"""Helpers of the kernels' timing scripts (``kernels/*_timing.py``), of
``chip_smoke.py`` and of the tests: device time per call, the device time
of each kernel of a call, seed-made forests and B4's bounds.

It imports only numpy and torch at import time, so a timing script loads
it from its own checkout before ``--package DIR`` points ``sys.path`` at
another version of ``lightgbm_tpu_torch``; the forest helpers import that
package when they are called.
"""

import numpy as np
import torch

SPIN_CYCLES = 20_000_000
PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
RECORD_BYTES = 8                # B4's node record
LOADS_PER_VISIT = 2             # B4's walk: a node record and the row's code
LANES = 32


def device_ms(fn, runs=11, inner=5):
    """Device ms per call of ``fn``: median over ``runs`` of CUDA events
    around ``inner`` calls queued behind a spin kernel, so the events time
    the calls' device work and not the host's launches."""
    for _ in range(2):
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


def device_us_by_kernel(fn, launches=5):
    """Device microseconds per launch of each kernel (and memset or copy)
    that ``fn`` runs, from ``torch.profiler``; empty when the profiler sees
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            out[ev.key[:60]] = us / launches
    return out


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
    """The forest's ``ForestSoA`` at ``precision`` on ``device``, packed as
    the serving runtime packs it."""
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
# B4's bounds
# ---------------------------------------------------------------------------
def walk_counts(soa, bins, depth_cap, t):
    """What B4's walks over trees ``[0, t)`` of ``soa`` read for ``bins``:
    ``(visits, records, cut)`` -- the internal nodes on the rows' paths
    (a row's steps that leave a slot), the distinct node slots whose
    record some walk reads (internal nodes and the leaves reached within
    ``depth_cap`` steps), and the distinct slots where a walk is cut
    short by ``depth_cap`` (their ``leaf * scale`` is read instead).  A
    slot the walk never leaves is one whose (effective) left child is
    itself, as in the kernel's records."""
    n, f = bins.shape
    dev = bins.device
    feat = soa.split_feature[:t].to(torch.int64)
    thr = soa.split_bin[:t].to(torch.int64)
    left = soa.left[:t].to(torch.int64)
    right = soa.right[:t].to(torch.int64)
    mp = feat.shape[1]
    slot = torch.arange(mp, device=dev)
    never_left = thr < 0
    eff_left = torch.where(never_left, right, left)
    th = torch.where(never_left | (thr >= 255), 255, thr)
    leaf = (eff_left == slot) & ((th == 255) | (right == slot))
    bins_t = bins.to(torch.int64).t()                       # [F, n]
    flat = (torch.arange(t, device=dev) * mp)[:, None]      # a tree's slots
    node = torch.zeros((t, n), dtype=torch.int64, device=dev)
    stopped = torch.zeros((t, n), dtype=torch.bool, device=dev)
    seen = torch.zeros(t * mp, dtype=torch.bool, device=dev)
    visits = 0
    for _ in range(int(depth_cap)):
        seen[(flat + node)[~stopped]] = True                # records read
        stopped = stopped | leaf.gather(1, node)
        visits += int((~stopped).sum())
        fi = feat.gather(1, node)
        ok = (fi >= 0) & (fi < f)
        code = torch.where(ok, bins_t.gather(0, fi.clamp(0, f - 1)), 0)
        nxt = torch.where(code <= thr.gather(1, node), left.gather(1, node),
                          right.gather(1, node))
        node = torch.where(stopped, node, nxt)
    cut = torch.zeros(t * mp, dtype=torch.bool, device=dev)
    cut[(flat + node)[~stopped]] = True
    return visits, int(seen.sum()), int(cut.sum())


def byte_bound_ms(n, f, records, cut):
    """Least ms to move what B4 must: the bins and the output once, and
    each node record a walk reads (8 bytes) and each cut walk's leaf value
    (4 bytes) once, at the HBM rate."""
    nbytes = n * f + 4 * n + RECORD_BYTES * records + 4 * cut
    return nbytes / PEAK_BYTES_S * 1e3


def walk_bound_ms(visits, sms, clock_mhz):
    """Least ms for the walk's dependent loads: ``LOADS_PER_VISIT`` lane
    loads a node visit, one warp-wide load per clock on each SM."""
    return visits * LOADS_PER_VISIT / LANES / sms / (clock_mhz * 1e6) * 1e3
