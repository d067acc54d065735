"""Time the histogram kernels of the checkout this file lives in, on the card.

    python3 <checkout>/lightgbm_tpu_torch/kernels/hist_timing.py [--kernels]

Builds ``hist_fused`` (B1), ``hist_fused_int8`` (B1's int8 mode),
``hist_partition`` (B2), ``hist_segstats`` (B6) and ``hist_fused_batched``
(B5) from that checkout, then on
``make_higgs_like(1,000,000)`` binned to 255 bins: each kernel against its
plain version (max abs err, routing equal, and digests of B1's and B2's
outputs) and its device ms per launch
(CUDA events, median of 11 runs of 5 launches queued behind a spin kernel)
at the north-star root (binary round-1 statistics, one segment) and at the
widest wave of a real north-star tree (grown once with the plain versions;
B1 int8 there with the wave's direct children as segments, bit-equal to its
plain version, beside one ``index_add_`` of the quantized values into flat
int32 cells);
B5 at the widest wave of a north-star ``cv()`` round (5 folds, K = 42) and
at the widest wave of a multiclass round at Covertype's shape (581,012 x
54, 7 classes), each with one ``index_add_`` over the flat (element,
segment, feature, bin) cells as the library call and the device ms of each
of its kernels (``torch.profiler``), and both routes at the
route's edge (K = 21: B6 through the folded operand, and B5); B6 on the
diamonds split (``make_synthetic_diamonds``, about 45,800 x 6) at Kc = 30
(the example's ``cv()``), 240 (an 8-config sweep bucket) and 1,080 (a
36-config hyper-batch), and at the north-star ``cv()`` root (Kc = 15), each
beside one ``index_add_``, and on the inputs of a real call of the sweep's
num_leaves-127 bucket; B5 and B6 there under forced launch plans
beside the wrapper's own (a checkout with their partitioned designs).
Without ``--kernels``, also 10 rounds of
north-star training (seconds per round) and its AUC on
``make_higgs_like(200,000, seed=9)``, at the default bf16 and at
``hist_dtype="int8"``; ``cv()`` as examples/gridsearch_cv.py calls it
(seconds, ``best_iter``, ``best_score``) and the 8-config num_leaves 127
sweep bucket run to its end (seconds, rounds, and the (rows, Kc) of its B6
calls).  Prints one ``RESULT`` JSON line.  To compare two versions of the
kernels in one call, unpack the other version into an ignored directory,
copy this file and ``_timing.py`` into it, and run both files in turns
(old, new, new, old).
Needs a CUDA card.
"""

import collections
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

if __package__:
    from . import _timing as T
else:                   # run as a file: this directory is on sys.path
    import _timing as T


def breakdown(fn, calls=3) -> dict:
    """Device ms per call of each kernel that ``fn`` launches
    (``torch.profiler`` over ``calls`` calls after a warm one)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            out[e.key.split("(")[0][-40:]] = us / 1e3 / calls
    return out


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def diamonds() -> dict:
    """``cv()`` and one sweep bucket on the diamonds split."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.kernels import histogram as kh
    from lightgbm_tpu_torch.models.fused import run_fused_cv_batch
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, _ = make_synthetic_diamonds()
    tr, _ = train_test_split_bernoulli(len(y), p_train=0.85, seed=3928272)
    X, y = X[tr], y[tr]
    out = {}
    ds = lgb.Dataset(X, label=y)
    ds.construct()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = lgb.cv({"learning_rate": 0.1, "objective": "regression"}, ds,
                 num_boost_round=1000, nfold=5, metrics="rmse",
                 early_stopping_rounds=5, stratified=False, seed=3928272)
    torch.cuda.synchronize()
    out["cv"] = {"s": time.perf_counter() - t0, "best_iter": fit.best_iter,
                 "best_score": fit.best_score}
    grid = [dict(num_leaves=127, min_data_in_leaf=m, feature_fraction=f,
                 bagging_fraction=b, bagging_freq=4, learning_rate=0.1,
                 objective="regression", hist_dtype="bf16", verbosity=-1)
            for b in (0.6, 0.8) for f in (0.8, 1.0) for m in (20, 40)]
    assign = np.random.default_rng(3928272).permutation(len(y)) % 5
    masks = np.stack([assign != k for k in range(5)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shapes = collections.Counter()
    orig = kh.hist_segstats

    def spy(bins, segstats, *a):
        shapes[f"n={segstats.shape[0]} Kc={segstats.shape[1]}"] += 1
        return orig(bins, segstats, *a)

    kh.hist_segstats = spy
    try:
        res = run_fused_cv_batch(ds, [parse_params(g) for g in grid], masks,
                                 1000, 5, 3928272)
    finally:
        kh.hist_segstats = orig
    torch.cuda.synchronize()
    out["bucket_127x8"] = {"s": time.perf_counter() - t0, "rounds": res[3],
                           "best_iter": res[1].tolist(),
                           "b6_calls_by_shape": dict(shapes)}
    return out


def diamonds_bins(dev):
    """The grid-search workflow's training split, binned to 255 bins."""
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, _ = make_synthetic_diamonds()
    tr, _ = train_test_split_bernoulli(len(y), p_train=0.85, seed=3928272)
    return torch.from_numpy(BinMapper.fit(X[tr], max_bin=255).transform(
        X[tr])).to(dev)


def sweep_round_b6() -> dict:
    """B6 on the inputs of a real call of the sweep's num_leaves-127 bucket
    (the first of a fused round's per-split calls: the `Dataset`'s padded
    bins, the folded statistics) and on those bins with normal statistics,
    which tells what the data does to the kernel's time."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.models.fused import FusedCVProgram
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, _ = make_synthetic_diamonds()
    tr, _ = train_test_split_bernoulli(len(y), p_train=0.85, seed=3928272)
    ds = lgb.Dataset(X[tr], label=y[tr])
    ds.construct()
    grid = [dict(num_leaves=127, min_data_in_leaf=m, feature_fraction=f,
                 bagging_fraction=b, bagging_freq=4, learning_rate=0.1,
                 objective="regression", hist_dtype="bf16", verbosity=-1)
            for b in (0.6, 0.8) for f in (0.8, 1.0) for m in (20, 40)]
    assign = np.random.default_rng(3928272).permutation(ds.num_data()) % 5
    masks = np.stack([assign != k for k in range(5)])
    prog = FusedCVProgram(ds, [parse_params(g) for g in grid], masks, 2, 0,
                          3928272)
    rec = []
    orig = H.hist_segstats

    def spy(bins, segstats, *a):
        if segstats.shape[1] == 240 and not rec:
            rec.append((bins, segstats.clone()))
        return orig(bins, segstats, *a)

    H.hist_segstats = spy
    try:
        prog.step(prog.init(), 1)
    finally:
        H.hist_segstats = orig
    bins, st = rec[0]
    normal = torch.from_numpy(np.random.default_rng(5).normal(
        size=tuple(st.shape)).astype(np.float32)).to(st.device)
    return {"b6_sweep_call": {
        "shape": f"n={st.shape[0]} Kc={st.shape[1]}",
        "zero_share": float((st == 0).float().mean()),
        "ms": T.device_ms(lambda: H.hist_segstats(bins, st, 256, "bf16")),
        "normal_stats_ms": T.device_ms(lambda: H.hist_segstats(
            bins, normal, 256, "bf16"))}}


def segstats_shapes(dev, dbins, higgs_bins) -> dict:
    """B6 against its plain version, its ms and one ``index_add_`` over the
    flat (feature, bin) cells at the main paths' channel counts."""
    from lightgbm_tpu_torch.ops import histogram as H

    rng = np.random.default_rng(5)
    out = {}
    for name, bins, kc, modes in (
            ("b6_kc30", dbins, 30, ("f32",)),
            ("b6", dbins, 240, ("f32", "bf16")),
            ("b6_kc1080", dbins, 1080, ("bf16",)),
            ("b6_root_kc15", higgs_bins, 15, ("bf16",))):
        n, f = bins.shape
        st = torch.from_numpy(rng.normal(size=(n, kc)).astype(
            np.float32)).to(dev)
        flat = (torch.arange(f, device=dev) * 256
                + bins.to(torch.int64)).reshape(-1)
        vals = st.repeat_interleave(f, dim=0)
        acc = torch.zeros(f * 256, kc, dtype=torch.float32, device=dev)
        lib = T.device_ms(lambda: acc.index_add_(0, flat, vals), runs=5)
        del flat, vals, acc
        for mode in modes:
            got = H.hist_segstats(bins, st, 256, mode)
            want = H.hist_segstats_plain(bins, st, 256, mode)
            torch.cuda.synchronize()
            out[f"{name}_{mode}"] = {
                "shape": f"n={n} F={f} Kc={kc}",
                "err": float((got - want).abs().max()),
                "ms": T.device_ms(lambda: H.hist_segstats(bins, st, 256,
                                                          mode)),
                "index_add_ms": lib,
                "kernels_ms": breakdown(lambda: H.hist_segstats(
                    bins, st, 256, mode))}
        del st
    return out


def plan_variants(b5_wave, dbins, higgs_bins) -> dict:
    """B5 at the north-star wave and B6 at Kc = 240 and at the north-star
    root under forced launch plans beside the wrapper's own (bf16 ms), for
    a checkout whose B5 and B6 take ``plan_batched`` / ``plan_segstats``
    plans of this form (an older checkout gets none)."""
    from lightgbm_tpu_torch.kernels import histogram as kh
    from lightgbm_tpu_torch.ops import histogram as H

    if not hasattr(kh, "B6_CHUNK_ROWS"):
        return {}
    out = {}
    bins, stats, seg, k = b5_wave
    (n, f), e = bins.shape, stats.shape[0]
    plan_b, plan_s = kh.plan_batched, kh.plan_segstats
    r0, _, fg0, parts = plan_b(n, f, 3, k, 256, kh._sm_count(bins.device),
                               e)
    try:
        half = max(512, r0 // 1024 * 512)
        for fg, r in ((fg0, r0), (4, r0), (fg0, half), (fg0, 2 * r0)):
            forced = (r, -(-n // r) + k, fg, parts)
            kh.plan_batched = lambda *a, p=forced: p
            out[f"b5_plan_R{r}_fg{fg}_ms"] = T.device_ms(
                lambda: H.hist_fused_batched(bins, stats, seg, k, 256,
                                             "bf16"))
        kh.plan_batched = plan_b
        rng = np.random.default_rng(7)
        for name, b6bins, kc in (("kc240", dbins, 240),
                                 ("root_kc15", higgs_bins, 15)):
            nn = b6bins.shape[0]
            st = torch.from_numpy(rng.normal(size=(nn, kc)).astype(
                np.float32)).to(b6bins.device)
            groups = -(-kc // kh.B6_LANES)
            for rows in kh.B6_CHUNK_ROWS:
                for per_set in sorted({1, 2, groups}):
                    if per_set > groups:
                        continue
                    forced = (rows, -(-nn // rows), per_set,
                              -(-groups // per_set))
                    kh.plan_segstats = lambda *a, p=forced: p
                    out[f"b6_{name}_plan_R{rows}_g{per_set}_ms"] = T.device_ms(
                        lambda: H.hist_segstats(b6bins, st, 256, "bf16"))
            kh.plan_segstats = plan_s
            del st
    finally:
        kh.plan_batched, kh.plan_segstats = plan_b, plan_s
    return out


def int8_times(bins, stats, wave) -> dict:
    """B1 int8 at the north-star root (one segment) and at the recorded
    wave (its direct children as segments): bit-equal to the plain version,
    kernel, plain and ``index_add_`` ms."""
    from lightgbm_tpu_torch.ops import histogram as H

    n, f = bins.shape
    seg_w, _ = H.route_wave(wave[0], *wave[2:8])
    out = {}
    for name, seg, k in (
            ("root", torch.zeros(n, dtype=torch.int32, device=bins.device),
             1),
            ("wave", seg_w.to(torch.int32), int(wave[4].shape[0]))):
        got = H.hist_fused(bins, stats, seg, k, 256, "int8")
        want = H.hist_fused_plain(bins, stats, seg, k, 256, "int8")
        q = H.quantize_int8(stats)[0].to(torch.int32)
        rows = torch.nonzero((seg >= 0) & (seg < k)).squeeze(1)
        flat = (((seg[rows].to(torch.int64) * f)[:, None]
                 + torch.arange(f, device=bins.device)) * 256
                + bins[rows].to(torch.int64)).reshape(-1)
        vals = q[rows].repeat_interleave(f, dim=0)
        acc = torch.zeros(k * f * 256, 3, dtype=torch.int32,
                          device=bins.device)
        out[f"b1_int8_{name}"] = {
            "k": k, "bit_equal": bool(torch.equal(got, want)),
            "ms": T.device_ms(lambda: H.hist_fused(bins, stats, seg, k, 256,
                                                   "int8")),
            "plain_ms": T.device_ms(lambda: H.hist_fused_plain(
                bins, stats, seg, k, 256, "int8"), runs=3, inner=1),
            "index_add_ms": T.device_ms(lambda: acc.index_add_(0, flat,
                                                               vals))}
        del flat, vals, acc
    return out


def widest_wave(run):
    """(bins, stats, seg, K) of the widest batched histogram call that
    ``run()`` makes."""
    import lightgbm_tpu_torch.models.tree as T

    rec = {}
    orig = T.compute_histograms_batched

    def spy(bins, stats, seg, k, *a, **kw):
        if k > rec.get("k", 0):
            rec.update(k=k, args=(bins, stats.clone(), seg.clone(), k))
        return orig(bins, stats, seg, k, *a, **kw)

    T.compute_histograms_batched = spy
    try:
        run()
    finally:
        T.compute_histograms_batched = orig
    return rec["args"]


def b5_times(name, bins, stats, seg, k) -> dict:
    """B5 against its plain version at both modes: max abs err, kernel and
    plain ms, beside one ``index_add_`` over the flat (element, segment,
    feature, bin) cells."""
    from lightgbm_tpu_torch.ops import histogram as H

    e, f = stats.shape[0], bins.shape[1]
    valid = (seg >= 0) & (seg < k)
    el, rows = torch.nonzero(valid, as_tuple=True)
    flat = ((((el * k + seg[el, rows].to(torch.int64)) * f)[:, None]
             + torch.arange(f, device=bins.device)) * 256
            + bins[rows].to(torch.int64)).reshape(-1)
    vals = stats[el, rows].repeat_interleave(f, dim=0)
    acc = torch.zeros(e * k * f * 256, 3, device=bins.device)
    out = {f"{name}_shape": f"E={e} K={k} n={bins.shape[0]} F={f} direct "
                            f"rows {int(valid.sum())}",
           f"{name}_index_add_ms": T.device_ms(lambda: acc.index_add_(
               0, flat, vals))}
    del flat, vals, acc, el, rows
    for mode in ("f32", "bf16"):
        got = H.hist_fused_batched(bins, stats, seg, k, 256, mode)
        want = H.hist_fused_batched_plain(bins, stats, seg, k, 256, mode)
        torch.cuda.synchronize()
        out[f"{name}_{mode}"] = {
            "err": float((got - want).abs().max()),
            "ms": T.device_ms(lambda: H.hist_fused_batched(bins, stats, seg, k,
                                                           256, mode)),
            "plain_ms": T.device_ms(lambda: H.hist_fused_batched_plain(
                bins, stats, seg, k, 256, mode), runs=3, inner=1)}
        del got, want
    out[f"{name}_bf16"]["kernels_ms"] = breakdown(
        lambda: H.hist_fused_batched(bins, stats, seg, k, 256, "bf16"))
    return out


def batched_wave(ds) -> dict:
    """B5 at the widest wave of one north-star cv round (5 stratified folds
    of the binary task, wave regime), and both routes at the route's edge
    (K = 21)."""
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.models.fused import FusedCVProgram
    from lightgbm_tpu_torch.ops import histogram as H

    y = ds.get_label()
    assign = np.random.default_rng(0).permutation(len(y)) % 5
    masks = np.stack([assign != k for k in range(5)])
    params = parse_params({"objective": "binary", "num_leaves": 127,
                           "learning_rate": 0.1, "min_data_in_leaf": 20,
                           "verbosity": -1})
    prog = FusedCVProgram(ds, [params], masks, 1, 0, 0)
    wave = widest_wave(lambda: prog.step(prog.init(), 1))
    bins, stats, seg, k = wave
    out = b5_times("b5", bins, stats, seg, k)
    # the route's edge: at K = 21 (63 lanes) the batch goes to B6 through
    # the folded [n, E*K*S] operand; B5 at the same call for comparison
    seg21 = torch.where(seg < 21, seg, -1)
    stats_t = stats.transpose(0, 1)
    out["route_edge_k21_bf16"] = {
        "b6_route_ms": T.device_ms(lambda: H.hist_segstats(
            bins, H.segstats_rows(stats_t, seg21.t(), 21), 256, "bf16"),
            runs=5, inner=2),
        "b5_ms": T.device_ms(lambda: H.hist_fused_batched(
            bins, stats, seg21, 21, 256, "bf16"), runs=5, inner=2)}
    return out, wave


def covertype_like(n, seed):
    """Rows with the shape of UCI Covertype (10 quantitative columns, a
    one-hot wilderness area of 4 and soil type of 40; 7 classes), as
    chip_smoke.py makes them."""
    rng = np.random.default_rng(seed)
    X = np.hstack([rng.normal(0, 1, (n, 10)),
                   np.eye(4)[rng.integers(0, 4, n)],
                   np.eye(40)[rng.integers(0, 40, n)]]).astype(np.float32)
    W = np.random.default_rng(20261017).normal(0, 1, (X.shape[1], 7))
    y = np.argmax(X @ W + rng.gumbel(size=(n, 7)), axis=1)
    return X, y.astype(np.float32)


def covertype_wave() -> dict:
    """B5 at the widest wave of the first multiclass round at Covertype's
    shape (E = 7 class trees, 54 features)."""
    import lightgbm_tpu_torch as lgb

    X, y = covertype_like(581_012, 20261017)
    ds = lgb.Dataset(X, label=y, params={"max_bin": 255})
    ds.construct()
    params = {"objective": "multiclass", "num_class": 7, "num_leaves": 127,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "max_bin": 255,
              "verbosity": -1}
    return b5_times("b5_covertype", *widest_wave(
        lambda: lgb.train(params, ds, 1)))


def main() -> int:
    if not torch.cuda.is_available():
        print("hist_timing: no CUDA device", file=sys.stderr)
        return 2
    import lightgbm_tpu_torch as lgb
    import lightgbm_tpu_torch.models.tree as T
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.kernels import build
    from lightgbm_tpu_torch.metrics import get_metric
    from lightgbm_tpu_torch.models.gbdt import (HyperScalars,
                                                resolve_wave_width)
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    print(ROOT, build.build(["hist_fused", "hist_partition",
                             "hist_segstats", "split_iter",
                             "hist_fused_batched", "hist_fused_int8"]))
    dev = torch.device("cuda")
    X, y = make_higgs_like(1_000_000, 28, seed=0)
    bins = torch.from_numpy(BinMapper.fit(X, max_bin=255).transform(X)).to(
        dev)
    p = np.full(len(y), float(y.mean()))
    stats = torch.from_numpy(np.stack([p - y, p * (1 - p), np.ones(len(y))],
                                      1).astype(np.float32)).to(dev)
    zeros = torch.zeros(len(y), dtype=torch.int32, device=dev)
    params = {"objective": "binary", "num_leaves": 127,
              "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1}
    pp = parse_params(params)
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
    out = {"wave_w": rec["w"]}
    for mode in ("f32", "bf16"):
        got = H.hist_fused(bins, stats, zeros, 1, 256, mode)
        want = H.hist_fused_plain(bins, stats, zeros, 1, 256, mode)
        g2, l2 = H.hist_partition_fused(*wave, mode)
        w2, wl2 = H.hist_partition_plain(*wave, mode)
        torch.cuda.synchronize()
        out[mode] = {
            "b1_err": float((got - want).abs().max()),
            "b2_err": float((g2 - w2).abs().max()),
            "route_eq": bool(torch.equal(l2, wl2)),
            # digests of B1's and B2's outputs: two versions of the
            # kernels compare them across runs
            "b1_sha": digest(got), "b2_sha": digest(g2),
            "b1_ms": T.device_ms(lambda: H.hist_fused(bins, stats, zeros, 1,
                                                      256, mode)),
            "b2_ms": T.device_ms(lambda: H.hist_partition_fused(*wave, mode))}
    out.update(int8_times(bins, stats, wave))
    ds = lgb.Dataset(X, label=y, params={"max_bin": 255})
    ds.construct()
    b5, b5_wave = batched_wave(ds)
    out.update(b5)
    out.update(covertype_wave())
    dbins = diamonds_bins(dev)
    out.update(segstats_shapes(dev, dbins, bins))
    out.update(plan_variants(b5_wave, dbins, bins))
    out.update(sweep_round_b6())
    del b5_wave
    if "--kernels" in sys.argv[1:]:
        print("RESULT", ROOT, json.dumps(out))
        return 0
    lgb.train(params, ds, 1)
    Xv, yv = make_higgs_like(200_000, 28, seed=9)
    yt = torch.from_numpy(yv).to(dev)
    for tag, extra in (("", {}), ("_int8", {"hist_dtype": "int8"})):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        booster = lgb.train(dict(params, **extra), ds, 10)
        torch.cuda.synchronize()
        out["s_per_round" + tag] = (time.perf_counter() - t0) / 10
        pv = torch.from_numpy(booster.predict(Xv)).to(dev)
        out["auc" + tag] = float(get_metric("auc").fn(pv, yt,
                                                      torch.ones_like(yt)))
    out.update(diamonds())
    print("RESULT", ROOT, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
