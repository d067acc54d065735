"""Time the histogram kernels of the checkout this file lives in, on the card.

    python3 <checkout>/lightgbm_tpu_torch/kernels/hist_timing.py

Builds ``hist_fused`` (B1), ``hist_fused_int8`` (B1's int8 mode),
``hist_partition`` (B2), ``hist_segstats`` (B6) and ``hist_fused_batched``
(B5) from that checkout, then on
``make_higgs_like(1,000,000)`` binned to 255 bins: each kernel against its
plain version (max abs err, routing equal) and its device ms per launch
(CUDA events, median of 11 runs of 5 launches queued behind a spin kernel)
at the north-star root (binary round-1 statistics, one segment) and at the
widest wave of a real north-star tree (grown once with the plain versions;
B1 int8 there with the wave's direct children as segments, bit-equal to its
plain version, beside one ``index_add_`` of the quantized values into flat
int32 cells);
B5 at the widest wave of a north-star ``cv()`` round (5 folds, K = 42), with
one ``index_add_`` over the flat (element, segment, feature, bin) cells as
the library call, and both routes at the route's edge (K = 21: B6 through
the folded operand, and B5); then 10 rounds of north-star training
(seconds per round) and its AUC on ``make_higgs_like(200,000, seed=9)``,
at the default bf16 and at ``hist_dtype="int8"``.
On the grid-search workflow's diamonds split (``make_synthetic_diamonds``,
about 45,800 x 6): B6 at 240 channels (an 8-config sweep bucket's two-child
histograms), ``cv()`` as examples/gridsearch_cv.py calls it (seconds,
``best_iter``, ``best_score``) and the 8-config num_leaves 127 sweep bucket
run to its end (seconds, rounds).  Prints one ``RESULT`` JSON line.  To
compare two versions of the kernels in one call, unpack the other version
into an ignored directory, copy this file into it, and run both files in
turns (old, new, new, old).  Needs a CUDA card.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

SPIN_CYCLES = 20_000_000


def device_ms(fn, runs=11, inner=5):
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


def diamonds(dev) -> dict:
    """B6 at the sweep's shape, ``cv()`` and one sweep bucket on the
    diamonds split."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.models.fused import run_fused_cv_batch
    from lightgbm_tpu_torch.ops import histogram as H
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, _ = make_synthetic_diamonds()
    tr, _ = train_test_split_bernoulli(len(y), p_train=0.85, seed=3928272)
    X, y = X[tr], y[tr]
    bins = torch.from_numpy(BinMapper.fit(X, max_bin=255).transform(X)).to(
        dev)
    st = torch.from_numpy(np.random.default_rng(5).normal(
        size=(len(y), 240)).astype(np.float32)).to(dev)
    out = {}
    for mode in ("f32", "bf16"):
        got = H.hist_segstats(bins, st, 256, mode)
        want = H.hist_segstats_plain(bins, st, 256, mode)
        torch.cuda.synchronize()
        out[f"b6_{mode}"] = {
            "err": float((got - want).abs().max()),
            "ms": device_ms(lambda: H.hist_segstats(bins, st, 256, mode))}
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
    res = run_fused_cv_batch(ds, [parse_params(g) for g in grid], masks,
                             1000, 5, 3928272)
    torch.cuda.synchronize()
    out["bucket_127x8"] = {"s": time.perf_counter() - t0, "rounds": res[3],
                           "best_iter": res[1].tolist()}
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
            "ms": device_ms(lambda: H.hist_fused(bins, stats, seg, k, 256,
                                                 "int8")),
            "plain_ms": device_ms(lambda: H.hist_fused_plain(
                bins, stats, seg, k, 256, "int8"), runs=3, inner=1),
            "index_add_ms": device_ms(lambda: acc.index_add_(0, flat,
                                                             vals))}
        del flat, vals, acc
    return out


def batched_wave(ds) -> dict:
    """B5 at the widest wave of one north-star cv round (5 stratified folds
    of the binary task, wave regime): kernel, plain version and one
    ``index_add_`` over the flat (element, segment, feature, bin) cells."""
    import lightgbm_tpu_torch.models.tree as T
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
    rec = {}
    orig = T.compute_histograms_batched

    def spy(bins, stats, seg, k, *a, **kw):
        if k > rec.get("k", 0):
            rec.update(k=k, args=(bins, stats.clone(), seg.clone(), k))
        return orig(bins, stats, seg, k, *a, **kw)

    T.compute_histograms_batched = spy
    try:
        prog.step(prog.init(), 1)
    finally:
        T.compute_histograms_batched = orig
    bins, stats, seg, k = rec["args"]
    e, f = stats.shape[0], bins.shape[1]
    valid = (seg >= 0) & (seg < k)
    el, rows = torch.nonzero(valid, as_tuple=True)
    flat = ((((el * k + seg[el, rows].to(torch.int64)) * f)[:, None]
             + torch.arange(f, device=bins.device)) * 256
            + bins[rows].to(torch.int64)).reshape(-1)
    vals = stats[el, rows].repeat_interleave(f, dim=0)
    acc = torch.zeros(e * k * f * 256, 3, device=bins.device)
    out = {"b5_shape": f"E={e} K={k} n={bins.shape[0]} F={f}",
           "b5_index_add_ms": device_ms(lambda: acc.index_add_(0, flat,
                                                               vals))}
    del flat, vals, acc
    # the route's edge: at K = 21 (63 lanes) the batch goes to B6 through
    # the folded [n, E*K*S] operand; B5 at the same call for comparison
    seg21 = torch.where(seg < 21, seg, -1)
    stats_t = stats.transpose(0, 1)
    out["route_edge_k21_bf16"] = {
        "b6_route_ms": device_ms(lambda: H.hist_segstats(
            bins, H.segstats_rows(stats_t, seg21.t(), 21), 256, "bf16"),
            runs=5, inner=2),
        "b5_ms": device_ms(lambda: H.hist_fused_batched(
            bins, stats, seg21, 21, 256, "bf16"), runs=5, inner=2)}
    for mode in ("f32", "bf16"):
        got = H.hist_fused_batched(bins, stats, seg, k, 256, mode)
        want = H.hist_fused_batched_plain(bins, stats, seg, k, 256, mode)
        torch.cuda.synchronize()
        out[f"b5_{mode}"] = {
            "err": float((got - want).abs().max()),
            "ms": device_ms(lambda: H.hist_fused_batched(bins, stats, seg, k,
                                                         256, mode)),
            "plain_ms": device_ms(lambda: H.hist_fused_batched_plain(
                bins, stats, seg, k, 256, mode), runs=3, inner=1)}
    return out


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
            "b1_ms": device_ms(lambda: H.hist_fused(bins, stats, zeros, 1,
                                                    256, mode)),
            "b2_ms": device_ms(lambda: H.hist_partition_fused(*wave, mode))}
    out.update(int8_times(bins, stats, wave))
    ds = lgb.Dataset(X, label=y, params={"max_bin": 255})
    ds.construct()
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
    out.update(batched_wave(ds))
    out.update(diamonds(dev))
    print("RESULT", ROOT, json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
