"""The hand-written kernels against their plain PyTorch versions on the card:
the forest-predict kernel (B4), the histogram kernels (B1 ``hist_fused``
in f32, bf16 and int8 mode, B2 ``hist_partition``, B5
``hist_fused_batched``, B6 ``hist_segstats``) and the split iteration (B3
``split_iter``, bit for bit).

The tests need a CUDA card and nvcc and skip without them.  This file
imports no JAX, so it runs on the machine with the card (whose Python has
no JAX; ``--noconftest`` skips ``tests/conftest.py``, which imports it):

    python3 -m pytest tests/test_torch_kernels_on_card.py -q --noconftest

B1's int8 mode and B3 have their own edge cases (one bin holding every
row, empty segments, a segment holding every row, most rows outside the
call, ragged row counts; B3 at the strict Booster's F = 28 with E = 1, the
``cv()`` shape E = 5, the in-place table), and so have B1 (f32/bf16) and
B2 since their partitioned design (both segments empty, one row in a
segment, every row in one bin, row counts no tile divides, views that
start off a 16-byte boundary, F = 300 with K = 42, one slot taking 90 %
of a wave's rows; dyadic statistics exact).

B4 has its own: every bucket of the serving ladder and both routes of
its plan, trees of 8,191 leaves (also served through ``PredictorRuntime``),
1,000 trees and rows of 2,000 columns.

One column (examples/bagging_boosting.py's data): B1, B6, B3 and B4 at
F = 1.  Per-node sampling on the strict grower: no B3 launch, B1 or B6
under the unfused body, structure-equal to the plain path.

GOSS and DART: the compacted selection on the card equals the CPU's with
no host read; GOSS's compacted rows and DART's dropped rounds train on the
wave grower, kernel path structure-equal to the plain path.

Ranking: the lambda pass on the card against the CPU's on both routes
with no host read, and a lambdarank round through B1/B2 against the plain
path.

Constraints: monotone constraints, interaction constraints and
extra-trees on the wave grower (B1 roots, B2 waves), the strict grower (B1
pairs, no B3) and the batched multiclass waves (B5), kernel path against
the plain path on exact sums; the extra-trees table drawn on the card
equal to the CPU's with no host read.

Linear leaves and introspection: a linear round on the wave grower (B1
roots, B2 waves) and on the strict grower (B1 pairs and B3) against the
plain path on exact sums, every field of the round-1 tree (the linear fit
is the same plain code on the same rows) equal, the fit under sync debug
mode "error"; TreeSHAP on the card against the CPU (within 1e-5) and its
additivity.

Continuation: 3 rounds continued 3 more on the card through
``init_model=<Booster>``, ``init_model=<model file>`` and
``Booster(model_file).update(ds)`` equal to 6 uninterrupted rounds bit for
bit (waves: B1 and B2; strict: B1 and B3); ``refit`` on the card
deterministic (one-hot matmul sums over row chunks, no float atomics) and
within rtol 1e-5 of the CPU's.

Multi-device training on virtual shards (2 and 4 on the card): wave,
strict, voting, feature-sharded, 2-D, multiclass and int8 runs through
the kernels per shard grow the plain path's trees bit for bit on exact
sums, and (but int8 and voting) the serial round-1 tree (multiclass: its
first differing split, if any, a near tie).

The serving mesh and streamed data parallelism on 4 virtual shards: dp
through B4 bit for bit the single route at every bucket and tp bit for bit
the same route on the CPU (B4 == plain, the psum in shard order), each
shard's tree slice kernel == plain, the node tables built once in
``warm()``; a streamed dp round (B1 per shard per block, B3 under psum)
growing the in-memory mesh's tree (serial streaming's at int8) on exact
sums; streamed dp killed and resumed bit for bit, and at D = 2.

Recovery: a 3-round run killed after each round and resumed from its
checkpoint on the card (50,000 rows, the wave grower through B1 and B2, the
strict grower through B1 and B3, int8 through B1's int8 mode) grows the
uninterrupted run's trees, train scores and bag bit for bit.

Tolerances: forest predictions bit for bit (served probabilities, whose
sigmoid may differ by an ulp between card and CPU, rtol 1e-5 / atol 1e-6);
histograms per cell
``|kernel - plain| <= 1e-6 * sum|x|`` (kernel and plain version sum in f64
in other orders and round once); counts, routing and two launches of a
histogram kernel exactly equal; B1's int8 mode bit for bit (integer
sums).
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import predict as tp

MODES = ["f32", "bf16"]
PRECISIONS = ["f32", "bf16", "int8"]
RTOL, ATOL = 1e-5, 1e-6


def _abs_hist(bins, stats, seg, k, num_bins, mode):
    """Per-cell sum |x| (float64) of the mode-rounded statistics."""
    st = stats
    if mode == "bf16":
        st = torch.from_numpy(stats).to(torch.bfloat16).float().numpy()
    st = np.abs(st).astype(np.float64)
    out = np.zeros((k, bins.shape[1], num_bins, stats.shape[1]))
    ok = (seg >= 0) & (seg < k)
    for j in range(bins.shape[1]):
        np.add.at(out, (seg[ok], j, bins[ok, j].astype(np.int64)), st[ok])
    return out


def _close(got, want, mag):
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= 1e-6 * mag).all(), float((err - 1e-6 * mag).max())
    np.testing.assert_array_equal(got[..., 2], want[..., 2])   # counts


def _stats(rng, n):
    return np.stack([rng.normal(size=n), rng.uniform(0, 0.25, n),
                     (rng.random(n) < 0.8).astype(np.float64)],
                    axis=1).astype(np.float32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_b1_kernel_matches_plain_on_card(mode):
    dev = _card()
    rng = np.random.default_rng(21)
    bins = rng.integers(0, 256, (100_003, 28)).astype(np.uint8)
    stats = _stats(rng, 100_003)
    seg = rng.integers(-1, 4, 100_003).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (bins, stats, seg)]
    got = th.hist_fused(*t, 3, 256, mode)
    again = th.hist_fused(*t, 3, 256, mode)
    want = th.hist_fused_plain(*t, 3, 256, mode)
    assert torch.equal(got, again)
    _close(got.cpu().numpy(), want.cpu().numpy(),
           _abs_hist(bins, stats, seg, 3, 256, mode))


# B1's (f32/bf16) edge cases: (name, n, F, B, K, statistics)
B1_EDGES = [("both_segments_empty", 50_000, 28, 256, 2, 3),
            ("one_row_in_a_segment", 50_000, 28, 256, 2, 3),
            ("every_row_in_one_bin", 70_001, 28, 256, 2, 3),
            ("root_ragged_rows", 100_003, 28, 256, 1, 3),
            ("strict_ragged_rows", 100_003, 28, 256, 2, 3),
            ("root_view_off_16_bytes", 100_003, 28, 256, 1, 3),
            ("strict_95pct_outside", 300_007, 28, 256, 2, 3),
            ("f300_k42", 20_011, 300, 256, 42, 3),
            ("root_f7_b64", 50_000, 7, 64, 1, 3),
            ("two_statistics_two_bins", 4_099, 3, 2, 5, 2),
            ("strict_dyadic", 200_000, 28, 256, 2, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", B1_EDGES, ids=[c[0] for c in B1_EDGES])
def test_b1_edge_cases_on_card(mode, case):
    """B1 (f32/bf16) within 1e-6 * sum|x| of float64 and of its plain
    version (exact on dyadic statistics), bit-equal across launches, where
    its partition, work items, ring tiles and bulk copies are stressed."""
    name, n, f, nb, k, s = case
    dev = _card()
    rng = np.random.default_rng(len(name) + n)
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    stats = _stats(rng, n)[:, :s].copy()
    seg = rng.integers(0, k, n).astype(np.int32)
    if name == "both_segments_empty":
        seg[:] = 2
    elif name == "one_row_in_a_segment":
        seg[:] = 2
        seg[n // 3] = 1
    elif name == "every_row_in_one_bin":
        bins[:] = 7
    elif name == "strict_95pct_outside":
        seg = np.where(rng.random(n) < 0.95, 2, seg).astype(np.int32)
    elif name == "strict_dyadic":
        stats = (rng.integers(-8, 9, (n, 3)) * 0.25).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (bins, stats, seg)]
    if name == "root_view_off_16_bytes":
        # views 3 rows in: the codes start 84 bytes into their storage
        bins, stats, seg = bins[3:], stats[3:], seg[3:]
        t = [x[3:] for x in t]
    got = th.hist_fused(*t, k, nb, mode)
    again = th.hist_fused(*t, k, nb, mode)
    want = th.hist_fused_plain(*t, k, nb, mode)
    torch.cuda.synchronize()
    assert got.shape == (k, f, nb, s)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    g = got.cpu().numpy()
    ref = _f64_sums(bins, stats, seg, k, nb, mode)
    if name == "strict_dyadic":
        np.testing.assert_array_equal(g, ref)
    mag = _abs_hist(bins, stats, seg, k, nb, mode)
    assert (np.abs(g - ref) <= 1e-6 * mag).all()
    err = np.abs(g.astype(np.float64) - want.cpu().numpy())
    assert (err <= 1e-6 * mag).all()
    if s == 3:
        np.testing.assert_array_equal(g[..., 2], want.cpu().numpy()[..., 2])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("w,heavy", [(42, 0.9), (1, None)],
                         ids=["one_slot_90pct", "one_split"])
def test_b2_edge_cases_on_card(mode, w, heavy):
    """B2 where one slot takes 90 % of the rows (its direct child all of
    them) and at a wave of one split: routing equal to ``route_wave``'s,
    cells within 1e-6 * sum|x| of float64 and of the plain version,
    bit-equal across launches."""
    dev = _card()
    rng = np.random.default_rng(50 + w)
    n, cap, f = 300_001, 120, 28
    bins = rng.integers(0, 256, (n, f)).astype(np.uint8)
    stats = _stats(rng, n)
    row_leaf = rng.integers(0, cap, n).astype(np.int32)
    slot = np.full(cap, -1, np.int32)
    nodes = rng.permutation(cap)[:w]
    slot[nodes] = np.arange(w)
    feat = rng.integers(0, f, w).astype(np.int32)
    thr = rng.integers(0, 256, w).astype(np.int32)
    dl = rng.integers(0, 2, w).astype(np.uint8)
    if heavy is not None:
        row_leaf = np.where(rng.random(n) < heavy, nodes[0],
                            row_leaf).astype(np.int32)
        thr[0], dl[0] = 255, 1
    t = [torch.from_numpy(a).to(dev)
         for a in (bins, stats, row_leaf, slot, feat, thr, dl)]
    got, leaf = th.hist_partition_fused(*t, 2 * cap, 256, mode)
    again, leaf2 = th.hist_partition_fused(*t, 2 * cap, 256, mode)
    want, want_leaf = th.hist_partition_plain(*t, 2 * cap, 256, mode)
    seg, route_leaf = th.route_wave(t[0], *t[2:], 2 * cap)
    torch.cuda.synchronize()
    assert torch.equal(leaf, route_leaf) and torch.equal(leaf, leaf2)
    assert torch.equal(leaf, want_leaf)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    seg = seg.cpu().numpy()
    if heavy is not None:
        assert (seg == 0).mean() > 0.85
    g = got.cpu().numpy()
    mag = _abs_hist(bins, stats, seg, w, 256, mode)
    assert (np.abs(g - _f64_sums(bins, stats, seg, w, 256, mode))
            <= 1e-6 * mag).all()
    _close(g, want.cpu().numpy(), mag)


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,nb,k,lo", [(100_003, 28, 256, 1, 0),
                                         (100_003, 28, 256, 42, -1),
                                         (4_099, 3, 2, 5, -3),
                                         (20_011, 300, 64, 70, 0)])
def test_b1_int8_kernel_bit_equal_to_plain_on_card(n, f, nb, k, lo):
    """B1's int8 mode: integer sums are exact, so the kernel equals its
    plain version bit for bit (segments out of range, padding rows)."""
    dev = _card()
    rng = np.random.default_rng(23 + k)
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    stats = _stats(rng, n)
    stats[-100:] = 0.0
    seg = rng.integers(lo, k + 2, n).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (bins, stats, seg)]
    got = th.hist_fused(*t, k, nb, "int8")
    again = th.hist_fused(*t, k, nb, "int8")
    want = th.hist_fused_plain(*t, k, nb, "int8")
    cpu = th.hist_fused_plain(*(x.cpu() for x in t), k, nb, "int8")
    assert torch.equal(got, again) and torch.equal(got, want)
    assert torch.equal(got.cpu(), cpu)
    q, scale = th.quantize_int8(t[1])
    q_cpu, scale_cpu = th.quantize_int8(t[1].cpu())
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(scale.cpu(), scale_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_b2_kernel_matches_plain_on_card(mode):
    dev = _card()
    rng = np.random.default_rng(22)
    n, cap, w = 100_003, 120, 42
    bins = rng.integers(0, 256, (n, 28)).astype(np.uint8)
    stats = _stats(rng, n)
    row_leaf = rng.integers(0, cap, n).astype(np.int32)
    slot = np.full(cap, -1, np.int32)
    slot[rng.permutation(cap)[:w]] = np.arange(w)
    feat = rng.integers(0, 28, w).astype(np.int32)
    thr = rng.integers(0, 256, w).astype(np.int32)
    dl = rng.integers(0, 2, w).astype(np.uint8)
    t = [torch.from_numpy(a).to(dev)
         for a in (bins, stats, row_leaf, slot, feat, thr, dl)]
    got, leaf = th.hist_partition_fused(*t, cap, 256, mode)
    again, leaf2 = th.hist_partition_fused(*t, cap, 256, mode)
    want, want_leaf = th.hist_partition_plain(*t, cap, 256, mode)
    assert torch.equal(leaf, want_leaf) and torch.equal(leaf, leaf2)
    assert torch.equal(got, again)
    seg, _ = th.route_wave(t[0], *t[2:], cap)
    _close(got.cpu().numpy(), want.cpu().numpy(),
           _abs_hist(bins, stats, seg.cpu().numpy(), w, 256, mode))


def _rand_tree(rng, m, f, num_bins):
    """One ragged tree with grower-style sentinels and garbage in dead
    slots."""
    feat = np.zeros(m, np.int32)
    thr = np.zeros(m, np.int32)
    left = -np.ones(m, np.int32)
    right = -np.ones(m, np.int32)
    leafv = rng.normal(size=m).astype(np.float32)     # internal garbage
    isl = np.zeros(m, bool)
    n_nodes, frontier = 1, [0]
    while frontier and n_nodes + 2 <= m:
        i = frontier.pop(rng.integers(len(frontier)))
        if rng.random() < 0.3 and i != 0:
            isl[i] = True
            leafv[i] = np.float32(rng.normal())
            continue
        feat[i] = rng.integers(f)
        thr[i] = rng.integers(0, num_bins)
        left[i], right[i] = n_nodes, n_nodes + 1
        frontier += [n_nodes, n_nodes + 1]
        n_nodes += 2
    for i in frontier:
        isl[i] = True
        leafv[i] = np.float32(rng.normal())
    leafv[n_nodes:] = 777.0
    return feat, thr, left, right, leafv, isl


def _stored(arrays, precision):
    """(per-node arrays in the precision's storage form, leaf_scale)."""
    feat, thr, left, right, leafv, isl = arrays
    if precision == "f32":
        return arrays, None
    if precision == "bf16":
        stored = torch.from_numpy(leafv).to(torch.bfloat16).float().numpy()
        return (feat, thr, left, right, stored, isl), None
    scale = np.full(feat.shape[0], 1.0 / 128.0, np.float32)
    codes = np.clip(np.round(leafv / scale[:, None]), -127,
                    127).astype(np.int8)
    return (feat.astype(np.int16), thr.astype(np.uint8),
            left.astype(np.int16), right.astype(np.int16), codes,
            isl), scale


@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
def test_kernel_matches_plain_version_on_card(precision):
    _card()
    from lightgbm_tpu_torch.kernels.predict import PREDICT_FOREST_LAUNCHES

    rng = np.random.default_rng(31)
    trees = [_rand_tree(rng, 63, 9, 40) for _ in range(13)]
    arrays = tuple(np.stack(x) for x in zip(*trees))
    bins = rng.integers(0, 40, (45, 9)).astype(np.uint8)
    stored, scale = _stored(arrays, precision)
    t = tp.pack_forest_soa(*stored, precision=precision, leaf_scale=scale,
                           device="cuda")
    tb = torch.from_numpy(bins).cuda()
    before = PREDICT_FOREST_LAUNCHES.count
    for k, s in [(13, 0), (4, 3), (1, 12)]:
        got = tp.predict_forest(t, tb, 0.1, 0.5, k, 20, start_iteration=s)
        want = tp.predict_forest_plain(t, tb, 0.1, 0.5, k, 20,
                                       start_iteration=s)
        assert torch.equal(got, want), (k, s)
    assert PREDICT_FOREST_LAUNCHES.count == before + 3


def _windows(t):
    """(num_iteration, start_iteration) pairs over a forest of ``t``
    trees: all of it, its first third, a middle half, its last tree, past
    its end."""
    return [(t, 0), (t // 3, 0), (t // 2, t // 4), (1, t - 1), (t + 50, 0),
            (5, t + 3)]


def _b4_forest(seed, trees, leaves, f, precision):
    from lightgbm_tpu_torch.kernels._timing import (depth_cap_of,
                                                    make_forest, soa_for)

    arrays = make_forest(seed, trees, leaves, np.full(f, 255))
    return soa_for(arrays, precision, "cuda"), depth_cap_of(arrays)


def _b4_equal(soa, depth, bins, windows, lr=0.1, init=0.5):
    for k, s in windows:
        got = tp.predict_forest(soa, bins, lr, init, k, depth, s)
        want = tp.predict_forest_plain(soa, bins, lr, init, k, depth, s)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (bins.shape, k, s)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["plan", "l2"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_b4_every_bucket_and_route_on_card(precision, route, monkeypatch):
    """The north-star forest (100 trees x 127 leaves, F = 28) at every
    bucket of the serving ladder, bit for bit against the plain version:
    as the plan launches it, and with every record read through L2 (no
    staged prefix)."""
    _card()
    from lightgbm_tpu_torch.kernels import predict as kp

    if route == "l2":
        monkeypatch.setattr(kp, "RECORD_BYTES", 0)
        kp.plan.cache_clear()
    soa, depth = _b4_forest(41, 100, 127, 28, precision)
    rng = np.random.default_rng(43)
    bins = torch.from_numpy(rng.integers(0, 255, (1 << 14, 28)).astype(
        np.uint8)).cuda()
    try:
        for i in range(15):
            b = 1 << i
            p = kp.plan(28, soa.split_feature.shape[1], 100, b)
            assert route == "plan" or p.route == "l2"
            _b4_equal(soa, depth, bins[:b], [(100, 0), (40, 30)])
    finally:
        kp.plan.cache_clear()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["leaves_8191_f32", "trees_1000",
                                  "features_2000"])
def test_b4_large_forests_on_card(case):
    """Trees of 8,191 leaves (16,384 slots, past one block's shared
    memory: a staged prefix and L2 below it), 1,000 trees (several rounds
    of a cluster) and rows of 2,000 columns (codes read from global
    memory), bit for bit against the plain version."""
    _card()
    trees, leaves, f, precisions = {
        "leaves_8191_f32": (3, 8191, 28, ["f32"]),
        "trees_1000": (1000, 127, 28, PRECISIONS),
        "features_2000": (24, 31, 2000, PRECISIONS)}[case]
    rng = np.random.default_rng(47)
    for precision in precisions:
        soa, depth = _b4_forest(53 + leaves, trees, leaves, f, precision)
        for n in (1, 300, 4096):
            bins = torch.from_numpy(rng.integers(0, 255, (n, f)).astype(
                np.uint8)).cuda()
            _b4_equal(soa, depth, bins, _windows(trees))
        _b4_equal(soa, max(depth // 2, 1), bins, [(trees, 0)])


@pytest.mark.gpu
@pytest.mark.parametrize("precision", PRECISIONS)
def test_b4_several_rounds_on_card(precision):
    """1,000 trees at 8,192 and 16,384 rows: a cluster walks the window in
    several rounds (the next round's records copied while a round is
    folded), bit for bit against the plain version."""
    _card()
    from lightgbm_tpu_torch.kernels import predict as kp

    soa, depth = _b4_forest(67, 1000, 127, 28, precision)
    rng = np.random.default_rng(71)
    bins = torch.from_numpy(rng.integers(0, 255, (1 << 14, 28)).astype(
        np.uint8)).cuda()
    for n in (1 << 13, 1 << 14):
        assert kp.plan(28, soa.split_feature.shape[1], 1000, n).rounds > 1
        _b4_equal(soa, depth, bins[:n], [(1000, 0), (700, 150)])


@pytest.mark.gpu
def test_b4_serves_8191_leaf_forest_on_card():
    """A ``PredictorRuntime`` deploys three 8,191-leaf f32 trees on the
    card and serves them, bit for bit equal to the same runtime on the CPU
    (the plain version)."""
    _card()
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.kernels._timing import make_forest
    from lightgbm_tpu_torch.serving import PredictorRuntime, packed_from_arrays

    X = np.random.default_rng(59).normal(size=(3000, 28))
    mapper = BinMapper.fit(X, max_bin=255)
    arrays = make_forest(61, 3, 8191, mapper.n_bins)
    meta = {"shrink": 0.1, "init_score": [0.25], "num_class": 1,
            "best_iteration": -1,
            "params": {"objective": "binary", "num_leaves": 8191},
            "bin_mapper": mapper.to_dict()}
    packed = packed_from_arrays(arrays, meta)
    card = PredictorRuntime(packed, max_bucket=1024, device="cuda")
    card.warm()
    host = PredictorRuntime(packed, max_bucket=1024, device="cpu")
    codes = mapper.transform(X)
    for raw in (True, False):
        got = card.predict_binned(codes, raw_score=raw)
        want = host.predict_binned(codes, raw_score=raw)
        if raw:
            np.testing.assert_array_equal(got, want)
        else:            # the sigmoid's exp may differ by an ulp
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert card.stats.snapshot()["fallbacks"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_b6_kernel_matches_plain_on_card(mode):
    dev = _card()
    rng = np.random.default_rng(21)
    n, f, kc, nb = 20_011, 6, 240, 256
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    st = rng.normal(size=(n, kc)).astype(np.float32)
    tb, ts = torch.from_numpy(bins).to(dev), torch.from_numpy(st).to(dev)
    got = th.hist_segstats(tb, ts, nb, mode)
    again = th.hist_segstats(tb, ts, nb, mode)
    want = th.hist_segstats_plain(tb, ts, nb, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    mag = np.zeros((f, nb, kc))
    a = np.abs(torch.from_numpy(st).to(torch.bfloat16).float().numpy()
               if mode == "bf16" else st).astype(np.float64)
    for j in range(f):
        np.add.at(mag[j], bins[:, j].astype(np.int64), a)
    err = np.abs(got.cpu().numpy().astype(np.float64)
                 - want.cpu().numpy().astype(np.float64))
    assert (err <= 1e-6 * mag).all()


@pytest.mark.gpu
def test_b3_kernel_matches_plain_bit_for_bit_on_card():
    from lightgbm_tpu_torch.kernels.split_iter import split_iter
    from lightgbm_tpu_torch.models.tree import (_packed_root_table,
                                                split_iter_plain)
    from lightgbm_tpu_torch.ops.split import (SplitContext,
                                              constrained_leaf_output,
                                              find_best_split)

    dev = _card()
    rng = np.random.default_rng(22)
    e, f, nb, cap = 40, 6, 63, 63

    def hists(lead):
        shape = tuple(lead) + (f, nb)
        c = rng.integers(0, 6, shape).astype(np.float64)
        h = np.stack([rng.normal(size=shape), rng.uniform(0, 0.25, shape) *
                      (c > 0), c], axis=-1).astype(np.float32)
        return torch.from_numpy(h).to(dev)

    ctx = SplitContext(*(torch.from_numpy(rng.choice(v, e).astype(
        np.float32)).to(dev) for v in ([0.0, 0.5], [0.0, 1.0], [1.0, 20.0],
                                       [1e-3], [0.0, 0.1], [0.0, 0.3],
                                       [0.0, 2.0])))
    fmask = torch.ones((e, f), device=dev)
    root = hists((e,)) * 4
    tot = root[:, 0].sum(dim=1)
    zero = torch.zeros(e, device=dev)
    out = constrained_leaf_output(tot[:, 0], tot[:, 1], tot[:, 2],
                                  ctx._replace(path_smooth=zero),
                                  float("-inf"), float("inf"), zero)
    best = find_best_split(root, ctx, fmask, None, out, arith="scan")
    table = _packed_root_table(cap, out, tot, best)
    aux = torch.stack([zero, best.feature.float(), best.bin.float(),
                       torch.isfinite(best.gain).float(), zero, zero, zero,
                       zero], dim=1)
    scal = torch.zeros((e, 16), device=dev)
    for i, v in enumerate(ctx):
        scal[:, i] = v
    scal[:, 7], scal[:, 8] = -1.0, 1.0
    for _ in range(10):
        hist = hists((e, 2))
        # the kernel updates its table in place: it gets a clone
        tk, ak = split_iter(hist, table.clone(), fmask, aux, scal)
        tp, ap = split_iter_plain(hist, table, fmask, aux, scal)
        torch.cuda.synchronize()
        assert torch.equal(tk.view(torch.int32), tp.view(torch.int32))
        assert torch.equal(ak.view(torch.int32), ap.view(torch.int32))
        scal[:, 8] += 2.0 * (aux[:, 3] > 0).float()
        table, aux = tp, ap


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [22, 42])
def test_b5_kernel_matches_plain_on_card(mode, k):
    dev = _card()
    rng = np.random.default_rng(23)
    n, f, e = 60_013, 9, 3
    bins = rng.integers(0, 256, (n, f)).astype(np.uint8)
    stats = np.stack([_stats(rng, n) for _ in range(e)])
    seg = rng.integers(-1, k + 2, (e, n)).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (bins, stats, seg)]
    got = th.hist_fused_batched(*t, k, 256, mode)
    again = th.hist_fused_batched(*t, k, 256, mode)
    want = th.hist_fused_batched_plain(*t, k, 256, mode)
    torch.cuda.synchronize()
    assert got.shape == (e, k, f, 256, 3)
    assert torch.equal(got, again)
    for i in range(e):
        _close(got[i].cpu().numpy(), want[i].cpu().numpy(),
               _abs_hist(bins, stats[i], seg[i], k, 256, mode))


def _f64_sums(bins, stats, seg, k, num_bins, mode):
    """Float64 sums ``[K, F, B, S]`` of the mode-rounded statistics."""
    st = stats
    if mode == "bf16":
        st = torch.from_numpy(stats).to(torch.bfloat16).float().numpy()
    out = np.zeros((k, bins.shape[1], num_bins, stats.shape[1]))
    ok = (seg >= 0) & (seg < k)
    for j in range(bins.shape[1]):
        np.add.at(out, (seg[ok], j, bins[ok, j].astype(np.int64)),
                  st[ok].astype(np.float64))
    return out


# B5's edge cases: (name, n, F, B, E, K, segment ids from lo to K + hi,
# kind of bins, dyadic statistics)
B5_EDGES = [("one_element", 5_000, 3, 256, 1, 5, 0, 0, "random", False),
            ("ragged_out_of_range", 70_001, 7, 256, 3, 13, -5, 5, "random",
             False),
            ("few_bins", 30_011, 5, 63, 2, 42, -1, 1, "random", False),
            ("one_bin", 40_000, 4, 256, 2, 42, 0, 0, "one", False),
            ("skewed_bins", 50_000, 54, 256, 2, 21, -1, 0, "skewed", False),
            ("dyadic", 80_000, 28, 256, 5, 42, -1, 0, "random", True)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", B5_EDGES, ids=[c[0] for c in B5_EDGES])
def test_b5_edge_cases_on_card(mode, case):
    """B5 within 1e-6 * sum|x| of float64 and of its plain version (exact
    on dyadic statistics), bit-equal across launches, at E = 1, ragged n,
    out-of-range ids, K not a multiple of anything, B < 256, all rows in
    one bin, a few heavy bins over 54 features."""
    name, n, f, nb, e, k, lo, hi, kind, dyadic = case
    dev = _card()
    rng = np.random.default_rng(31 + n)
    if kind == "one":
        bins = np.zeros((n, f), np.uint8)
    elif kind == "skewed":
        bins = rng.choice(np.array([0, 1, 7, nb - 1], np.uint8), (n, f),
                          p=[0.6, 0.3, 0.05, 0.05])
    else:
        bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    if dyadic:
        stats = (rng.integers(-8, 9, (e, n, 3)) * 0.25).astype(np.float32)
    else:
        stats = np.stack([_stats(rng, n) for _ in range(e)])
    seg = rng.integers(lo, k + hi, (e, n)).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (bins, stats, seg)]
    got = th.hist_fused_batched(*t, k, nb, mode)
    again = th.hist_fused_batched(*t, k, nb, mode)
    want = th.hist_fused_batched_plain(*t, k, nb, mode)
    torch.cuda.synchronize()
    assert got.shape == (e, k, f, nb, 3)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    for i in range(e):
        g = got[i].cpu().numpy()
        if dyadic:
            np.testing.assert_array_equal(
                g, _f64_sums(bins, stats[i], seg[i], k, nb, mode))
        mag = _abs_hist(bins, stats[i], seg[i], k, nb, mode)
        _close(g, want[i].cpu().numpy(), mag)
        ref = _f64_sums(bins, stats[i], seg[i], k, nb, mode)
        assert (np.abs(g - ref) <= 1e-6 * mag).all()


# B6's edge cases: (n, F, B, Kc, kind of bins, dyadic statistics)
B6_EDGES = [(10_007, 3, 256, 1, "random", False),
            (45_957, 6, 256, 15, "skewed", False),
            (45_957, 6, 256, 30, "random", False),
            (20_011, 5, 17, 33, "random", False),
            (9_000, 4, 256, 240, "one", False),
            (45_957, 6, 256, 240, "skewed", True),
            (12_345, 6, 256, 1_080, "random", False)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", B6_EDGES,
                         ids=[f"kc{c[3]}_{c[4]}_b{c[2]}" for c in B6_EDGES])
def test_b6_edge_cases_on_card(mode, case):
    """B6 within 1e-6 * sum|x| of float64 and of its plain version (exact
    on dyadic statistics), bit-equal across launches, for Kc from 1 to
    1,080, ragged n, B < 256, all rows in one bin and heavy bins."""
    n, f, nb, kc, kind, dyadic = case
    dev = _card()
    rng = np.random.default_rng(41 + kc)
    if kind == "one":
        bins = np.full((n, f), 3, np.uint8)
    elif kind == "skewed":
        bins = rng.choice(np.array([0, 1, 4, 9, 200], np.uint8), (n, f),
                          p=[0.5, 0.2, 0.15, 0.1, 0.05])
    else:
        bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    st = (rng.integers(-8, 9, (n, kc)) * 0.25).astype(np.float32) if dyadic \
        else rng.normal(size=(n, kc)).astype(np.float32)
    tb, ts = torch.from_numpy(bins).to(dev), torch.from_numpy(st).to(dev)
    got = th.hist_segstats(tb, ts, nb, mode)
    again = th.hist_segstats(tb, ts, nb, mode)
    want = th.hist_segstats_plain(tb, ts, nb, mode)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    a = torch.from_numpy(st).to(torch.bfloat16).float().numpy() \
        if mode == "bf16" else st
    ref = np.zeros((f, nb, kc))
    mag = np.zeros((f, nb, kc))
    for j in range(f):
        np.add.at(ref[j], bins[:, j].astype(np.int64), a.astype(np.float64))
        np.add.at(mag[j], bins[:, j].astype(np.int64),
                  np.abs(a).astype(np.float64))
    g = got.cpu().numpy().astype(np.float64)
    if dyadic:
        np.testing.assert_array_equal(g, ref)
    assert (np.abs(g - ref) <= 1e-6 * mag).all()
    assert (np.abs(g - want.cpu().numpy()) <= 1e-6 * mag).all()


INT8_EDGES = [
    # name, n, f, nb, k, s
    ("one_bin_feature", 100_003, 28, 256, 3, 3),
    ("empty_segments", 50_021, 6, 64, 9, 3),
    ("one_segment_all_rows", 70_001, 28, 256, 3, 3),
    ("k42_70pct_outside", 300_007, 28, 256, 42, 3),
    ("root_ragged", 12_345, 5, 256, 1, 3),
    ("root_one_bin_zero_channel", 100_003, 28, 256, 1, 3),
    ("one_channel", 40_009, 7, 33, 5, 1),
    ("five_channels", 40_009, 7, 33, 5, 5),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", INT8_EDGES, ids=[c[0] for c in INT8_EDGES])
def test_b1_int8_edge_cases_on_card(case):
    """B1's int8 mode bit for bit against its plain version (and the plain
    version of its own passes, :func:`int8_passes_plain`, at the launch's
    plan) where its work items and warp aggregation are stressed."""
    from lightgbm_tpu_torch.kernels import histogram as kh

    name, n, f, nb, k, s = case
    dev = _card()
    rng = np.random.default_rng(len(name) + n)
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    stats = rng.normal(size=(n, s)).astype(np.float32)
    if s >= 3:
        stats[:, 1] = rng.uniform(0, 0.25, n)
        stats[:, 2] = (rng.random(n) < 0.8).astype(np.float32)
    seg = rng.integers(0, k, n).astype(np.int32)
    if name.startswith("one_bin") or name.startswith("root_one_bin"):
        bins[:, 0] = 7                   # every row of feature 0 in one bin
        bins[:, 5] = np.where(rng.random(n) < 0.95, 0, bins[:, 5])
    if name == "root_one_bin_zero_channel":
        stats[:, 1] = 0.0                # the 1e-30 scale floor
    if name == "empty_segments":
        seg = rng.choice(np.array([0, 4, 8, -1, 11], np.int32), n)
    if name == "one_segment_all_rows":
        seg[:] = 1
    if name == "k42_70pct_outside":
        seg = np.where(rng.random(n) < 0.7, k + 3, seg).astype(np.int32)
    t = [torch.from_numpy(a).to(dev) for a in (bins, stats, seg)]
    got = th.hist_fused(*t, k, nb, "int8")
    again = th.hist_fused(*t, k, nb, "int8")
    want = th.hist_fused_plain(*t, k, nb, "int8")
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    rows, fg, _, target, _ = kh.plan_int8(
        n, f, s, k, nb, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    passes = kh.int8_passes_plain(*t, k, nb, rows, fg, target)
    assert torch.equal(got.view(torch.int32), passes.view(torch.int32))
    assert torch.equal(kh.int8_scale_plain(t[1]), th.quantize_int8(t[1])[1])


def _b3_chain(e, f, nb, iters, seed, in_place):
    """``iters`` chained B3 iterations of ``e`` elements, bit for bit
    against the plain version on table and aux; ``in_place``: the kernel
    runs on its own running table (as the strict grower calls it), else on
    a clone of the plain version's each time."""
    from lightgbm_tpu_torch.kernels.split_iter import split_iter
    from lightgbm_tpu_torch.models.tree import (_packed_root_table,
                                                split_iter_plain)
    from lightgbm_tpu_torch.ops.split import (SplitContext,
                                              constrained_leaf_output,
                                              find_best_split)

    dev = _card()
    rng = np.random.default_rng(seed)
    cap = 2 * iters + 3

    def hists(lead):
        shape = tuple(lead) + (f, nb)
        c = rng.integers(0, 6, shape).astype(np.float64)
        h = np.stack([rng.normal(size=shape), rng.uniform(0, 0.25, shape) *
                      (c > 0), c], axis=-1).astype(np.float32)
        return torch.from_numpy(h).to(dev)

    ctx = SplitContext(*(torch.from_numpy(rng.choice(v, e).astype(
        np.float32)).to(dev) for v in ([0.0, 0.5], [0.0, 1.0], [1.0, 20.0],
                                       [1e-3], [0.0, 0.1], [0.0, 0.3],
                                       [0.0, 2.0])))
    fmask = torch.from_numpy((rng.random((e, f)) < 0.8).astype(
        np.float32)).to(dev)
    fmask[:, 0] = 1.0
    root = hists((e,)) * 4
    tot = root[:, 0].sum(dim=1)
    zero = torch.zeros(e, device=dev)
    out = constrained_leaf_output(tot[:, 0], tot[:, 1], tot[:, 2],
                                  ctx._replace(path_smooth=zero),
                                  float("-inf"), float("inf"), zero)
    best = find_best_split(root, ctx, fmask, None, out, arith="scan")
    table = _packed_root_table(cap, out, tot, best)
    aux = torch.stack([zero, best.feature.float(), best.bin.float(),
                       torch.isfinite(best.gain).float(), zero, zero, zero,
                       zero], dim=1)
    scal = torch.zeros((e, 16), device=dev)
    for i, v in enumerate(ctx):
        scal[:, i] = v
    scal[:, 7] = torch.from_numpy(rng.choice([-1.0, 3.0], e).astype(
        np.float32)).to(dev)
    scal[:, 8] = 1.0
    tk, ak = table.clone(), aux
    for _ in range(iters):
        hist = hists((e, 2))
        src = tk if in_place else table.clone()
        tk2, ak = split_iter(hist, src, fmask, ak if in_place else aux, scal)
        assert tk2.data_ptr() == src.data_ptr()        # in place
        tp, ap = split_iter_plain(hist, table, fmask, aux, scal)
        torch.cuda.synchronize()
        assert torch.equal(tk2.view(torch.int32), tp.view(torch.int32))
        assert torch.equal(ak.view(torch.int32), ap.view(torch.int32))
        scal[:, 8] += 2.0 * (aux[:, 3] > 0).float()
        table, aux, tk = tp, ap, tk2


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [16, 63, 256])
@pytest.mark.parametrize("e,f", [(1, 28), (5, 6)])
def test_b3_strict_and_cv_shapes_in_place_on_card(e, f, nb):
    """B3 at the strict Booster's shape (E = 1, F = 28: a cluster of eight
    blocks) and ``cv()``'s (E = 5, F = 6), its table updated in place
    through a chain of iterations."""
    _b3_chain(e, f, nb, 12, 61 + e + nb, in_place=True)


@pytest.mark.gpu
@pytest.mark.parametrize("e,f", [(3, 150), (200, 6)])
def test_b3_chunked_and_unclustered_on_card(e, f):
    """B3 where a block's pairs take several shared-memory chunks (F =
    150) and where the batch fills the card without clusters (E = 200)."""
    _b3_chain(e, f, 256, 4, 71 + e, in_place=False)


@pytest.mark.gpu
@pytest.mark.parametrize("grower", ["wave", "strict", "int8"])
def test_kill_and_resume_bit_identical_on_card(grower, tmp_path):
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (HIST_FUSED_LAUNCHES,
                                                      HIST_PARTITION_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import tree_to_arrays
    from lightgbm_tpu_torch.training import (list_checkpoints,
                                             resume_booster, train_resumable)

    dev = _card()
    rng = np.random.default_rng(23)
    X = rng.normal(size=(50_000, 12)).astype(np.float32)
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y = (rng.random(50_000) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    p = dict(objective="binary", num_leaves=31, max_bin=255,
             learning_rate=0.1, min_data_in_leaf=20, bagging_fraction=0.8,
             bagging_freq=1, feature_fraction=0.8, verbosity=-1)
    if grower == "strict":
        p["grow_policy"] = "leafwise"
    mode = "int8" if grower == "int8" else "f32"
    if grower == "int8":
        p["hist_dtype"] = "int8"

    def make_ds():
        return lgb.Dataset(X, label=y, params=dict(p), device=dev)

    counters = [*HIST_FUSED_LAUNCHES.values(),
                *HIST_PARTITION_LAUNCHES.values(), SPLIT_ITER_LAUNCHES]
    for c in counters:
        c.reset()
    ref = lgb.Booster(dict(p), make_ds())
    for _ in range(3):
        ref.update()
    assert HIST_FUSED_LAUNCHES[mode].count > 0
    if grower == "wave":
        assert HIST_PARTITION_LAUNCHES["f32"].count > 0
    elif grower == "strict":
        assert SPLIT_ITER_LAUNCHES.count > 0
    d = str(tmp_path / "ck")
    res = train_resumable(dict(p), make_ds(), 3, checkpoint_dir=d,
                          checkpoint_rounds=1, keep_last=4, resume=False)
    runs = [res.booster]
    for path in list_checkpoints(d)[:-1]:
        b = resume_booster(path, make_ds())
        assert b.device.type == "cuda"
        while b._iter < 3:
            b.update()
        runs.append(b)
    assert len(runs) == 3
    for got in runs:
        for ta, tb in zip(ref.trees, got.trees):
            a, b = tree_to_arrays(ta), tree_to_arrays(tb)
            assert all(np.array_equal(a[k], b[k]) for k in a)
        assert torch.equal(ref._pred_train, got._pred_train)
        assert torch.equal(ref._bag, got._bag)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["b1", "b6", "b3", "b4"])
def test_one_feature_kernels_match_plain_on_card(kernel):
    """One column, as examples/bagging_boosting.py's data has: B1's root
    and two-segment calls, B6 at cv()'s five folds, B3 chained at E = 1 and
    E = 5, B4 over a forest on one feature."""
    dev = _card()
    rng = np.random.default_rng(41)
    n, nb = 1_000, 256
    bins = rng.integers(0, nb, (n, 1)).astype(np.uint8)
    if kernel == "b1":
        stats = _stats(rng, n)
        for k in (1, 2):
            seg = rng.integers(0, k + 1, n).astype(np.int32)
            t = [torch.from_numpy(a).to(dev) for a in (bins, stats, seg)]
            for mode in MODES:
                got = th.hist_fused(*t, k, nb, mode)
                want = th.hist_fused_plain(*t, k, nb, mode)
                torch.cuda.synchronize()
                _close(got.cpu().numpy(), want.cpu().numpy(),
                       _abs_hist(bins, stats, seg, k, nb, mode))
    elif kernel == "b6":
        st = rng.normal(size=(n, 15)).astype(np.float32)
        tb, ts = torch.from_numpy(bins).to(dev), torch.from_numpy(st).to(dev)
        got = th.hist_segstats(tb, ts, nb, "f32")
        want = th.hist_segstats_plain(tb, ts, nb, "f32")
        torch.cuda.synchronize()
        mag = np.zeros((1, nb, 15))
        np.add.at(mag[0], bins[:, 0].astype(np.int64),
                  np.abs(st).astype(np.float64))
        err = np.abs(got.cpu().numpy().astype(np.float64)
                     - want.cpu().numpy().astype(np.float64))
        assert (err <= 1e-6 * mag).all()
    elif kernel == "b3":
        for e in (1, 5):
            _b3_chain(e, 1, nb, 12, 91 + e, in_place=True)
    else:
        soa, depth = _b4_forest(43, 100, 20, 1, "f32")
        for rows in (1, 400, 1_000):
            _b4_equal(soa, depth, torch.from_numpy(bins[:rows]).to(dev),
                      [(100, 0), (1, 0), (20, 0), (50, 50)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["strict", "rf", "cv"])
def test_unfused_strict_body_on_card(case):
    """Per-node sampling on the strict grower: no B3 launch (the
    reference's ``fuse_si`` rule), B1 (one tree) or B6 (cv()'s batch) on
    the card, the trees of the kernel path structure-equal to the plain
    path's and their predictions within rtol 1e-5."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (HIST_FUSED_LAUNCHES,
                                                      HIST_SEGSTATS_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES

    dev = _card()
    rng = np.random.default_rng(44)
    X = rng.normal(size=(20_000, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=20_000)
         ).astype(np.float32)
    p = dict(objective="regression", num_leaves=31, grow_policy="leafwise",
             feature_fraction_bynode=0.5, verbosity=-1)
    if case == "rf":
        p.update(boosting="rf", bagging_fraction=0.632, bagging_freq=1)
    for c in (SPLIT_ITER_LAUNCHES, HIST_FUSED_LAUNCHES["f32"],
              HIST_SEGSTATS_LAUNCHES["f32"]):
        c.reset()
    runs = []
    for impl in ("auto", "plain"):
        ds = lgb.Dataset(X, label=y, device=dev)
        params = dict(p, hist_impl=impl)
        if case == "cv":
            params.pop("grow_policy")
            runs.append(lgb.cv(params, ds, 4, nfold=5, stratified=False,
                               seed=1))
        else:
            runs.append(lgb.train(params, ds, 3))
    assert SPLIT_ITER_LAUNCHES.count == 0
    if case == "cv":
        assert HIST_SEGSTATS_LAUNCHES["f32"].count > 0
        np.testing.assert_allclose(runs[0]["valid l2-mean"],
                                   runs[1]["valid l2-mean"], rtol=1e-5)
        return
    assert HIST_FUSED_LAUNCHES["f32"].count > 0
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    for ta, tb in zip(runs[0].trees, runs[1].trees):
        a, b = tree_to_arrays(ta), tree_to_arrays(tb)
        for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
            assert np.array_equal(a[k], b[k]), k
    np.testing.assert_allclose(runs[0].predict(X[:2000]),
                               runs[1].predict(X[:2000]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(50_000, 3), (5, 20_000, 3)])
def test_sr_round_bf16_on_card_bit_equal_to_cpu(shape):
    """``hist_dtype="bf16sr"``'s rounding on the card, bit for bit the CPU
    version's (integer arithmetic), with non-finite and largest values."""
    dev = _card()
    rng = np.random.default_rng(45)
    x = rng.normal(0, 1e3, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:8] = [np.inf, -np.inf, np.nan, 1e-40, -0.0, 3.4028235e38,
                -3.4028235e38, 1.5]
    cpu = th.sr_round_bf16(torch.from_numpy(x))
    card = th.sr_round_bf16(torch.from_numpy(x).to(dev)).cpu()
    assert torch.equal(card.view(torch.int32), cpu.view(torch.int32))
    t = torch.from_numpy(x).transpose(0, 1)
    assert torch.equal(th.sr_round_bf16(t.to(dev)).cpu().view(torch.int32),
                       th.sr_round_bf16(t).view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("weights", ["bag", "mape"])
def test_renew_leaf_values_on_card(weights):
    """Leaf renewal on the card against the CPU: with 0/1 weights every
    partial sum is an exact integer, so the leaves are bit-equal; with
    MAPE's scale ``torch.cumsum``'s order may move a target by a row, so
    each leaf is a residual of one of its own in-bag rows, at most one
    place from the CPU's in the leaf's sorted residuals."""
    from lightgbm_tpu_torch.models.tree import Tree, renew_leaf_values

    dev = _card()
    rng = np.random.default_rng(46)
    n, cap = 200_000, 253
    leaves = rng.choice(cap, 127, replace=False)
    is_leaf = np.zeros(cap, bool)
    is_leaf[leaves] = True
    row_leaf = rng.choice(leaves, n).astype(np.int32)
    res = rng.normal(size=n).astype(np.float32)
    w = (rng.random(n) < 0.8).astype(np.float32)
    if weights == "mape":
        y = rng.normal(0, 50, n).astype(np.float32)
        w = w / np.maximum(np.abs(y), 1.0).astype(np.float32)
    z = torch.zeros(cap, dtype=torch.int32)
    lv = torch.from_numpy(rng.normal(size=cap).astype(np.float32))
    tree = Tree(z, z, z, z, lv, torch.from_numpy(is_leaf), torch.zeros(cap),
                torch.zeros(cap), torch.tensor(127))
    args = (torch.from_numpy(row_leaf), torch.from_numpy(res),
            torch.from_numpy(w), 0.5)
    cpu = renew_leaf_values(tree, *args).leaf_value.numpy()
    card = renew_leaf_values(
        Tree(*(None if f is None else f.to(dev) for f in tree)),
        *(a.to(dev) for a in args[:3]), 0.5).leaf_value.cpu().numpy()
    if weights == "bag":
        assert np.array_equal(card, cpu)
        return
    for leaf in leaves:
        r = np.sort(res[(row_leaf == leaf) & (w > 0)])
        assert card[leaf] in r
        assert abs(np.searchsorted(r, card[leaf])
                   - np.searchsorted(r, cpu[leaf])) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape",
                                       "gamma"])
def test_objectives_train_kernel_vs_plain_on_card(objective):
    """The new objectives on the card's wave grower (B1 roots, B2 waves,
    renewal where the objective asks): the kernel path's trees
    structure-equal to the plain path's, predictions within rtol 1e-5."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (HIST_FUSED_LAUNCHES,
                                                      HIST_PARTITION_LAUNCHES)
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    rng = np.random.default_rng(47)
    X = rng.normal(size=(20_000, 8)).astype(np.float32)
    y = rng.gamma(2.0, np.exp(0.4 * X[:, 0] - 0.3 * X[:, 1]) / 2.0
                  ).astype(np.float32)
    p = dict(objective=objective, num_leaves=31, alpha=0.9, verbosity=-1,
             hist_dtype="f32")
    HIST_FUSED_LAUNCHES["f32"].reset()
    HIST_PARTITION_LAUNCHES["f32"].reset()
    runs = [lgb.train(dict(p, hist_impl=impl),
                      lgb.Dataset(X, label=y, device=dev), 4)
            for impl in ("auto", "plain")]
    assert HIST_FUSED_LAUNCHES["f32"].count > 0
    assert HIST_PARTITION_LAUNCHES["f32"].count > 0
    for ta, tb in zip(runs[0].trees, runs[1].trees):
        a, b = tree_to_arrays(ta), tree_to_arrays(tb)
        for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
            assert np.array_equal(a[k], b[k]), k
    np.testing.assert_allclose(runs[0].predict(X[:2000]),
                               runs[1].predict(X[:2000]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_goss_selection_on_card_equals_cpu(seed):
    """GOSS's compacted selection on the card: the same rows, weights and
    counts as on the CPU for the same gradients and key, with no host read
    (PyTorch's sync debug mode "error")."""
    from lightgbm_tpu_torch.ops.sampling import goss_select

    dev = _card()
    rng = np.random.default_rng(seed)
    n = 300_000
    g = (rng.standard_cauchy(n) * (rng.random(n) < 0.999)).astype(np.float32)
    bag = (np.arange(n) < n - 1000).astype(np.float32)      # padded rows
    goss_k = (int(0.2 * (n - 1000)), int(0.1 * (n - 1000)))
    key = (0, 12345 + seed)
    cpu = goss_select(key, torch.from_numpy(g), torch.from_numpy(bag),
                      goss_k, 0.2, 0.1)
    gd, bd = torch.from_numpy(g).to(dev), torch.from_numpy(bag).to(dev)
    goss_select(key, gd, bd, goss_k, 0.2, 0.1)                 # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = goss_select(key, gd, bd, goss_k, 0.2, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_goss_dart_train_kernel_vs_plain_on_card(boosting):
    """GOSS (compacted rows on the wave grower: B1 roots, B2 waves) and a
    DART run whose rounds drop and rescale trees, on the card: the kernel
    path's trees structure-equal to the plain path's, leaf values and
    predictions within rtol 1e-5."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (HIST_FUSED_LAUNCHES,
                                                      HIST_PARTITION_LAUNCHES)
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    rng = np.random.default_rng(53)
    X = rng.normal(size=(30_000, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
         + 0.3 * rng.normal(size=30_000) > 0).astype(np.float32)
    p = dict(objective="binary", num_leaves=31, verbosity=-1,
             boosting=boosting, drop_rate=0.5, skip_drop=0.0,
             top_rate=0.3, other_rate=0.2)
    HIST_FUSED_LAUNCHES["f32"].reset()
    HIST_PARTITION_LAUNCHES["f32"].reset()
    runs = [lgb.train(dict(p, hist_impl=impl),
                      lgb.Dataset(X, label=y, device=dev), 6)
            for impl in ("auto", "plain")]
    assert HIST_FUSED_LAUNCHES["f32"].count > 0
    assert HIST_PARTITION_LAUNCHES["f32"].count > 0
    for ta, tb in zip(runs[0].trees, runs[1].trees):
        a, b = tree_to_arrays(ta), tree_to_arrays(tb)
        for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(a["leaf_value"], b["leaf_value"],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(runs[0].predict(X[:2000]),
                               runs[1].predict(X[:2000]), rtol=RTOL,
                               atol=ATOL)


def _cat_dyadic(n, seed):
    """Two categorical columns (12 and 40 categories) and two numeric ones;
    y in {0, 1} with exactly n/2 ones from per-category effects, so every
    round-1 l2 statistic is +-0.5 or 1 and every histogram sum is exact."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 12, n), rng.integers(0, 40, n)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    s = rng.normal(size=12)[a] + rng.normal(size=40)[b] + 0.7 * x1 + x2 ** 2
    y = np.zeros(n, np.float32)
    y[np.argsort(s)[n // 2:]] = 1.0
    return np.column_stack([a, x1, b, x2]).astype(np.float32), y


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["wave", "strict", "int8", "multiclass",
                                  "cv"])
def test_categorical_kernel_vs_plain_on_card(case):
    """Categorical training on the card: the round-1 trees of the kernel
    path equal the plain path's bit for bit on exact sums (every field, the
    subset masks included; multiclass and the folds' scores are not exact
    sums, so there predictions and held-out metrics agree within rtol
    1e-5); subset splits never launch B2 or B3 (the reference's
    ``fuse_part``/``fuse_si`` rules), and B1 (waves, the strict pair,
    int8) or B5/B6 (the batched growers) run."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (
        HIST_FUSED_BATCHED_LAUNCHES, HIST_FUSED_LAUNCHES,
        HIST_PARTITION_LAUNCHES, HIST_SEGSTATS_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    X, y = _cat_dyadic(40_000, 61)
    p = dict(objective="l2", num_leaves=31, learning_rate=0.5,
             min_data_in_leaf=5, verbosity=-1)
    p.update({"wave": {}, "strict": dict(grow_policy="leafwise"),
              "int8": dict(hist_dtype="int8"),
              "multiclass": dict(objective="multiclass", num_class=3),
              "cv": dict(grow_policy="leafwise")}[case])
    if case == "multiclass":
        y = (np.arange(len(y)) % 2 + y).astype(np.float32)     # 3 classes
    counters = ([SPLIT_ITER_LAUNCHES] + list(HIST_FUSED_LAUNCHES.values())
                + list(HIST_PARTITION_LAUNCHES.values())
                + list(HIST_SEGSTATS_LAUNCHES.values())
                + list(HIST_FUSED_BATCHED_LAUNCHES.values()))
    for c in counters:
        c.reset()
    runs = []
    for impl in ("auto", "plain"):
        ds = lgb.Dataset(X, label=y, device=dev, categorical_feature=[0, 2])
        params = dict(p, hist_impl=impl)
        if case == "cv":
            runs.append(lgb.cv(params, ds, 1, nfold=5, stratified=False,
                               seed=1))
        else:
            runs.append(lgb.train(params, ds, 1))
    assert SPLIT_ITER_LAUNCHES.count == 0
    assert sum(c.count for c in HIST_PARTITION_LAUNCHES.values()) == 0
    if case == "cv":
        assert HIST_SEGSTATS_LAUNCHES["f32"].count > 0
        np.testing.assert_allclose(runs[0]["valid l2-mean"],
                                   runs[1]["valid l2-mean"], rtol=RTOL)
        return
    if case == "multiclass":
        assert HIST_FUSED_BATCHED_LAUNCHES["f32"].count > 0
        assert HIST_SEGSTATS_LAUNCHES["f32"].count > 0
        assert runs[0].trees[0].is_cat_split.any()
        np.testing.assert_allclose(runs[0].predict(X[:5000]),
                                   runs[1].predict(X[:5000]), rtol=RTOL,
                                   atol=ATOL)
        return
    mode = "int8" if case == "int8" else "f32"
    assert HIST_FUSED_LAUNCHES[mode].count > 0
    a, b = tree_to_arrays(runs[0].trees[0]), tree_to_arrays(runs[1].trees[0])
    assert a.keys() == b.keys() and "cat_mask" in a
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert a["is_cat_split"].any()
    assert np.array_equal(runs[0].predict(X[:5000]),
                          runs[1].predict(X[:5000]))


@pytest.mark.gpu
def test_categorical_scan_reads_nothing_back_on_card():
    """The subset scan (sorts, gathers, the winner's rank by a scatter) on
    CUDA tensors under PyTorch's sync debug mode "error", equal to the same
    scan on the CPU, bit for bit (both add the prefix sums in the
    reference's block order)."""
    from lightgbm_tpu_torch.ops.split import (CatInfo, SplitContext,
                                              find_best_split)

    dev = _card()
    rng = np.random.default_rng(62)
    w, f, nb = 42, 8, 255
    hist = np.zeros((w, f, nb, 3), np.float32)
    hist[..., 0] = rng.normal(size=(w, f, nb)) * 10
    hist[..., 1] = rng.uniform(1, 5, (w, f, nb))
    hist[..., 2] = rng.integers(0, 40, (w, f, nb))
    hist[hist[..., 2] == 0] = 0.0
    is_cat = torch.tensor([True, False] * (f // 2))

    def inputs(d):
        return (torch.from_numpy(hist).to(d),
                SplitContext(0.0, 1.0, 20.0, 1e-3, 0.0),
                torch.ones((w, f), device=d),
                torch.ones(w, dtype=torch.bool, device=d),
                torch.zeros(w, device=d), CatInfo(is_cat.to(d), 10.0, 10.0,
                                                  32))

    def run(a):
        return find_best_split(*a[:5], arith="cat", cat_info=a[5])

    cpu = run(inputs("cpu"))
    args = inputs(dev)
    one_leaf = (args[0][0], args[1], args[2][0], args[3][0], args[4][0],
                args[5])                      # a 0-d winner, as a root's
    run(args)
    run(one_leaf)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = run(args)
        run(one_leaf)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(card.cat.any())
    for name, a in cpu._asdict().items():
        assert torch.equal(a, getattr(card, name).cpu()), name


def _ranked(sizes, f, seed):
    """Query-grouped rows: graded labels 0-4 from each query's utility
    ranks (the shape of the reference's ranking test data)."""
    rng = np.random.default_rng(seed)
    n = int(sizes.sum())
    X = rng.normal(size=(n, f)).astype(np.float32)
    u = X[:, 0] + np.sin(2 * X[:, 1]) + 0.3 * rng.normal(size=n)
    y = np.zeros(n)
    start = 0
    for s in sizes:
        r = u[start:start + s].argsort().argsort()
        y[start:start + s] = np.minimum(4, (5 * r) // s)
        start += s
    return X, y


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["uniform", "ragged"])
def test_lambdarank_grad_hess_on_card_vs_cpu(route):
    """LambdaRank's pair pass on the card (plain torch ops: ``torch.exp``,
    ``torch.log2``, ``torch.sum``) against the CPU's (XLA's rounding), with
    no host read (PyTorch's sync debug mode "error"): the uniform route at
    MSLR's 100 documents (truncation 100) and the ragged route over three
    query chunks (20-220 documents).  Tolerance: a gradient within 1e-4 of
    its query's largest |gradient| (a row's lambdas cancel, and 1 - p
    cancels where p is near 1, so ulps of ``exp`` and of the sum order
    reach 1.1e-5 of it), a hessian within rtol 1e-4."""
    from lightgbm_tpu_torch.config import parse_params
    from lightgbm_tpu_torch.ranking import LambdaRank

    dev = _card()
    rng = np.random.default_rng(71)
    sizes = (np.full(300, 100) if route == "uniform"
             else rng.integers(20, 221, 800))
    _, y = _ranked(sizes, 2, 72)
    n = int(sizes.sum())
    n_pad = n + 5
    yp = np.zeros(n_pad, np.float32)
    yp[:n] = y
    pred = (0.5 * rng.normal(size=n_pad)).astype(np.float32)
    w = np.ones(n_pad, np.float32)
    params = parse_params(dict(objective="lambdarank",
                               lambdarank_truncation_level=100))
    out = {}
    for d in ("cpu", dev):
        obj = LambdaRank(params)
        obj.set_group(sizes, yp, n_pad, device=d)
        args = [torch.from_numpy(a).to(d) for a in (pred, yp, w)]
        if d == "cpu":
            out[d] = obj.grad_hess(*args)
            continue
        assert (obj._packed["uniform"] is not None) == (route == "uniform")
        assert route == "uniform" or -(-len(sizes) // obj.query_chunk) == 3
        obj.grad_hess(*args)                                     # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out["card"] = obj.grad_hess(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    (gc, hc), (gd, hd) = ([t.cpu().numpy() for t in p]
                          for p in (out["cpu"], out["card"]))
    qid = np.repeat(np.arange(len(sizes)), sizes)
    qmax = np.zeros(len(sizes))
    np.maximum.at(qmax, qid, np.abs(gc[:n]))
    assert (np.abs(gd[:n] - gc[:n]) <= 1e-4 * qmax[qid]).all()
    np.testing.assert_allclose(hd, hc, rtol=1e-4, atol=0)
    # padding rows: no lambda, the hessian floor 2e-3 (times w = 1 here)
    assert (gd[n:] == 0).all() and (hd[n:] == np.float32(2e-3)).all()


@pytest.mark.gpu
def test_lambdarank_round_kernel_vs_plain_on_card():
    """One lambdarank round on the wave grower through B1 (the root) and B2
    (the waves): the kernel path's tree structure-equal to the plain
    path's, leaves within rtol 1e-5 (atol 1e-5, ROADMAP C.5), and the
    held-out NDCG@10 of three rounds within 1e-4."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (HIST_FUSED_LAUNCHES,
                                                      HIST_PARTITION_LAUNCHES)
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    sizes = np.random.default_rng(73).integers(10, 41, 400)
    X, y = _ranked(sizes, 12, 74)
    p = dict(objective="lambdarank", num_leaves=31, min_data_in_leaf=20,
             hist_dtype="bf16", eval_at=[10], verbosity=-1)
    for c in (HIST_FUSED_LAUNCHES["bf16"], HIST_PARTITION_LAUNCHES["bf16"]):
        c.reset()
    runs = []
    for impl in ("auto", "plain"):
        ds = lgb.Dataset(X, label=y, group=sizes, device=dev)
        runs.append(lgb.train(dict(p, hist_impl=impl), ds, 3,
                              valid_sets=[ds]))
        if impl == "auto":
            assert HIST_FUSED_LAUNCHES["bf16"].count > 0
            assert HIST_PARTITION_LAUNCHES["bf16"].count > 0
    a, b = (tree_to_arrays(r.trees[0]) for r in runs)
    for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
        assert np.array_equal(a[k], b[k]), k
    np.testing.assert_allclose(a["leaf_value"], b["leaf_value"], rtol=RTOL,
                               atol=1e-5)
    ndcg = [r.eval_train()[0][2] for r in runs]
    assert abs(ndcg[0] - ndcg[1]) <= 1e-4, ndcg


def _mono_dyadic(n, seed):
    """Six numeric columns; y in {0, 1} with exactly n/2 ones, so every
    round-1 l2 statistic is +-0.5 or 1 and every histogram sum is exact."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    s = 1.2 * X[:, 0] - 0.8 * X[:, 1] + np.sin(2 * X[:, 2]) \
        + 0.5 * X[:, 3] * X[:, 4]
    y = np.zeros(n, np.float32)
    y[np.argsort(s)[n // 2:]] = 1.0
    return X, y


CONSTRAINTS = {
    "mono": {"monotone_constraints": [1, -1, 0, 0, 1, 0]},
    "extra_trees": {"extra_trees": True},
    "interaction": {"interaction_constraints": [[0, 1, 2], [3, 4]]},
}


@pytest.mark.gpu
@pytest.mark.parametrize("grower", ["wave", "strict", "multiclass"])
@pytest.mark.parametrize("option", sorted(CONSTRAINTS))
def test_constrained_kernel_vs_plain_on_card(option, grower):
    """Constrained training on the card: the round-1 trees of the kernel
    path equal the plain path's bit for bit on exact sums (every field;
    multiclass scores are not exact sums, so there the trees are
    structure-equal and predictions within rtol 1e-5).  The wave grower
    keeps B1 roots and B2 waves (the reference's ``fuse_part`` holds for
    these options); the strict grower runs B1's two-segment calls and never
    B3 (``fuse_si`` excludes them); multiclass waves run B5."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (
        HIST_FUSED_BATCHED_LAUNCHES, HIST_FUSED_LAUNCHES,
        HIST_PARTITION_LAUNCHES, HIST_SEGSTATS_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    X, y = _mono_dyadic(40_000, 91)
    p = dict(objective="l2", num_leaves=31, learning_rate=0.5,
             min_data_in_leaf=5, verbosity=-1, hist_dtype="f32",
             **CONSTRAINTS[option])
    p.update({"wave": {}, "strict": dict(grow_policy="leafwise"),
              "multiclass": dict(objective="multiclass",
                                 num_class=3)}[grower])
    if grower == "multiclass":
        y = (np.arange(len(y)) % 2 + y).astype(np.float32)     # 3 classes
    counters = ([SPLIT_ITER_LAUNCHES] + list(HIST_FUSED_LAUNCHES.values())
                + list(HIST_PARTITION_LAUNCHES.values())
                + list(HIST_SEGSTATS_LAUNCHES.values())
                + list(HIST_FUSED_BATCHED_LAUNCHES.values()))
    for c in counters:
        c.reset()
    runs = []
    for impl in ("auto", "plain"):
        ds = lgb.Dataset(X, label=y, device=dev)
        runs.append(lgb.train(dict(p, hist_impl=impl), ds, 1))
        if impl == "auto":
            launched = {"b1": HIST_FUSED_LAUNCHES["f32"].count,
                        "b2": HIST_PARTITION_LAUNCHES["f32"].count,
                        "b3": SPLIT_ITER_LAUNCHES.count,
                        "b5": HIST_FUSED_BATCHED_LAUNCHES["f32"].count}
    assert launched["b3"] == 0, launched
    if grower == "wave":
        assert launched["b1"] > 0 and launched["b2"] > 0, launched
    elif grower == "strict":
        assert launched["b1"] > 0, launched
    else:
        assert launched["b5"] > 0, launched
    a, b = (tree_to_arrays(r.trees[0]) for r in runs)
    if grower == "multiclass":
        for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(runs[0].predict(X[:5000]),
                                   runs[1].predict(X[:5000]), rtol=RTOL,
                                   atol=ATOL)
        return
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(runs[0].predict(X[:5000]),
                          runs[1].predict(X[:5000]))


@pytest.mark.gpu
@pytest.mark.parametrize("col_bins", [None, (2, 255, 17, 1, 64, 3)],
                         ids=["global", "per_column"])
def test_rand_bin_table_on_card_equals_cpu(col_bins):
    """The extra-trees table drawn on the card equals the CPU's bit for
    bit (the threefry words are integers; ``floor(u * hi)`` rounds the f32
    product once on both), with no host read (sync debug mode "error")."""
    from lightgbm_tpu_torch.models.tree import rand_bin_table
    from lightgbm_tpu_torch.utils.random import split_on

    dev = _card()
    cb = None if col_bins is None else torch.tensor(col_bins)
    out = {}
    for d in ("cpu", dev):
        keys = split_on((0, 12345), 7, d)
        if d == "cpu":
            out[d] = rand_bin_table(keys, 6, 256, cb, 509)
            continue
        cbd = None if cb is None else cb.to(dev)
        rand_bin_table(keys, 6, 256, cbd, 509)                   # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out["card"] = rand_bin_table(keys, 6, 256, cbd, 509)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out["card"].cpu(), out["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("grower", ["wave", "strict"])
def test_linear_round_kernel_vs_plain_on_card(grower):
    """``linear_tree=True`` on the card: the wave grower keeps B1 roots and
    B2 waves (the reference's linear round grows with ``fuse_partition``),
    the strict grower B1 pairs and B3 (``fuse_si`` does not exclude linear
    leaves); on exact sums the round-1 trees of the kernel path equal the
    plain path's in every field, ``linear_feat`` and ``linear_coef``
    included, and so do the predictions.  The fit itself reads nothing back
    to the host."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (HIST_FUSED_LAUNCHES,
                                                      HIST_PARTITION_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import (fit_linear_leaves,
                                                tree_to_arrays)

    dev = _card()
    X, y = _mono_dyadic(40_000, 93)
    p = dict(objective="l2", num_leaves=31, learning_rate=0.5,
             min_data_in_leaf=5, verbosity=-1, hist_dtype="f32",
             linear_tree=True)
    if grower == "strict":
        p["grow_policy"] = "leafwise"
    counters = ([SPLIT_ITER_LAUNCHES] + list(HIST_FUSED_LAUNCHES.values())
                + list(HIST_PARTITION_LAUNCHES.values()))
    for c in counters:
        c.reset()
    runs = []
    for impl in ("auto", "plain"):
        ds = lgb.Dataset(X, label=y, device=dev)
        runs.append(lgb.train(dict(p, hist_impl=impl), ds, 1))
        if impl == "auto":
            launched = {"b1": HIST_FUSED_LAUNCHES["f32"].count,
                        "b2": HIST_PARTITION_LAUNCHES["f32"].count,
                        "b3": SPLIT_ITER_LAUNCHES.count}
    assert launched["b1"] > 0, launched
    if grower == "wave":
        assert launched["b2"] > 0 and launched["b3"] == 0, launched
    else:
        assert launched["b3"] > 0, launched
    a, b = (tree_to_arrays(r.trees[0]) for r in runs)
    assert "linear_coef" in a
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert np.array_equal(runs[0].predict(X[:5000]),
                          runs[1].predict(X[:5000]))
    # the fit alone under the sync debug mode: no host read
    bst = runs[0]
    tree = bst.trees[0]
    n_pad = int(bst.train_set.row_mask.shape[0])
    row_leaf = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    g = torch.ones(n_pad, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fit_linear_leaves(tree, row_leaf, bst._xraw, g, g, bst._bag, 0.0, 8)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.gpu
def test_pred_contrib_on_card_vs_cpu(tmp_path):
    """TreeSHAP on the card: within 1e-5 of the same model's contributions
    on CPU tensors (the card's f32 ops round as the CPU's up to ulps), rows
    summing to the raw score within 1e-4."""
    import lightgbm_tpu_torch as lgb

    dev = _card()
    X, y = _mono_dyadic(20_000, 95)
    b = lgb.train(dict(objective="l2", num_leaves=31, verbosity=-1),
                  lgb.Dataset(X, label=y, device=dev), 10)
    path = str(tmp_path / "m.txt")
    b.save_model(path)
    cpu = lgb.Booster(model_file=path, device="cpu")
    got = b.predict(X[:2000], pred_contrib=True)
    want = cpu.predict(X[:2000], pred_contrib=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got.sum(1) - b.predict(X[:2000], raw_score=True)).max() \
        <= 1e-4
    np.testing.assert_array_equal(b.predict(X[:2000], pred_leaf=True),
                                  cpu.predict(X[:2000], pred_leaf=True))


def _continuation_frame(n=50_000, seed=29):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 12)).astype(np.float32)
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    return X, y


@pytest.mark.gpu
@pytest.mark.parametrize("grower", ["wave", "strict", "multiclass"])
def test_continuation_bit_identical_on_card(grower, tmp_path):
    """3 rounds continued 3 more on the card (``init_model=<Booster>``,
    ``init_model=<model file>``, ``Booster(model_file).update(ds)``) grow
    the trees, train scores and bag of 6 uninterrupted rounds bit for bit,
    through B1 and B2 (waves), B1 and B3 (strict) or B6 and B5 (the
    multiclass class batch, whose replayed scores are row-major where a
    live round's are class-major: ROADMAP C.8)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (
        HIST_FUSED_BATCHED_LAUNCHES, HIST_FUSED_LAUNCHES,
        HIST_PARTITION_LAUNCHES, HIST_SEGSTATS_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    X, y = _continuation_frame()
    p = dict(objective="binary", num_leaves=31, max_bin=255,
             learning_rate=0.1, min_data_in_leaf=20, bagging_fraction=0.8,
             bagging_freq=1, feature_fraction=0.8, hist_dtype="f32",
             verbosity=-1)
    if grower == "strict":
        p["grow_policy"] = "leafwise"
    elif grower == "multiclass":
        p.update(objective="multiclass", num_class=3)
        y = np.digitize(X[:, 0] + X[:, 4], [-0.5, 0.5]).astype(np.float32)
    ds = lgb.Dataset(X, label=y, device=dev)
    batched = (HIST_FUSED_BATCHED_LAUNCHES["f32"],
               HIST_SEGSTATS_LAUNCHES["f32"])
    for c in (*HIST_FUSED_LAUNCHES.values(),
              *HIST_PARTITION_LAUNCHES.values(), SPLIT_ITER_LAUNCHES,
              *batched):
        c.reset()
    full = lgb.train(p, ds, 6)
    first = lgb.train(p, ds, 3)
    path = str(tmp_path / "first.txt")
    first.save_model(path)
    loaded = lgb.Booster(model_file=path)
    for _ in range(3):
        loaded.update(ds)
    runs = [lgb.train(p, ds, 3, init_model=first),
            lgb.train(p, ds, 3, init_model=path), loaded]
    if grower == "multiclass":
        assert all(c.count > 0 for c in batched)
    else:
        assert HIST_FUSED_LAUNCHES["f32"].count > 0
    if grower == "wave":
        assert HIST_PARTITION_LAUNCHES["f32"].count > 0
    elif grower == "strict":
        assert SPLIT_ITER_LAUNCHES.count > 0
    for b in runs:
        assert b.num_trees() == 6 and b._pred_train.device.type == "cuda"
        for ta, tb in zip(full.trees, b.trees):
            fa, fb = tree_to_arrays(ta), tree_to_arrays(tb)
            for k in fa:
                assert np.array_equal(fa[k], fb[k]), k
        assert torch.equal(b._pred_train, full._pred_train)
        assert torch.equal(b._bag, full._bag)


@pytest.mark.gpu
def test_refit_deterministic_on_card():
    """``refit`` on the card: the per-leaf sums are one-hot matmuls over row
    chunks added in order (no float atomics), so two refits are bit-equal;
    within rtol 1e-5 of the same refit on CPU tensors (row-order scatter
    sums); a multi-chunk sum equal to a one-chunk one within 1e-6 of the
    rows' sum of |x|."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.gbdt import leaf_sums

    dev = _card()
    X, y = _continuation_frame()
    b = lgb.train(dict(objective="binary", num_leaves=31, verbosity=-1),
                  lgb.Dataset(X, label=y, device=dev), 5)
    Xn, yn = X[:30_000] * 1.05, y[:30_000]
    r1, r2 = b.refit(Xn, yn), b.refit(Xn, yn)
    cpu = lgb.Booster(model_str=b.model_to_string(), device="cpu").refit(
        Xn, yn)
    for t1, t2, tc in zip(r1.trees, r2.trees, cpu.trees):
        assert torch.equal(t1.leaf_value, t2.leaf_value)
        np.testing.assert_allclose(t1.leaf_value.cpu().numpy(),
                                   tc.leaf_value.numpy(), rtol=1e-5,
                                   atol=1e-7)
    rng = np.random.default_rng(31)
    leaf = torch.from_numpy(rng.integers(0, 61, 200_000)).to(dev)
    stats = torch.from_numpy(rng.normal(size=(200_000, 3)).astype(
        np.float32)).to(dev)
    chunked = leaf_sums(leaf, stats, 61, row_chunk=4096)
    assert torch.equal(chunked, leaf_sums(leaf, stats, 61, row_chunk=4096))
    whole = leaf_sums(leaf, stats, 61, row_chunk=200_000)
    ref = torch.zeros((61, 3), dtype=torch.float64, device=dev).index_add_(
        0, leaf, stats.double())
    mag = torch.zeros((61, 3), dtype=torch.float64, device=dev).index_add_(
        0, leaf, stats.double().abs())
    for got in (chunked, whole):
        assert bool(((got.double() - ref).abs() <= 1e-6 * mag).all())


def _stream_frame(n=60_000, f=28, seed=41):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    s = X @ w + 0.6 * np.sin(X[:, 0] * 2)
    yd = np.zeros(n, np.float32)
    yd[np.argsort(s, kind="stable")[n // 2:]] = 1.0
    return X, yd


@pytest.mark.gpu
@pytest.mark.parametrize("grower", ["wave", "strict"])
def test_streamed_trees_equal_in_memory_on_card(grower):
    """Out-of-core training on the card: 60,000 rows streamed in 16,384-row
    blocks (4 blocks, the tail padded) grow the in-memory trees bit for bit
    on exact sums (dyadic labels, l2: every histogram sum exact, so the
    float64 sum of the block partials equals the in-memory sum), through B1
    per block and, on the strict grower, B3; the in-memory wave grower
    takes B2 where the streamed one routes in plain ops and launches B1."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import HIST_FUSED_LAUNCHES
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    X, y = _stream_frame()
    p = dict(objective="regression", num_leaves=31, max_bin=255,
             learning_rate=0.5, min_data_in_leaf=20, hist_dtype="f32",
             wave_tail="greedy", stream_block_rows=16_384, verbosity=-1)
    if grower == "strict":
        p["grow_policy"] = "leafwise"
    ds = lgb.Dataset(X, label=y, device=dev, params=dict(p)).construct()
    sds = lgb.Dataset.from_blocks(
        [(X[lo:lo + 16_384], y[lo:lo + 16_384])
         for lo in range(0, len(X), 16_384)], params=dict(p), reference=ds)
    for c in (*HIST_FUSED_LAUNCHES.values(), SPLIT_ITER_LAUNCHES):
        c.reset()
    bs = lgb.train(p, sds, 1)
    nb = sds.block_store.num_blocks
    assert nb == 4 and HIST_FUSED_LAUNCHES["f32"].count % nb == 0
    if grower == "strict":
        assert SPLIT_ITER_LAUNCHES.count == 30
    bm = lgb.train(p, ds, 1)
    fa, fb = tree_to_arrays(bm.trees[0]), tree_to_arrays(bs.trees[0])
    for k in fa:
        assert np.array_equal(fa[k], fb[k]), k
    assert torch.equal(bm._pred_train[:len(X)], bs._pred_train[:len(X)])


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_streamed_block_hist_equals_resident_on_card(mode):
    """A block that crossed through the store's ring gives B1 the same
    histogram, bit for bit, as the same rows resident on the card (the same
    kernel on the same bytes); in int8 mode the per-block call quantizes
    over its own rows and equals its plain version bit for bit."""
    from lightgbm_tpu_torch.data import BlockStore

    dev = _card()
    rng = np.random.default_rng(43)
    codes = rng.integers(0, 256, (3 * 16_384 + 1000, 28)).astype(np.uint8)
    stats = torch.from_numpy(_stats(rng, 4 * 16_384)).to(dev)
    store = BlockStore.from_binned(codes, 16_384)
    store.device = dev
    for off, b in store.device_blocks():
        st = stats[off:off + b.shape[0]]
        seg = torch.from_numpy(rng.integers(-1, 3, b.shape[0]).astype(
            np.int32)).to(dev)
        resident = torch.from_numpy(store.blocks[off // 16_384]).to(dev)
        got = th.hist_fused(b, st, seg, 3, 256, mode)
        assert torch.equal(got, th.hist_fused(resident, st, seg, 3, 256,
                                              mode))
        if mode == "int8":
            assert torch.equal(got, th.hist_fused_plain(b, st, seg, 3, 256,
                                                        mode))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3])
def test_block_ring_stress_on_card(depth):
    """The ring of ``prefetch_blocks + 1`` device buffers under a slow
    consumer: 24 blocks, each read by a chain of B1 launches while later
    blocks' copies run on the side stream; every block's histogram equals
    the one from its resident copy bit for bit (a copy that overwrote a
    buffer still being read would show here), over three passes and a
    column view's pass, and no more than ``depth + 1`` buffers are ever
    alive."""
    from lightgbm_tpu_torch.data import BlockStore, ColumnViewStore

    dev = _card()
    rng = np.random.default_rng(47 + depth)
    rows = 8192
    codes = rng.integers(0, 256, (24 * rows, 28)).astype(np.uint8)
    store = BlockStore.from_binned(codes, rows)
    store.device = dev
    store.prefetch_blocks = depth
    stats = torch.from_numpy(_stats(rng, rows)).to(dev)
    seg = torch.zeros(rows, dtype=torch.int32, device=dev)
    want = [th.hist_fused(torch.from_numpy(b).to(dev), stats, seg, 1, 256,
                          "f32") for b in store.blocks]
    for _ in range(3):
        got = []
        for _, b in store.device_blocks():
            for _ in range(6):          # keep the block busy on the card
                h = th.hist_fused(b, stats, seg, 1, 256, "f32")
            got.append(h)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert store.peak_device_buffers == depth + 1
    # a column view: the active columns staged in pinned memory per slot
    cols = np.array([0, 3, 7, 11, 27])
    view = ColumnViewStore(store, cols)
    for k, (_, b) in enumerate(view.device_blocks()):
        for _ in range(6):
            h = th.hist_fused(b, stats, seg, 1, 256, "f32")
        resident = torch.from_numpy(np.ascontiguousarray(
            store.blocks[k][:, cols])).to(dev)
        assert torch.equal(h, th.hist_fused(resident, stats, seg, 1, 256,
                                            "f32"))
    assert store.peak_device_buffers == depth + 1


@pytest.mark.gpu
def test_streamed_int8_and_goss_kernel_vs_plain_on_card():
    """Streamed int8 (B1's int8 mode per block: each block quantized over
    its own rows) and streamed GOSS (the in-memory grower on the gathered
    rows: B1 and B2) through the kernels equal the same runs through the
    plain versions: the same trees (int8 sums are exact integers; GOSS on
    exact dyadic sums)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    dev = _card()
    X, y = _stream_frame()
    blocks = [(X[lo:lo + 16_384], y[lo:lo + 16_384])
              for lo in range(0, len(X), 16_384)]
    base = dict(objective="regression", num_leaves=31, max_bin=255,
                learning_rate=0.5, min_data_in_leaf=20, verbosity=-1,
                stream_block_rows=16_384)
    for extra, rounds in (({"hist_dtype": "int8"}, 3),
                          ({"boosting": "goss", "hist_dtype": "f32"}, 1)):
        p = dict(base, **extra)
        sds = lgb.Dataset.from_blocks(blocks, params=dict(p), device=dev)
        bk = lgb.train(p, sds, rounds)
        bp = lgb.train(dict(p, hist_impl="plain"), sds, rounds)
        for ta, tb in zip(bk.trees, bp.trees):
            fa, fb = tree_to_arrays(ta), tree_to_arrays(tb)
            for k in fa:
                assert np.array_equal(fa[k], fb[k]), (extra, k)


# -- multi-device training on virtual shards ------------------------------

DP_CASES = {
    "wave_pipelined": {},
    "wave_psum": {"histogram_merge": "psum"},
    "strict_psum": {"histogram_merge": "psum", "grow_policy": "leafwise"},
    "strict_ring": {"histogram_merge": "reduce_scatter_ring",
                    "grow_policy": "leafwise"},
    "voting": {"tree_learner": "voting", "top_k": 5},
    "feature": {"tree_learner": "feature"},
    "mesh_2d": {"mesh_shape": None},          # d // 2 x 2
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "int8": {"hist_dtype": "int8"},
}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_dp_trees_kernel_vs_plain_on_card(case, d):
    """Multi-device training on ``d`` virtual shards on the card: every
    shard's histograms through the kernels (B1 roots and B2 waves per
    shard; B1 pairs and, under psum, B3 on the strict grower; B1 without
    B2 on feature shards; B5/B6 per shard for multiclass; B1's int8 mode)
    grow the plain path's trees bit for bit on exact sums (dyadic labels,
    l2; int8 sums are exact integers), and the serial kernel path's
    where no per-shard quantization or ballot enters (multiclass: its
    softmax sums are not exact, so a first differing split must be a near
    tie)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import (
        HIST_FUSED_BATCHED_LAUNCHES, HIST_FUSED_LAUNCHES,
        HIST_PARTITION_LAUNCHES, HIST_SEGSTATS_LAUNCHES)
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import tree_to_arrays
    from lightgbm_tpu_torch.parallel import set_virtual_devices

    dev = _card()
    X, y = _stream_frame(n=40_960)
    extra = dict(DP_CASES[case])
    if case == "mesh_2d":
        extra["mesh_shape"] = f"{d // 2}x2"
    if extra.get("objective") == "multiclass":
        y = (y + (X[:, 1] > 0.5)).astype(np.float32)
    p = dict(dict(objective="regression", num_leaves=31, max_bin=255,
                  learning_rate=0.5, min_data_in_leaf=20, hist_dtype="f32",
                  verbosity=-1, tree_learner="data"), **extra)
    ds = lgb.Dataset(X, label=y, device=dev, params=dict(p)).construct()
    counters = (*HIST_FUSED_LAUNCHES.values(),
                *HIST_PARTITION_LAUNCHES.values(),
                *HIST_SEGSTATS_LAUNCHES.values(),
                *HIST_FUSED_BATCHED_LAUNCHES.values(), SPLIT_ITER_LAUNCHES)
    set_virtual_devices(d)
    try:
        for c in counters:
            c.reset()
        bk = lgb.train(p, ds, 2)
        launched = {"b1": sum(HIST_FUSED_LAUNCHES[m].count
                              for m in HIST_FUSED_LAUNCHES),
                    "b2": sum(c.count for c in
                              HIST_PARTITION_LAUNCHES.values()),
                    "b3": SPLIT_ITER_LAUNCHES.count,
                    "b56": sum(c.count for c in (
                        *HIST_SEGSTATS_LAUNCHES.values(),
                        *HIST_FUSED_BATCHED_LAUNCHES.values()))}
        bp = lgb.train(dict(p, hist_impl="plain"), ds, 2)
        assert bk._mesh is not None and bk._mesh.n_devices == d
    finally:
        set_virtual_devices(0)
    if case == "multiclass":
        assert launched["b56"] > 0 and launched["b56"] % d == 0
    else:
        assert launched["b1"] > 0 and launched["b1"] % d == 0, launched
    if case in ("wave_pipelined", "wave_psum", "voting"):
        assert launched["b2"] > 0 and launched["b2"] % d == 0
    if case in ("feature", "mesh_2d"):
        assert launched["b2"] == 0 and launched["b3"] == 0
    if case == "strict_psum":
        assert launched["b3"] == 2 * 30
    if case == "strict_ring":
        assert launched["b3"] == 0
    # softmax statistics are not exact: multiclass holds structure and
    # leaves within rtol 1e-5 (kernel and plain sum in f64 in other orders)
    exact = case != "multiclass"

    def same(a, b, what):
        fa, fb = tree_to_arrays(a), tree_to_arrays(b)
        for k in fa:
            if exact or k not in ("leaf_value", "split_gain"):
                assert np.array_equal(fa[k], fb[k]), (case, what, k)
            else:
                np.testing.assert_allclose(fa[k], fb[k], rtol=1e-5,
                                           atol=1e-6)

    for ta, tb in zip(bk.trees, bp.trees):
        same(ta, tb, "plain")
    if exact:
        assert torch.equal(bk._pred_train, bp._pred_train)
    if case not in ("int8", "voting", "multiclass"):
        serial = lgb.train(dict(p, tree_learner="serial"), ds, 1)
        same(serial.trees[0], bk.trees[0], "serial")
    elif case == "multiclass":
        # softmax sums merged from shard partials against one f64 pass:
        # the first differing node (if any) a near tie, gains within 1e-4
        serial = lgb.train(dict(p, tree_learner="serial"), ds, 1)
        fa, fb = tree_to_arrays(serial.trees[0]), tree_to_arrays(bk.trees[0])
        diff = np.flatnonzero((fa["split_feature"] != fb["split_feature"])
                              | (fa["split_bin"] != fb["split_bin"]))
        if len(diff):
            i = int(diff[0])
            ga = fa["split_gain"].reshape(-1)[i]
            gb = fb["split_gain"].reshape(-1)[i]
            assert abs(ga - gb) <= 1e-4 * max(abs(ga), abs(gb)), (ga, gb)


# -- the serving mesh and streamed data parallelism on virtual shards --------


def _mesh_forest(precision, nc=1):
    """A seed-made packed forest (20 trees x 31 leaves a class, 16 columns,
    64 bins) and 3,000 rows of codes."""
    from lightgbm_tpu_torch.dataset import BinMapper
    from lightgbm_tpu_torch.kernels._timing import make_forest
    from lightgbm_tpu_torch.serving import packed_from_arrays

    rng = np.random.default_rng(61)
    X = rng.normal(size=(3_000, 16))
    mapper = BinMapper.fit(X, max_bin=63)
    arrays = make_forest(62, 20 * nc, 31, mapper.n_bins)
    if nc > 1:
        arrays = {k: v.reshape((20, nc) + v.shape[1:])
                  for k, v in arrays.items()}
    meta = {"shrink": 0.1, "init_score": [0.1 * c for c in range(nc)],
            "num_class": nc, "best_iteration": -1,
            "params": {"objective": "multiclass" if nc > 1 else "binary",
                       "num_class": nc, "num_leaves": 31},
            "bin_mapper": mapper.to_dict()}
    return packed_from_arrays(arrays, meta), mapper.transform(X)


@pytest.mark.gpu
@pytest.mark.parametrize("nc", [1, 3])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_serving_mesh_routes_on_card(precision, nc):
    """dp and tp on 4 virtual shards of the card: dp through B4 (one launch a
    shard and class) bit for bit the single route, at every bucket; tp (a
    launch a shard and class over its tree slice) bit for bit the same
    route on the CPU, whose shards take B4's plain version (B4 == plain,
    and the psum adds in shard order on both), truncated windows too; each
    shard's tree slice through B4 bit for bit its plain version; the
    slices' node tables built once, in ``warm()``."""
    from lightgbm_tpu_torch.kernels import predict as kp
    from lightgbm_tpu_torch.kernels.predict import PREDICT_FOREST_LAUNCHES
    from lightgbm_tpu_torch.parallel import set_virtual_devices
    from lightgbm_tpu_torch.serving import PredictorRuntime, bucket_for

    dev = _card()
    packed, codes = _mesh_forest(precision, nc)
    set_virtual_devices(4)
    try:
        kw = dict(max_bucket=1024, forest_precision=precision)
        single = PredictorRuntime(packed, device=dev, **kw)
        rts = {pol: PredictorRuntime(packed, mesh_devices=4,
                                     shard_policy=pol, device=dev, **kw)
               for pol in ("dp", "tp")}
        tp_cpu = PredictorRuntime(packed, mesh_devices=4, shard_policy="tp",
                                  device="cpu", **kw)
        builds = []
        real = kp.build_node_tables
        kp.build_node_tables = lambda soa: (builds.append(1), real(soa))[1]
        try:
            for rt in (single, *rts.values()):
                rt.warm()
            warmed = len(builds)
            for n in (1, 7, 64, 65, 300, 1024):
                want = single.predict_binned(codes[:n], raw_score=True)
                for pol, rt in rts.items():
                    PREDICT_FOREST_LAUNCHES.reset()
                    got = rt.predict_binned(codes[:n], raw_score=True)
                    route = rt.route_for(bucket_for(n, 1024))
                    shards = 4 if route != "single" else 1
                    assert PREDICT_FOREST_LAUNCHES.count == shards * nc
                    np.testing.assert_array_equal(
                        got, want if pol == "dp" else tp_cpu.predict_binned(
                            codes[:n], raw_score=True), err_msg=(pol, n))
            for k in (1, 5, 20):
                np.testing.assert_array_equal(
                    rts["tp"].predict_binned(codes[:32], num_iteration=k,
                                             raw_score=True),
                    tp_cpu.predict_binned(codes[:32], num_iteration=k,
                                          raw_score=True), err_msg=k)
            assert len(builds) == warmed
        finally:
            kp.build_node_tables = real
    finally:
        set_virtual_devices(0)
    shards, t_loc = rts["tp"]._tp_soa_parts()
    bins = torch.from_numpy(codes[:512]).to(dev)
    for d, soas_d in enumerate(shards):
        for soa in soas_d:
            t0, t1 = tp.tree_window(t_loc, 13, -d * t_loc)
            got = kp.forest_sums(soa, bins, t0, t1, packed.depth_cap)
            want = tp.forest_sums_plain(soa, bins, 13, packed.depth_cap,
                                        -d * t_loc)
            assert torch.equal(got, want), (d, t0, t1)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("grower", ["wave", "strict"])
def test_stream_dp_trees_equal_in_memory_mesh_on_card(grower, mode):
    """Streamed data parallelism on 4 virtual shards of the card: 65,536 rows
    in 8,192-row blocks (8 blocks, two a shard), every shard's block through
    B1 (and B3 on the strict grower under psum), one merge a block-round,
    grow the in-memory mesh's round-1 tree bit for bit on exact sums
    (dyadic labels, l2; int8 against the streamed serial run: both quantize
    per block) and the streamed plain path's."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.kernels.histogram import HIST_FUSED_LAUNCHES
    from lightgbm_tpu_torch.kernels.split_iter import SPLIT_ITER_LAUNCHES
    from lightgbm_tpu_torch.models.tree import tree_to_arrays
    from lightgbm_tpu_torch.parallel import set_virtual_devices

    dev = _card()
    X, y = _stream_frame(n=65_536)
    p = dict(objective="regression", num_leaves=31, max_bin=255,
             learning_rate=0.5, min_data_in_leaf=20, hist_dtype=mode,
             wave_tail="greedy", stream_block_rows=8_192, verbosity=-1,
             tree_learner="data", histogram_merge="psum")
    if grower == "strict":
        p["grow_policy"] = "leafwise"
    ds = lgb.Dataset(X, label=y, device=dev, params=dict(p)).construct()
    sds = lgb.Dataset.from_blocks(
        [(X[lo:lo + 8_192], y[lo:lo + 8_192])
         for lo in range(0, len(X), 8_192)], params=dict(p), reference=ds)
    set_virtual_devices(4)
    try:
        for c in (*HIST_FUSED_LAUNCHES.values(), SPLIT_ITER_LAUNCHES):
            c.reset()
        bs = lgb.train(p, sds, 1)
        assert bs._mesh.n_devices == 4
        assert all(sh.num_blocks == 2 for sh in bs._mesh.shards)
        assert HIST_FUSED_LAUNCHES[mode].count % 8 == 0
        if grower == "strict":
            assert SPLIT_ITER_LAUNCHES.count == 30
        plain = lgb.train(dict(p, hist_impl="plain"), sds, 1)
        other = (lgb.train(dict(p, tree_learner="serial"), sds, 1)
                 if mode == "int8" else lgb.train(p, ds, 1))
    finally:
        set_virtual_devices(0)
    for b in (plain, other):
        fa, fb = tree_to_arrays(b.trees[0]), tree_to_arrays(bs.trees[0])
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k
        assert torch.equal(b._pred_train[:len(X)], bs._pred_train[:len(X)])


@pytest.mark.gpu
def test_stream_dp_kill_resume_on_card(tmp_path):
    """A 4-shard streamed run killed after round index 1 of 3 and resumed
    from its checkpoint on the card: the uninterrupted run's trees, scores
    and bag bit for bit; resumed at D = 2 it keeps the first two trees."""
    import os
    import signal

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.tree import tree_to_arrays
    from lightgbm_tpu_torch.parallel import set_virtual_devices
    from lightgbm_tpu_torch.training import resume_booster, train_resumable

    dev = _card()
    X, y = _stream_frame(n=65_536)
    y = y + 0.25 * X[:, 2].astype(np.float32)
    p = dict(objective="regression", num_leaves=31, max_bin=255,
             learning_rate=0.3, min_data_in_leaf=20, verbosity=-1,
             bagging_fraction=0.8, bagging_freq=1, stream_block_rows=8_192,
             tree_learner="data")
    ds = lgb.Dataset(X, label=y, device=dev, params=dict(p)).construct()

    def sds():
        return lgb.Dataset.from_blocks(
            [(X[lo:lo + 8_192], y[lo:lo + 8_192])
             for lo in range(0, len(X), 8_192)], params=dict(p),
            reference=ds)

    def kill(booster, i):
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    set_virtual_devices(4)
    try:
        full = train_resumable(dict(p), sds(), 3, resume=False,
                               checkpoint_dir=str(tmp_path / "full"))
        cut = train_resumable(dict(p), sds(), 3, resume=False,
                              checkpoint_dir=str(tmp_path / "kill"),
                              round_callbacks=[kill])
        again = train_resumable(dict(p), sds(), 3, resume=True,
                                checkpoint_dir=str(tmp_path / "kill"))
        set_virtual_devices(2)
        two = resume_booster(cut.last_checkpoint, sds())
        assert two._mesh.n_devices == 2
    finally:
        set_virtual_devices(0)
    assert cut.preempted and cut.rounds_done == 2 and again.completed
    a, b = full.booster, again.booster
    assert len(a.trees) == len(b.trees) == 3
    for ta, tb in zip(a.trees, b.trees):
        fa, fb = tree_to_arrays(ta), tree_to_arrays(tb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k
    assert torch.equal(a._pred_train, b._pred_train)
    assert torch.equal(a._bag, b._bag)
    for ta, tb in zip(a.trees[:2], two.trees):
        assert np.array_equal(tree_to_arrays(ta)["leaf_value"],
                              tree_to_arrays(tb)["leaf_value"])


def _refresh_run(root, impl, blocks):
    """Two refresh generations of the daemon on the card (SimClock)."""
    from lightgbm_tpu_torch.pipeline import (ArrivalFeed, RefreshDaemon,
                                             SimClock)

    p = dict(objective="regression", num_leaves=31, max_bin=255,
             learning_rate=0.5, min_data_in_leaf=20, hist_dtype="f32",
             wave_tail="greedy", stream_block_rows=16_384, verbosity=-1,
             hist_impl=impl)
    clock = SimClock()
    feed = ArrivalFeed(clock)
    d = RefreshDaemon(p, str(root), feed=feed, refresh_rounds=2,
                      initial_rounds=2, checkpoint_rounds=2, clock=clock,
                      device="cuda")
    events = []
    for X, y in blocks:
        feed.push(X, y)
        events.append(d.tick())
    return d, events


@pytest.mark.gpu
def test_refresh_daemon_generation_kernel_vs_plain_on_card(tmp_path):
    """The refresh daemon on the card: two generations (60,000 rows in
    16,384-row blocks, then 20,000 more) through the kernels (B1 per block,
    B4 in the bank's canary) grow the plain path's forest bit for bit on
    exact sums (dyadic labels, l2, f32 histograms); each stamp follows the
    stage's device work."""
    from lightgbm_tpu_torch.kernels.histogram import HIST_FUSED_LAUNCHES
    from lightgbm_tpu_torch.kernels.predict import PREDICT_FOREST_LAUNCHES
    from lightgbm_tpu_torch.serving.packed import PackedForest

    _card()
    X, y = _stream_frame()
    X2, y2 = _stream_frame(n=20_000, seed=43)
    blocks = [(X, y), (X2, y2)]
    for c in (HIST_FUSED_LAUNCHES["f32"], PREDICT_FOREST_LAUNCHES):
        c.reset()
    dk, ek = _refresh_run(tmp_path / "kernel", "auto", blocks)
    assert HIST_FUSED_LAUNCHES["f32"].count > 0
    assert PREDICT_FOREST_LAUNCHES.count > 0
    dp, ep = _refresh_run(tmp_path / "plain", "plain", blocks)
    assert [e["event"] for e in ek] == [e["event"] for e in ep] == \
        ["flipped", "flipped"]
    assert ek[-1]["rounds"] == ep[-1]["rounds"] == 4
    a, b = PackedForest.load(dk._live_path), PackedForest.load(dp._live_path)
    for f in ("split_feature", "split_bin", "left", "right", "is_leaf",
              "leaf_value"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    served = dk.bank.predict("model", X2[:4096], raw_score=True)
    want = a.predict_numpy(a.bin_mapper.transform(X2[:4096]))
    np.testing.assert_allclose(served, want, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_profile_training_booster_equals_train_on_card():
    """profile_training on the card (CUDA events): every time positive,
    and its timed rounds are ``lgb.train``'s with the same params bit for
    bit (B1 roots, B2 waves)."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models.gbdt import Booster
    from lightgbm_tpu_torch.models.tree import tree_to_arrays
    from lightgbm_tpu_torch.utils.profiling import profile_training

    dev = _card()
    X, y = _stream_frame()
    params = {"objective": "binary", "num_leaves": 31, "verbose": -1}
    boosters = []
    orig = Booster.update_many

    def spy(self, k):
        orig(self, k)
        boosters.append(self)

    Booster.update_many = spy
    try:
        rep = profile_training(dict(params), X, y, 3)
    finally:
        Booster.update_many = orig
    assert all(rep[k] > 0 for k in rep if k.endswith("_s"))
    want = lgb.train(dict(params), lgb.Dataset(X, label=y, device=dev), 3)
    got = boosters[-1]
    assert len(got.trees) == len(want.trees) == 3
    for ta, tb in zip(got.trees, want.trees):
        fa, fb = tree_to_arrays(ta), tree_to_arrays(tb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k], equal_nan=True), k


@pytest.mark.gpu
def test_card_launch_budgets_hold():
    """The *_card launch budgets: CUDA launches a split iteration (B1 + B3,
    B6 + B3) and a bucket-8 dispatch (B4), counted by torch.profiler."""
    from lightgbm_tpu_torch.analysis.budgets import (LAUNCH_BUDGETS,
                                                     check_launch_budgets)

    _card()
    res = check_launch_budgets([b.name for b in LAUNCH_BUDGETS
                                if b.where == "card"])
    assert len(res) == 3
    assert all(r["ok"] for r in res), res


# ranges a figure of this card must lie in, stated up front (not tuned to a
# run): a PCIe Gen5 x16 link carries at most 64 GB/s each way; a copy
# inside HBM cannot beat HBM's 3.35 TB/s; latencies and legs are positive
# and under a second; ratios are positive
H2D_MAX_BYTES_PER_S, HBM_BYTES_PER_S = 64e9, 3.35e12


@pytest.mark.gpu
def test_budget_constants_measured_on_card(tmp_path):
    """Phase 26's own measurements (``chip_smoke.py``) on the card: the
    virtual-shard link, B1's histogram rate at the reference block, the
    host->device copies, B4's dispatch and the scores' copy back, a new
    bucket's first dispatch, the canary's replay, the checkpoint's legs:
    each finite and within its plausible range."""
    import chip_smoke as C
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serving import pack_booster

    dev = _card()
    X, y = _stream_frame()
    booster = lgb.train({"objective": "binary", "num_leaves": 31,
                         "verbose": -1},
                        lgb.Dataset(X, label=y, device=dev), 5)
    c = {}
    for got, _ in (C.p26_link(dev), C.p26_hist(dev), C.p26_h2d(dev),
                   C.p26_ckpt(str(tmp_path))):
        c.update(got)
    srv, warm, canary, _ = C.p26_serve(dev, pack_booster(booster))
    c.update(srv, **warm, **canary)
    assert all(np.isfinite(v) and v > 0 for v in c.values()), c
    assert c["H2D_BYTES_PER_S"] <= H2D_MAX_BYTES_PER_S, c
    assert c["LINK_BYTES_PER_S"] < HBM_BYTES_PER_S, c
    assert c["HIST_EQUIV_FLOPS"] > 0
    for name in ("LINK_HOP_LATENCY_S", "H2D_PUT_LATENCY_S",
                 "SERVE_DISPATCH_FIXED_S", "WARM_S_PER_SHAPE",
                 "CKPT_FIXED_LATENCY_S", "CANARY_ORACLE_S_PER_ROW_TREE"):
        assert c[name] < 1.0, (name, c[name])
