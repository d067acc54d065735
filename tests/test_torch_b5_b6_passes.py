"""The redesigned B5 and B6 launch plans and their passes, on the CPU.

The kernels run only on the card; what surrounds them runs here:

* the plans at the recorded shapes (the north-star ``cv()`` wave, E = 5,
  K = 42, 1,000,192 x 28; Covertype's wave, E = 7, 581,012 x 54; B6 on
  the diamonds split at Kc = 15, 30, 240 and 1,080 and at the north-star
  root): every block within the opt-in shared memory (232,448 B), at
  least four blocks to an SM as the designs claim, work items that cover
  every row, channel-group sets that cover every channel;
* ``batched_passes_plain`` (B5's partition, work items, f64 partials and
  reduce in the kernel's order): its partition equals a stable ``argsort``
  by segment with out-of-range rows dropped, its items tile each segment in
  order, and its histograms equal the plain version's (exact on dyadic
  statistics, within 1e-6 * sum|x| of float64 otherwise);
* ``segstats_passes_plain`` (B6's per-chunk sort, the warps' ranges with
  continued runs added last, the chunk reduce): its order equals a stable
  per-chunk ``argsort`` by bin, and its histograms equal the plain
  version's.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.kernels import histogram as kh
from lightgbm_tpu_torch.ops import histogram as H

SMS = 132
QUARTER_SM = kh.SMEM_PER_SM // 4 - 1024   # four blocks to an SM


@pytest.mark.parametrize("n,f,e,k", [(1_000_192, 28, 5, 42),
                                     (581_012, 54, 7, 42),
                                     (581_012, 15, 7, 42),
                                     (300_001, 28, 2, 22),
                                     (4_099, 3, 1, 5)])
def test_batched_plan(n, f, e, k):
    r, cap, fg, n_part = kh.plan_batched(n, f, 3, k, 256, SMS, e)
    smem = kh.batched_smem_bytes(3, 256, fg)
    assert smem <= QUARTER_SM <= kh.SMEM_LIMIT         # four blocks an SM
    assert 4 * kh.B5_WARPS * k <= kh.SMEM_LIMIT        # partition counts
    assert r % kh.B5_TILE == 0 and 1 <= fg <= min(f, kh.B5_WARPS)
    # the item slots bound sum_k ceil(c_k / R) for any split of n rows
    assert cap >= -(-n // r) + k
    assert n_part * kh.B5_PART_ROWS >= n
    groups = -(-f // fg)
    assert groups * fg - f < groups                    # balanced groups
    if n >= 500_000:
        # the upper-bound grid (every row direct) makes about four rounds
        # of four blocks per SM, and fits the launch limits
        blocks = -(-e * n // r) * groups
        assert 8 * SMS <= blocks <= 16 * SMS
        assert e * cap < 2 ** 31 and groups <= 65535


def test_batched_plan_at_the_north_star_wave():
    """The recorded plans: feature groups of 7 at F = 28 (four groups), 8
    at Covertype's 54 raw and 15 bundled features, 55,296 B a block at 8,
    items of 9,728 positions at the north star."""
    assert kh.plan_batched(1_000_192, 28, 3, 42, 256, SMS, 5) == (
        9728, 145, 7, 977)
    assert kh.plan_batched(581_012, 54, 3, 42, 256, SMS, 7)[2] == 8
    assert kh.plan_batched(581_012, 15, 3, 42, 256, SMS, 7)[2] == 8
    assert kh.batched_smem_bytes(3, 256, 8) == 55_296


@pytest.mark.parametrize("n,f,kc", [(45_957, 6, 15), (45_957, 6, 30),
                                    (45_957, 6, 240), (45_957, 6, 1_080),
                                    (1_000_192, 28, 15), (1_000_192, 28, 21),
                                    (3_000, 6, 1)])
def test_segstats_plan(n, f, kc):
    rows, chunks, per_set, sets = kh.plan_segstats(n, f, kc, 256, SMS)
    smem = kh.segstats_smem_bytes(rows)
    assert smem <= QUARTER_SM                          # four blocks an SM
    assert rows in kh.B6_CHUNK_ROWS and rows % (kh.WARPS * 32) == 0
    assert rows * chunks >= n > rows * (chunks - 1)
    groups = -(-kc // kh.B6_LANES)
    assert per_set * sets >= groups > per_set * (sets - 1)
    assert sets <= 65535 and f <= 65535


def test_segstats_plan_at_the_sweep_shape():
    """Kc = 240 on the diamonds split: 23 chunks of 2,048 rows, one channel
    group per block, 1,104 blocks (about eight per SM); the north-star
    root: 123 chunks of 8,192 rows; a block of 8,192 rows takes 45,092 B,
    so five share an SM."""
    assert kh.plan_segstats(45_957, 6, 240, 256, SMS) == (2048, 23, 1, 8)
    assert kh.plan_segstats(1_000_192, 28, 15, 256, SMS) == (8192, 123, 1,
                                                              1)
    assert kh.segstats_smem_bytes(8192) == 45_092


def _dyadic_or_normal(rng, shape, dyadic):
    if dyadic:
        return (rng.integers(-8, 9, shape) * 0.25).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("dyadic", [False, True])
def test_batched_passes_match_plain(mode, dyadic):
    rng = np.random.default_rng(11 + dyadic)
    n, f, e, k, nb, r = 5_003, 4, 3, 9, 64, 512
    bins = torch.from_numpy(rng.integers(0, nb, (n, f)).astype(np.uint8))
    stats = torch.from_numpy(_dyadic_or_normal(rng, (e, n, 3), dyadic))
    seg = torch.from_numpy(rng.integers(-3, k + 3, (e, n)).astype(np.int32))
    res = kh.batched_passes_plain(bins, stats, seg, k, nb, mode, r)
    for el in range(e):
        s = seg[el].numpy()
        ok = (s >= 0) & (s < k)
        key = np.where(ok, s, k)
        want = np.argsort(key, kind="stable")[:ok.sum()]
        assert np.array_equal(res["order"][el].numpy(), want)
        starts = np.concatenate([[0], np.cumsum(np.bincount(s[ok],
                                                            minlength=k))])
        assert np.array_equal(res["seg_start"][el].numpy(), starts)
    # the items of a segment tile its positions in order, at most r each
    for el in range(e):
        for kk in range(k):
            its = [(p0, p1) for (ee, k2, p0, p1) in res["items"]
                   if ee == el and k2 == kk]
            bounds = res["seg_start"][el]
            assert len(its) == -(-int(bounds[kk + 1] - bounds[kk]) // r)
            pos = int(bounds[kk])
            for p0, p1 in its:
                assert p0 == pos and 0 < p1 - p0 <= r
                pos = p1
            assert pos == int(bounds[kk + 1])
    want = H.hist_fused_batched_plain(bins, stats, seg, k, nb, mode)
    got = res["out"]
    if dyadic:
        assert torch.equal(got, want)
    st = stats.to(torch.bfloat16).float() if mode == "bf16" else stats
    for el in range(e):
        mag = H.hist_fused_plain(bins, st[el].abs(), seg[el], k, nb, "f32")
        assert ((got[el].double() - want[el].double()).abs()
                <= 1e-6 * mag.double()).all()


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["random", "skewed", "one_bin", "dyadic"])
def test_segstats_passes_match_plain(mode, kind):
    rng = np.random.default_rng(13)
    n, f, kc, nb, rows = 3_001, 3, 37, 32, 1_024
    if kind == "skewed":
        codes = rng.choice(np.array([0, 1, 5, 31], np.uint8), (n, f),
                           p=[0.7, 0.2, 0.05, 0.05])
    elif kind == "one_bin":
        codes = np.full((n, f), 7, np.uint8)
    else:
        codes = rng.integers(0, nb, (n, f)).astype(np.uint8)
    bins = torch.from_numpy(codes)
    st = torch.from_numpy(_dyadic_or_normal(rng, (n, kc), kind == "dyadic"))
    res = kh.segstats_passes_plain(bins, st, nb, mode, rows)
    for c, r0 in enumerate(range(0, n, rows)):
        for j in range(f):
            want = np.argsort(codes[r0:r0 + rows, j], kind="stable")
            assert np.array_equal(res["order"][c][j].numpy(), want)
    want = H.hist_segstats_plain(bins, st, nb, mode)
    if kind == "dyadic":
        assert torch.equal(res["out"], want)
    a = (st.to(torch.bfloat16).float() if mode == "bf16" else st).abs()
    mag = H.hist_segstats_plain(bins, a, nb, "f32").double()
    assert ((res["out"].double() - want.double()).abs() <= 1e-6 * mag).all()
