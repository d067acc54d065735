"""The redesigned B1 (f32/bf16) and B2 launch plans and their passes, on the
CPU.

The kernels (``csrc/hist_rows.cuh``, ``csrc/row_partition.cuh``) run only on
the card; what surrounds them runs here:

* ``plan_rows`` at the north star (1,000,000 x 28 x 256 bins, S = 3) for
  K = 1 (a root), 2 (the strict grower), 42 (a wave) and 200: every block
  within the opt-in shared memory (232,448 B), at most 32 warps, work
  items of whole tiles, item slots enough for every item the device can
  cut;
* ``rows_items_plain`` (the partition and the work items): each segment's
  rows appear once, in row order, rows outside ``[0, K)`` never;
* ``rows_passes_plain`` (one f64 partial per work item, the segments of
  several items summed in item order and rounded once) against
  ``hist_fused_plain`` and ``hist_partition_plain`` (within 1e-6 * sum|x|
  per cell, counts exact; bit for bit on dyadic statistics, and equal to
  the float64 sums there) and against the reference's Pallas kernels in
  interpret mode (``hist_fused_pallas``; ``hist_partition_fused_pallas``
  through its wave operands), with the tolerances of
  ``test_torch_histogram.py``: 1e-6 * sum|x| + 1e-7 at bf16, 2^-14 *
  sum|x| at f32 (the TPU kernel's f32 is a hi/lo pair of bf16 passes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram_pallas as jp
from lightgbm_tpu_torch.kernels import histogram as kh
from lightgbm_tpu_torch.ops import histogram as H

MODES = ["f32", "bf16"]
SMS = 132


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


def _f64_sums(bins, stats, seg, k, num_bins):
    out = np.zeros((k, bins.shape[1], num_bins, stats.shape[1]))
    ok = (seg >= 0) & (seg < k)
    for j in range(bins.shape[1]):
        np.add.at(out, (seg[ok], j, bins[ok, j].astype(np.int64)),
                  stats[ok].astype(np.float64))
    return out


def _close(got, want, mag, rel, absol=0.0):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= rel * mag + absol).all(), float((err - rel * mag).max())
    np.testing.assert_array_equal(np.asarray(got)[..., 2],
                                  np.asarray(want)[..., 2])   # counts


# (name, n, F, B, K, segment ids drawn from [lo, hi), kind of segments)
CASES = [("root", 5_000, 7, 64, 1, 0, 1, "random"),
         ("root_other_segments", 4_099, 5, 256, 1, -1, 3, "random"),
         ("strict_most_outside", 9_001, 6, 256, 2, 0, 2, "outside"),
         ("strict_one_row", 3_000, 4, 32, 2, 0, 2, "one_row"),
         ("strict_empty", 2_000, 3, 16, 2, 0, 2, "empty"),
         ("k5_out_of_range", 6_007, 3, 2, 5, -3, 8, "random"),
         ("k42_one_segment_90pct", 12_011, 4, 256, 42, -1, 42, "skewed")]
IDS = [c[0] for c in CASES]


def _case(case, dyadic=False):
    name, n, f, nb, k, lo, hi, kind = case
    rng = np.random.default_rng(len(name) + n)
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    if dyadic:
        stats = (rng.integers(-8, 9, (n, 3)) * 0.25).astype(np.float32)
        stats[:, 2] = 1.0
    else:
        stats = np.stack([rng.normal(size=n), rng.uniform(0, 0.25, n),
                          (rng.random(n) < 0.8).astype(np.float64)],
                         axis=1).astype(np.float32)
    seg = rng.integers(lo, hi, n).astype(np.int32)
    if kind == "outside":
        seg = np.where(rng.random(n) < 0.95, 2, seg).astype(np.int32)
    elif kind == "one_row":
        seg[:] = 2
        seg[n // 3] = 1
    elif kind == "empty":
        seg[:] = 2
    elif kind == "skewed":
        seg = np.where(rng.random(n) < 0.9, 7, seg).astype(np.int32)
    return bins, stats, seg, k, nb


def _plan(bins, k, nb, sms=4):
    """A plan at a small card's size, so that the small cases still cut
    several work items (and several per segment)."""
    n, f = bins.shape
    return kh.plan_rows(n, f, 3, k, nb, sms)


@pytest.mark.parametrize("k", [1, 2, 42, 200])
def test_plan_rows_fits_at_the_north_star(k):
    n, f, s, nb = 1_000_000, 28, 3, 256
    p = kh.plan_rows(n, f, s, k, nb, SMS)
    assert kh.rows_smem_bytes(f, s, nb, p.feat_group, p.bulk) \
        <= kh.SMEM_LIMIT
    assert 1 <= p.feat_group <= kh.ROWS_MAX_WARPS
    assert p.groups * p.feat_group >= f
    assert p.feat_group == 28 and p.groups == 1     # every feature, one block
    assert p.bulk == (k == 1)
    assert p.rows % kh.ROWS_TILE == 0 and p.rows >= kh.ROWS_TILE
    if k == 1:
        assert p.rows * p.slots >= n and p.slots <= 2 * p.target
    else:
        # the device cuts at most v / R + K items, R >= v * groups / target
        for v in (n, n // 2, 56_009, 4_601, 1):
            r = max(p.rows, kh.rows_item_rows(v, p.groups, p.target, k))
            assert -(-v // r) + k <= p.slots


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_items_cover_each_segment_once_in_row_order(case):
    bins, stats, seg, k, nb = _case(case)
    p = _plan(bins, k, nb)
    items = kh.rows_items_plain(torch.from_numpy(seg), k, p)
    order, table = items["order"].numpy(), items["items"].numpy()
    assert len(table) <= p.slots
    if k == 1:
        assert np.array_equal(order, np.arange(len(seg)))
        assert table[0, 1] == 0 and table[-1, 2] == len(seg)
        assert (table[1:, 1] == table[:-1, 2]).all()
        return
    for kk in range(k):
        rows = [order[a:b] for s, a, b in table if s == kk]
        got = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        assert np.array_equal(got, np.nonzero(seg == kk)[0])
        assert int(items["item_count"][kk]) == len(rows)
    r = max(p.rows, kh.rows_item_rows(len(order), p.groups, p.target, k))
    assert (table[:, 2] - table[:, 1] <= r).all()
    assert (table[:, 2] > table[:, 1]).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_passes_match_the_plain_version(case, mode):
    bins, stats, seg, k, nb = _case(case)
    t = [torch.from_numpy(a) for a in (bins, stats, seg)]
    got = kh.rows_passes_plain(*t, k, nb, mode, _plan(bins, k, nb))["out"]
    want = H.hist_fused_plain(*t, k, nb, mode)
    assert got.shape == (k, bins.shape[1], nb, 3)
    _close(got.numpy(), want.numpy(), _abs_hist(bins, stats, seg, k, nb,
                                                mode), 1e-6)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_passes_exact_on_dyadic_statistics(case):
    bins, stats, seg, k, nb = _case(case, dyadic=True)
    t = [torch.from_numpy(a) for a in (bins, stats, seg)]
    for mode in MODES:
        got = kh.rows_passes_plain(*t, k, nb, mode, _plan(bins, k, nb))
        assert torch.equal(got["out"], H.hist_fused_plain(*t, k, nb, mode))
        np.testing.assert_array_equal(got["out"].numpy(),
                                      _f64_sums(bins, stats, seg, k, nb))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["root", "k5_out_of_range",
                                  "strict_most_outside"])
def test_passes_match_the_reference_kernel(case, mode):
    bins, stats, seg, k, nb = _case(CASES[IDS.index(case)])
    want = np.asarray(jp.hist_fused_pallas(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(seg), k, nb,
        interpret=True, hist_dtype=mode))
    got = kh.rows_passes_plain(torch.from_numpy(bins),
                               torch.from_numpy(stats),
                               torch.from_numpy(seg), k, nb, mode,
                               _plan(bins, k, nb))["out"].numpy()
    mag = _abs_hist(bins, stats, seg, k, nb, mode)
    if mode == "bf16":
        _close(got, want, mag, 1e-6, 1e-7)
    else:
        _close(got, want, mag, 2.0 ** -14)


def _wave(seed, n, f, nb, w, cap, heavy=None):
    """A wave: rows spread over ``cap`` nodes, ``w`` of them splitting on
    random features and thresholds; ``heavy``: that share of the rows in
    the first splitting node, whose split sends them all left."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    stats = np.stack([rng.normal(size=n), rng.uniform(0, 0.25, n),
                      (rng.random(n) < 0.8).astype(np.float64)],
                     axis=1).astype(np.float32)
    row_leaf = rng.integers(0, cap, n).astype(np.int32)
    slot = np.full(cap, -1, np.int32)
    nodes = rng.permutation(cap)[:w]
    slot[nodes] = np.arange(w)
    feat = rng.integers(0, f, w).astype(np.int32)
    thr = rng.integers(0, nb, w).astype(np.int32)
    dl = rng.integers(0, 2, w).astype(np.uint8)
    if heavy is not None:
        row_leaf = np.where(rng.random(n) < heavy, nodes[0],
                            row_leaf).astype(np.int32)
        thr[0], dl[0] = nb - 1, 1
    return bins, stats, row_leaf, slot, feat, thr, dl, cap


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("heavy", [None, 0.9], ids=["spread", "one_slot_90"])
def test_wave_passes_match_b2_plain_and_the_reference(heavy, mode):
    """B2's passes: the route's segments through ``rows_passes_plain``
    equal ``hist_partition_plain`` and the reference's fused wave kernel
    (interpret mode), also when one slot takes 90 % of the rows."""
    bins, stats, row_leaf, slot, feat, thr, dl, cap = _wave(
        11 if heavy is None else 12, 1_500, 5, 32, 4, 12, heavy)
    w = feat.shape[0]
    t = [torch.from_numpy(a) for a in (bins, stats, row_leaf, slot, feat,
                                       thr, dl)]
    seg, leaf = H.route_wave(t[0], *t[2:], cap)
    got = kh.rows_passes_plain(t[0], t[1], seg.to(torch.int32), w, 32, mode,
                               _plan(bins, w, 32))["out"].numpy()
    want, want_leaf = H.hist_partition_plain(*t, cap, 32, mode)
    assert torch.equal(leaf, want_leaf)
    mag = _abs_hist(bins, stats, seg.numpy(), w, 32, mode)
    _close(got, want.numpy(), mag, 1e-6)
    bins_t, stats_t, chunk = jp.prepare_wave_operands(
        jnp.asarray(bins), jnp.asarray(stats), 32, w)
    s = slot[row_leaf]
    sel = s >= 0
    sc = np.maximum(s, 0)
    pv = np.zeros((8, bins_t.shape[1]), np.float32)
    pv[0, :len(s)] = sel
    pv[1, :len(s)] = np.where(sel, feat[sc], 0)
    pv[2, :len(s)] = np.where(sel, thr[sc], 0)
    pv[3, :len(s)] = np.where(sel, 2 * sc, 0)
    pv[4, :len(s)] = np.where(sel, dl[sc], 0)
    ref, _ = jp.hist_partition_fused_pallas(
        bins_t, stats_t, jnp.asarray(pv), w, 32, chunk, interpret=True,
        hist_dtype=mode, wfeat=jnp.asarray(feat), num_features=5)
    _close(got, np.asarray(ref), mag, 1e-6 if mode == "bf16" else 2.0 ** -14,
           1e-7)
