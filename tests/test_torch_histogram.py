"""Port parity: the histogram kernels' plain versions (B1 ``hist_fused``,
B2 ``hist_partition_fused``) against the reference.

The same numpy-seeded bins, statistics and segments go through the
reference's XLA ``compute_histograms`` (its CPU path), through its Pallas
kernels in interpret mode (``hist_fused_pallas``,
``hist_partition_fused_pallas``), and through the port, whose wrappers take
the plain PyTorch version for CPU tensors.  Tolerances, per cell:

* ``|delta| <= 1e-6 * sum|x| + 1e-7`` against the XLA path at f32 and bf16,
  and against the Pallas kernels at bf16 (all are sums of the same
  f32 or bf16-rounded values, in different orders);
* ``|delta| <= 2**-14 * sum|x|`` against the Pallas kernels at f32, whose
  f32 mode is a hi/lo split into two bf16 passes (the port sums true f32);
* counts and B2's row routing exactly.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_kernels_on_card.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import histogram_pallas as jp
from lightgbm_tpu_torch.ops import histogram as th

MODES = ["f32", "bf16"]


def _rounded(stats, mode):
    if mode == "bf16":
        return torch.from_numpy(stats).to(torch.bfloat16).float().numpy()
    return stats


def _abs_hist(bins, stats, seg, k, num_bins, mode):
    """Per-cell sum |x| (float64) of the mode-rounded statistics."""
    st = np.abs(_rounded(stats, mode)).astype(np.float64)
    n, f = bins.shape
    out = np.zeros((k, f, num_bins, stats.shape[1]))
    ok = (seg >= 0) & (seg < k)
    for j in range(f):
        np.add.at(out, (seg[ok], j, bins[ok, j].astype(np.int64)), st[ok])
    return out


def _close(got, want, mag, rel, absol=0.0):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= rel * mag + absol).all(), float((err - rel * mag).max())
    np.testing.assert_array_equal(np.asarray(got)[..., 2],
                                  np.asarray(want)[..., 2])   # counts


def _case(seed, n, f, num_bins, k, seg_lo=0, seg_hi=None, one_bin=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, num_bins, (n, f)).astype(np.uint8)
    if one_bin:
        bins[:] = num_bins // 2
    stats = np.stack([rng.normal(size=n), rng.uniform(0, 0.25, n),
                      (rng.random(n) < 0.8).astype(np.float64)],
                     axis=1).astype(np.float32)
    seg = rng.integers(seg_lo, k if seg_hi is None else seg_hi,
                       n).astype(np.int32)
    return bins, stats, seg


CASES = {
    "n1500_f4_b32_k5": dict(n=1500, f=4, num_bins=32, k=5),
    "root_f7_b64": dict(n=3000, f=7, num_bins=64, k=1),
    "out_of_range_segments": dict(n=2000, f=3, num_bins=16, k=4, seg_lo=-3,
                                  seg_hi=7),
    "empty_segments_one_bin": dict(n=1000, f=2, num_bins=8, k=6, seg_hi=2,
                                   one_bin=True),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_b1_plain_matches_reference_xla(case, mode):
    c = CASES[case]
    bins, stats, seg = _case(sorted(CASES).index(case), **{
        k: v for k, v in c.items()})
    k, nb = c["k"], c["num_bins"]
    want = jh.compute_histograms(jnp.asarray(bins), jnp.asarray(stats),
                                 jnp.asarray(seg), k, nb, hist_dtype=mode)
    got = th.hist_fused(torch.from_numpy(bins), torch.from_numpy(stats),
                        torch.from_numpy(seg), k, nb, mode)
    assert got.shape == (k, bins.shape[1], nb, 3)
    _close(got.numpy(), np.asarray(want),
           _abs_hist(bins, stats, seg, k, nb, mode), 1e-6, 1e-7)
    if case == "empty_segments_one_bin":
        g = got.numpy()
        assert not g[2:].any()
        assert not np.delete(g, nb // 2, axis=2).any()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", ["n1500_f4_b32_k5", "out_of_range_segments"])
def test_b1_plain_matches_pallas_interpret(case, mode):
    c = CASES[case]
    bins, stats, seg = _case(sorted(CASES).index(case), **c)
    k, nb = c["k"], c["num_bins"]
    want = jp.hist_fused_pallas(jnp.asarray(bins), jnp.asarray(stats),
                                jnp.asarray(seg), k, nb, interpret=True,
                                hist_dtype=mode)
    got = th.hist_fused(torch.from_numpy(bins), torch.from_numpy(stats),
                        torch.from_numpy(seg), k, nb, mode)
    mag = _abs_hist(bins, stats, seg, k, nb, mode)
    if mode == "bf16":
        _close(got.numpy(), np.asarray(want), mag, 1e-6, 1e-7)
    else:
        _close(got.numpy(), np.asarray(want), mag, 2.0 ** -14)


def test_compute_histograms_impls_agree():
    bins, stats, seg = _case(9, 800, 3, 16, 2)
    args = (torch.from_numpy(bins), torch.from_numpy(stats),
            torch.from_numpy(seg), 2, 16)
    a = th.compute_histograms(*args, impl="auto", hist_dtype="f32x")
    b = th.compute_histograms(*args, impl="plain", hist_dtype="f32")
    assert torch.equal(a, b)
    # int8 is the quantized contract under either impl (not the reference's
    # full-precision XLA fallback on the CPU)
    q8 = th.compute_histograms(*args, impl="auto", hist_dtype="int8")
    assert torch.equal(q8, th.compute_histograms(*args, impl="plain",
                                                 hist_dtype="int8"))
    assert not torch.equal(q8, b)
    with pytest.raises(NotImplementedError, match="int4"):
        th.compute_histograms(*args, hist_dtype="int4")
    with pytest.raises(ValueError, match="hist_impl"):
        th.compute_histograms(*args, impl="pallas")


def _wave(seed, n, f, num_bins, w, capacity):
    """A wave: rows spread over ``capacity`` nodes, ``w`` of them (at
    random) splitting on random features and thresholds."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, num_bins, (n, f)).astype(np.uint8)
    stats = np.stack([rng.normal(size=n), rng.uniform(0, 0.25, n),
                      (rng.random(n) < 0.8).astype(np.float64)],
                     axis=1).astype(np.float32)
    row_leaf = rng.integers(0, capacity, n).astype(np.int32)
    slot = np.full(capacity, -1, np.int32)
    slot[rng.permutation(capacity)[:w]] = np.arange(w)
    feat = rng.integers(0, f, w).astype(np.int32)
    thr = rng.integers(0, num_bins, w).astype(np.int32)
    dl = rng.integers(0, 2, w).astype(np.uint8)
    return bins, stats, row_leaf, slot, feat, thr, dl, capacity


def _reference_wave(bins, stats, row_leaf, slot, feat, thr, dl, n_nodes,
                    num_bins, mode):
    """The reference's fused wave kernel in interpret mode: (hist,
    new_row_leaf) from its per-row [8, n] field table and ``enc``."""
    n, f = bins.shape
    w = feat.shape[0]
    bins_t, stats_t, chunk = jp.prepare_wave_operands(
        jnp.asarray(bins), jnp.asarray(stats), num_bins, w)
    s = slot[row_leaf]
    sel = s >= 0
    sc = np.maximum(s, 0)
    pv = np.zeros((8, bins_t.shape[1]), np.float32)
    pv[0, :n] = sel
    pv[1, :n] = np.where(sel, feat[sc], 0)
    pv[2, :n] = np.where(sel, thr[sc], 0)
    pv[3, :n] = np.where(sel, 2 * sc, 0)
    pv[4, :n] = np.where(sel, dl[sc], 0)
    hist, enc = jp.hist_partition_fused_pallas(
        bins_t, stats_t, jnp.asarray(pv), w, num_bins, chunk,
        interpret=True, hist_dtype=mode, wfeat=jnp.asarray(feat),
        num_features=f)
    enc = np.asarray(enc)[:n]
    new_leaf = np.where(enc > 0, n_nodes + enc - 1, row_leaf)
    return np.asarray(hist), new_leaf


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", ["single_block", "multi_block"])
def test_b2_plain_matches_pallas_interpret(shape, mode):
    n, f, nb, w = ((1200, 5, 32, 4) if shape == "single_block"
                   else (700, 50, 256, 6))
    bins, stats, row_leaf, slot, feat, thr, dl, cap = _wave(
        7 + (shape == "multi_block"), n, f, nb, w, 3 * w)
    n_nodes = cap
    want_hist, want_leaf = _reference_wave(bins, stats, row_leaf, slot, feat,
                                           thr, dl, n_nodes, nb, mode)
    t = [torch.from_numpy(a) for a in (bins, stats, row_leaf, slot, feat,
                                       thr, dl)]
    got_hist, got_leaf = th.hist_partition_fused(*t, n_nodes, nb, mode)
    np.testing.assert_array_equal(got_leaf.numpy(), want_leaf)
    seg, leaf2 = th.route_wave(t[0], *t[2:], n_nodes)
    assert torch.equal(leaf2, got_leaf)
    mag = _abs_hist(bins, stats, seg.numpy(), w, nb, mode)
    _close(got_hist.numpy(), want_hist, mag,
           1e-6 if mode == "bf16" else 2.0 ** -14, 1e-7)


def test_b2_plain_matches_reference_xla_segments():
    """B2's histogram equals B1 over its routed segments, and both match the
    reference's XLA histogram of the same segments."""
    bins, stats, row_leaf, slot, feat, thr, dl, cap = _wave(3, 2000, 6, 64,
                                                            5, 12)
    t = [torch.from_numpy(a) for a in (bins, stats, row_leaf, slot, feat,
                                       thr, dl)]
    hist, _ = th.hist_partition_fused(*t, cap, 64, "f32")
    seg, _ = th.route_wave(t[0], *t[2:], cap)
    assert torch.equal(hist, th.hist_fused(t[0], t[1], seg.to(torch.int32),
                                           5, 64, "f32"))
    want = jh.compute_histograms(jnp.asarray(bins), jnp.asarray(stats),
                                 jnp.asarray(seg.numpy()), 5, 64)
    _close(hist.numpy(), np.asarray(want),
           _abs_hist(bins, stats, seg.numpy(), 5, 64, "f32"), 1e-6, 1e-7)
