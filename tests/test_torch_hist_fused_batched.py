"""Port parity: the plain version of kernel B5 (``hist_fused_batched_plain``,
the batched fused histogram) and the batched route, against the reference on
the CPU.

The same seeded numpy bins, statistics and segment ids (E = 3 elements,
K = 22 segments, ids in [-1, 24] so that out-of-range ids occur on both
sides, n = 2,001 rows, F = 5, B = 32) go into both:

* against ``hist_fused_pallas_batched`` in interpret mode, the TPU kernel it
  replaces: bf16 exact on dyadic statistics (both round the statistics to
  bf16 and every partial sum is exact); f32 within ``2**-15 * sum|x|`` per
  cell, the error of the TPU kernel's hi/lo bf16 split, which the port does
  not copy (its f32 is true f32);
* against the reference's XLA ``compute_histograms_batched`` (true f32 sums)
  within ``1e-6 * sum|x|`` per cell, exactly on dyadic statistics;
* the route: ``compute_histograms_batched`` and ``histograms_rows`` take B5
  exactly when ``K * S >= 64`` and B6 below, as the reference routes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as rh
from lightgbm_tpu.ops.histogram_pallas import hist_fused_pallas_batched
from lightgbm_tpu_torch.ops import histogram as th

N, F, B, E, K = 2001, 5, 32, 3, 22


def _inputs(seed, dyadic=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    if dyadic:
        stats = (rng.integers(-8, 9, (E, N, 3)) * 0.25).astype(np.float32)
    else:
        stats = rng.normal(size=(E, N, 3)).astype(np.float32)
    seg = rng.integers(-1, K + 3, (E, N)).astype(np.int32)
    return bins, stats, seg


def _mag(bins, stats, seg, mode):
    """Per-cell sum |x| ``[E, K, F, B, 3]`` of the mode-rounded stats."""
    st = stats
    if mode == "bf16":
        st = torch.from_numpy(stats).to(torch.bfloat16).float().numpy()
    st = np.abs(st).astype(np.float64)
    out = np.zeros((E, K, F, B, 3))
    for e in range(E):
        ok = (seg[e] >= 0) & (seg[e] < K)
        for j in range(F):
            np.add.at(out[e], (seg[e][ok], j, bins[ok, j].astype(np.int64)),
                      st[e][ok])
    return out


def _plain(bins, stats, seg, mode):
    return th.hist_fused_batched_plain(
        torch.from_numpy(bins), torch.from_numpy(stats),
        torch.from_numpy(seg), K, B, mode).numpy().astype(np.float64)


@pytest.mark.parametrize("dyadic", [False, True], ids=["general", "dyadic"])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_plain_matches_pallas_kernel(mode, dyadic):
    bins, stats, seg = _inputs(20 + dyadic, dyadic)
    want = np.asarray(hist_fused_pallas_batched(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(seg), K, B,
        interpret=True, hist_dtype=mode)).astype(np.float64)
    got = _plain(bins, stats, seg, mode)
    assert got.shape == want.shape == (E, K, F, B, 3)
    if mode == "bf16" and dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        tol = 2.0 ** -15 if mode == "f32" else 1e-6
        assert (np.abs(got - want) <= tol * _mag(bins, stats, seg, mode)).all()


@pytest.mark.parametrize("dyadic", [False, True], ids=["general", "dyadic"])
@pytest.mark.parametrize("mode", ["f32", "f32x", "bf16"])
def test_batched_route_matches_reference_xla(mode, dyadic):
    bins, stats, seg = _inputs(30 + dyadic, dyadic)
    want = np.asarray(rh.compute_histograms_batched(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(seg), K, B,
        hist_dtype=mode)).astype(np.float64)
    got = th.compute_histograms_batched(
        torch.from_numpy(bins), torch.from_numpy(stats),
        torch.from_numpy(seg), K, B, hist_dtype=mode).numpy()
    assert got.shape == want.shape == (E, K, F, B, 3)
    if dyadic:
        np.testing.assert_array_equal(got, want)
    else:
        m = "bf16" if mode == "bf16" else "f32"
        assert (np.abs(got - want) <= 1e-6 * _mag(bins, stats, seg, m)).all()
    # the CPU dispatch takes the plain version
    plain = _plain(bins, stats, seg, "bf16" if mode == "bf16" else "f32")
    np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("k", [2, 21, 22, 42])
def test_route_takes_b5_exactly_when_wide(k, monkeypatch):
    """``K * S >= 64`` goes to B5 (``hist_fused_batched``), narrower calls
    to B6 (``hist_segstats``), in both layouts; both routes give the same
    sums."""
    bins, stats, seg = _inputs(5)
    seg = np.where(seg < k, seg, -1).astype(np.int32)
    calls = []
    for name in ("hist_fused_batched", "hist_segstats"):
        real = getattr(th, name)

        def spy(*a, _name=name, _real=real, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(th, name, spy)
    tb, ts, tg = (torch.from_numpy(x) for x in (bins, stats, seg))
    a = th.compute_histograms_batched(tb, ts, tg, k, B)
    b = th.histograms_rows(tb, ts.transpose(0, 1), tg.t(), k, B)
    want = "hist_fused_batched" if k * 3 >= 64 else "hist_segstats"
    assert calls == [want, want]
    assert torch.equal(a, b)
    if k * 3 < 64:
        other = th.hist_fused_batched_plain(tb, ts, tg, k, B)
    else:
        folded = th.segstats_rows(ts.transpose(0, 1), tg.t(), k)
        other = th.hist_segstats_plain(tb, folded, B).view(
            F, B, E, k, 3).permute(2, 3, 0, 1, 4)
    mag = np.abs(a.numpy()).max()
    np.testing.assert_allclose(other.numpy(), a.numpy(), rtol=0,
                               atol=1e-5 * mag)
