"""Port parity: batched histograms over a shared binned matrix
(``compute_histograms_batched`` and the plain version of kernel B6,
``hist_segstats_plain``) against the reference on the CPU: its XLA segstats
route and ``hist_from_segstats_pallas`` in interpret mode.

The same seeded numpy bins, statistics and segment ids go into both.  Every
cell agrees to ``1e-6 * sum|x|`` over the rows it collects (the reference
sums in f32 one-hot contractions, the port in f64 rounded once), and exactly
on dyadic statistics, whose every partial sum is exact.  Modes: ``f32``,
``f32x`` (the explicit f32 contract) and ``bf16`` (statistics rounded to
nearest-even bf16, summed in f32); segment ids outside ``[0, K)`` add
nothing; ``int8`` raises by name.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram as rh
from lightgbm_tpu.ops.histogram_pallas import hist_from_segstats_pallas
from lightgbm_tpu_torch.ops import histogram as th

N, F, B, E = 3001, 5, 32, 3


def _inputs(seed, dyadic=False, s=3):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    if dyadic:
        stats = (rng.integers(-8, 9, (E, N, s)) * 0.25).astype(np.float32)
    else:
        stats = rng.normal(size=(E, N, s)).astype(np.float32)
    seg = rng.integers(-1, 4, (E, N)).astype(np.int32)   # K = 3: -1, 3 drop
    return bins, stats, seg


def _mag(bins, stats, seg, k, mode):
    """Per-cell sum |x| ``[E, K, F, B, S]`` of the mode-rounded stats."""
    st = stats
    if mode == "bf16":
        st = torch.from_numpy(stats).to(torch.bfloat16).float().numpy()
    st = np.abs(st).astype(np.float64)
    out = np.zeros((E, k, F, B, stats.shape[2]))
    for e in range(E):
        ok = (seg[e] >= 0) & (seg[e] < k)
        for j in range(F):
            np.add.at(out[e], (seg[e][ok], j, bins[ok, j].astype(np.int64)),
                      st[e][ok])
    return out


def _close(got, want, mag, exact):
    got, want = got.astype(np.float64), want.astype(np.float64)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert (np.abs(got - want) <= 1e-6 * mag).all()


@pytest.mark.parametrize("dyadic", [False, True], ids=["general", "dyadic"])
@pytest.mark.parametrize("mode", ["f32", "f32x", "bf16"])
@pytest.mark.parametrize("k", [1, 3])
def test_batched_matches_reference(k, mode, dyadic):
    bins, stats, seg = _inputs(10 + k, dyadic)
    if k == 1:
        seg = np.zeros_like(seg)
    want = np.asarray(rh.compute_histograms_batched(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(seg), k, B,
        hist_dtype=mode))
    got = th.compute_histograms_batched(
        torch.from_numpy(bins), torch.from_numpy(stats),
        torch.from_numpy(seg), k, B, hist_dtype=mode).numpy()
    assert got.shape == want.shape == (E, k, F, B, 3)
    _close(got, want, _mag(bins, stats, seg, k, mode), dyadic)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_segstats_plain_matches_pallas_kernel(mode):
    """The plain version of B6 against the TPU kernel it replaces."""
    rng = np.random.default_rng(4)
    kc = 18
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    segstats = rng.normal(size=(N, kc)).astype(np.float32)
    want = np.asarray(hist_from_segstats_pallas(
        jnp.asarray(bins), jnp.asarray(segstats), B, interpret=True,
        hist_dtype=mode))
    got = th.hist_segstats_plain(torch.from_numpy(bins),
                                 torch.from_numpy(segstats), B, mode).numpy()
    assert got.shape == want.shape == (F, B, kc)
    st = segstats
    if mode == "bf16":
        st = torch.from_numpy(st).to(torch.bfloat16).float().numpy()
    mag = np.zeros((F, B, kc))
    for j in range(F):
        np.add.at(mag[j], bins[:, j].astype(np.int64), np.abs(st))
    _close(got, want, mag, False)
    # the CPU dispatch takes the plain version
    assert torch.equal(th.hist_segstats(torch.from_numpy(bins),
                                        torch.from_numpy(segstats), B, mode),
                       torch.from_numpy(got))


def test_rows_layout_equals_batched_layout():
    """The grower's row-major entry point is the same function."""
    bins, stats, seg = _inputs(7)
    a = th.compute_histograms_batched(torch.from_numpy(bins),
                                      torch.from_numpy(stats),
                                      torch.from_numpy(seg), 3, B)
    b = th.histograms_rows(torch.from_numpy(bins),
                           torch.from_numpy(stats).transpose(0, 1).contiguous(),
                           torch.from_numpy(seg).t().contiguous(), 3, B)
    assert torch.equal(a, b)
    one = th.histograms_rows(torch.from_numpy(bins),
                             torch.from_numpy(stats).transpose(0, 1), None, 1,
                             B)
    ref = th.compute_histograms_batched(
        torch.from_numpy(bins), torch.from_numpy(stats),
        torch.zeros((E, N), dtype=torch.int32), 1, B)
    assert torch.equal(one, ref)


def test_int8_raises_by_name():
    """int8 batched histograms run at full precision (B6's f32 route, as the
    reference's XLA segstats path), at narrow and wide widths; a mode the
    port lacks still raises by name."""
    bins, stats, seg = _inputs(1)
    args = (torch.from_numpy(bins), torch.from_numpy(stats),
            torch.from_numpy(seg))
    for k in (3, 25):
        q8 = th.compute_histograms_batched(*args, k, B, hist_dtype="int8")
        f32 = th.compute_histograms_batched(*args, k, B, hist_dtype="f32")
        assert torch.equal(q8, f32)
    with pytest.raises(NotImplementedError, match="int4"):
        th.compute_histograms_batched(*args, 3, B, hist_dtype="int4")
