"""Port parity: ``find_best_split`` on numpy histograms.

The same ``[F, B, 3]`` histograms go through the reference's
``lightgbm_tpu.ops.split.find_best_split`` and the port's (batched over a
leading axis where the reference is called per histogram).  Winner feature,
bin, child statistics and child outputs are exactly equal; the gain is
within rtol 1e-6 (the same f32 ops, so in practice equal too).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.ops import split as ts

F, B = 6, 32


def _hist(rng, f=F, b=B, rows=4000, dyadic=False):
    """A histogram of real rows: per-bin (grad, hess, count) sums."""
    codes = rng.integers(0, b, (rows, f))
    if dyadic:
        g = np.where(rng.random(rows) < 0.5, -0.5, 0.5)
        h = np.ones(rows)
    else:
        g = rng.normal(0.2, 1.0, rows)
        h = rng.uniform(0.05, 0.25, rows)
    hist = np.zeros((f, b, 3), np.float32)
    for j in range(f):
        for k, v in enumerate((g, h, np.ones(rows))):
            hist[j, :, k] = np.bincount(codes[:, j], weights=v, minlength=b)
    return hist


def _ctx(**kw):
    base = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20.0,
                min_sum_hessian=1e-3, min_gain_to_split=0.0,
                max_delta_step=0.0, path_smooth=0.0)
    base.update(kw)
    jctx = js.SplitContext(**{k: jnp.float32(v) for k, v in base.items()})
    return jctx, ts.SplitContext(**base)


def _compare(hists, masks, depth_ok, parent_out, **ctx_kw):
    jctx, tctx = _ctx(**ctx_kw)
    got = ts.find_best_split(torch.from_numpy(hists),
                             tctx, torch.from_numpy(masks),
                             torch.from_numpy(depth_ok),
                             torch.from_numpy(parent_out))
    for i in range(hists.shape[0]):
        want = js.find_best_split(jnp.asarray(hists[i]), jctx,
                                  jnp.asarray(masks[i]),
                                  jnp.bool_(depth_ok[i]),
                                  parent_out=jnp.float32(parent_out[i]))
        assert int(want.feature) == int(got.feature[i])
        assert int(want.bin) == int(got.bin[i])
        for name in ("left_g", "left_h", "left_c", "right_g", "right_h",
                     "right_c", "left_out", "right_out"):
            a = np.float32(getattr(want, name))
            b = got._asdict()[name][i].numpy()
            assert np.array_equal(a, b), (name, a, b)
        wg, gg = np.float32(want.gain), got.gain[i].numpy()
        if np.isfinite(wg):
            np.testing.assert_allclose(gg, wg, rtol=1e-6)
        else:
            assert wg == gg
    return got


def _batch(rng, k=4, **kw):
    hists = np.stack([_hist(rng, **kw) for _ in range(k)])
    masks = np.ones((k, hists.shape[1]), np.float32)
    parent_out = rng.normal(0, 0.1, k).astype(np.float32)
    return hists, masks, np.ones(k, bool), parent_out


CASES = {
    "plain": {},
    "l1_l2": dict(lambda_l1=0.5, lambda_l2=2.0),
    "min_data_gain": dict(min_data_in_leaf=300.0, min_gain_to_split=0.5),
    "max_delta_step": dict(max_delta_step=0.05),
    "path_smooth": dict(path_smooth=10.0),
    "all_regularizers": dict(lambda_l1=0.1, lambda_l2=1.0,
                             max_delta_step=0.2, path_smooth=3.0,
                             min_sum_hessian=5.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_find_best_split_matches_reference(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    hists, masks, depth_ok, parent_out = _batch(rng)
    got = _compare(hists, masks, depth_ok, parent_out, **CASES[case])
    assert got.gain.shape == (hists.shape[0],)


def test_feature_mask_and_depth():
    rng = np.random.default_rng(11)
    hists, masks, depth_ok, parent_out = _batch(rng)
    masks[0, :] = 0.0              # all masked: no valid split
    masks[1, ::2] = 0.0            # half the features masked
    depth_ok[2] = False            # the max_depth cap
    got = _compare(hists, masks, depth_ok, parent_out)
    assert np.isneginf(got.gain[0].numpy()) and int(got.feature[0]) == 0
    assert np.isneginf(got.gain[2].numpy())
    assert int(got.feature[1]) % 2 == 1


def test_ties_take_the_first_occurrence():
    rng = np.random.default_rng(12)
    h = _hist(rng, dyadic=True)
    h[3] = h[1]                    # feature 3 ties feature 1 exactly
    h[5] = h[1]
    hists = np.stack([h, h[::-1].copy()])
    masks = np.ones((2, F), np.float32)
    masks[0, 1] = 0.0              # feature 1 masked: 3 must beat 5
    got = _compare(hists, masks, np.ones(2, bool),
                   np.zeros(2, np.float32))
    assert int(got.feature[0]) in (0, 2, 3, 4)


def test_feature_best_gains_matches_reference():
    rng = np.random.default_rng(13)
    h = _hist(rng)
    jctx, tctx = _ctx(lambda_l2=1.0)
    mask = np.ones(F, np.float32)
    want = js.feature_best_gains(jnp.asarray(h), jctx, jnp.asarray(mask),
                                 jnp.bool_(True))
    got = ts.feature_best_gains(torch.from_numpy(h), tctx,
                                torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
