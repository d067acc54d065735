"""Port parity where it is hardest: near-tied thresholds (ROADMAP C.1).

At 255 bins a node often has two thresholds between which none of its
in-bag rows lie.  Their gains are then equal but for the f32 rounding of
the histogram subtraction, which differs between the packages, so either
package may take either threshold.  This file runs the case that
``test_torch_fused_cv.py`` names: fused ``cv()`` in the wave regime
(``grow_policy="frontier"``, 3 folds, 3,000 x 6, bagging 0.8 every 4
rounds, ``feature_fraction`` 0.8, 31 leaves), on the ``cv`` seeds 0 and 2,
which DO show such swaps, and holds the port to what its regime promises.

Every round's batched grower call of the port's program is replayed through
the reference's ``jax.vmap(grow_tree)`` on the same inputs, and per element:

* in-bag row routing is equal;
* the split structure (features, children, leaves, counts) is equal, and
  a threshold may differ only between two thresholds with no in-bag row of
  the node between them; the two gains are then within 8 ulps (6 is the
  most seen: seed 0 round 3, 4 and 1 ulps at the other swaps);
* elsewhere gains and leaf values agree within rtol 1e-5, atol 1e-6.

Seed 0 swaps at rounds 3 (two folds) and 12, seed 2 at round 11 (of 12).
How far the held-out predictions move: after 12 rounds of the port's and
the reference's whole programs, seed 0's held-out predictions differ by at
most 4.8e-7 (f32 ulps of the sums), seed 2's by 0.066 in fold 2, whose
swap left one out-of-bag training row between the thresholds: that row
routes differently, its next gradient differs, and the trees part from
there (fold 2's held-out RMSE 2.151542 against the reference's 2.151607,
3.0e-5 relative; the other folds 9.5e-7 apart).  The test holds every
fold's held-out RMSE within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.config import parse_params as r_params
from lightgbm_tpu.models.fused import FusedCVProgram as RProgram
from lightgbm_tpu.models.tree import grow_tree as r_grow
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops.split import SplitContext as RCtx
from lightgbm_tpu_torch.config import parse_params as p_params
from lightgbm_tpu_torch.models import fused as pf
from lightgbm_tpu_torch.models.tree import _tree_from_packed
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROUNDS, FOLDS, MAX_GAIN_ULPS = 12, 3, 8
PARAMS = dict(objective="regression", num_leaves=31, max_bin=31, verbose=-1,
              learning_rate=0.2, bagging_freq=4, min_data_in_leaf=20,
              feature_fraction=0.8, bagging_fraction=0.8,
              grow_policy="frontier")
STRUCTURE = ("split_feature", "left", "right", "is_leaf", "num_leaves",
             "count")


def _data(n=3000, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 6))
    y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] * X[:, 3]
         + 2.0 * rng.normal(0, 1, n))
    return X, y


@pytest.fixture(scope="module")
def data():
    X, y = _data()
    return X, y, R.Dataset(X, label=y), P.Dataset(X, label=y, device="cpu")


_REF = {}


def _reference(args):
    """The reference's vmapped grower on the port's grower inputs."""
    bins, stats_t, fmask, ctx, max_depth, leaves, num_bins, ww = args[:8]
    key = (leaves, num_bins, ww)
    if key not in _REF:
        def one(st, fm, c, md, b):
            return r_grow(b, st, fm, RCtx(*c), leaves, num_bins, md,
                          wave_width=ww)

        _REF[key] = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
    tree, rl = _REF[key](
        jnp.asarray(stats_t.transpose(0, 1).numpy()),
        jnp.asarray(fmask.numpy()),
        tuple(jnp.asarray(v.numpy()) for v in ctx),
        jnp.asarray(max_depth.numpy().astype(np.int32)),
        jnp.asarray(bins.numpy()))
    return r_arrays(tree), np.asarray(rl)


def _path_nodes(a, e, bins):
    """bool [M, n]: node i lies on row r's path in element e's tree (a row
    goes left when its bin is at most the threshold)."""
    n = bins.shape[0]
    cur = np.zeros(n, np.int64)
    on = np.zeros((a["is_leaf"].shape[1], n), bool)
    for _ in range(a["is_leaf"].shape[1]):
        on[cur, np.arange(n)] = True
        leaf = a["is_leaf"][e][cur]
        if leaf.all():
            break
        f = np.maximum(a["split_feature"][e][cur], 0)
        left = bins[np.arange(n), f] <= a["split_bin"][e][cur]
        cur = np.where(leaf, cur, np.where(left, a["left"][e][cur],
                                           a["right"][e][cur]))
    return on, cur


def _ulps(a, b):
    ia = np.float32(a).view(np.int32).astype(np.int64)
    ib = np.float32(b).view(np.int32).astype(np.int64)
    return int(abs(ia - ib))


def _compare_round(args, port_out):
    """Tie-aware comparison of one grower call; returns the swaps seen as
    (element, node, gain ulps)."""
    P_, n_leaves, rl, _ = port_out
    pa = p_arrays(_tree_from_packed(P_, n_leaves))
    ra, rrl = _reference(args)
    prl = rl.t().numpy()
    bins = args[0].numpy()
    in_bag = args[1][:, :, 2].t().numpy() > 0            # [E, n]
    swaps = []
    for e in range(prl.shape[0]):
        on, leaf = _path_nodes(pa, e, bins)
        assert np.array_equal(leaf, prl[e])     # the traversal is the port's
        assert np.array_equal(prl[e][in_bag[e]], rrl[e][in_bag[e]])
        for k in STRUCTURE:
            assert np.array_equal(pa[k][e], ra[k][e]), k
        differ = pa["split_bin"][e] != ra["split_bin"][e]
        for i in np.nonzero(differ)[0]:
            f = pa["split_feature"][e][i]
            lo, hi = sorted((pa["split_bin"][e][i], ra["split_bin"][e][i]))
            between = on[i] & in_bag[e] & (bins[:, f] > lo) & (bins[:, f]
                                                              <= hi)
            assert not between.any(), (e, i, lo, hi)
            ulps = _ulps(pa["split_gain"][e][i], ra["split_gain"][e][i])
            assert ulps <= MAX_GAIN_ULPS, (e, i, ulps)
            swaps.append((e, int(i), ulps))
        same = ~differ
        for k in ("split_gain", "leaf_value"):
            np.testing.assert_allclose(pa[k][e][same], ra[k][e][same],
                                       rtol=1e-5, atol=1e-6)
    return swaps


def _port_rounds(pd, masks, seed, monkeypatch):
    prog = pf.FusedCVProgram(pd, [p_params(PARAMS)], masks, ROUNDS, 0, seed)
    calls = []
    real = pf.grow_trees_batched

    def spy(*a, **k):
        out = real(*a, **k)
        calls.append((a, out))
        return out

    monkeypatch.setattr(pf, "grow_trees_batched", spy)
    carry = prog.step(prog.init(), ROUNDS)
    monkeypatch.setattr(pf, "grow_trees_batched", real)
    return carry, calls


@pytest.mark.parametrize("seed,want_swaps", [(0, 3), (2, 1)])
def test_near_tied_thresholds_swap_only_where_no_in_bag_row_lies(
        data, seed, want_swaps, monkeypatch):
    X, y, rd, pd = data
    assign = np.random.default_rng(seed).permutation(len(y)) % FOLDS
    masks = np.stack([assign != i for i in range(FOLDS)])
    carry, calls = _port_rounds(pd, masks, seed, monkeypatch)
    assert len(calls) == ROUNDS
    swaps = [s for args, out in calls for s in _compare_round(args, out)]
    # the seeds were chosen because they DO swap
    assert len(swaps) == want_swaps, swaps
    # the whole programs: held-out quality within 1e-4 relative per fold
    rp = RProgram(rd, [r_params(PARAMS)], masks, ROUNDS, 0, seed)
    rpred = np.asarray(rp.step(rp.init(), ROUNDS).pred)[:, :len(y)]
    ppred = carry.pred.numpy()[:, :len(y)]
    for e in range(FOLDS):
        held = assign == e
        r_rmse = np.sqrt(np.mean((rpred[e][held] - y[held]) ** 2))
        p_rmse = np.sqrt(np.mean((ppred[e][held] - y[held]) ** 2))
        assert abs(p_rmse - r_rmse) <= 1e-4 * r_rmse, (e, p_rmse, r_rmse)
