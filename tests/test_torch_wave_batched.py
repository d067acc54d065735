"""Port parity: the batched wave grower (``grow_tree_frontier_batched``,
``grow_trees_batched``) against the reference's ``jax.vmap(grow_tree)`` over
E = 3 elements, on the CPU with the plain versions of kernels B5 and B6.

Each element has its own regularizers, feature mask and depth cap, and one
element (depth cap 2) finishes its tree waves before the others, so the
vmapped loop carries it unchanged while they go on.  All three wave tails
(half, greedy, exact) run; the greedy and exact tails at width 22, whose
waves take kernel B5's route (22 segments x 3 statistics >= 64 lanes), the
half tail at width 7 (B6's route).

* dyadic tier (l2 gradients +-0.5, hessian 1): every histogram sum is exact,
  so the trees (structure, thresholds, leaf values, counts, gains) and the
  row routing are bit-identical;
* general data: split structure and row routing equal, leaf values and gains
  within rtol 1e-5, atol 1e-6 (the reference sums its histograms in f32, the
  port's plain version in f64 rounded once).  The gradients are centred, as
  a round's are at the boost-from-average score: a sibling's histogram is
  its parent's minus the direct child's in f32 in both packages, so a small
  leaf carries an error of the order of an ulp of the root's sums.  With an
  off-centre gradient sum (mean 0.2 over 3,000 rows) the packages' values of
  a 23-row node differed by 2e-5 of it (the port 2e-5 off its float64 value,
  the reference 3e-6): f32 cancellation, which either package may take the
  worse side of.  Seed 2 has no near-tied split at these shapes.

Each element's tree also equals the one the single-model wave grower
(``grow_tree_frontier``) grows for it alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.models.tree import grow_tree as r_grow
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops.split import SplitContext as RCtx
from lightgbm_tpu_torch.models.gbdt import _exact_overgrow_target
from lightgbm_tpu_torch.models.tree import (_tree_from_packed, grow_tree,
                                            grow_trees_batched)
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.ops.split import SplitContext as PCtx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the batched growers run thousands of small ops,
    which several test workers' thread pools, each as wide as the machine,
    would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves", "count")
N, F, B, LEAVES, E = 3000, 6, 32, 31, 3
# per element: l1, l2, min_data, min_hess, min_gain, max_delta_step,
# path_smooth; and max_depth (element 2 stops after two levels)
CTX = np.array([[0.0, 0.0, 5.0, 1e-3, 0.0, 0.0, 0.0],
                [0.5, 1.0, 20.0, 0.5, 0.1, 0.3, 0.0],
                [0.0, 2.0, 10.0, 1e-3, 0.0, 0.0, 0.0]], np.float32)
MAX_DEPTH = np.array([-1, 5, 2], np.int32)
TAILS = {"half": 7, "greedy": -22,
         "exact": _exact_overgrow_target(LEAVES, 22, 2.0) * 1024 + 22}


def _data(seed, dyadic):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (N, F)).astype(np.uint8)
    stats = np.zeros((E, N, 3), np.float32)
    for e in range(E):
        if dyadic:
            g = np.where(rng.random(N) < 0.5, -0.5, 0.5)
            h = np.ones(N)
        else:
            g = rng.normal(size=N) + 0.4 * (bins[:, e] / B)
            g -= g.mean()        # centred, as at the boost-from-average score
            h = rng.uniform(0.1, 0.3, N)
        bag = (rng.random(N) < 0.9).astype(np.float64)
        stats[e] = np.stack([g * bag, h * bag, bag], axis=1)
    fmask = (rng.random((E, F)) < 0.8).astype(np.float32)
    fmask[:, 0] = 1.0
    return bins, stats, fmask


_REF = {}


def _reference(bins, stats, fmask, ww):
    if ww not in _REF:
        def one(st, fm, c, md, b):
            return r_grow(b, st, fm, RCtx(*c), LEAVES, B, md, wave_width=ww)

        _REF[ww] = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
    ctx = tuple(jnp.asarray(CTX[:, i]) for i in range(CTX.shape[1]))
    tree, rl = _REF[ww](jnp.asarray(stats), jnp.asarray(fmask), ctx,
                        jnp.asarray(MAX_DEPTH), jnp.asarray(bins))
    return r_arrays(tree), np.asarray(rl)                  # [E, ...]


def _port(bins, stats, fmask, ww):
    ctx = PCtx(*(torch.from_numpy(CTX[:, i].copy())
                 for i in range(CTX.shape[1])))
    P, n_leaves, rl, _ = grow_trees_batched(
        torch.from_numpy(bins), torch.from_numpy(stats).transpose(0, 1),
        torch.from_numpy(fmask), ctx,
        torch.from_numpy(MAX_DEPTH.astype(np.float32)), LEAVES, B, ww)
    return p_arrays(_tree_from_packed(P, n_leaves)), rl.t().numpy()


def _check(a, b, rla, rlb, exact):
    assert set(a) == set(b)
    assert np.array_equal(rla, rlb)
    keys = a if exact else STRUCTURE
    for k in keys:
        assert np.array_equal(a[k], b[k]), k
    if not exact:
        for k in ("leaf_value", "split_gain"):
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL)
    leaves = b["num_leaves"]
    assert leaves[2] <= 4 < leaves[0]        # element 2 stopped early


@pytest.mark.parametrize("tail", sorted(TAILS))
@pytest.mark.parametrize("tier", ["dyadic", "general"])
def test_batched_waves_match_vmapped_reference(tail, tier):
    bins, stats, fmask = _data(1 if tier == "dyadic" else 2,
                               tier == "dyadic")
    (a, rla), (b, rlb) = (_reference(bins, stats, fmask, TAILS[tail]),
                          _port(bins, stats, fmask, TAILS[tail]))
    _check(a, b, rla, rlb, tier == "dyadic")


@pytest.mark.parametrize("tail", ["greedy", "exact"])
def test_each_element_equals_single_model_grower(tail):
    """Element e of the batch is the tree the unbatched wave grower grows
    from element e's inputs (dyadic statistics: bit for bit)."""
    bins, stats, fmask = _data(3, dyadic=True)
    batch, rl_b = _port(bins, stats, fmask, TAILS[tail])
    for e in range(E):
        tree, rl = grow_tree(torch.from_numpy(bins),
                             torch.from_numpy(stats[e]),
                             torch.from_numpy(fmask[e]),
                             PCtx(*(float(v) for v in CTX[e])), LEAVES, B,
                             int(MAX_DEPTH[e]), wave_width=TAILS[tail])
        one = p_arrays(tree)
        for k in one:
            assert np.array_equal(one[k], batch[k][e]), (e, k)
        assert np.array_equal(rl.numpy(), rl_b[e])
