"""Port parity: per-node column sampling (``feature_fraction_bynode``).

(a) ``utils.random.fold_in_tensor`` equals ``vmap(jax.random.fold_in)``
    for the counters 0 ... 2^20, and ``models.feature_mask.node_mask_table``
    equals the reference's ``node_mask_fn`` row for row, bit for bit, for
    every node id below the grower's capacity;
(b) the four growers with bynode against the reference's ``grow_tree``
    (and its ``vmap`` over E = 3 elements with their own keys, fractions,
    regularizers and tree masks), on the CPU with the kernels' plain
    versions: the strict grower's unfused body, single (B1's route) and
    batched (B6's), and the wave grower, single (B2's) and batched (B5's).
    Dyadic statistics give bit-identical trees and routing, but for the
    stored split gains of the element with l1, l2 and max_delta_step on,
    which may differ by an ulp (the vmapped reference program with per-node
    masks contracts that element's gain arithmetic differently); general
    data equal structure and routing, values within rtol 1e-5, atol 1e-6;
(c) the reference's ``fuse_si`` rule: the strict grower calls the split
    iteration (kernel B3 on the card) only with bynode off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch.models.tree as ptree
from lightgbm_tpu.models.feature_mask import node_mask_fn as r_node_mask_fn
from lightgbm_tpu.models.tree import grow_tree as r_grow
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops.split import SplitContext as RCtx
from lightgbm_tpu_torch.models.feature_mask import node_mask_table
from lightgbm_tpu_torch.models.gbdt import _exact_overgrow_target
from lightgbm_tpu_torch.models.tree import (_tree_from_packed, grow_tree,
                                            grow_trees_batched)
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.ops.split import SplitContext as PCtx
from lightgbm_tpu_torch.utils.random import fold_in_tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the growers run thousands of small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves", "count")
N, F, B, LEAVES, E = 3000, 6, 32, 31, 3
CTX = np.array([[0.0, 0.0, 5.0, 1e-3, 0.0, 0.0, 0.0],
                [0.5, 1.0, 20.0, 0.5, 0.1, 0.3, 0.0],
                [0.0, 2.0, 10.0, 1e-3, 0.0, 0.0, 0.0]], np.float32)
MAX_DEPTH = np.array([-1, 5, 4], np.int32)
FF = np.array([0.5, 0.34, 1.0], np.float32)   # element 2: bynode a no-op
WIDTHS = {"strict": 1, "greedy": -22,
          "exact": _exact_overgrow_target(LEAVES, 22, 2.0) * 1024 + 22}


def _keys():
    base = jax.random.PRNGKey(11)
    return np.stack([np.asarray(jax.random.fold_in(base, e))
                     for e in range(E)]).astype(np.int64)


def test_fold_in_tensor_bit_equal():
    ids = np.arange(1 << 20, dtype=np.int64)
    keys = _keys()[:2]
    got = fold_in_tensor(torch.from_numpy(keys), torch.from_numpy(ids))
    for e in range(2):
        k = jnp.asarray(keys[e], jnp.uint32)
        want = jax.vmap(lambda i: jax.random.fold_in(k, i))(
            jnp.asarray(ids, jnp.uint32))
        assert np.array_equal(np.asarray(want).astype(np.int64),
                              got[e].numpy())


@pytest.mark.parametrize("ff", [5 / 28, 0.5, 0.97, 1.0])
def test_mask_table_equals_reference_node_masks(ff):
    num_features, capacity = 28, 2 * 127 - 1
    rng = np.random.default_rng(4)
    masks = (rng.random((E, num_features)) < 0.7).astype(np.float32)
    keys = _keys()
    table = node_mask_table(torch.from_numpy(keys),
                            torch.full((E,), ff), torch.from_numpy(masks),
                            capacity).numpy()
    for e in range(E):
        fn = r_node_mask_fn(jnp.asarray(keys[e], jnp.uint32),
                            jnp.float32(ff), num_features,
                            jnp.asarray(masks[e]), False)
        want = np.asarray(jax.vmap(fn)(jnp.arange(capacity, dtype=jnp.int32)))
        assert np.array_equal(want, table[e]), e
        picked = table[e].sum(1)
        assert picked.min() >= 1 and (table[e] <= masks[e]).all()


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
            g -= g.mean()
            h = rng.uniform(0.1, 0.3, N)
        bag = (rng.random(N) < 0.9).astype(np.float64)
        stats[e] = np.stack([g * bag, h * bag, bag], axis=1)
    fmask = (rng.random((E, F)) < 0.85).astype(np.float32)
    fmask[:, 0] = 1.0
    return bins, stats, fmask


_REF = {}


def _reference(bins, stats, fmask, ww, batched):
    key = (ww, batched)
    if key not in _REF:
        def one(st, fm, c, md, k, ff, b):
            return r_grow(b, st, fm, RCtx(*c), LEAVES, B, md, ff_bynode=ff,
                          key=k, wave_width=ww)

        _REF[key] = jax.jit(jax.vmap(one, in_axes=(0,) * 6 + (None,))
                            if batched else one)
    ctx = [jnp.asarray(CTX[:, i]) for i in range(CTX.shape[1])]
    args = (jnp.asarray(stats), jnp.asarray(fmask), tuple(ctx),
            jnp.asarray(MAX_DEPTH), jnp.asarray(_keys(), jnp.uint32),
            jnp.asarray(FF))
    if not batched:
        args = tuple(jax.tree.map(lambda a: a[0], x) for x in args)
    tree, rl = _REF[key](*args, jnp.asarray(bins))
    return r_arrays(tree), np.asarray(rl)


def _port(bins, stats, fmask, ww, batched):
    if not batched:
        tree, rl = grow_tree(
            torch.from_numpy(bins), torch.from_numpy(stats[0]),
            torch.from_numpy(fmask[0]), PCtx(*(float(v) for v in CTX[0])),
            LEAVES, B, int(MAX_DEPTH[0]), wave_width=ww,
            ff_bynode=float(FF[0]), key=tuple(int(v) for v in _keys()[0]))
        return p_arrays(tree), rl.numpy()
    ctx = PCtx(*(torch.from_numpy(CTX[:, i].copy())
                 for i in range(CTX.shape[1])))
    P, n_leaves, rl, _ = grow_trees_batched(
        torch.from_numpy(bins), torch.from_numpy(stats).transpose(0, 1),
        torch.from_numpy(fmask), ctx,
        torch.from_numpy(MAX_DEPTH.astype(np.float32)), LEAVES, B, ww,
        ff_bynode=torch.from_numpy(FF), keys=torch.from_numpy(_keys()))
    return p_arrays(_tree_from_packed(P, n_leaves)), rl.t().numpy()


@pytest.mark.parametrize("grower,tier", [
    ("strict", "dyadic"), ("strict", "general"), ("exact", "dyadic"),
    ("exact", "general"), ("greedy", "general")])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_bynode_growers_match_reference(grower, tier, batched):
    bins, stats, fmask = _data(1 if tier == "dyadic" else 2,
                               tier == "dyadic")
    ww = WIDTHS[grower]
    (a, rla), (b, rlb) = (_reference(bins, stats, fmask, ww, batched),
                          _port(bins, stats, fmask, ww, batched))
    assert set(a) == set(b)
    assert np.array_equal(rla, rlb)
    exact = set(a) - {"split_gain"} if tier == "dyadic" else STRUCTURE
    for k in exact:
        assert np.array_equal(a[k], b[k]), k
    if tier == "dyadic":
        plain = [0, 2] if batched else [0]    # elements without l1/l2
        assert np.array_equal(np.atleast_2d(a["split_gain"])[plain],
                              np.atleast_2d(b["split_gain"])[plain])
        np.testing.assert_allclose(b["split_gain"], a["split_gain"],
                                   rtol=1e-6, atol=0)
    else:
        for k in ("leaf_value", "split_gain"):
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL)
    assert int(np.max(b["num_leaves"])) > 8


@pytest.mark.parametrize("bynode", [False, True], ids=["off", "on"])
def test_fuse_si_rule_picks_the_strict_body(bynode, monkeypatch):
    calls = []
    real = ptree.split_iter

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(ptree, "split_iter", counting)
    bins, stats, fmask = _data(2, dyadic=False)
    extra = (dict(ff_bynode=0.5, key=(0, 7)) if bynode else {})
    tree, _ = grow_tree(torch.from_numpy(bins), torch.from_numpy(stats[0]),
                        torch.from_numpy(fmask[0]),
                        PCtx(*(float(v) for v in CTX[0])), LEAVES, B, -1,
                        wave_width=1, **extra)
    assert len(calls) == (0 if bynode else LEAVES - 1)
    assert int(tree.num_leaves) == LEAVES


@pytest.mark.parametrize("case", ["strict", "multiclass"])
def test_fused_cv_with_bynode_matches_reference(case):
    """``cv()``'s fused route with per-node sampling: each element's grower
    key (split over its classes for multiclass), the batched unfused
    strict body (B6's route), per-round fold means within the regime."""
    import lightgbm_tpu as R
    import lightgbm_tpu_torch as P

    rng = np.random.default_rng(6)
    X = rng.normal(size=(2400, 6)).astype(np.float32)
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.2 * rng.normal(size=2400)
    params = dict(objective="regression", num_leaves=15,
                  feature_fraction_bynode=0.5, verbosity=-1)
    y = s.astype(np.float32)
    if case == "multiclass":
        params.update(objective="multiclass", num_class=3, num_leaves=7)
        y = np.digitize(s, [-0.5, 0.5]).astype(np.float32)
    want = R.cv(params, R.Dataset(X, label=y), 6, nfold=3, stratified=False,
                seed=3)
    got = P.cv(params, P.Dataset(X, label=y, device="cpu"), 6, nfold=3,
               stratified=False, seed=3)
    key = [k for k in want if k.endswith("-mean")][0]
    np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)
