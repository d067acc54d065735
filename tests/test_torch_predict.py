"""Port parity: ``lightgbm_tpu_torch.ops.predict`` against ``lightgbm_tpu``.

The same numpy-seeded forests go through the reference (``pack_forest_soa``
and ``predict_forest_pallas`` in interpret mode on the CPU, as
``test_predict_fused.py`` runs it) and through the port (whose
``predict_forest`` takes its plain PyTorch version for CPU tensors).
Tolerances: packed tables equal exactly; predictions rtol 1e-5 / atol 1e-6
(the reference sums trees in chunks, the port one tree at a time), and
exactly on forests whose leaves are dyadic, where every sum is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.models.tree import Tree as JaxTree
from lightgbm_tpu.ops import predict as jp
from lightgbm_tpu_torch.models.tree import Tree
from lightgbm_tpu_torch.ops import predict as tp

RTOL, ATOL = 1e-5, 1e-6
PRECISIONS = ["f32", "bf16", "int8"]


def _rand_tree(rng, m, f, num_bins, shape, dyadic):
    """One tree with grower-style sentinels and garbage in dead slots."""
    def leaf_value():
        if dyadic:
            return np.float32(rng.integers(-127, 128) / 128.0)
        return np.float32(rng.normal())

    feat = np.zeros(m, np.int32)
    thr = np.zeros(m, np.int32)
    left = -np.ones(m, np.int32)
    right = -np.ones(m, np.int32)
    leafv = rng.normal(size=m).astype(np.float32)     # internal garbage
    isl = np.zeros(m, bool)
    if shape == "single-leaf":
        isl[0] = True
        leafv[0] = leaf_value()
        leafv[1:] = 999.0
        return feat, thr, left, right, leafv, isl
    n_nodes, frontier = 1, [0]
    while frontier and n_nodes + 2 <= m:
        i = frontier.pop(rng.integers(len(frontier)))
        if shape == "ragged" and rng.random() < 0.3 and i != 0:
            isl[i] = True
            leafv[i] = leaf_value()
            continue
        feat[i] = rng.integers(f)
        thr[i] = rng.integers(0, num_bins)
        left[i], right[i] = n_nodes, n_nodes + 1
        frontier += [n_nodes, n_nodes + 1]
        n_nodes += 2
    for i in frontier:
        isl[i] = True
        leafv[i] = leaf_value()
    leafv[n_nodes:] = 777.0
    return feat, thr, left, right, leafv, isl


def _forest(seed, t=6, m=31, f=5, num_bins=16, shape="ragged",
            dyadic=False):
    rng = np.random.default_rng(seed)
    shapes = [shape] * t
    if shape == "ragged":
        shapes[t // 2] = "single-leaf"
    arrs = [_rand_tree(rng, m, f, num_bins, s, dyadic) for s in shapes]
    arrays = tuple(np.stack(x) for x in zip(*arrs))
    bins = rng.integers(0, num_bins, (45, f)).astype(np.uint8)
    return arrays, bins


def _stored(arrays, precision):
    """(per-node arrays in the precision's storage form, leaf_scale)."""
    feat, thr, left, right, leafv, isl = arrays
    if precision == "f32":
        return arrays, None
    if precision == "bf16":
        stored = np.asarray(jnp.asarray(leafv, jnp.bfloat16), np.float32)
        return (feat, thr, left, right, stored, isl), None
    scale = np.full(feat.shape[0], 1.0 / 128.0, np.float32)
    codes = np.clip(np.round(leafv / scale[:, None]), -127,
                    127).astype(np.int8)
    return (feat.astype(np.int16), thr.astype(np.uint8),
            left.astype(np.int16), right.astype(np.int16), codes,
            isl), scale


def _pack_both(arrays, precision):
    stored, scale = _stored(arrays, precision)
    j = jp.pack_forest_soa(*stored, precision=precision, leaf_scale=scale)
    t = tp.pack_forest_soa(*stored, precision=precision, leaf_scale=scale,
                           device="cpu")
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("shape", ["ragged", "single-leaf"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_pack_forest_soa_matches_reference(precision, shape):
    arrays, _ = _forest(seed=11, shape=shape)
    j, t = _pack_both(arrays, precision)
    assert tp.soa_tree_chunk(t) == jp.soa_tree_chunk(j)
    assert t.precision == precision
    for name in jp.ForestSoA._fields:
        a, b = _np(getattr(j, name)), _np(getattr(t, name))
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("dyadic", [False, True])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_plain_predict_matches_pallas(precision, dyadic):
    arrays, bins = _forest(seed=23 + dyadic, dyadic=dyadic)
    j, t = _pack_both(arrays, precision)
    n_trees = arrays[0].shape[0]
    cap = jp.forest_depth_cap(JaxTree(
        *(jnp.asarray(a) for a in arrays[:6]),
        count=None, split_gain=None, num_leaves=None))
    tb = torch.from_numpy(bins)
    for k, s in [(n_trees, 0), (2, 0), (3, 1), (1, n_trees - 1),
                 (n_trees + 4, 0)]:
        ref = np.asarray(jp.predict_forest_pallas(
            j, jnp.asarray(bins), 0.1, 0.5, jnp.int32(k), cap,
            start_iteration=jnp.int32(s)))
        got = tp.predict_forest(t, tb, 0.1, 0.5, k, cap,
                                start_iteration=s).numpy()
        assert got.dtype == np.float32 and got.shape == (bins.shape[0],)
        if dyadic:
            np.testing.assert_array_equal(got, ref, err_msg=f"{k=} {s=}")
        else:
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k=} {s=}")


def test_short_depth_cap_and_garbage_feature_match_pallas():
    # a walk cut short by depth_cap, and a split on a column the batch does
    # not have (read as code 0 by both kernels)
    arrays, bins = _forest(seed=5, f=5)
    feat = arrays[0].copy()
    feat[:, 0] = 7                       # root splits on a missing column
    arrays = (feat,) + arrays[1:]
    j, t = _pack_both(arrays, "f32")
    for cap in (1, 3):
        ref = np.asarray(jp.predict_forest_pallas(
            j, jnp.asarray(bins), 1.0, 0.0, jnp.int32(6), cap))
        got = tp.predict_forest(t, torch.from_numpy(bins), 1.0, 0.0, 6,
                                cap).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_multiclass_planes_match_pallas():
    # one ForestSoA per class, as the runtime packs them
    for c in range(3):
        arrays, bins = _forest(seed=100 + c)
        j, t = _pack_both(arrays, "f32")
        ref = np.asarray(jp.predict_forest_pallas(
            j, jnp.asarray(bins), 0.2, -0.1, jnp.int32(6), 12))
        got = tp.predict_forest(t, torch.from_numpy(bins), 0.2, -0.1, 6,
                                12).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=f"class {c}")


def _cat_forest(seed, t=4, m=15, f=3, nb=8):
    """A stacked forest whose root splits are categorical subsets."""
    rng = np.random.default_rng(seed)
    arrs = [_rand_tree(rng, m, f, nb, "ragged", False) for _ in range(t)]
    feat, thr, left, right, leafv, isl = (np.stack(x) for x in zip(*arrs))
    is_cat = np.zeros((t, m), bool)
    is_cat[:, 0] = ~isl[:, 0]
    cat_mask = rng.random((t, m, nb)) < 0.5
    bins = rng.integers(0, nb, (40, f)).astype(np.uint8)
    fields = dict(split_feature=feat, split_bin=thr, left=left, right=right,
                  leaf_value=leafv, is_leaf=isl, is_cat_split=is_cat,
                  cat_mask=cat_mask)
    jt = JaxTree(**{k: jnp.asarray(v) for k, v in fields.items()},
                 count=jnp.zeros((t, 1)), split_gain=jnp.zeros((t, 1)),
                 num_leaves=jnp.zeros(t, jnp.int32))
    tt = Tree(**{k: torch.from_numpy(v) for k, v in fields.items()},
              count=torch.zeros((t, 1)), split_gain=torch.zeros((t, 1)),
              num_leaves=torch.zeros(t, dtype=torch.int32))
    return jt, tt, bins


def test_legacy_binned_predict_matches_on_categorical_forest():
    jt, tt, bins = _cat_forest(seed=3)
    cap = jp.forest_depth_cap(jt)
    assert tp.forest_depth_cap(tt) == cap
    for k, s in [(4, 0), (2, 1)]:
        ref = np.asarray(jp.predict_forest_binned(
            jt, jnp.asarray(bins), 0.3, 0.1, jnp.int32(k), cap,
            start_iteration=jnp.int32(s), tree_chunk=3))
        got = tp.predict_forest_binned(tt, torch.from_numpy(bins), 0.3, 0.1,
                                       k, cap, start_iteration=s,
                                       tree_chunk=3).numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    one_j = JaxTree(*(None if a is None else a[1] for a in jt))
    one_t = Tree(*(None if a is None else a[1] for a in tt))
    for depth in (None, cap):
        ref = np.asarray(jp.predict_tree_binned(one_j, jnp.asarray(bins),
                                                depth))
        got = tp.predict_tree_binned(one_t, torch.from_numpy(bins),
                                     depth).numpy()
        np.testing.assert_array_equal(got, ref)


def test_wrapper_takes_plain_version_only_for_cpu_tensors():
    arrays, bins = _forest(seed=8)
    _, t = _pack_both(arrays, "int8")
    tb = torch.from_numpy(bins)
    got = tp.predict_forest(t, tb, 0.1, 0.0, 6, 12)
    want = tp.predict_forest_plain(t, tb, 0.1, 0.0, 6, 12)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tp.predict_forest(t, tb.to("meta"), 0.1, 0.0, 6, 12)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_kernel_shared_memory_plan_has_no_column_limit(precision):
    # a block stages its tile's codes only while they fit 32 KB; past that
    # it reads them from global memory, so any column count gets a launch
    # within a block's shared memory
    from lightgbm_tpu_torch.kernels import predict as kp

    p = kp.plan(256, 256, 100, 128)
    assert p.staged_codes and p.smem == kp.smem_bytes(
        p.rows, 256, p.trees, p.prefix, True, p.cluster)
    assert p.smem - kp.smem_bytes(p.rows, 256, p.trees, p.prefix, False,
                                  p.cluster) == -(-p.rows * 256 // 16) * 16
    for f in (28, 256, 257, 1775, 1776, 5000, 100_000):
        for n in (1, 128, 16_384):
            p = kp.plan(f, 256, 100, n)
            assert 1 <= p.cluster <= kp.MAX_CLUSTER
            assert p.smem <= kp.SMEM_LIMIT
            assert p.staged_codes == (p.rows * f <= kp.STAGED_CODES_LIMIT)
    # one tree whose node tables outgrow a block's shared memory plans a
    # launch too: its top is staged, the rest read through L2 (the kernel
    # once refused such a tree)
    mp = 16_384 if precision == "f32" else 32_768
    for n in (1, 128, 16_384):
        p = kp.plan(28, mp, 1, n)
        assert p.smem <= kp.SMEM_LIMIT and p.prefix < mp
