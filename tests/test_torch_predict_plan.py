"""The forest-predict kernel's launch plan and node records, on the CPU.

``kernels/predict.py`` plans each launch (row tiles, clusters of blocks
over the tree window, rounds, staged record prefixes, shared memory) and
packs each ``ForestSoA`` into the kernel's own node records.  Here the plan
is held for every precision x F x node slots x bucket of the serving
ladder (shared memory within a block's, every tree of the window walked
once, in tree order), and the plain walk over the records
(``records_leaf_nodes``, ``records_sums_plain``) equals ``forest_leaf_nodes``
and ``forest_sums_plain`` bit for bit, and the reference's
``predict_forest_pallas`` (interpret mode) on a dyadic forest, where every
sum is exact.  The kernel itself runs only on the card
(``test_torch_kernels_on_card.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import predict as jp
from lightgbm_tpu_torch.kernels import predict as kp
from lightgbm_tpu_torch.kernels._timing import (depth_cap_of, make_forest,
                                                soa_for)
from lightgbm_tpu_torch.ops import predict as tp

PRECISIONS = ["f32", "bf16", "int8"]
FEATURES = [28, 256, 257, 2000, 100_000]
BUCKETS = [1 << i for i in range(15)]
WINDOWS = [0, 1, 3, 10, 100, 1000]


def _slots(precision):
    # int16 indices hold 32,768 slots at most (pack_forest_soa)
    return [128, 256, 16_384] + ([32_768] if precision != "f32" else [])


def _windows(t):
    return [(t, 0), (t // 3, 0), (t // 2, t // 4), (1, t - 1), (t + 50, 0),
            (5, t + 3)]


@pytest.mark.parametrize("f", FEATURES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_plan_fits_and_covers_the_window(precision, f):
    for mp in _slots(precision):
        for n in BUCKETS:
            for w in WINDOWS:
                p = kp.plan(f, mp, w, n)
                what = (precision, f, mp, n, w, p)
                assert p.smem == kp.smem_bytes(p.rows, f, p.trees, p.prefix,
                                               p.staged_codes, p.cluster), what
                assert p.smem <= kp.SMEM_LIMIT, what
                assert 1 <= p.cluster <= kp.MAX_CLUSTER, what
                assert 32 <= p.threads <= kp.MAX_THREADS, what
                assert p.threads % 32 == 0, what
                # each row of a tile has an owner thread in its cluster
                assert -(-p.rows // p.cluster) <= p.threads, what
                assert p.tiles * p.rows >= n > (p.tiles - 1) * p.rows, what
                assert 0 <= p.prefix <= mp and p.prefix % 2 == 0, what
                assert (p.route == "staged") == (p.prefix > 0), what
                assert not p.staged_codes or (
                    p.rows * f <= kp.STAGED_CODES_LIMIT), what
                for t0 in (0, 7):
                    trees = [t for _, _, first, count in
                             kp.plan_trees(p, t0, t0 + w)
                             for t in range(first, first + count)]
                    assert trees == list(range(t0, t0 + w)), what


@pytest.mark.parametrize("precision", PRECISIONS)
def test_plan_of_one_large_tree(precision):
    # one tree of 16,384 slots (f32) or 32,768 (the int16 edge): its SoA
    # tables outgrow a block's shared memory, which refused such a tree
    # when the kernel staged whole trees; the kernel stages its top and
    # reads the rest through L2, so every bucket has a launch
    mp = 16_384 if precision == "f32" else 32_768
    soa_bytes_per_slot = {"f32": 20, "bf16": 9, "int8": 8}[precision]
    assert mp * soa_bytes_per_slot > kp.SMEM_LIMIT
    routes = set()
    for n in BUCKETS:
        p = kp.plan(28, mp, 1, n)
        assert p.smem <= kp.SMEM_LIMIT and p.prefix < mp
        routes.add(p.route)
    assert routes == {"staged"}


def _forest(leaves, trees=6, f=9, seed=3, leaf_fn=None):
    arrays = make_forest(seed + leaves, trees, leaves, np.full(f, 40),
                         leaf_fn=leaf_fn)
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(0, 40, (45, f)).astype(np.uint8))
    return arrays, bins


def _records_equal_plain(soa, bins, depth, t):
    rec, leafv = kp.node_tables(soa)
    tpad = soa.split_feature.shape[0]
    for k, s in _windows(t):
        t0, t1 = tp.tree_window(tpad, k, s)
        nodes = kp.records_leaf_nodes(rec, bins, t0, t1, depth)
        assert torch.equal(nodes, tp.forest_leaf_nodes(soa, bins,
                                                       depth)[t0:t1]), (k, s)
        got = kp.records_sums_plain(rec, leafv, bins, t0, t1, depth)
        want = tp.forest_sums_plain(soa, bins, k, depth, s)
        assert torch.equal(got, want), (k, s)


@pytest.mark.parametrize("leaves", [63, 127, 8191])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_records_walk_equals_plain(precision, leaves):
    arrays, bins = _forest(leaves, trees=3 if leaves > 127 else 6)
    feat = arrays["split_feature"]
    feat[:, 0] = bins.shape[1] + 3     # a root split on a missing column
    soa = soa_for(arrays, precision, "cpu")
    depth = depth_cap_of(arrays)
    t = feat.shape[0]
    _records_equal_plain(soa, bins, depth, t)
    _records_equal_plain(soa, bins, max(depth // 3, 1), t)   # cut walks


def test_records_thresholds_and_features_outside_the_codes():
    # an f32 SoA holds int32 thresholds and features: below 0 the walk
    # always goes right, at or above 255 always left, and a feature below
    # 0 reads code 0, as the SoA's int32 compare decides
    arrays, bins = _forest(31, trees=8, seed=5)
    rng = np.random.default_rng(9)
    internal = ~arrays["is_leaf"] & (arrays["left"] >= 0)
    pick = rng.random(internal.shape) < 0.5
    thr = arrays["split_bin"]
    thr[internal & pick] = rng.choice([-7, -1, 255, 256, 1 << 20],
                                      int((internal & pick).sum()))
    feat = arrays["split_feature"]
    neg = internal & (rng.random(internal.shape) < 0.2)
    feat[neg] = -3
    soa = soa_for(arrays, "f32", "cpu")
    _records_equal_plain(soa, bins, depth_cap_of(arrays), 8)


def test_records_sums_match_pallas_on_a_dyadic_forest():
    # every leaf k/128: each partial sum is exact in f32, so the kernel's
    # tree-order sum equals the reference kernel's chunked one exactly
    k = np.random.default_rng(13)
    arrays, bins = _forest(63, trees=13, seed=11, leaf_fn=lambda: np.float32(
        k.integers(-127, 128) / 128.0))
    depth = depth_cap_of(arrays)
    a = arrays
    for precision in ("f32", "bf16"):
        j = jp.pack_forest_soa(a["split_feature"], a["split_bin"], a["left"],
                               a["right"], a["leaf_value"], a["is_leaf"],
                               precision=precision)
        soa = soa_for(arrays, precision, "cpu")
        rec, leafv = kp.node_tables(soa)
        tpad = soa.split_feature.shape[0]
        for num_it, start in _windows(13):
            ref = np.asarray(jp.predict_forest_pallas(
                j, jnp.asarray(bins.numpy()), 1.0, 0.0, jnp.int32(num_it),
                depth, start_iteration=jnp.int32(start)))
            t0, t1 = tp.tree_window(tpad, num_it, start)
            got = kp.records_sums_plain(rec, leafv, bins, t0, t1, depth)
            np.testing.assert_array_equal(got.numpy(), ref)


def test_node_tables_cached_per_soa_and_rebuilt_after_a_change():
    arrays, _ = _forest(15, trees=4)
    soa = soa_for(arrays, "int8", "cpu")
    first = kp.node_tables(soa)
    assert kp.node_tables(soa) is first
    rec, leafv = first
    assert rec.dtype == torch.int64 and leafv.dtype == torch.float32
    assert rec.shape == leafv.shape == soa.leaf.shape
    # the slots the walk never leaves are leaf records holding their value
    leaf = rec < 0                     # the flag is the sign bit
    assert torch.equal(leaf, soa.is_leaf)
    bits = leafv.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(rec[leaf] & 0xFFFFFFFF, bits[leaf])
    other = soa._replace(scale=soa.scale * 2)
    assert kp.node_tables(other) is not first
    soa.leaf.add_(1)                   # in place: the versions move
    again = kp.node_tables(soa)
    assert again is not first
    assert torch.equal(again[1], (soa.leaf.float() * soa.scale[:, None]))


def test_node_tables_refuse_what_the_records_cannot_hold():
    arrays, _ = _forest(15, trees=2)
    soa = soa_for(arrays, "f32", "cpu")
    bad_child = soa._replace(left=soa.left.clone().fill_(soa.left.shape[1]))
    with pytest.raises(ValueError, match="child outside"):
        kp.build_node_tables(bad_child)
    bad_feat = soa._replace(split_feature=soa.split_feature.clone().fill_(
        kp.FEATURE_NONE))
    with pytest.raises(ValueError, match="split feature"):
        kp.build_node_tables(bad_feat)
    wide = torch.zeros((1, kp.MAX_SLOTS + 128), dtype=torch.int32)
    huge = soa._replace(split_feature=wide, split_bin=wide, left=wide,
                        right=wide, leaf=wide.float(),
                        scale=torch.ones(1))
    with pytest.raises(ValueError, match="node slots"):
        kp.build_node_tables(huge)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_walk_counts_are_what_the_records_walk_reads(precision):
    # B4's byte and walk bounds count the records the rows' paths read,
    # the leaf values of walks cut short and the internal-node visits:
    # here from the plain walk over the records, step by step
    from lightgbm_tpu_torch.kernels._timing import walk_counts

    arrays, bins = _forest(127, trees=7, seed=17)
    soa = soa_for(arrays, precision, "cpu")
    rec, _ = kp.node_tables(soa)
    t, mp = rec.shape
    full = depth_cap_of(arrays)
    for cap in (full, max(full // 2, 1)):
        nodes = [kp.records_leaf_nodes(rec, bins, 0, t, s)
                 for s in range(cap + 1)]
        leaf = [(rec < 0).gather(1, nd) for nd in nodes[:cap]]
        tree = torch.arange(t)[:, None].expand_as(nodes[0])
        read = torch.unique(torch.cat([(tree * mp + nd).flatten()
                                       for nd in nodes[:cap]]))
        stopped = torch.stack(leaf).any(0)
        cut = torch.unique((tree * mp + nodes[cap])[~stopped])
        visits = sum(int((~lf).sum()) for lf in leaf)
        assert walk_counts(soa, bins, cap, t) == (visits, read.numel(),
                                                  cut.numel()), cap
