"""Port parity: ``lightgbm_tpu_torch.ops.quantize`` against ``lightgbm_tpu``.

The same numpy-seeded packed node arrays are quantized by both packages.
Everything must agree exactly: the quantizer is host-side arithmetic, and
the port's bf16 rounding (torch's cast, round to nearest even) is the same
rounding as the reference's ``ml_dtypes`` cast.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu_torch.ops import quantize as tq


def _arrays(seed, t=7, k=None, m=29):
    rng = np.random.default_rng(seed)
    lead = (t,) if k is None else (t, k)
    feat = rng.integers(0, 12, lead + (m,)).astype(np.int32)
    thr = rng.integers(0, 256, lead + (m,)).astype(np.int32)
    left = rng.integers(-1, m, lead + (m,)).astype(np.int32)
    right = rng.integers(-1, m, lead + (m,)).astype(np.int32)
    # leaf magnitudes spread over decades, as late boosting trees are
    scale = 10.0 ** rng.integers(-6, 2, lead + (1,))
    leaf = (rng.normal(size=lead + (m,)) * scale).astype(np.float32)
    is_leaf = rng.random(lead + (m,)) < 0.5
    leaf[~is_leaf] = 777.0          # sentinels must not set the scale
    return feat, thr, left, right, leaf, is_leaf


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_quantize_forest_matches_reference(precision, k):
    arrays = _arrays(seed=17 + (k or 0), k=k)
    j = jq.quantize_forest(*arrays, precision)
    t = tq.quantize_forest(*arrays, precision)
    for name in ("split_feature", "split_bin", "left", "right", "leaf_q",
                 "is_leaf"):
        a, b = getattr(j, name), getattr(t, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if precision == "int8":
        np.testing.assert_array_equal(j.leaf_scale, t.leaf_scale)
    else:
        assert j.leaf_scale is None and t.leaf_scale is None
    assert j.error_bound == t.error_bound
    np.testing.assert_array_equal(j.dequantized_leaf_values(),
                                  t.dequantized_leaf_values())
    assert j.node_bytes() == t.node_bytes()
    for c in ([None] if k is None else range(k)):
        for a, b in zip(j.class_arrays(c), t.class_arrays(c)):
            np.testing.assert_array_equal(a, b)


def test_bf16_rounding_is_round_to_nearest_even():
    import ml_dtypes

    rng = np.random.default_rng(0)
    x = (rng.normal(size=4096)
         * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32)
    ties = ((np.arange(512, dtype=np.uint32) << 16) | 0x8000).view(
        np.float32)
    x = np.concatenate([x, ties, -ties])
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(tq.bf16_round(x), want)


@pytest.mark.parametrize("field,value,match", [
    ("split_bin", 256, "split_bin"),
    ("split_bin", -1, "split_bin"),
    ("split_feature", 40000, "split_feature"),
    ("left", 32768, "left child"),
    ("right", -2, "right child"),
])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_threshold_bound_error_on_same_inputs(precision, field, value,
                                              match):
    arrays = list(_arrays(seed=3))
    idx = ("split_feature", "split_bin", "left", "right").index(field)
    arrays[idx] = arrays[idx].copy()
    arrays[idx][2, 5] = value
    with pytest.raises(jq.ThresholdBoundError, match=match):
        jq.quantize_forest(*arrays, precision)
    with pytest.raises(tq.ThresholdBoundError, match=match):
        tq.quantize_forest(*arrays, precision)


def test_layout_tables_and_model_bytes_match():
    assert tq.PACKED_NODE_BYTES == jq.PACKED_NODE_BYTES
    assert tq.PACKED_SCALE_BYTES_PER_TREE == jq.PACKED_SCALE_BYTES_PER_TREE
    assert tq.FOREST_PRECISIONS == jq.FOREST_PRECISIONS
    for prec in tq.FOREST_PRECISIONS:
        for shape in [(100, 253, 1), (30, 61, 4)]:
            assert (tq.packed_model_bytes(*shape, prec)
                    == jq.packed_model_bytes(*shape, prec))
    with pytest.raises(ValueError):
        tq.packed_model_bytes(1, 3, 1, "fp8")
    with pytest.raises(ValueError):
        tq.quantize_forest(*_arrays(seed=1), "f32")


@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_legacy_device_tree_widens_to_dequantized_values(precision):
    arrays = _arrays(seed=9)
    q = tq.quantize_forest(*arrays, precision)
    tree, scale = tq.to_device_tree(q, "cpu")
    assert tree.split_bin.dtype == torch.uint8
    assert tree.split_feature.dtype == torch.int16
    wide = tq.widen_tree(tree, scale)
    np.testing.assert_array_equal(wide.leaf_value.numpy(),
                                  q.dequantized_leaf_values())
    np.testing.assert_array_equal(wide.split_bin.numpy(),
                                  arrays[1].astype(np.int32))
