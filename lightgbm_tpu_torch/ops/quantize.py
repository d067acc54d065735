"""Low-precision quantization — the port of ``lightgbm_tpu/ops/quantize.py``:
the histogram ring's wire format (:func:`wire_transfer`) and packed forests.

:func:`quantize_forest` shrinks a packed forest's device residency: int8 or
bf16 leaf values (int8 with one symmetric f32 scale per tree), uint8
thresholds, int16 node and feature indices.  Thresholds are bin codes,
small integers, so they are stored exactly or not at all: any value outside
the container's range is a hard :class:`ThresholdBoundError`, never a
rounding.  Only leaf values are lossy, and the worst-case prediction error
bound comes back beside the arrays so the serving canary gates on
arithmetic.

bf16 rounding goes through ``torch.bfloat16`` (round to nearest even), the
same rounding as the reference's cast.

:func:`wire_transfer` is one ring hop of an f32 partial-sum histogram over
per-shard lists (``parallel.mesh``): f32 as it is, bf16 rounded on the
wire, or int8 with one scale per (feature, stat) column, re-quantized at
every hop.  Plain PyTorch on purpose: in the reference it is a ``lax``
collective and XLA ops, not a Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

WIRE_DTYPES = ("f32", "bf16", "int8")
_INV127 = float(np.float32(1.0) / np.float32(127.0))
FOREST_PRECISIONS = ("f32", "bf16", "int8")

# Per-node storage bytes of a packed forest's traversal arrays by
# precision — the layout contract of the device-resident node tables:
#   f32:  split_feature i32 + split_bin i32 + left/right i32 +
#         leaf_value f32 + is_leaf bool               = 21 B
#   bf16: split_feature i16 + split_bin u8 + left/right i16 +
#         leaf_value bf16 + is_leaf bool              = 10 B
#   int8: split_feature i16 + split_bin u8 + left/right i16 +
#         leaf_value i8 + is_leaf bool                =  9 B
# plus (int8) one f32 scale per tree — charged separately because it does
# not scale with node capacity.
PACKED_NODE_BYTES = {"f32": 21, "bf16": 10, "int8": 9}
PACKED_SCALE_BYTES_PER_TREE = {"f32": 0, "bf16": 0, "int8": 4}

_I16_MAX = np.iinfo(np.int16).max
_U8_MAX = np.iinfo(np.uint8).max


def wire_transfer(ts, perm, wire_dtype: str, f_axis: int = 1):
    """One ring hop of per-shard f32 partial sums ``ts`` (a list, one tensor
    a shard) along ``perm`` in the chosen wire format (the reference's
    ``wire_transfer``):

    * ``"f32"`` — the plain hop (:func:`~..parallel.mesh.ppermute`);
    * ``"bf16"`` — rounded to bf16 (nearest even) on the wire, widened back
      on arrival;
    * ``"int8"`` — ``q = clip(round(t / s), ±127)`` with one f32 scale
      ``s = max|t| * f32(1 / 127)`` per (feature, stat) column (axes ``f_axis`` and
      the last; 1 where the column is all zero); ``q`` and the scales hop,
      the receiver takes ``q * s``.  ``round`` is half-to-even, as
      ``jnp.round``.

    Lossy for bf16 and int8, and re-quantized at every hop, so the error
    grows with the ring's length: only the ring merge modes reach it."""
    from ..parallel.mesh import ppermute

    if wire_dtype == "f32":
        return ppermute(ts, perm)
    if wire_dtype == "bf16":
        return [t.to(torch.float32) for t in ppermute(
            [t.to(torch.bfloat16) for t in ts], perm)]
    if wire_dtype == "int8":
        qs, ss = [], []
        for t in ts:
            red = tuple(i for i in range(t.dim())
                        if i not in (f_axis % t.dim(), t.dim() - 1))
            # XLA's program multiplies by the f32 reciprocal of 127
            s = t.abs().amax(dim=red, keepdim=True) * _INV127
            s = torch.where(s > 0, s, torch.ones_like(s))
            qs.append(torch.clamp(torch.round(t / s), -127, 127).to(
                torch.int8))
            ss.append(s)
        return [q.to(torch.float32) * s for q, s in zip(
            ppermute(qs, perm), ppermute(ss, perm))]
    raise ValueError(
        f"unknown wire dtype {wire_dtype!r}; expected one of {WIRE_DTYPES}")


class ThresholdBoundError(ValueError):
    """A structural forest field does not fit its quantized container
    exactly.  Thresholds/indices are never rounded — this is a hard
    deploy-time error, not a tolerance."""


def bf16_round(values) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    t = torch.from_numpy(np.ascontiguousarray(values, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


@dataclass
class QuantizedForestArrays:
    """Compact host-side node arrays + the audit trail of the shrink.

    ``leaf_q`` is int8 (``precision="int8"``, dequantize as ``leaf_q *
    leaf_scale[tree]``) or f32 ALREADY ROUNDED to bf16-representable
    values (``precision="bf16"`` — stored on device as bf16; keeping the
    host copy in rounded f32 lets the numpy oracle reproduce device
    arithmetic exactly).  ``error_bound`` is the worst-case |quantized −
    original| of ONE raw (unshrunk) tree-sum prediction; multiply by
    shrinkage for the served-margin bound.
    """

    precision: str
    split_feature: np.ndarray        # i16 [T, (K,) M]
    split_bin: np.ndarray            # u8  [T, (K,) M]
    left: np.ndarray                 # i16 [T, (K,) M]
    right: np.ndarray                # i16 [T, (K,) M]
    leaf_q: np.ndarray               # i8 / f32(bf16-rounded) [T, (K,) M]
    is_leaf: np.ndarray              # bool [T, (K,) M]
    leaf_scale: Optional[np.ndarray]  # f32 [T, (K,)] (int8 only)
    error_bound: float
    # categorical subset splits ride through unchanged — already minimal
    # (bool); the byte model covers the numeric traversal arrays
    is_cat_split: Optional[np.ndarray] = None
    cat_mask: Optional[np.ndarray] = None

    def dequantized_leaf_values(self) -> np.ndarray:
        """f32 leaf values as the device arithmetic resolves them — the
        numpy-oracle side of the serving canary's device-vs-oracle drift
        gate, and nothing else: the predict kernel reads ``leaf_q`` in
        storage dtype and applies ``leaf_scale`` once per tree, so this
        f32 table exists only inside the lazily built numpy oracle
        (``PredictorRuntime.oracle``), never in device memory."""
        if self.precision == "int8":
            return (self.leaf_q.astype(np.float32)
                    * self.leaf_scale[..., None])
        return np.asarray(self.leaf_q, np.float32)

    def class_arrays(self, c: Optional[int] = None) -> tuple:
        """Compact traversal arrays for one class, in storage dtypes —
        the plumbing between the quantizer and the predict kernel's
        ``ops.predict.pack_forest_soa`` (which keeps these dtypes
        resident; no widening, no dequantize pass).  ``c=None`` returns
        the binary/regression ``[T, M]`` arrays unchanged; an int
        selects the class plane of ``[T, K, M]`` multiclass arrays.
        Returns ``(split_feature, split_bin, left, right, leaf_q,
        is_leaf, leaf_scale)``."""
        pick = (lambda a: a) if c is None else (lambda a: a[:, c])
        return (pick(self.split_feature), pick(self.split_bin),
                pick(self.left), pick(self.right), pick(self.leaf_q),
                pick(self.is_leaf),
                None if self.leaf_scale is None
                else pick(self.leaf_scale))

    def node_bytes(self) -> int:
        """Resident traversal bytes (node arrays + scale sidecar)."""
        per_node = sum(a.dtype.itemsize for a in (
            self.split_feature, self.split_bin, self.left, self.right,
            self.is_leaf)) + (1 if self.precision == "int8"
                              else 2 if self.precision == "bf16" else 4)
        n_slots = int(np.prod(self.split_feature.shape))
        scale = (self.leaf_scale.size * 4
                 if self.leaf_scale is not None else 0)
        return per_node * n_slots + scale


def _check_exact(name: str, a: np.ndarray, lo: int, hi: int) -> None:
    mn, mx = int(a.min()), int(a.max())
    if mn < lo or mx > hi:
        raise ThresholdBoundError(
            f"{name} range [{mn}, {mx}] does not fit the quantized "
            f"container [{lo}, {hi}] exactly — refusing to round a "
            "structural field")


def quantize_forest(split_feature: np.ndarray, split_bin: np.ndarray,
                    left: np.ndarray, right: np.ndarray,
                    leaf_value: np.ndarray, is_leaf: np.ndarray,
                    precision: str,
                    is_cat_split: Optional[np.ndarray] = None,
                    cat_mask: Optional[np.ndarray] = None
                    ) -> QuantizedForestArrays:
    """Quantize packed node arrays to ``precision`` (bf16 | int8).

    Structural fields are container-narrowed EXACTLY (hard
    :class:`ThresholdBoundError` on overflow — see module docstring):
    ``split_bin`` must fit uint8 (bin codes < 256, the repo-wide
    ``max_bin`` ceiling), node indices and feature ids must fit int16
    (capacity/feature count <= 32767; children use -1 sentinels).  Leaf
    values quantize with one symmetric scale per tree: per-tree rather
    than per-forest for the same measured reason the wire uses
    per-feature scales — late boosting trees are orders of magnitude
    smaller than early ones, and a shared scale washes them out.
    """
    if precision not in ("bf16", "int8"):
        raise ValueError(
            f"quantize_forest precision must be 'bf16' or 'int8', got "
            f"{precision!r} (f32 needs no quantization)")
    split_feature = np.asarray(split_feature)
    split_bin = np.asarray(split_bin)
    left = np.asarray(left)
    right = np.asarray(right)
    leaf_value = np.asarray(leaf_value, np.float32)
    is_leaf = np.asarray(is_leaf, bool)
    _check_exact("split_bin", split_bin, 0, _U8_MAX)
    _check_exact("split_feature", split_feature, -1, _I16_MAX)
    _check_exact("left child index", left, -1, _I16_MAX)
    _check_exact("right child index", right, -1, _I16_MAX)

    if precision == "int8":
        # one symmetric scale per tree (per class for multiclass): only
        # REAL leaf slots set the scale — dead slots carry grower
        # sentinels that would inflate it
        mag = np.max(np.abs(np.where(is_leaf, leaf_value, 0.0)), axis=-1)
        scale = np.where(mag > 0, mag / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(leaf_value / scale[..., None]),
                    -127, 127).astype(np.int8)
        deq = q.astype(np.float32) * scale[..., None]
        leaf_q, leaf_scale = q, scale
    else:
        # round-to-nearest-even bf16 (torch's cast, the same rounding as
        # the reference's XLA cast), held as f32 host-side so the numpy
        # oracle and the device share one arithmetic
        deq = bf16_round(leaf_value)
        leaf_q, leaf_scale = deq, None

    # worst-case raw-margin error: per-tree max leaf error, summed over
    # the tree axis (each tree contributes one leaf per row), maxed over
    # classes — arithmetic, not an estimate
    per_tree = np.max(np.abs(np.where(is_leaf, deq - leaf_value, 0.0)),
                      axis=-1)
    bound = float(np.max(np.sum(per_tree, axis=0)))
    return QuantizedForestArrays(
        precision=precision,
        split_feature=split_feature.astype(np.int16),
        split_bin=split_bin.astype(np.uint8),
        left=left.astype(np.int16),
        right=right.astype(np.int16),
        leaf_q=leaf_q, is_leaf=is_leaf, leaf_scale=leaf_scale,
        error_bound=bound,
        is_cat_split=(None if is_cat_split is None
                      else np.asarray(is_cat_split, bool)),
        cat_mask=(None if cat_mask is None
                  else np.asarray(cat_mask, bool)))


def packed_model_bytes(num_trees: int, capacity: int, num_class: int = 1,
                       precision: str = "f32") -> int:
    """Resident traversal bytes of one packed model at ``precision`` (the
    layout table of :data:`PACKED_NODE_BYTES`)."""
    if precision not in FOREST_PRECISIONS:
        raise ValueError(
            f"precision must be one of {FOREST_PRECISIONS}, got "
            f"{precision!r}")
    slots = int(num_trees) * int(num_class) * int(capacity)
    return (PACKED_NODE_BYTES[precision] * slots
            + PACKED_SCALE_BYTES_PER_TREE[precision]
            * int(num_trees) * int(num_class))


def to_device_tree(q: QuantizedForestArrays,
                   device) -> Tuple["Tree", Optional[torch.Tensor]]:
    """The compact arrays as a ``Tree`` of tensors on ``device``, in their
    storage dtypes (int16 indices, uint8 thresholds, int8/bf16 leaves).

    Returns ``(tree, leaf_scale)``.  This is the legacy layout, used only
    for categorical forests, which the SoA kernel does not take; the
    runtime widens it per dispatch with :func:`widen_tree`."""
    from ..models.tree import Tree

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), device=device,
                               dtype=dtype)

    leaf = (dev(q.leaf_q) if q.precision == "int8"
            else dev(q.leaf_q).to(torch.bfloat16))
    # count/split_gain/num_leaves are dead fields for traversal; one int8
    # cell per tree keeps them out of the byte budget
    lead = q.split_feature.shape[:-1]
    tree = Tree(
        split_feature=dev(q.split_feature),
        split_bin=dev(q.split_bin),
        left=dev(q.left),
        right=dev(q.right),
        leaf_value=leaf,
        is_leaf=dev(q.is_leaf),
        count=torch.zeros(lead + (1,), dtype=torch.int8, device=device),
        split_gain=torch.zeros(lead + (1,), dtype=torch.int8, device=device),
        num_leaves=torch.zeros(lead, dtype=torch.int32, device=device),
        is_cat_split=(None if q.is_cat_split is None
                      else dev(q.is_cat_split)),
        cat_mask=None if q.cat_mask is None else dev(q.cat_mask),
    )
    scale = (None if q.leaf_scale is None
             else dev(q.leaf_scale, torch.float32))
    return tree, scale


def widen_tree(tree, leaf_scale=None):
    """Inverse of :func:`to_device_tree`: a transient i32/f32 copy for the
    traversal, while the compact tensors stay the resident ones."""
    leaf = tree.leaf_value.to(torch.float32)
    if leaf_scale is not None:
        leaf = leaf * leaf_scale[..., None]
    return tree._replace(
        split_feature=tree.split_feature.to(torch.int32),
        split_bin=tree.split_bin.to(torch.int32),
        left=tree.left.to(torch.int32),
        right=tree.right.to(torch.int32),
        leaf_value=leaf,
    )
