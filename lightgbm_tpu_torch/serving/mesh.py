"""The serving mesh: shard the traffic over devices — the port of
``lightgbm_tpu/serving/mesh.py``.

Two routes over a 1-D mesh of the port's ``parallel.mesh`` (its own axis
name, so serving and training meshes never share one):

* **dp — row sharding.**  The forest is resident on every shard and the
  padded bucket's rows split in order over the shards
  (:func:`~..parallel.mesh.row_bounds`); each shard runs the unchanged
  single-route program on its rows on its device, and the outputs
  concatenate in shard order.  No collective and no cross-row arithmetic:
  the forest-predict kernel adds each row's trees once, in tree order,
  whatever launch plan a row count picks, so dp output is bit-identical to
  the single route.
* **tp — tree sharding.**  The forest's tree axis pads to a device multiple
  with inert trees and each shard keeps its slice of ``trees_per_device``
  trees; every shard walks the whole batch over its slice (one
  forest-predict launch per class) and the partial raw margins
  ``psum`` in shard order, shard 0 first; the runtime then applies the
  init score and the learning rate to the sum as the single route applies
  them to its tree sum.  The psum regroups the f32 tree sum, so tp is held
  within a few ulp of the single route, not bit for bit.
  The global staged window ``[0, num_iteration)`` maps into a shard's local
  trees by ``start_iteration = -shard * trees_per_device``
  (:func:`~..ops.predict.tree_window` clips it to the shard's ``[t0,
  t1)``), so truncation lands in the right shard.
* **auto** — :func:`choose_route`, a pure function of (bucket, trees,
  devices), so ``warm()`` and dispatch resolve the same route.

With virtual shards (``parallel.set_virtual_devices``) every shard sits on
one device and every hop is a no-op; between cards a hop is a peer copy.
Device counts are powers of two, as the bucket ladder is, so every dp
bucket divides evenly.
"""

from __future__ import annotations

from typing import List

import torch

from ..parallel.mesh import make_mesh, place_tables, psum, row_bounds

SERVE_AXIS = "serve"
SHARD_POLICIES = ("auto", "dp", "tp")

# auto-route thresholds (see choose_route): buckets at or below the
# ceiling are latency-bound -> tp when the forest is deep enough to split;
# above it, throughput-bound -> dp
TP_BUCKET_CEILING = 64
TP_MIN_TREES_PER_DEVICE = 2

# dp engages only when every shard holds at least this many rows: the
# reference's floor (below it its backend re-tiles the per-row reduction
# and sharding sub-tile buckets loses to the fan-out cost); kept so that
# both packages route every bucket alike
DP_MIN_ROWS_PER_SHARD = 16


class ServingMesh:
    """A 1-D serving mesh over ``devices`` devices (a power of two) of
    ``base``'s platform: :func:`~..parallel.mesh.make_mesh` with its own
    axis name.  ``devices`` is the count, as in the reference; ``mesh``
    holds the ``torch.device`` list."""

    def __init__(self, devices: int, axis_name: str = SERVE_AXIS,
                 base=None):
        devices = int(devices)
        if devices < 1 or (devices & (devices - 1)):
            raise ValueError(
                f"mesh_devices must be a power of two >= 1, got {devices}"
                " (the power-of-two bucket ladder is what guarantees dp"
                " shards divide evenly)")
        self.devices = devices
        self.axis_name = axis_name
        self.mesh = make_mesh(devices, axis_name=axis_name, base=base)

    def __repr__(self) -> str:
        return f"ServingMesh(devices={self.devices})"


def choose_route(policy: str, bucket: int, num_trees: int,
                 n_devices: int) -> str:
    """Deterministic dispatch route for one bucket — ``single`` | ``dp``
    | ``tp`` (the reference's, verbatim; shared by dispatch and
    ``warm()``).

    * ``policy="dp"``: dp whenever every device gets a full
      ``DP_MIN_ROWS_PER_SHARD``-row tile, else single.
    * ``policy="tp"``: tp whenever the forest has a tree per device,
      else single.
    * ``policy="auto"``: tp for small buckets over splittable forests
      (latency route), dp when the bucket feeds every device a full
      tile (throughput route), single otherwise.
    """
    if policy not in SHARD_POLICIES:
        raise ValueError(
            f"shard_policy must be one of {SHARD_POLICIES}, got {policy!r}")
    if n_devices <= 1:
        return "single"
    dp_ok = bucket >= n_devices * DP_MIN_ROWS_PER_SHARD
    if policy == "dp":
        return "dp" if dp_ok else "single"
    if policy == "tp":
        return "tp" if num_trees >= n_devices else "single"
    if (bucket <= TP_BUCKET_CEILING
            and num_trees >= TP_MIN_TREES_PER_DEVICE * n_devices):
        return "tp"
    if dp_ok:
        return "dp"
    return "single"


def dp_shard(smesh: ServingMesh, fns):
    """Row-shard the single-route program: ``fns[d](bins, mask, num_it)``
    is the program over the tables on shard ``d``'s device, run on the
    shard's rows there; the outputs (``[n]`` or ``[n, K]``) concatenate in
    shard order on the batch's device."""
    devices = smesh.mesh.devices

    def sharded(bins, mask, num_it):
        outs = [fn(bins[a:b].to(dev, non_blocking=True),
                   mask[a:b].to(dev, non_blocking=True), num_it)
                for (a, b), dev, fn in zip(row_bounds(bins.shape[0],
                                                      len(devices)),
                                           devices, fns)]
        return torch.cat([o.to(bins.device, non_blocking=True)
                          for o in outs])

    return sharded


def _pad_rows(a: torch.Tensor, pad: int, fill) -> torch.Tensor:
    return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                    dtype=a.dtype, device=a.device)])


def pad_forest_for_tp(forest, leaf_scale, n_devices: int):
    """Pad a stacked ``Tree``'s tree axis to a device multiple with zero
    trees: node 0 self-loops (not a leaf, both children 0) with value 0,
    and the staged window excludes their global indices anyway.
    ``leaf_scale`` pads with 1.0.  Returns ``(forest, leaf_scale,
    trees_per_device)``."""
    t = forest.leaf_value.shape[0]
    t_pad = -(-t // n_devices) * n_devices
    pad = t_pad - t
    if pad:
        forest = type(forest)(*(None if a is None else _pad_rows(a, pad, 0)
                                for a in forest))
        if leaf_scale is not None:
            leaf_scale = _pad_rows(leaf_scale, pad, 1)
    return forest, leaf_scale, t_pad // n_devices


def pad_soa_for_tp(soa, n_devices: int):
    """Pad a ``ForestSoA``'s tree axis to a multiple of (its tree chunk x
    devices), so each shard's slice is itself a legal kernel operand:
    every node of a padded tree self-loops as a zero leaf, scale pads with
    1.0.  Returns ``(soa, trees_per_device)``."""
    from ..ops.predict import soa_tree_chunk

    t, m = soa.split_feature.shape
    mult = soa_tree_chunk(soa) * n_devices
    t_pad = -(-t // mult) * mult
    pad = t_pad - t
    if pad:
        def pad_field(a, name):
            if name in ("left", "right"):
                loop = torch.arange(m, dtype=a.dtype, device=a.device)
                return torch.cat([a, loop.expand(pad, m)])
            fill = 1 if name in ("scale", "is_leaf") else 0
            return _pad_rows(a, pad, fill)

        soa = type(soa)(*(pad_field(a, name)
                          for name, a in zip(soa._fields, soa)))
    return soa, t_pad // n_devices


def shard_soas(smesh: ServingMesh, soas, trees_per_device: int
               ) -> List[list]:
    """Each shard's tree slice of every padded per-class SoA, on the
    shard's device: ``[shard][class]``.  Build these once per deployed
    model and keep them: the kernel's node tables are cached per SoA
    (``kernels/predict.py`` ``node_tables``), so a slice re-made per
    dispatch would rebuild its tables on the host every time."""
    return [[place_tables(s, dev, sl, host=("is_leaf",)) for s in soas]
            for sl, dev in _tree_slices(smesh, trees_per_device)]


def _tree_slices(smesh: ServingMesh, trees_per_device: int):
    """Each shard's ``(tree slice, device)``."""
    return [(slice(d * trees_per_device, (d + 1) * trees_per_device), dev)
            for d, dev in enumerate(smesh.mesh.devices)]


def tp_raw_margins_fused(smesh: ServingMesh, shards, trees_per_device: int,
                         depth_cap: int, num_class: int = 1):
    """Build ``fn(bins, num_it) -> tree sums`` over per-shard SoA slices
    (:func:`shard_soas`): shard ``d`` launches the forest-predict kernel
    once per class over its slice with ``start_iteration = -d *
    trees_per_device``, and the shards' sums ``psum`` in shard order.  The
    output (``[n]`` / ``[n, K]``, before the learning rate and the init
    score) lands on the batch's device."""
    from ..ops.predict import predict_forest

    devices = smesh.mesh.devices

    def fn(bins, num_it):
        parts = []
        for d, (dev, soas_d) in enumerate(zip(devices, shards)):
            b = bins.to(dev, non_blocking=True)
            start = -d * trees_per_device
            cols = [predict_forest(soas_d[c], b, 1.0, 0.0, num_it,
                                   depth_cap, start_iteration=start)
                    for c in range(num_class)]
            parts.append(torch.stack(cols, dim=1) if num_class > 1
                         else cols[0])
        return psum(parts)[0].to(bins.device, non_blocking=True)

    return fn


def shard_forest(smesh: ServingMesh, forest, leaf_scale,
                 trees_per_device: int):
    """Each shard's tree slice of a padded stacked ``Tree`` (and its leaf
    scales) on the shard's device: ``[(tree, scale)]``, built once."""
    return [(place_tables(forest, dev, sl),
             None if leaf_scale is None else leaf_scale[sl].to(dev))
            for sl, dev in _tree_slices(smesh, trees_per_device)]


def tp_raw_margins(smesh: ServingMesh, shards, trees_per_device: int,
                   depth_cap: int, num_class: int = 1, widen: bool = False):
    """The legacy tp route (categorical forests, which the kernel does not
    take): ``fn(bins, num_it) -> tree sums`` over per-shard slices of a
    stacked ``Tree`` (:func:`shard_forest`), each summed by
    ``predict_forest_binned`` with ``start_iteration = -d *
    trees_per_device`` and ``psum``-ed in shard order.  With ``widen`` a
    shard widens its compact slice per dispatch (transient)."""
    from ..ops.predict import map_node_arrays, predict_forest_binned
    from ..ops.quantize import widen_tree

    devices = smesh.mesh.devices

    def fn(bins, num_it):
        parts = []
        for d, (dev, (tree, scale)) in enumerate(zip(devices, shards)):
            b = bins.to(dev, non_blocking=True)
            start = -d * trees_per_device
            if num_class > 1:
                cols = []
                for c in range(num_class):
                    t_c = map_node_arrays(tree, lambda a, c=c: a[:, c])
                    s_c = None if scale is None else scale[:, c]
                    if widen:
                        t_c = widen_tree(t_c, s_c)
                    cols.append(predict_forest_binned(
                        t_c, b, 1.0, 0.0, num_it, depth_cap,
                        start_iteration=start))
                parts.append(torch.stack(cols, dim=1))
            else:
                t_1 = widen_tree(tree, scale) if widen else tree
                parts.append(predict_forest_binned(
                    t_1, b, 1.0, 0.0, num_it, depth_cap,
                    start_iteration=start))
        return psum(parts)[0].to(bins.device, non_blocking=True)

    return fn
