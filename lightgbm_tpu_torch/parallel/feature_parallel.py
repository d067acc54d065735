"""Feature-parallel training and the split exchange — the port of
``lightgbm_tpu/parallel/feature_parallel.py``.

When the histogram, not the row count, is the bottleneck (wide data, many
bins), ``tree_learner="feature"`` shards the COLUMNS: every shard holds all
rows but only its slice of feature columns, builds histograms and scans
splits for those columns only, with no histogram merge at all.  The
per-shard winners combine by :func:`reduce_best_split` (an all-gather of a
few scalars and a first-occurrence argmax), and the winning column reaches
every shard by :func:`broadcast_feature_column` (the ``[n]`` bitmap
exchange of upstream's design).  The grown tree is replicated by
construction.

The same exchange ends every distributed split scan: the data-parallel
reduce-scatter merges hand each shard a slice of the features and the
voting merge a candidate subset, and their winners combine by the same
rule (``models/tree.py`` :func:`~..models.tree.make_dist_scorer`, which
scans the pieces as one batch).

The round itself is the Booster's round body over a
:class:`~.data_parallel.MeshLayout` whose column axis is sharded (the
reference's ``make_fp_train_step`` and ``make_dp_fp_train_step``); this
module holds the exchange and the column sharding.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.split import BestSplit
from .mesh import Mesh


def reduce_best_split(bss: Sequence[BestSplit], f_local: int,
                      feature_maps: Optional[Sequence[torch.Tensor]] = None
                      ) -> BestSplit:
    """Combine per-shard :class:`~..ops.split.BestSplit` candidates (a list,
    shard order, any common leading shape) into the global winner on shard
    0's device (the reference's ``reduce_best_split``).

    Each shard's ``feature`` is LOCAL to its slice: globalized as
    ``feature + shard * f_local`` for contiguous slices, or through its
    ``feature_maps[shard]`` (int ``[..., f_local]``, local slot -> global
    id: a voting candidate set) — before the gather, so the combine is one
    argmax over ``D`` gains.  Ties go to the lowest shard (first
    occurrence), which under ascending slices is the serial scan's
    lowest-feature tie-break (the rule of the mesh scorer's batched
    combine, :func:`~..models.tree._best_of_pieces`, which this calls)."""
    from ..models.tree import _best_of_pieces

    dev = bss[0].gain.device
    gfeat = []
    for d, bs in enumerate(bss):
        if feature_maps is None:
            gfeat.append(bs.feature + d * int(f_local))
        else:
            fm = feature_maps[d].to(bs.feature.device).to(torch.int64)
            gfeat.append(fm.gather(-1, bs.feature.unsqueeze(-1)).squeeze(-1))
    fields = {}
    for name in BestSplit._fields:
        vals = [getattr(bs, name) for bs in bss]
        fields[name] = (None if vals[0] is None else torch.stack(
            [v.to(dev) for v in vals], dim=-2 if name == "cat_mask" else -1))
    return _best_of_pieces(BestSplit(**fields),
                           torch.stack([g.to(dev) for g in gfeat], dim=-1))


def broadcast_feature_column(bins_blocks: Sequence[torch.Tensor],
                             feat: torch.Tensor, f_local: int
                             ) -> torch.Tensor:
    """The GLOBAL columns ``feat`` (int ``[k]``) under feature sharding:
    only the owning shard has each, so every shard contributes its codes
    where it owns the column and zeros elsewhere, summed in shard order
    (the reference's psum broadcast).  ``bins_blocks`` are one row block's
    column slices ``[n, f_local]``; returns ``[n, k]`` on the first
    block's device."""
    dev = bins_blocks[0].device
    out = None
    for j, bins_j in enumerate(bins_blocks):
        local = feat.to(bins_j.device).to(torch.int64) - j * int(f_local)
        mine = (local >= 0) & (local < f_local)
        col = bins_j.index_select(1, local.clamp(0, f_local - 1))
        part = torch.where(mine[None, :], col,
                           torch.zeros((), dtype=col.dtype,
                                       device=col.device)).to(dev)
        out = part if out is None else out + part
    return out


def pad_features(codes, n_shards: int):
    """Pad the feature axis of ``[n, F]`` codes (numpy or torch) to a shard
    multiple with constant-zero columns (masked out of every scan)."""
    f = codes.shape[1]
    f_pad = -(-f // n_shards) * n_shards
    if f_pad == f:
        return codes
    if isinstance(codes, np.ndarray):
        return np.concatenate(
            [codes, np.zeros((codes.shape[0], f_pad - f), codes.dtype)],
            axis=1)
    return torch.cat([codes, codes.new_zeros((codes.shape[0], f_pad - f))],
                     dim=1)


def shard_features(mesh: Mesh, bins: torch.Tensor) -> List[List[torch.Tensor]]:
    """``[n, F]`` bins over a mesh's ``(data, feature)`` grid: block ``(i,
    j)`` holds row block ``i`` and column block ``j`` (F padded to a shard
    multiple, :func:`pad_features`), contiguous on its device.  Returns
    ``blocks[i][j]``."""
    from .mesh import FEATURE_AXIS, DATA_AXIS, row_bounds

    dr, dc = mesh.axis_size(DATA_AXIS), mesh.axis_size(FEATURE_AXIS)
    padded = pad_features(bins, dc)
    f_loc = padded.shape[1] // dc
    blocks = []
    for i, (a, b) in enumerate(row_bounds(padded.shape[0], dr)):
        blocks.append([padded[a:b, j * f_loc:(j + 1) * f_loc].to(
            mesh.devices[i * dc + j]).contiguous() for j in range(dc)])
    return blocks
