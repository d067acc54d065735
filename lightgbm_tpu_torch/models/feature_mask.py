"""Per-tree and per-node feature masks — the port of the mask layer of
``lightgbm_tpu/models/feature_mask.py``.

:func:`compose_tree_mask` is the one tree-level column sampler
(``feature_fraction`` drawn within an optional base mask);
:func:`node_mask_table` draws every per-node mask of a tree at once
(``feature_fraction_bynode``, drawn within the tree mask), and
:func:`node_mask_fn` is the per-node sampler the growers consume.  The EMA
feature screener is refused by the Booster with a named
``NotImplementedError``.

The reference draws a node's mask inside its grower loop from
``fold_in(key, node_id)``.  The port's growers keep node ids on the device
and read nothing back inside a tree, so the whole table — one row per node
id below the grower's capacity, ``2 * leaves - 1`` — is drawn once per tree
and rows are gathered by node id; row ``i`` equals the reference's draw for
node ``i`` bit for bit.
"""

from __future__ import annotations

import torch

from ..ops.sampling import sample_feature_mask
from ..utils.random import fold_in_tensor, key_tensor, uniform_rows

_F32 = torch.float32


def compose_tree_mask(key, fraction, num_features, base_mask=None,
                      device="cpu"):
    """The per-tree column mask: ``feature_fraction`` sampled within
    ``base_mask`` (f32 ``[num_features]``)."""
    return sample_feature_mask(key, fraction, num_features,
                               base_mask=base_mask, device=device)


def node_mask_table(keys: torch.Tensor, ff_bynode: torch.Tensor,
                    tree_masks: torch.Tensor, capacity: int) -> torch.Tensor:
    """Every node's column mask of ``E`` trees: f32 ``[E, capacity, F]``.

    ``keys`` int64 ``[E, 2]`` are the growers' keys, ``ff_bynode`` f32
    ``[E]`` the per-node fractions and ``tree_masks`` f32 ``[E, F]`` the
    tree masks.  Row ``i`` of element ``e`` is the reference's
    ``sample_feature_mask(fold_in(keys[e], i), ff_bynode[e], F,
    base_mask=tree_masks[e])``: ``max(1, round(fraction * avail))`` of the
    tree mask's features, the ranks of uniform draws picking them; an
    element whose fraction is >= 1 gets its tree mask in every row.  Drawn
    on the masks' device with no host read."""
    dev = tree_masks.device
    e, num_features = tree_masks.shape
    node_ids = torch.arange(int(capacity), dtype=torch.int64, device=dev)
    node_keys = fold_in_tensor(keys.to(dev), node_ids)       # [E, cap, 2]
    r = uniform_rows(node_keys.reshape(-1, 2), num_features).view(
        e, int(capacity), num_features)
    on = (tree_masks > 0)[:, None, :]                        # [E, 1, F]
    frac = ff_bynode.to(device=dev, dtype=_F32)[:, None]     # [E, 1]
    avail = torch.clamp(on.to(_F32).sum(-1), min=1.0)        # [E, 1]
    k = torch.minimum(torch.clamp(torch.round(frac * avail), min=1.0), avail)
    r = torch.where(on, r, torch.full_like(r, 2.0))
    rank = torch.argsort(torch.argsort(r, dim=-1, stable=True), dim=-1,
                         stable=True)
    sampled = (rank.to(_F32) < k[..., None]).to(_F32) * on.to(_F32)
    full = tree_masks.to(_F32)[:, None, :].expand_as(sampled)
    return torch.where((frac >= 1.0)[..., None], full, sampled)


def node_mask_fn(key, ff_bynode, num_features: int, tree_mask,
                 bynode_off: bool, capacity: int = 0):
    """The per-node column sampler of one tree: a function of a node id
    (an int or an int64 tensor of ids below ``capacity``) returning the
    node's mask.  With bynode sampling off every node uses the tree mask;
    else the rows of :func:`node_mask_table` drawn under ``key`` (a pair of
    ints)."""
    mask = tree_mask.to(_F32)
    if bynode_off:
        return lambda node_id: mask

    dev = mask.device
    frac = torch.full((1,), float(ff_bynode), dtype=_F32, device=dev)
    table = node_mask_table(key_tensor([key], dev), frac,
                            mask.reshape(1, num_features), capacity)[0]
    return lambda node_id: table[node_id]
