"""Per-tree and per-node feature masks — the port of the mask layer of
``lightgbm_tpu/models/feature_mask.py``.

:func:`compose_tree_mask` is the one tree-level column sampler
(``feature_fraction`` drawn within an optional base mask);
:func:`node_mask_fn` builds the per-node sampler the grower consumes.  This
slice ports the path with ``feature_fraction_bynode`` off, where every node
uses the tree mask; per-node sampling and the EMA feature screener are
refused by the Booster with a named ``NotImplementedError``.
"""

from __future__ import annotations

from ..ops.sampling import sample_feature_mask


def compose_tree_mask(key, fraction, num_features, base_mask=None,
                      device="cpu"):
    """The per-tree column mask: ``feature_fraction`` sampled within
    ``base_mask`` (f32 ``[num_features]``)."""
    return sample_feature_mask(key, fraction, num_features,
                               base_mask=base_mask, device=device)


def node_mask_fn(key, ff_bynode, num_features: int, tree_mask,
                 bynode_off: bool):
    """The per-node column sampler: with bynode sampling off every node
    uses the tree mask."""
    if not bynode_off:
        raise NotImplementedError(
            "feature_fraction_bynode < 1 (per-node column sampling) is not "
            "ported yet: ROADMAP slice 3 (breadth of training)")

    def node_mask(node_id):
        return tree_mask

    return node_mask
