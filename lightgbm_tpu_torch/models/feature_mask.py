"""Per-tree and per-node feature masks — the port of the mask layer of
``lightgbm_tpu/models/feature_mask.py``.

:func:`compose_tree_mask` is the one tree-level column sampler
(``feature_fraction`` drawn within an optional base mask);
:func:`node_mask_table` draws every per-node mask of a tree at once
(``feature_fraction_bynode``, drawn within the tree mask), and
:func:`node_mask_fn` is the per-node sampler the growers consume.

:class:`FeatureScreener` is gain-informed feature screening (EMA-FS,
``feature_screen="ema"``): per-feature gain EWMAs across rounds select a
compacted active set per round, with periodic full refresh rounds for
exactness and cold-feature rediscovery.  Trees of a screened round grow in
compacted ``[0, F_active)`` space and :func:`remap_split_features` gathers
their winner ids back to global feature ids before the tree is stored, so
predict, valid sets and checkpoints never see compacted ids.  The screener
is host numpy on purpose, as the reference's: it reads one tree's realized
split gains a round, and its output is a sorted id vector.

The reference draws a node's mask inside its grower loop from
``fold_in(key, node_id)``.  The port's growers keep node ids on the device
and read nothing back inside a tree, so the whole table — one row per node
id below the grower's capacity, ``2 * leaves - 1`` — is drawn once per tree
and rows are gathered by node id; row ``i`` equals the reference's draw for
node ``i`` bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
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


def active_feature_count(num_features: int, keep_ratio: float) -> int:
    """Size of the screened active set: ``ceil(keep_ratio * F)``, at least
    1."""
    return max(1, int(math.ceil(float(keep_ratio) * int(num_features))))


def remap_split_features(tree, active_ids):
    """Gather a compacted-space tree's winner ids back to GLOBAL feature
    ids; ``-1`` slots (unused node-table rows, leaves) pass through."""
    sf = tree.split_feature
    ids = torch.as_tensor(np.asarray(active_ids), dtype=torch.int32,
                          device=sf.device)
    safe = torch.clamp(sf, 0, ids.shape[0] - 1).to(torch.int64)
    return tree._replace(split_feature=torch.where(sf >= 0, ids[safe], sf))


class FeatureScreener:
    """EMA-FS: per-feature gain EWMAs -> per-round active set (the
    reference's ``FeatureScreener``, host numpy).

    Lifecycle per round: :meth:`plan` returns ``(active_ids, is_refresh)``
    — ``active_ids`` is ``None`` on refresh rounds (grow over the FULL
    feature set: round 0, every ``refresh_rounds`` rounds after, and any
    round before the EWMA has seen a positive gain), otherwise a sorted
    i32 id vector of the ``keep`` hottest features.  After the round,
    :meth:`observe` folds the tree's realized split gains (GLOBAL ids)
    into the EWMA.  Refresh rounds observe too, which is how a feature
    whose gain appears late re-enters the active set.

    State is two host values (the EWMA vector and the rounds-since-refresh
    counter); both ride the checkpoint, so kill-anywhere resume replans
    identical rounds.
    """

    def __init__(self, num_features: int, keep_ratio: float,
                 ema_decay: float, refresh_rounds: int):
        self.num_features = int(num_features)
        self.keep = active_feature_count(num_features, keep_ratio)
        self.ema_decay = float(ema_decay)
        self.refresh_rounds = int(refresh_rounds)
        self.ema = np.zeros(self.num_features, np.float32)
        self.rounds_since_refresh = 0

    @property
    def screening(self) -> bool:
        """Whether compaction can ever trigger (keep < F)."""
        return self.keep < self.num_features

    def plan(self) -> Tuple[Optional[np.ndarray], bool]:
        """Active set for the NEXT round: ``(sorted_ids | None,
        is_refresh)``."""
        if (not self.screening or self.rounds_since_refresh == 0
                or not np.any(self.ema > 0.0)):
            return None, True
        # stable arg-partition by descending EWMA: ties keep the lower
        # feature id, then sort ascending so the compacted layout keeps
        # column order
        hot = np.argsort(-self.ema, kind="stable")[:self.keep]
        return np.sort(hot).astype(np.int32), False

    def observe(self, split_feature: np.ndarray,
                split_gain: np.ndarray) -> None:
        """Fold one tree's realized split gains (global feature ids) into
        the EWMA and advance the refresh counter."""
        sf = np.asarray(split_feature).ravel()
        sg = np.asarray(split_gain, np.float64).ravel()
        gains = np.zeros(self.num_features, np.float64)
        m = (sf >= 0) & (sf < self.num_features)
        np.add.at(gains, sf[m].astype(np.int64), np.maximum(sg[m], 0.0))
        d = self.ema_decay
        self.ema = (d * self.ema + (1.0 - d) * gains).astype(np.float32)
        self.rounds_since_refresh += 1
        if self.rounds_since_refresh >= self.refresh_rounds:
            self.rounds_since_refresh = 0   # next plan() is a refresh

    def state(self) -> Tuple[np.ndarray, int]:
        return self.ema.copy(), int(self.rounds_since_refresh)

    def restore(self, ema: np.ndarray, rounds_since_refresh: int) -> None:
        ema = np.asarray(ema, np.float32)
        if ema.shape != (self.num_features,):
            raise ValueError(
                f"screener EWMA shape {ema.shape} does not match "
                f"num_features={self.num_features}")
        self.ema = ema.copy()
        self.rounds_since_refresh = int(rounds_since_refresh)
