"""Tensorized trees and the wave grower — the port of ``lightgbm_tpu/models/tree.py``.

A tree is a struct of arrays with a static node capacity.  Traversal rule at
internal node i: go left iff ``bin_code[row, split_feature[i]] <=
split_bin[i]`` for numeric splits; for categorical k-vs-rest splits
(``is_cat_split[i]``) go left iff ``cat_mask[i, bin_code[row,
split_feature[i]]]``.  Unused slots have ``is_leaf=False`` and are
unreachable.  Here the fields are torch tensors on one device; a forest
stacks trees on a leading ``[T]`` axis.

Growth: :func:`grow_tree` dispatches on the encoded wave width
(:func:`decode_wave_width`), with per-node column sampling (``ff_bynode``:
each node scored under its row of a mask table drawn once per tree,
:func:`~.feature_mask.node_mask_table`) or without, with monotone
constraints (the basic method's mid-point bounds in the node table's
``BOUND_LO``/``BOUND_HI``), extra-trees (every node's scan positions drawn
once per tree, :func:`rand_bin_table`) and interaction constraints (each
node's surviving groups carried beside the nodes) or without, and with
categorical k-vs-rest subset splits (``cat_info``,
:class:`~..ops.split.CatInfo`) or without.  A categorical candidate keeps
its left-bin set in a mask table ``[capacity, B]`` beside the packed
nodes, the partition sends a row left by its code's bit there, and the
tree's ``is_cat_split``/``cat_mask`` come from that table, as in the
reference:

* widths above 1 grow in waves (:func:`grow_tree_frontier`, the default at
  n >= 4096 rows and num_leaves >= 16), with all three wave tails:
  ``greedy``, ``half`` and ``exact`` (overgrow, then :func:`_exact_prune`).
  Each wave runs kernel B2 (``ops.histogram.hist_partition_fused``), which
  routes the rows and builds the smaller children's histograms in one pass
  (int8 histograms, more than 256 features and categorical splits take the
  reference's unfused route instead: the plain partition, then kernel B1);
  the siblings come from the per-leaf histogram cache by subtraction.
* width 1 is the strict best-first grower (:func:`grow_tree_strict`):
  ``num_leaves - 1`` split iterations, each one histogram pass over both
  children of the split leaf and one call of kernel B3
  (:func:`split_iter`: the gain scan, the argmax, the node-table writes and
  the next pick); with per-node sampling, categorical splits or any
  constraint, the reference's unfused body instead (the same histograms,
  the split scan in plain ops, under a mask per child with per-node
  sampling or interaction constraints, bounds per child with monotone
  constraints).  It grows a batch of ``E`` trees at once over a shared
  binned matrix, which is how fused cross-validation grows configs x folds;
  a Booster grows one (``E = 1``).

:func:`grow_trees_batched` grows a batch of ``E`` trees over a shared binned
matrix (the reference's ``vmap`` of ``grow_tree``: configs x folds of fused
cross-validation, the classes of multiclass): strict at width 1, else in
waves (:func:`grow_tree_frontier_batched`), whose every wave is one
histogram pass for the whole batch, kernel B5 at the default widths.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.histogram import (compute_histograms, compute_histograms_batched,
                             hist_partition_fused, hist_partition_plain,
                             histograms_rows, resolve_mode, route_wave,
                             sr_round_bf16)
from ..ops.split import (CatInfo, SplitContext, constrained_leaf_output,
                         find_best_split, prefix_sum)
from ..utils.random import (fold_in_keys, fold_in_tensor, key_tensor,
                            uniform_rows)
from .feature_mask import node_mask_fn, node_mask_table

_F32 = torch.float32


class Tree(NamedTuple):
    split_feature: torch.Tensor  # i32[M]
    split_bin: torch.Tensor      # i32[M]
    left: torch.Tensor           # i32[M]
    right: torch.Tensor          # i32[M]
    leaf_value: torch.Tensor     # f32[M] (raw, no shrinkage)
    is_leaf: torch.Tensor        # bool[M]
    count: torch.Tensor          # f32[M] rows that reached the node
    split_gain: torch.Tensor     # f32[M] gain of the split at internal nodes
    num_leaves: torch.Tensor     # i32[] leaves actually grown
    # categorical subset splits — None for forests without categoricals
    is_cat_split: Optional[torch.Tensor] = None  # bool[M]
    cat_mask: Optional[torch.Tensor] = None      # bool[M, B] bins going LEFT
    # linear leaves (``linear_tree``) — None for constant-leaf models; a
    # leaf predicts leaf_value[l] + sum_k linear_coef[l, k] *
    # raw[linear_feat[l, k]] (feature -1: an unused slot; NaN reads as 0)
    linear_feat: Optional[torch.Tensor] = None   # i32[M, K] training columns
    linear_coef: Optional[torch.Tensor] = None   # f32[M, K]

    @property
    def capacity(self) -> int:
        return self.split_feature.shape[-1]


class _PK:
    """Column layout of the packed per-node table ``[capacity, NC]`` f32
    (the reference's layout; integer fields are exact in f32)."""

    SPLIT_FEAT = 0    # init -1
    SPLIT_BIN = 1
    LEFT = 2          # init -1
    RIGHT = 3         # init -1
    LEAF_VALUE = 4
    IS_LEAF = 5       # 0/1
    COUNT = 6
    SPLIT_GAIN = 7
    DEPTH = 8
    CAND_GAIN = 9     # init -inf
    CAND_FEAT = 10
    CAND_BIN = 11
    CAND_LG = 12
    CAND_LH = 13
    CAND_LC = 14
    CAND_RG = 15
    CAND_RH = 16
    CAND_RC = 17
    CAND_WL = 18
    CAND_WR = 19
    BOUND_LO = 20     # init -inf
    BOUND_HI = 21     # init +inf
    CAND_CAT = 22     # 0/1: the candidate is a categorical subset split
    PM = 23           # pathmin: min candidate gain over ancestors-or-self
    NC = 24


def _xla_arith(cat_info: Optional[CatInfo],
               mono: Optional[torch.Tensor] = None) -> str:
    """The rounding of the reference's XLA split scan in a grower
    (:mod:`~..ops.split`): ``"cat"`` in a program with categorical columns
    or monotone constraints (XLA contracts the leaf objective of the
    clipped outputs there; found by matching the reference's split gains
    on exact sums), else ``"scan"``."""
    return "scan" if cat_info is None and mono is None else "cat"


def rand_bin_table(keys: torch.Tensor, num_features: int, num_bins: int,
                   col_bins: Optional[torch.Tensor], capacity: int
                   ) -> torch.Tensor:
    """Every node's extra-trees threshold positions for ``E`` trees: int64
    ``[E, capacity, F]``, drawn once per tree on the keys' device with no
    host read.  Row ``i`` of element ``e`` is the reference's
    ``_rand_bins_for_node(keys[e], i, ...)``: ``u = uniform(fold_in(
    fold_in(key, 0x0EF7), i), (F,))``, then ``floor(u * max(hi, 1))`` with
    ``hi`` each column's used bins less one (``col_bins`` int ``[F]``), or
    ``max(num_bins - 1, 1)`` for every column when None; the product is
    rounded to f32 before the floor, as there."""
    dev = keys.device
    e = keys.shape[0]
    node_ids = torch.arange(int(capacity), dtype=torch.int64, device=dev)
    node_keys = fold_in_tensor(fold_in_keys(keys, 0x0EF7), node_ids)
    u = uniform_rows(node_keys.reshape(-1, 2), num_features).view(
        e, int(capacity), num_features)
    if col_bins is None:
        hi = torch.full((num_features,), float(max(num_bins - 1, 1)),
                        dtype=_F32, device=dev)
    else:
        hi = col_bins.to(device=dev, dtype=_F32) - 1.0
    return torch.floor(u * torch.clamp(hi, min=1.0)).to(torch.int64)


def _ic_allowed(group_sets: torch.Tensor, member: torch.Tensor
                ) -> torch.Tensor:
    """Interaction constraints: the columns a node may split on, f32
    ``[..., F]``: the union of the groups its path still fits in
    (``group_sets`` bool ``[..., NG]``) over ``member`` bool ``[NG, F]``,
    as the reference's f32 product compared > 0.5."""
    return ((group_sets.to(_F32) @ member.to(_F32)) > 0.5).to(_F32)


def _mono_child_bounds(mono: Optional[torch.Tensor], feat, wl, wr, lo, hi):
    """The basic method's output bounds of a split's children (the
    reference's ``_mono_child_bounds``): an increasing split caps its left
    side's descendants at the mid-point of the two outputs and floors its
    right side's there, a decreasing one the other way round.  ``feat``,
    ``wl``, ``wr``, ``lo``, ``hi`` share a shape; returns ``(lo_l, hi_l,
    lo_r, hi_r)``."""
    if mono is None:
        return lo, hi, lo, hi
    mval = torch.take(mono.to(feat.device), feat.to(torch.int64))
    mid = 0.5 * (wl + wr)
    hi_l = torch.where(mval > 0, torch.minimum(hi, mid), hi)
    lo_l = torch.where(mval < 0, torch.maximum(lo, mid), lo)
    lo_r = torch.where(mval > 0, torch.maximum(lo, mid), lo)
    hi_r = torch.where(mval < 0, torch.minimum(hi, mid), hi)
    return lo_l, hi_l, lo_r, hi_r


def decode_wave_width(wave_width: int):
    """Decode the wave-width int into (width, tail, overgrow_leaves):
    negative = greedy tail; >= 1024 = exact tail, ``overgrow_leaves * 1024
    + width``; else half (``gbdt.resolve_wave_width``'s encoding)."""
    if wave_width < 0:
        return -wave_width, "greedy", None
    if wave_width >= 1024:
        return wave_width % 1024, "exact", wave_width // 1024
    return wave_width, "half", None


def _empty_packed_table(capacity: int, device) -> torch.Tensor:
    """All-sentinel packed table (no children, no candidate, unbounded)."""
    K = _PK
    nodes = torch.zeros((capacity, K.NC), dtype=_F32, device=device)
    nodes[:, K.SPLIT_FEAT] = -1.0
    nodes[:, K.LEFT] = -1.0
    nodes[:, K.RIGHT] = -1.0
    nodes[:, K.CAND_GAIN] = float("-inf")
    nodes[:, K.BOUND_LO] = float("-inf")
    nodes[:, K.BOUND_HI] = float("inf")
    nodes[:, K.PM] = float("-inf")
    return nodes


def _packed_root_table(capacity, root_out, root_tot, root_best
                       ) -> torch.Tensor:
    """Initial packed table with the root's row set: ``[capacity, NC]``, or
    ``[E, capacity, NC]`` when the root fields carry a leading axis ``[E]``
    (``root_tot [E, 3]``)."""
    K = _PK
    dev = root_out.device
    lead = tuple(root_out.shape)
    cols = [K.SPLIT_FEAT, K.LEFT, K.RIGHT, K.LEAF_VALUE, K.IS_LEAF, K.COUNT,
            K.CAND_GAIN, K.CAND_FEAT, K.CAND_BIN, K.CAND_LG, K.CAND_LH,
            K.CAND_LC, K.CAND_RG, K.CAND_RH, K.CAND_RC, K.CAND_WL, K.CAND_WR,
            K.BOUND_LO, K.BOUND_HI, K.CAND_CAT, K.PM]

    def f(v):
        return torch.as_tensor(v, device=dev).to(_F32).expand(lead)

    vals = [f(-1.0), f(-1.0), f(-1.0), root_out, f(1.0), root_tot[..., 2],
            root_best.gain, f(root_best.feature), f(root_best.bin),
            root_best.left_g, root_best.left_h, root_best.left_c,
            root_best.right_g, root_best.right_h, root_best.right_c,
            root_best.left_out, root_best.right_out, f(float("-inf")),
            f(float("inf")),
            f(0.0) if root_best.cat is None else root_best.cat,
            root_best.gain]
    nodes = _empty_packed_table(capacity, dev).expand(
        lead + (capacity, K.NC)).clone()
    row = nodes[..., 0, :]
    row[..., torch.tensor(cols, device=dev)] = torch.stack(
        [f(v) for v in vals], dim=-1)
    return nodes


class GrownTrees(NamedTuple):
    """What the batched growers return: the packed node tables ``table``
    f32 ``[E, cap, 24]``, ``n_leaves`` i32 ``[E]``, ``row_leaf`` i32 ``[n,
    E]``, and the candidate mask table ``catmask`` bool ``[E, cap, B]``
    (None without categorical columns)."""

    table: torch.Tensor
    n_leaves: torch.Tensor
    row_leaf: torch.Tensor
    catmask: Optional[torch.Tensor] = None


def _tree_from_packed(P: torch.Tensor, n_leaves,
                      cand_catmask: Optional[torch.Tensor] = None) -> Tree:
    """Unpack the packed node table ``[..., cap, NC]`` into the public Tree
    struct (``n_leaves`` an int, or a tensor of the table's leading shape);
    a batch of tables gives a Tree whose fields lead with the batch axes.
    With the candidate mask table ``cand_catmask`` bool ``[..., cap, B]``
    the tree carries ``is_cat_split`` (internal nodes whose split was a
    subset split) and ``cat_mask`` (that table, as the reference's)."""
    K = _PK
    if isinstance(n_leaves, torch.Tensor):
        num_leaves = n_leaves.to(torch.int32).reshape(P.shape[:-2])
    else:
        num_leaves = torch.tensor(int(n_leaves), dtype=torch.int32,
                                  device=P.device)
    return Tree(
        split_feature=P[..., K.SPLIT_FEAT].to(torch.int32),
        split_bin=P[..., K.SPLIT_BIN].to(torch.int32),
        left=P[..., K.LEFT].to(torch.int32),
        right=P[..., K.RIGHT].to(torch.int32),
        leaf_value=P[..., K.LEAF_VALUE].clone(),
        is_leaf=P[..., K.IS_LEAF] > 0.5,
        count=P[..., K.COUNT].clone(),
        split_gain=P[..., K.SPLIT_GAIN].clone(),
        num_leaves=num_leaves,
        is_cat_split=(None if cand_catmask is None else
                      (P[..., K.IS_LEAF] <= 0.5) & (P[..., K.LEFT] >= 0)
                      & (P[..., K.CAND_CAT] > 0.5)),
        cat_mask=None if cand_catmask is None else cand_catmask.clone(),
    )


def grow_tree(bins: torch.Tensor, stats: torch.Tensor,
              feature_mask: torch.Tensor, ctx: SplitContext,
              num_leaves: int, num_bins: int, max_depth: int,
              hist_impl: str = "auto", hist_dtype: str = "f32",
              wave_width: int = 1, ff_bynode: Optional[float] = None,
              key=None, cat_info: Optional[CatInfo] = None,
              mono: Optional[torch.Tensor] = None,
              extra_trees: bool = False,
              col_bins: Optional[torch.Tensor] = None,
              ic_member: Optional[torch.Tensor] = None,
              rows=None, scorer=None) -> Tuple[Tree, torch.Tensor]:
    """Grow one best-first tree; returns ``(tree, row_leaf)``.

    ``bins`` uint8 ``[n, F]``; ``stats`` f32 ``[n, 3]`` of (grad, hess,
    in-bag indicator), already bagging-masked; ``feature_mask`` f32 ``[F]``;
    ``max_depth`` <= 0 means unlimited.  ``wave_width`` carries the wave
    tail in its encoding (see :func:`decode_wave_width`).  Widths above 1
    grow in waves (:func:`grow_tree_frontier`); width 1 is the strict
    best-first grower (:func:`grow_tree_strict` with one element).
    ``ff_bynode`` (None: off) samples each node's columns within the tree
    mask under the grower ``key``, a pair of ints
    (:func:`~.feature_mask.node_mask_table`).  ``cat_info`` (None: no
    categorical columns) gives its columns k-vs-rest subset splits.  The
    constraints, as the reference's: ``mono`` int ``[F]`` monotone signs
    (the basic method: violating candidates rejected, descendants bounded
    at a split's output mid-point); ``extra_trees`` one threshold position
    a column per node, drawn under ``key`` within the column's used bins
    (``col_bins`` int ``[F]``, None: ``num_bins``; :func:`rand_bin_table`);
    ``ic_member`` bool ``[NG, F]`` the interaction groups (a node splits
    only on columns of the groups its path still fits in).  ``key`` None
    is ``PRNGKey(0)``.  On a mesh, ``rows`` and ``scorer`` go to the
    grower (:func:`grow_tree_strict`, :func:`grow_tree_frontier`); the rows
    then carry the shards' statistics, already rounded for ``bf16sr``.
    """
    width, tail, overgrow = _decode_checked(wave_width, num_leaves)
    if hist_dtype == "bf16sr":
        # the statistics rounded once, in the reference's [n, S] layout;
        # the rounding is idempotent, so every histogram of the tree sees
        # them as the reference's B1 and B2 calls do
        if rows is None:
            stats = sr_round_bf16(stats)
        hist_dtype = "bf16"
    key = (0, 0) if key is None else key
    cons = dict(mono=mono, extra_trees=extra_trees, col_bins=col_bins,
                ic_member=ic_member, rows=rows, scorer=scorer)
    if width <= 1:
        dev = bins.device if rows is None else rows.device
        fmask = feature_mask.to(_F32).reshape(1, -1)
        keyed = {}
        if ff_bynode is not None or extra_trees:
            keyed["keys"] = key_tensor([key], dev)
        if ff_bynode is not None:
            keyed["ff_bynode"] = torch.full((1,), float(ff_bynode),
                                            dtype=_F32, device=dev)
        P, n_leaves, row_leaf, catmask = grow_tree_strict(
            bins, None if rows is not None else stats.unsqueeze(1), fmask,
            SplitContext.per_element([ctx], dev),
            torch.tensor([float(max_depth)], dtype=_F32, device=dev),
            num_leaves, num_bins, hist_impl=hist_impl,
            hist_dtype=hist_dtype, batched=False, cat_info=cat_info,
            **keyed, **cons)
        return (_tree_from_packed(P[0], n_leaves[0],
                                  None if catmask is None else catmask[0]),
                row_leaf[:, 0])
    return grow_tree_frontier(bins, stats, feature_mask, ctx, num_leaves,
                              num_bins, max_depth, width,
                              hist_impl=hist_impl, hist_dtype=hist_dtype,
                              wave_tail=tail, overgrow_leaves=overgrow,
                              ff_bynode=ff_bynode, key=key,
                              cat_info=cat_info, **cons)


def _lead_axis(x):
    """A per-node argument with a trailing axis for the pieces a mesh
    scorer scans side by side (None and scalars as they are)."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def _best_of_pieces(bs, gfeat: torch.Tensor):
    """The winner among the pieces on the last axis of ``bs``'s fields
    (each scanned on its own), its feature the GLOBAL id ``gfeat`` (same
    shape): the first occurrence of the largest gain, so ties go to the
    lowest piece — under ascending pieces the serial scan's lowest-feature
    tie-break (:func:`~..parallel.feature_parallel.reduce_best_split`'s
    rule, batched)."""
    best = bs.gain.max(dim=-1, keepdim=True).values
    win = torch.argmax((bs.gain == best).to(torch.uint8), dim=-1,
                       keepdim=True)
    fields = {}
    for name in bs._fields:
        v = gfeat if name == "feature" else getattr(bs, name)
        if v is None:
            fields[name] = None
        elif name == "cat_mask":
            idx = win[..., None].expand(win.shape + (v.shape[-1],))
            fields[name] = v.gather(-2, idx).squeeze(-2)
        else:
            fields[name] = v.gather(-1, win).squeeze(-1)
    return type(bs)(**fields)


def make_dist_scorer(mode: str, n_shards: int, num_features: int,
                     voting_k: int = 0, merge_chunks: int = 1):
    """The split scorer of a mesh's distributed merge (the reference's
    ``_make_dist_scorer``), with :func:`~..ops.split.find_best_split`'s
    signature and GLOBAL per-feature arguments (masks ``[..., F]``,
    ``mono [F]``, ``cat_info``, extra-trees positions ``[..., F]``): the
    scorer slices them to match.

    * ``"reduce_scatter"``, ``"reduce_scatter_ring"`` and
      ``"reduce_scatter_pipelined"`` (and the feature-sharded learners):
      ``hist [..., F_pad, B, 3]`` holds the shards' merged slices side by
      side (slice ``d`` at ``[d * f_loc, (d + 1) * f_loc)``, widths from
      :func:`~..ops.histogram.merge_slice_width`).  Each slice is scanned
      on its own (the pipelined mode in ``merge_chunks`` sub-chunks) and
      the winners combine by a first-occurrence argmax: lowest chunk,
      lowest shard, so the serial scan's tie-break holds.  The slices are
      scanned as one batch (a pieces axis before the features), not one
      call each.  Pad columns carry mask 0, sign 0 and no category.
    * ``"voting"`` (PV-Tree): ``hist [..., D, F, B, 3]`` holds each shard's
      LOCAL partials.  Each shard ranks its features by local gain
      (:func:`~..ops.split.feature_best_gains`) and votes for the ones at
      or above its ``k``-th largest (``k = voting_k``, 20 when 0); the
      global candidates are the top ``2k`` by votes (a stable sort: vote
      ties go to the lower feature id), their columns are reduce-scattered
      (summed in shard order) and each shard scans its share, the winners
      mapped back to global ids.  When ``2k >= F`` the union is exact and
      the candidates keep ascending ids, so the trees match
      reduce-scatter's.  No categorical columns (the ballot scans numeric
      thresholds)."""
    from ..ops.histogram import merge_slice_width
    from ..ops.split import feature_best_gains

    if mode == "voting":
        k_top = max(1, min(int(voting_k) if voting_k else 20, num_features))
        kc = min(2 * k_top, num_features)
        kc_pad = -(-kc // n_shards) * n_shards
        kc_loc = kc_pad // n_shards
        exact_union = kc == num_features

        def score_voting(hist, ctx, feature_mask, depth_ok=None,
                         parent_out=None, lo=None, hi=None, arith=None,
                         cat_info=None, mono=None, rand_bins=None):
            if cat_info is not None:
                raise ValueError(
                    "hist_merge='voting' does not support categorical "
                    "splits (the local ballot scans numeric thresholds "
                    "only) — use 'reduce_scatter' or 'psum'")
            lead = tuple(hist.shape[:-4])
            dev = hist.device
            nb = hist.shape[-2]
            mask = feature_mask.to(dev).expand(lead + (num_features,))
            rb = (None if rand_bins is None else
                  rand_bins.to(dev).expand(lead + (num_features,)))
            node = [_lead_axis(x) for x in (depth_ok, parent_out, lo, hi)]
            if exact_union:
                cand = torch.arange(kc, device=dev).expand(lead + (kc,))
            else:
                # every shard's ballot at once (the shard axis before F)
                g = feature_best_gains(
                    hist, ctx, mask.unsqueeze(-2), node[0], node[1],
                    node[2], node[3], mono,
                    None if rb is None else rb.unsqueeze(-2))  # [..., D, F]
                kth = torch.sort(g, dim=-1, descending=True).values[
                    ..., k_top - 1:k_top]
                ballot = (torch.isfinite(g) & (g >= kth)).to(torch.float32)
                votes = ballot[..., 0, :]
                for d in range(1, n_shards):             # shard order
                    votes = votes + ballot[..., d, :]
                cand = torch.sort(-votes, dim=-1, stable=True).indices[
                    ..., :kc]
            cand_pad = cand
            if kc_pad != kc:
                cand_pad = torch.cat([cand, cand.new_zeros(
                    lead + (kc_pad - kc,))], dim=-1)
            valid = torch.arange(kc_pad, device=dev) < kc
            idx = cand_pad[..., None, :, None, None].expand(
                lead + (n_shards, kc_pad, nb, 3))
            cand_hist = torch.where(valid[:, None, None],
                                    hist.gather(-3, idx), 0.0)
            merged = cand_hist[..., 0, :, :, :]
            for d in range(1, n_shards):                 # shard order
                merged = merged + cand_hist[..., d, :, :, :]
            # shard d's share: candidate slots [d * kc_loc, (d+1) * kc_loc)
            merged = merged.reshape(lead + (n_shards, kc_loc, nb, 3))
            ids = cand_pad.reshape(lead + (n_shards, kc_loc))
            ok = valid.reshape(n_shards, kc_loc)
            m_l = torch.where(ok, mask.gather(-1, cand_pad).reshape(
                lead + (n_shards, kc_loc)), 0.0)
            mono_l = None if mono is None else torch.where(
                ok, mono.to(dev)[ids], 0)
            rb_l = None if rb is None else rb.gather(-1, cand_pad).reshape(
                lead + (n_shards, kc_loc))
            bs = find_best_split(merged, ctx, m_l, node[0], node[1],
                                 node[2], node[3], arith, None, mono_l,
                                 rb_l)                    # [..., D]
            gfeat = ids.gather(-1, bs.feature.unsqueeze(-1)).squeeze(-1)
            return _best_of_pieces(bs, gfeat)

        return score_voting

    chunks = (max(int(merge_chunks), 1)
              if mode == "reduce_scatter_pipelined" else 1)
    f_loc = merge_slice_width(num_features, n_shards, mode, chunks)
    f_pad = f_loc * n_shards
    sub = f_loc // chunks
    n_pieces = n_shards * chunks

    def pad_f(a, value):
        if a is None or a.shape[-1] == f_pad:
            return a
        fill = torch.full(tuple(a.shape[:-1]) + (f_pad - a.shape[-1],),
                          value, dtype=a.dtype, device=a.device)
        return torch.cat([a, fill], dim=-1)

    def score_rs(hist, ctx, feature_mask, depth_ok=None, parent_out=None,
                 lo=None, hi=None, arith=None, cat_info=None, mono=None,
                 rand_bins=None):
        masks = pad_f(feature_mask.to(hist.device), 0.0)
        mono_p = pad_f(mono, 0)
        rand_p = pad_f(rand_bins, 0)
        if hist.shape[-3] != f_pad:
            hist = hist.narrow(-3, 0, min(hist.shape[-3], f_pad))
            if hist.shape[-3] < f_pad:
                shape = list(hist.shape)
                shape[-3] = f_pad - hist.shape[-3]
                hist = torch.cat([hist, hist.new_zeros(shape)], dim=-3)
        lead = tuple(hist.shape[:-3])
        pieces = lead + (n_pieces, sub)
        cat_p = None if cat_info is None else cat_info._replace(
            is_cat=pad_f(cat_info.is_cat.to(hist.device), False).reshape(
                n_pieces, sub))
        bs = find_best_split(
            hist.reshape(pieces + tuple(hist.shape[-2:])), ctx,
            masks.expand(lead + (f_pad,)).reshape(pieces),
            *[_lead_axis(x) for x in (depth_ok, parent_out, lo, hi)],
            arith, cat_p,
            None if mono_p is None else mono_p.reshape(n_pieces, sub),
            None if rand_p is None
            else rand_p.expand(lead + (f_pad,)).reshape(pieces))
        base = torch.arange(n_pieces, device=hist.device) * sub
        return _best_of_pieces(bs, bs.feature + base)

    return score_rs


def _decode_checked(wave_width: int, num_leaves: int):
    """:func:`decode_wave_width`, refusing an exact-tail encoding that
    :func:`~.gbdt.resolve_wave_width` cannot have produced."""
    width, tail, overgrow = decode_wave_width(int(wave_width))
    if tail == "exact" and (width > 512 or overgrow <= num_leaves):
        raise ValueError(
            f"wave_width={wave_width} decodes to exact-tail (width={width}, "
            f"overgrow_leaves={overgrow}) but is not a valid "
            f"resolve_wave_width encoding for num_leaves={num_leaves}; raw "
            "widths must be < 1024 — use gbdt.resolve_wave_width to encode "
            "the exact tail")
    return width, tail, overgrow


def grow_trees_batched(bins: torch.Tensor, stats_t: torch.Tensor,
                       fmask: torch.Tensor, ctx: SplitContext,
                       max_depth: torch.Tensor, num_leaves: int,
                       num_bins: int, wave_width: int,
                       hist_impl: str = "auto", hist_dtype: str = "f32",
                       ff_bynode: Optional[torch.Tensor] = None,
                       keys: Optional[torch.Tensor] = None,
                       cat_info: Optional[CatInfo] = None,
                       mono: Optional[torch.Tensor] = None,
                       extra_trees: bool = False,
                       col_bins: Optional[torch.Tensor] = None,
                       ic_member: Optional[torch.Tensor] = None,
                       rows=None, scorer=None):
    """Grow ``E`` trees at once over the shared ``bins`` (the reference's
    ``vmap`` of :func:`grow_tree`): the strict grower at width 1
    (:func:`grow_tree_strict`), else the batched wave grower
    (:func:`grow_tree_frontier_batched`).  Inputs and outputs as
    :func:`grow_tree_strict`'s (a :class:`GrownTrees`); ``ff_bynode`` f32
    ``[E]`` and ``keys`` int64 ``[E, 2]`` (None: off) sample each node's
    columns; the constraints as :func:`grow_tree`'s, shared by the batch,
    with ``extra_trees`` drawn under each element's key; ``rows`` and
    ``scorer`` as :func:`grow_tree`'s."""
    width, tail, overgrow = _decode_checked(wave_width, num_leaves)
    if hist_dtype == "bf16sr":
        # rounded once in the reference's batched layout [E, n, S]
        if rows is None:
            stats_t = sr_round_bf16(stats_t.transpose(0, 1)).transpose(0, 1)
        hist_dtype = "bf16"
    cons = dict(mono=mono, extra_trees=extra_trees, col_bins=col_bins,
                ic_member=ic_member, rows=rows, scorer=scorer)
    if width <= 1:
        return grow_tree_strict(bins, stats_t, fmask, ctx, max_depth,
                                num_leaves, num_bins, hist_impl=hist_impl,
                                hist_dtype=hist_dtype, ff_bynode=ff_bynode,
                                keys=keys, cat_info=cat_info, **cons)
    return grow_tree_frontier_batched(
        bins, stats_t, fmask, ctx, max_depth, num_leaves, num_bins, width,
        hist_impl=hist_impl, hist_dtype=hist_dtype, wave_tail=tail,
        overgrow_leaves=overgrow, ff_bynode=ff_bynode, keys=keys,
        cat_info=cat_info, **cons)


def split_iter_plain(hist: torch.Tensor, table: torch.Tensor,
                     fmask: torch.Tensor, aux: torch.Tensor,
                     scal: torch.Tensor, arith: Optional[str] = None,
                     cat_info: Optional[CatInfo] = None,
                     catmask: Optional[torch.Tensor] = None,
                     mono: Optional[torch.Tensor] = None,
                     rand_bins: Optional[torch.Tensor] = None,
                     scorer=None):
    """Plain PyTorch version of :func:`split_iter`: one iteration of the
    reference's strict-grower body (``lightgbm_tpu/models/tree.py``, the
    XLA loop body) for each of ``E`` elements, plus the next pick.

    ``hist [E, 2, F, B, 3]`` holds the two children's histograms of the
    leaf ``aux[:, 0]``; ``table [E, cap, 24]`` the packed nodes; ``fmask
    [E, F]``, or ``[E, 2, F]`` for a mask per child (per-node sampling,
    where the reference runs this body in XLA and ``arith="scan"`` takes
    its rounding; the default is kernel B3's); ``aux [E, 8]`` = [leaf,
    feat, thr, active, 0...]; ``scal [E, 16]`` = [l1, l2, min_data,
    min_hess, min_gain, max_delta_step, path_smooth, max_depth, n_nodes,
    0...].  Returns ``(table', aux')``:
    where active, the leaf's row becomes internal and the rows ``n_nodes``
    and ``n_nodes + 1`` receive the children with their candidate splits;
    ``aux'`` picks the next leaf (the lowest index among the maximal
    candidate gains) and stays active while that gain is finite.  With
    ``cat_info`` (the reference's XLA body, never kernel B3's) the children
    take categorical subset candidates too, and their left-bin sets go into
    the candidate mask table ``catmask`` bool ``[E, cap, B]``; the result is
    then ``(table', aux', catmask')``.  With ``mono`` int ``[F]`` (the
    reference's XLA body too) each child is scored, and written, under its
    own bounds from the split's mid-point (:func:`_mono_child_bounds`), and
    candidates run against a column's sign are rejected; ``rand_bins`` int
    ``[E, 2, F]`` are the children's extra-trees scan positions.
    ``scorer`` (None: :func:`~..ops.split.find_best_split`) scores the
    children from a mesh merge's histograms (:func:`make_dist_scorer`).
    """
    K = _PK
    e, cap, nc = table.shape
    dev = table.device
    ar = torch.arange(e, device=dev)
    leaf = aux[:, 0].to(torch.int64)
    active = aux[:, 3] > 0
    row = table[ar, leaf]                                     # [E, NC]
    ctx = SplitContext(*(scal[:, i] for i in range(7)))
    md = scal[:, 7]
    n_nodes = scal[:, 8].to(torch.int64)
    child_depth = row[:, K.DEPTH] + 1.0
    depth_ok = (md <= 0) | (child_depth < md)

    def two(a, b=None):
        return torch.stack([a, a if b is None else b], dim=1)

    lo_l, hi_l, lo_r, hi_r = _mono_child_bounds(
        mono, row[:, K.CAND_FEAT], row[:, K.CAND_WL], row[:, K.CAND_WR],
        row[:, K.BOUND_LO], row[:, K.BOUND_HI])
    child_masks = fmask if fmask.dim() == 3 else fmask[:, None, :]
    bs = (scorer or find_best_split)(
                         hist, ctx, child_masks, two(depth_ok),
                         two(row[:, K.CAND_WL], row[:, K.CAND_WR]),
                         two(lo_l, lo_r), two(hi_l, hi_r),
                         arith=arith, cat_info=cat_info, mono=mono,
                         rand_bins=rand_bins)
    # the reference kernel gathers the winner's statistics as a sum over
    # every cell of where(hit, x, 0.0), which turns -0.0 into +0.0
    bs = bs._replace(**{f: getattr(bs, f) + 0.0 for f in (
        "left_g", "left_h", "left_c", "right_g", "right_h", "right_c",
        "left_out", "right_out")})
    leaf_row = row.clone()
    leaf_row[:, K.SPLIT_FEAT] = row[:, K.CAND_FEAT]
    leaf_row[:, K.SPLIT_BIN] = row[:, K.CAND_BIN]
    leaf_row[:, K.LEFT] = n_nodes.to(_F32)
    leaf_row[:, K.RIGHT] = (n_nodes + 1).to(_F32)
    leaf_row[:, K.IS_LEAF] = 0.0
    leaf_row[:, K.SPLIT_GAIN] = row[:, K.CAND_GAIN]
    full = torch.full((e, 2), -1.0, dtype=_F32, device=dev)
    zero = torch.zeros((e, 2), dtype=_F32, device=dev)
    child_rows = torch.stack([
        full, zero, full, full,                               # FEAT BIN L R
        two(row[:, K.CAND_WL], row[:, K.CAND_WR]),            # LEAF_VALUE
        torch.ones((e, 2), dtype=_F32, device=dev),           # IS_LEAF
        two(row[:, K.CAND_LC], row[:, K.CAND_RC]),            # COUNT
        zero, two(child_depth),                               # GAIN, DEPTH
        bs.gain, bs.feature.to(_F32), bs.bin.to(_F32),
        bs.left_g, bs.left_h, bs.left_c,
        bs.right_g, bs.right_h, bs.right_c,
        bs.left_out, bs.right_out,                            # CAND_WL, WR
        two(lo_l, lo_r), two(hi_l, hi_r),                     # BOUNDS
        zero if bs.cat is None else bs.cat.to(_F32),          # CAND_CAT
        torch.minimum(two(row[:, K.PM]), bs.gain),            # PM
    ], dim=-1)                                                # [E, 2, NC]
    new_rows = torch.cat([leaf_row[:, None], child_rows], dim=1)
    idx = torch.stack([leaf, n_nodes, n_nodes + 1], dim=1).clamp(max=cap - 1)
    idx3 = idx[..., None].expand(e, 3, nc)
    rows = torch.where(active[:, None, None], new_rows, table.gather(1, idx3))
    out = table.clone().scatter_(1, idx3, rows)

    gains = torch.where(out[:, :, K.IS_LEAF] > 0.5, out[:, :, K.CAND_GAIN],
                        torch.full_like(out[:, :, K.CAND_GAIN],
                                        float("-inf")))
    best = gains.max(dim=1).values
    leaf_n = torch.argmax((gains == best[:, None]).to(torch.uint8), dim=1)
    sel = out[ar, leaf_n]
    active_n = (active & torch.isfinite(best)).to(_F32)
    z = torch.zeros(e, dtype=_F32, device=dev)
    aux_n = torch.stack([leaf_n.to(_F32), sel[:, K.CAND_FEAT],
                         sel[:, K.CAND_BIN], active_n, z, z, z, z], dim=1)
    if cat_info is None:
        return out, aux_n
    kids = idx[:, 1:, None].expand(e, 2, catmask.shape[-1])
    masks = torch.where(active[:, None, None], bs.cat_mask,
                        catmask.gather(1, kids))
    return out, aux_n, catmask.clone().scatter_(1, kids, masks)



def split_iter(hist, table, fmask, aux, scal, impl: str = "auto"):
    """One strict split iteration (see :func:`split_iter_plain`): kernel B3
    on CUDA tensors, its plain version on CPU tensors or when ``impl`` is
    ``"plain"``.  The kernel writes the three changed rows into ``table``
    in place and returns it; the plain version returns a new table.  A
    caller drops its input table either way."""
    if impl in ("plain", "jnp") or hist.device.type == "cpu":
        return split_iter_plain(hist, table, fmask, aux, scal)
    from ..kernels.split_iter import split_iter as launch

    return launch(hist, table, fmask, aux, scal)


def _strict_root(root_hist: torch.Tensor, ctx: SplitContext,
                 root_mask: torch.Tensor, max_depth: torch.Tensor, cap: int,
                 scorer=None, root_tot: Optional[torch.Tensor] = None,
                 **split_kw):
    """The strict grower's root from its histograms ``[E, F, B, 3]``:
    ``(packed table [E, cap, NC], aux [E, 8], scal [E, 16], root split)``
    — the root's output and candidate, the first pick and the split
    iteration's scalars (``ctx`` per element, ``max_depth`` f32 ``[E]``).
    ``split_kw`` goes to :func:`~..ops.split.find_best_split`, or to
    ``scorer`` (a mesh's split scorer, :func:`make_dist_scorer`, whose
    histograms are a merge's slices and whose root totals ``root_tot [E,
    3]`` come from the rows)."""
    e = root_hist.shape[0]
    dev = root_hist.device
    if root_tot is None:
        root_tot = root_hist[:, 0].sum(dim=1)                 # [E, 3]
    zero_e = torch.zeros(e, dtype=_F32, device=dev)
    root_out = constrained_leaf_output(
        root_tot[:, 0], root_tot[:, 1], root_tot[:, 2],
        ctx._replace(path_smooth=zero_e), float("-inf"), float("inf"),
        zero_e)
    root_best = (scorer or find_best_split)(root_hist, ctx, root_mask, None,
                                            root_out, **split_kw)
    P = _packed_root_table(cap, root_out, root_tot, root_best)
    aux = torch.stack([zero_e, root_best.feature.to(_F32),
                       root_best.bin.to(_F32),
                       torch.isfinite(root_best.gain).to(_F32),
                       zero_e, zero_e, zero_e, zero_e], dim=1)
    scal = torch.zeros((e, 16), dtype=_F32, device=dev)
    for i, v in enumerate(ctx):
        scal[:, i] = v
    scal[:, 7] = max_depth.to(_F32)
    scal[:, 8] = 1.0                                          # n_nodes
    return P, aux, scal, root_best


def _strict_partition(bins: torch.Tensor, row_leaf: torch.Tensor,
                      aux: torch.Tensor, scal: torch.Tensor,
                      catmask: Optional[torch.Tensor] = None,
                      P: Optional[torch.Tensor] = None):
    """One strict split iteration's row partition (plain ops, as XLA ops in
    the reference): the rows of the leaf ``aux[:, 0]`` go to the children
    ``n_nodes`` (left iff code <= threshold, or by the code's bit in the
    leaf's candidate mask for a subset split) and ``n_nodes + 1``.
    ``row_leaf`` i32 ``[n, E]``; returns ``(row_leaf', seg i32 [n, E])``
    with segment 0 / 1 for the left / right child's rows and 2 for the
    rest."""
    leaf = aux[:, 0].to(torch.int32)
    thr = aux[:, 2].to(torch.int32)
    grew = aux[:, 3] > 0
    nl = scal[:, 8].to(torch.int32)
    col = bins.index_select(1, aux[:, 1].to(torch.int64))     # [n, E]
    go_left = col.to(torch.int32) <= thr
    if catmask is not None:
        ar = torch.arange(aux.shape[0], device=aux.device)
        leaf64 = leaf.to(torch.int64)
        bit = catmask[ar, leaf64].t().gather(0, col.to(torch.int64))
        go_left = torch.where(P[ar, leaf64, _PK.CAND_CAT] > 0.5, bit,
                              go_left)
    moved = torch.where(row_leaf == leaf,
                        torch.where(go_left, nl, nl + 1), row_leaf)
    row_leaf = torch.where(grew, moved, row_leaf)
    seg = torch.where(row_leaf == nl, 0,
                      torch.where(row_leaf == nl + 1, 1, 2)).to(torch.int32)
    return row_leaf, seg


class StrictRows:
    """The strict grower's row work on one device: the partition of the
    split leaf's rows and the children's histograms from one pass (kernel
    B6 for a batch, B1 with two segments for one tree).  A mesh supplies
    its own (``parallel.data_parallel.MeshStrictRows``) with the same
    methods."""

    fuse_split = True

    def __init__(self, bins: torch.Tensor, stats_t: torch.Tensor,
                 num_bins: int, hist_impl: str, hist_dtype: str,
                 batched: bool):
        self.bins, self.stats_t = bins, stats_t
        self.n, self.e, _ = stats_t.shape
        self.num_features = bins.shape[1]
        self.device = bins.device
        self.num_bins, self.hist_impl = num_bins, hist_impl
        self.hist_dtype, self.batched = hist_dtype, batched
        self.row_leaf = torch.zeros((self.n, self.e), dtype=torch.int32,
                                    device=self.device)

    def hist(self, seg_t, k):
        if self.batched:
            return histograms_rows(self.bins, self.stats_t, seg_t, k,
                                   self.num_bins, impl=self.hist_impl,
                                   hist_dtype=self.hist_dtype)
        seg = (torch.zeros(self.n, dtype=torch.int32, device=self.device)
               if seg_t is None else seg_t[:, 0])
        return compute_histograms(self.bins, self.stats_t[:, 0], seg, k,
                                  self.num_bins, impl=self.hist_impl,
                                  hist_dtype=self.hist_dtype).unsqueeze(0)

    def root(self) -> torch.Tensor:
        """The roots' histograms ``[E, F, B, 3]``."""
        return self.hist(None, 1)[:, 0]

    def total(self) -> torch.Tensor:
        """The roots' (g, h, count) totals ``[E, 3]``."""
        return self.stats_t.sum(dim=0)

    def strict(self, aux, scal, catmask, P) -> torch.Tensor:
        """One split iteration's rows: partition, then both children's
        histograms ``[E, 2, F, B, 3]``."""
        self.row_leaf, seg = _strict_partition(self.bins, self.row_leaf, aux,
                                               scal, catmask, P)
        return self.hist(seg, 2)


def grow_tree_strict(bins: torch.Tensor, stats_t: torch.Tensor,
                     fmask: torch.Tensor, ctx: SplitContext,
                     max_depth: torch.Tensor, num_leaves: int, num_bins: int,
                     hist_impl: str = "auto", hist_dtype: str = "f32",
                     batched: bool = True,
                     ff_bynode: Optional[torch.Tensor] = None,
                     keys: Optional[torch.Tensor] = None,
                     cat_info: Optional[CatInfo] = None,
                     mono: Optional[torch.Tensor] = None,
                     extra_trees: bool = False,
                     col_bins: Optional[torch.Tensor] = None,
                     ic_member: Optional[torch.Tensor] = None,
                     rows=None, scorer=None):
    """Strict best-first growth of ``E`` trees at once (the reference's
    strict grower, ``vmap``ped over E in fused CV).

    ``bins`` u8 ``[n, F]`` is shared; ``stats_t`` f32 ``[n, E, 3]`` holds
    each element's (grad, hess, in-bag) rows, already bagging-masked (held-
    out rows carry zeros but are partitioned all the same); ``fmask`` f32
    ``[E, F]``; ``ctx`` per-element regularizers ``[E]``; ``max_depth`` f32
    ``[E]`` (<= 0: unlimited).  Runs ``num_leaves - 1`` iterations with the
    per-element ``active`` flags on the device: nothing is read back to the
    host inside a tree.  Histograms of both children come from one pass over
    the rows: kernel B6 for the batch (``batched``), kernel B1 with two
    segments for a single tree (``batched=False``, ``E = 1``), as the
    reference's batched and unbatched calls do.

    The reference's eligibility rule for its split-iteration kernel
    (``fuse_si``, restricted to what the port grows) picks the body: with
    per-node sampling off, no categorical columns and no constraint each
    iteration is one launch of kernel B3 (:func:`split_iter`); otherwise
    the reference's XLA body runs in plain ops (:func:`split_iter_plain` at
    its rounding, :func:`_xla_arith`).  The constraints are
    :func:`grow_tree`'s: ``mono`` bounds each child at its split's
    mid-point, ``extra_trees`` scores each node at the positions of its row
    of :func:`rand_bin_table` (drawn once per tree under ``keys``), and
    ``ic_member`` carries each node's surviving interaction groups in a
    table ``[E, cap, NG]`` beside the nodes, a child's mask the product of
    its column mask and :func:`_ic_allowed`.  With per-node sampling
    (``ff_bynode`` f32 ``[E]`` and the grower ``keys`` int64 ``[E, 2]``)
    each child is scored under
    its own node mask, a row of :func:`~.feature_mask.node_mask_table`
    drawn once per tree.  With ``cat_info`` the children take categorical
    subset candidates, whose left-bin sets live in a mask table bool ``[E,
    cap, B]``, and the partition sends a row of a subset split left by its
    code's bit there.

    Returns a :class:`GrownTrees`: ``(table f32 [E, cap, 24], n_leaves
    i32 [E], row_leaf i32 [n, E], catmask)``, the mask table None without
    ``cat_info``.

    On a mesh, ``rows`` (None: :class:`StrictRows` over ``bins`` and
    ``stats_t``) does the row work per shard and hands back merged
    histograms, and ``scorer`` (None: :func:`~..ops.split.find_best_split`)
    scores them when the merge leaves slices or local partials
    (:func:`make_dist_scorer`); the root totals then come from the rows and
    B3 does not run (the reference's ``fuse_si`` excludes ``dist_mode``).
    """
    if rows is None:
        rows = StrictRows(bins, stats_t, num_bins, hist_impl, hist_dtype,
                          batched)
    e = rows.e
    dev = rows.device
    cap = 2 * num_leaves - 1
    fuse_si = (ff_bynode is None and cat_info is None and mono is None
               and not extra_trees and ic_member is None
               and scorer is None and rows.fuse_split)
    fmask = fmask.to(_F32).contiguous()
    node_masks = (None if ff_bynode is None
                  else node_mask_table(keys, ff_bynode, fmask, cap))
    rand = (rand_bin_table(keys, rows.num_features, num_bins, col_bins, cap)
            if extra_trees else None)                         # [E, cap, F]
    if not batched and e != 1:
        raise ValueError("the unbatched strict grower grows one tree")

    # ---- root ---------------------------------------------------------
    root_hist = rows.root()                                   # [E, F, B, 3]
    root_mask = fmask if node_masks is None else node_masks[:, 0]
    icsets = None
    if ic_member is not None:
        # every group survives at the root
        member = ic_member.to(dev)
        icsets = torch.zeros((e, cap, member.shape[0]), dtype=torch.bool,
                             device=dev)
        icsets[:, 0] = True
        root_mask = root_mask * _ic_allowed(icsets[:, 0], member)
    P, aux, scal, root_best = _strict_root(
        root_hist, ctx, root_mask, max_depth, cap, scorer=scorer,
        root_tot=None if scorer is None else rows.total(),
        arith=_xla_arith(cat_info, mono), cat_info=cat_info, mono=mono,
        rand_bins=None if rand is None else rand[:, 0])
    ar = torch.arange(e, device=dev)
    catmask = None
    if cat_info is not None:
        catmask = torch.zeros((e, cap, num_bins), dtype=torch.bool,
                              device=dev)
        catmask[:, 0] = root_best.cat_mask
    n_leaves = torch.ones(e, dtype=torch.int32, device=dev)

    for _ in range(num_leaves - 1):
        leaf = aux[:, 0].to(torch.int32)
        grew = aux[:, 3] > 0
        nl = scal[:, 8].to(torch.int32)
        hist2 = rows.strict(aux, scal, catmask, P)           # [E, 2, F, B, 3]
        if fuse_si:
            P, aux = split_iter(hist2, P, fmask, aux, scal, impl=hist_impl)
        else:
            kids = torch.stack([nl, nl + 1], dim=1).clamp(
                max=cap - 1).to(torch.int64)                  # [E, 2]
            child_masks = fmask
            if node_masks is not None:
                child_masks = node_masks.gather(1, kids[..., None].expand(
                    e, 2, node_masks.shape[-1]))
            if icsets is not None:
                # the children keep the split leaf's groups that hold its
                # split column
                child_sets = icsets[ar, leaf.to(torch.int64)] & \
                    member.t()[aux[:, 1].to(torch.int64)]     # [E, NG]
                allowed = _ic_allowed(child_sets, member)     # [E, F]
                child_masks = (child_masks if child_masks.dim() == 3 else
                               child_masks[:, None, :]) * allowed[:, None]
                for j in range(2):
                    icsets[ar, kids[:, j]] = torch.where(
                        grew[:, None], child_sets, icsets[ar, kids[:, j]])
            out = split_iter_plain(
                hist2, P, child_masks, aux, scal,
                arith=_xla_arith(cat_info, mono), cat_info=cat_info,
                catmask=catmask, mono=mono,
                rand_bins=None if rand is None else rand.gather(
                    1, kids[..., None].expand(e, 2, rand.shape[-1])),
                scorer=scorer)
            P, aux = out[:2]
            if catmask is not None:
                catmask = out[2]
        scal[:, 8] += 2.0 * grew.to(_F32)
        n_leaves += grew.to(torch.int32)
    return GrownTrees(P, n_leaves, rows.row_leaf, catmask)



def wave_fuses_partition(num_features: int, w_width: int, num_bins: int,
                         hist_dtype: str, categorical: bool = False) -> bool:
    """Whether a wave routes its rows and builds its histograms in one
    kernel (B2): the reference's ``fuse_part`` condition.  Categorical
    splits (B2 routes by threshold only), int8 histograms (B2 has no
    quantized mode) and shapes past its exact-bf16 table lookup, ``max(F,
    2 * width, B) > 256``, take the unfused route."""
    return (not categorical and hist_dtype != "int8"
            and max(num_features, 2 * w_width, num_bins) <= 256)


class WavePlan(NamedTuple):
    """One wave's splits, chosen from the packed table (:func:`_wave_plan`):
    ``s`` splits of the leaves ``parent_r`` (their rows ``prow``), each
    histogramming its smaller ("direct") child, the children at node ids
    ``nl_r`` / ``nr_r``; ``gains`` the leaves' candidate gains; and
    ``route_args`` the routing inputs after the row vectors (slot of each
    node, split feature, threshold, direct-left flag, ``n_nodes``)."""

    s: int
    parent_r: torch.Tensor
    prow: torch.Tensor
    direct_left: torch.Tensor
    nl_r: torch.Tensor
    nr_r: torch.Tensor
    gains: torch.Tensor
    route_args: tuple


def _wave_root(root_hist: torch.Tensor, ctx: SplitContext,
               root_mask: torch.Tensor, capacity: int, scorer=None,
               root_tot: Optional[torch.Tensor] = None, **split_kw):
    """The wave grower's root from its histogram ``[F, B, 3]``: ``(packed
    table [capacity, NC], root split)``; ``split_kw`` goes to
    :func:`~..ops.split.find_best_split`, or to a mesh's ``scorer`` with
    the root totals ``root_tot [3]`` from the rows."""
    dev = root_hist.device
    if root_tot is None:
        root_tot = root_hist[0].sum(dim=0)                    # (g, h, c)
    root_out = constrained_leaf_output(
        root_tot[0], root_tot[1], root_tot[2], ctx._replace(path_smooth=0.0),
        float("-inf"), float("inf"), torch.zeros((), dtype=_F32, device=dev))
    root_best = (scorer or find_best_split)(
        root_hist, ctx, root_mask,
        torch.ones((), dtype=torch.bool, device=dev), root_out, **split_kw)
    return _packed_root_table(capacity, root_out, root_tot,
                              root_best), root_best


def _wave_cache(root_hist: torch.Tensor, grow_leaves: int, capacity: int):
    """The per-leaf histogram cache ``[grow_leaves, F, B, 3]`` holding the
    root's, and every node's cache slot (the root's, 0)."""
    dev = root_hist.device
    hist_cache = torch.zeros((grow_leaves,) + tuple(root_hist.shape),
                             dtype=_F32, device=dev)
    hist_cache[0] = root_hist
    return hist_cache, torch.zeros(capacity, dtype=torch.int64, device=dev)


def _wave_plan(P: torch.Tensor, n_nodes: int, n_leaves: int,
               grow_leaves: int, w_width: int,
               wave_tail: str) -> Optional[WavePlan]:
    """The next wave's splits (None when no leaf has a finite candidate
    gain): the top leaves by candidate gain (by pathmin in the exact
    tail), as many as the tail's budget and the width allow.  Reads one
    number on the host, the wave's sync."""
    K = _PK
    dev = P.device
    capacity = P.shape[0]
    neg_inf = torch.tensor(float("-inf"), dtype=_F32, device=dev)
    is_leaf = P[:, K.IS_LEAF] > 0.5
    gains = torch.where(is_leaf, P[:, K.CAND_GAIN], neg_inf)
    n_cand = int(torch.isfinite(gains).sum())             # the wave's sync
    if n_cand == 0:
        return None
    sel_key = (torch.where(is_leaf, P[:, K.PM], neg_inf)
               if wave_tail == "exact" else gains)
    order = torch.argsort(-sel_key, stable=True)
    budget = grow_leaves - n_leaves
    alloc = max(1, budget // 2) if wave_tail == "half" else budget
    s = min(n_cand, alloc, w_width)                       # splits this wave
    iota_s = torch.arange(s, device=dev)
    parent_r = order[:s]
    prow = P[parent_r]                                    # [s, NC]
    direct_left = prow[:, K.CAND_LC] <= prow[:, K.CAND_RC]
    nl_r = n_nodes + 2 * iota_s
    slot_of_node = torch.full((capacity,), -1, dtype=torch.int32,
                              device=dev)
    slot_of_node[parent_r] = iota_s.to(torch.int32)
    route_args = (slot_of_node, prow[:, K.CAND_FEAT].to(torch.int32),
                  prow[:, K.CAND_BIN].to(torch.int32),
                  direct_left.to(torch.uint8), n_nodes)
    return WavePlan(s, parent_r, prow, direct_left, nl_r, nl_r + 1, gains,
                    route_args)


def _wave_commit(plan: WavePlan, direct_hist: torch.Tensor, P: torch.Tensor,
                 hist_cache: torch.Tensor, node_slot: torch.Tensor,
                 n_leaves: int, ctx: SplitContext, max_depth: int,
                 node_mask, mono=None, icsets=None, member=None, rand=None,
                 cat_info: Optional[CatInfo] = None,
                 catmask: Optional[torch.Tensor] = None,
                 scorer=None, num_features: Optional[int] = None):
    """A wave's table work once its direct children's histograms ``[s, F,
    B, 3]`` are in: the siblings by subtraction from the per-leaf cache,
    the 2s fresh children scored (under ``node_mask``, the monotone bounds,
    the interaction groups and the extra-trees positions where given) and
    the packed table, cache, slots and masks updated in place.  On a mesh
    the histograms are a merge's representation (slices or local partials,
    ``num_features`` the global F) and ``scorer`` scores them.  Returns
    ``(n_nodes, n_leaves)`` after the wave."""
    K = _PK
    s, parent_r, prow = plan.s, plan.parent_r, plan.prow
    nl_r, nr_r = plan.nl_r, plan.nr_r
    dev = P.device
    if num_features is None:
        num_features = hist_cache.shape[1]
    iota_s = torch.arange(s, device=dev)

    # siblings by subtraction from the per-leaf histogram cache (plain
    # gathers and writes: exact, as the reference's one-hot matmuls)
    parent_slot = node_slot[parent_r]
    other_hist = hist_cache[parent_slot] - direct_hist
    dl = plan.direct_left.view((s,) + (1,) * (direct_hist.dim() - 1))
    left_hist = torch.where(dl, direct_hist, other_hist)
    right_hist = torch.where(dl, other_hist, direct_hist)
    right_slot = n_leaves + iota_s
    hist_cache[parent_slot] = left_hist
    hist_cache[right_slot] = right_hist
    node_slot[nl_r] = parent_slot
    node_slot[nr_r] = right_slot

    # score the 2s fresh children from their histograms
    child_nodes = torch.cat([nl_r, nr_r])
    child_hists = torch.cat([left_hist, right_hist])
    child_depth1 = prow[:, K.DEPTH] + 1.0
    child_depth = torch.cat([child_depth1, child_depth1])
    if max_depth <= 0:
        depth_ok = torch.ones_like(child_depth, dtype=torch.bool)
    else:
        depth_ok = child_depth < float(max_depth)
    child_vals = torch.cat([prow[:, K.CAND_WL], prow[:, K.CAND_WR]])
    child_masks = node_mask(child_nodes).expand(2 * s, num_features)
    pf = prow[:, K.CAND_FEAT].to(torch.int64)
    lo_l, hi_l, lo_r, hi_r = _mono_child_bounds(
        mono, pf, prow[:, K.CAND_WL], prow[:, K.CAND_WR],
        prow[:, K.BOUND_LO], prow[:, K.BOUND_HI])
    child_lo = torch.cat([lo_l, lo_r])
    child_hi = torch.cat([hi_l, hi_r])
    if icsets is not None:
        child_sets = icsets[parent_r] & member.t()[pf]        # [s, NG]
        allowed = _ic_allowed(child_sets, member)             # [s, F]
        child_masks = child_masks * torch.cat([allowed, allowed])
        icsets[child_nodes] = torch.cat([child_sets, child_sets])
    # without monotone constraints every bound is infinite: the scan keeps
    # its scalar clip (fewer ops a wave)
    bounded = mono is not None
    bs = (scorer or find_best_split)(
        child_hists, ctx, child_masks, depth_ok, child_vals,
        child_lo if bounded else None, child_hi if bounded else None,
        arith=_xla_arith(cat_info, mono), cat_info=cat_info, mono=mono,
        rand_bins=None if rand is None else rand[child_nodes])

    # commit: the parents become internal, the children arrive with their
    # candidate splits
    parent_rows = prow.clone()
    parent_rows[:, K.SPLIT_FEAT] = prow[:, K.CAND_FEAT]
    parent_rows[:, K.SPLIT_BIN] = prow[:, K.CAND_BIN]
    parent_rows[:, K.LEFT] = nl_r.to(_F32)
    parent_rows[:, K.RIGHT] = nr_r.to(_F32)
    parent_rows[:, K.IS_LEAF] = 0.0
    parent_rows[:, K.SPLIT_GAIN] = plan.gains[parent_r]
    c2 = 2 * s
    child_rows = torch.stack([
        torch.full((c2,), -1.0, device=dev),              # SPLIT_FEAT
        torch.zeros(c2, device=dev),                      # SPLIT_BIN
        torch.full((c2,), -1.0, device=dev),              # LEFT
        torch.full((c2,), -1.0, device=dev),              # RIGHT
        child_vals,                                       # LEAF_VALUE
        torch.ones(c2, device=dev),                       # IS_LEAF
        torch.cat([prow[:, K.CAND_LC], prow[:, K.CAND_RC]]),  # COUNT
        torch.zeros(c2, device=dev),                      # SPLIT_GAIN
        child_depth,                                      # DEPTH
        bs.gain,                                          # CAND_GAIN
        bs.feature.to(_F32), bs.bin.to(_F32),             # CAND_FEAT, BIN
        bs.left_g, bs.left_h, bs.left_c,
        bs.right_g, bs.right_h, bs.right_c,
        bs.left_out, bs.right_out,                        # CAND_WL, WR
        child_lo, child_hi,                               # BOUND_LO, HI
        torch.zeros(c2, device=dev) if bs.cat is None
        else bs.cat.to(_F32),                             # CAND_CAT
        torch.minimum(torch.cat([prow[:, K.PM], prow[:, K.PM]]),
                      bs.gain),                           # PM
    ], dim=-1).to(_F32)
    P[parent_r] = parent_rows
    P[child_nodes] = child_rows
    if catmask is not None:
        catmask[child_nodes] = bs.cat_mask
    return plan.route_args[-1] + 2 * s, n_leaves + s


class WaveRows:
    """The wave grower's row work on one device: the root's histogram
    (kernel B1, one segment) and each wave's routing with the direct
    children's histograms (kernel B2, or the plain partition then B1 on
    the unfused route).  A mesh supplies its own
    (``parallel.data_parallel.MeshWaveRows``) with the same methods."""

    def __init__(self, bins: torch.Tensor, stats: torch.Tensor,
                 num_bins: int, hist_impl: str, hist_dtype: str):
        self.bins, self.stats = bins, stats
        self.n, self.num_features = bins.shape
        self.device = bins.device
        self.num_bins, self.hist_impl = num_bins, hist_impl
        self.hist_dtype = hist_dtype
        self.row_leaf = torch.zeros(self.n, dtype=torch.int32,
                                    device=self.device)

    def root(self) -> torch.Tensor:
        """The root's histogram ``[F, B, 3]``."""
        return compute_histograms(
            self.bins, self.stats,
            torch.zeros(self.n, dtype=torch.int32, device=self.device), 1,
            self.num_bins, impl=self.hist_impl,
            hist_dtype=self.hist_dtype)[0]

    def total(self) -> torch.Tensor:
        """The root's (g, h, count) totals ``[3]``."""
        return self.stats.sum(dim=0)

    def wave(self, plan: "WavePlan", fuse_part: bool, **cat) -> torch.Tensor:
        """Route the wave's rows into ``row_leaf`` and return the direct
        children's histograms ``[s, F, B, 3]``."""
        args = (self.bins, self.stats, self.row_leaf) + plan.route_args
        if fuse_part:
            args += (self.num_bins, resolve_mode(self.hist_dtype))
            direct, self.row_leaf = (
                hist_partition_plain(*args)
                if self.hist_impl in ("plain", "jnp")
                else hist_partition_fused(*args))
            return direct
        seg, self.row_leaf = route_wave(self.bins, *args[2:], **cat)
        return compute_histograms(self.bins, self.stats, seg, plan.s,
                                  self.num_bins, impl=self.hist_impl,
                                  hist_dtype=self.hist_dtype)


def grow_tree_frontier(bins: torch.Tensor, stats: torch.Tensor,
                       feature_mask: torch.Tensor, ctx: SplitContext,
                       num_leaves: int, num_bins: int, max_depth: int,
                       wave_width: int, hist_impl: str = "auto",
                       hist_dtype: str = "f32", wave_tail: str = "half",
                       overgrow_leaves: Optional[int] = None,
                       ff_bynode: Optional[float] = None, key=None,
                       cat_info: Optional[CatInfo] = None,
                       mono: Optional[torch.Tensor] = None,
                       extra_trees: bool = False,
                       col_bins: Optional[torch.Tensor] = None,
                       ic_member: Optional[torch.Tensor] = None,
                       rows=None, scorer=None
                       ) -> Tuple[Tree, torch.Tensor]:
    """Best-first growth in waves: up to ``wave_width`` splits per data
    pass (the reference's ``grow_tree_frontier``).

    Per wave: the top leaves by cached candidate gain (by pathmin in the
    exact tail) split together; one pass of kernel B2 routes their rows and
    histograms each split's smaller child (on the reference's unfused route,
    :func:`wave_fuses_partition` false: categorical splits, int8 histograms
    or more than 256 features, the plain partition
    :func:`~..ops.histogram.route_wave`, which sends a subset split's rows
    left by their code's bit in its candidate mask, and kernel B1 with one
    segment per split); the sibling is parent minus child
    from the per-leaf histogram cache; the fresh children are scored from
    the cached histograms.  The loop reads one number per wave on the host
    (how many leaves still have a finite candidate gain), which decides
    whether another wave runs and how many splits it takes: the reference's
    ``while_loop`` condition.  With ``ff_bynode`` (None: off) each fresh
    child is scored under its own node mask, drawn once per tree under the
    grower ``key`` for every node id below the capacity
    (:func:`~.feature_mask.node_mask_fn`); B2 is unchanged by it.  The
    constraints (:func:`grow_tree`'s) leave the partition alone too, so B2
    runs with them as in the reference: a wave's children are scored under
    the bounds from their parents' mid-points (``mono``), at their rows of
    the extra-trees table (drawn once per tree for every node id below the
    capacity, the exact tail's overgrowth included) and under their
    surviving interaction groups; the bounds ride in the node table, so the
    exact tail's prune keeps them.

    On a mesh, ``rows`` (None: :class:`WaveRows` over ``bins`` and
    ``stats``) routes each shard's rows and hands back merged histograms,
    and ``scorer`` (:func:`make_dist_scorer`) scores a merge's slices or
    local partials, the root totals then coming from the rows.
    """
    if rows is None:
        rows = WaveRows(bins, stats, num_bins, hist_impl, hist_dtype)
    num_features = rows.num_features
    dev = rows.device
    K = _PK
    exact = wave_tail == "exact"
    grow_leaves = (max(num_leaves + 1, int(overgrow_leaves or 0))
                   if exact else num_leaves)
    capacity = 2 * grow_leaves - 1
    w_width = min(int(wave_width), grow_leaves - 1)
    fuse_part = wave_fuses_partition(num_features, w_width, num_bins,
                                     hist_dtype, cat_info is not None)
    node_mask = node_mask_fn(key, ff_bynode, num_features, feature_mask,
                             bynode_off=ff_bynode is None,
                             capacity=capacity)
    rand = (rand_bin_table(key_tensor([key], dev), num_features, num_bins,
                           col_bins, capacity)[0]
            if extra_trees else None)                         # [cap, F]

    # ---- root: kernel B1 with one segment --------------------------------
    root_hist = rows.root()                                   # [F, B, 3]
    root_mask = node_mask(0)
    icsets = member = None
    if ic_member is not None:
        member = ic_member.to(dev)
        icsets = torch.zeros((capacity, member.shape[0]), dtype=torch.bool,
                             device=dev)
        icsets[0] = True
        root_mask = root_mask * _ic_allowed(icsets[0], member)
    P, root_best = _wave_root(root_hist, ctx, root_mask, capacity,
                              scorer=scorer,
                              root_tot=None if scorer is None
                              else rows.total(),
                              arith=_xla_arith(cat_info, mono),
                              cat_info=cat_info, mono=mono,
                              rand_bins=None if rand is None else rand[0])
    catmask = None
    if cat_info is not None:
        catmask = torch.zeros((capacity, num_bins), dtype=torch.bool,
                              device=dev)
        catmask[0] = root_best.cat_mask
    hist_cache, node_slot = _wave_cache(root_hist, grow_leaves, capacity)
    n_nodes, n_leaves = 1, 1

    while n_leaves < grow_leaves:
        plan = _wave_plan(P, n_nodes, n_leaves, grow_leaves, w_width,
                          wave_tail)
        if plan is None:
            break

        # route the rows and histogram the smaller children: kernel B2, or
        # on the unfused route the plain partition and kernel B1 with one
        # segment per split
        cat = {} if catmask is None else dict(
            cat=plan.prow[:, K.CAND_CAT] > 0.5,
            catmask=catmask[plan.parent_r])
        direct_hist = rows.wave(plan, fuse_part, **cat)
        n_nodes, n_leaves = _wave_commit(
            plan, direct_hist, P, hist_cache, node_slot, n_leaves, ctx,
            max_depth, node_mask, mono=mono, icsets=icsets, member=member,
            rand=rand, cat_info=cat_info, catmask=catmask, scorer=scorer,
            num_features=num_features)

    if exact:
        return _exact_prune(P, rows.row_leaf, num_leaves, catmask)
    return _tree_from_packed(P, n_leaves, catmask), rows.row_leaf


def _exact_prune(P: torch.Tensor, row_leaf: torch.Tensor, num_leaves: int,
                 catmask: Optional[torch.Tensor] = None
                 ) -> Tuple[Tree, torch.Tensor]:
    """Replay strict best-first selection over an overgrown wave tree and
    prune it back to ``num_leaves`` (the reference's ``_exact_prune``).

    Every node's candidate split depends only on its own rows, so the
    overgrown tree's realized gains are the gains strict growth would have
    scored; strict growth is priority-first extraction over that gain tree
    (``num_leaves - 1`` trips of argmax over the available candidates, the
    first occurrence on ties).  The table is a few KB, so the replay runs on
    the host in numpy (:func:`_exact_prune_table`); one device gather then
    remaps ``row_leaf`` onto the pruned tree's node ids.  The candidate
    mask table ``catmask`` (None: no categorical columns) follows its
    surviving nodes to their new ids (:func:`_prune_tables`).
    """
    dev = P.device
    newP, catmask, node_to_new, kept = _prune_tables(P, catmask, num_leaves)
    remap = torch.from_numpy(node_to_new).to(dev)
    row_leaf_new = remap[row_leaf.to(torch.int64)]
    return _tree_from_packed(newP, kept[0] + 1, catmask), row_leaf_new


def _prune_tables(P: torch.Tensor, catmask: Optional[torch.Tensor],
                  num_leaves: int):
    """The host half of the exact tail for one overgrown table ``[m, NC]``
    or a batch ``[E, m, NC]`` (:func:`_exact_prune_table` each), with the
    candidate mask tables ``catmask`` bool ``[..., m, B]`` (None: no
    categorical columns) riding in the same transfers: one read of the
    tables and one copy of the pruned ones back, as without masks.
    Returns ``(pruned tables [..., 2 * num_leaves - 1, NC] and masks on the
    device, node id maps i32 [..., m] on the host, splits kept per
    table)``."""
    nc = _PK.NC
    both = P if catmask is None else torch.cat([P, catmask.to(_F32)], -1)
    host = both.cpu().numpy()
    pruned, remaps, kept = [], [], []
    for t in host.reshape((-1,) + host.shape[-2:]):
        newP, node_to_new, n_kept, target = _exact_prune_table(t[:, :nc],
                                                               num_leaves)
        if catmask is not None:
            masks = np.zeros((newP.shape[0], t.shape[1] - nc), np.float32)
            masks[target[target >= 0]] = t[target >= 0, nc:]
            newP = np.concatenate([newP, masks], axis=1)
        pruned.append(newP)
        remaps.append(node_to_new)
        kept.append(n_kept)
    out = torch.from_numpy(np.stack(pruned).reshape(
        host.shape[:-2] + pruned[0].shape)).to(P.device)
    new_cat = None if catmask is None else out[..., nc:] > 0.5
    return (out[..., :nc], new_cat,
            np.stack(remaps).reshape(host.shape[:-1]), kept)


def _exact_prune_table(Pn: np.ndarray, num_leaves: int):
    """The host half of :func:`_exact_prune` for one overgrown table
    ``[m, NC]``: ``(pruned table [2 * num_leaves - 1, NC], node id map
    i32 [m] from overgrown node to the pruned tree's leaf, splits kept,
    each node's row in the pruned table i64 [m], -1 where pruned away)``."""
    K = _PK
    m_over = Pn.shape[0]
    capacity = 2 * num_leaves - 1
    ids = np.arange(m_over)
    left = Pn[:, K.LEFT].astype(np.int64)
    right = Pn[:, K.RIGHT].astype(np.int64)
    parent = np.zeros(m_over, np.int64)
    parent[left[left >= 0]] = ids[left >= 0]
    parent[right[right >= 0]] = ids[right >= 0]
    expandable = left >= 0

    gain_c = Pn[:, K.CAND_GAIN]
    avail = np.zeros(m_over, bool)
    avail[0] = True
    kept = np.zeros(m_over, bool)
    for _ in range(num_leaves - 1):
        g_av = np.where(avail & expandable, gain_c, np.float32(-np.inf))
        i = int(np.argmax(g_av))
        if not np.isfinite(g_av[i]):
            break                     # nothing left to extract
        kept[i] = True
        avail[i] = False
        avail[left[i]] = True
        avail[right[i]] = True
    n_kept = int(kept.sum())

    # final leaves = children of kept splits that are not kept themselves
    # (the root when nothing was kept), among the real nodes only
    real = (Pn[:, K.IS_LEAF] > 0.5) | expandable
    final_leaf = real & ~kept & ((kept[parent] & (ids != 0))
                                 | ((ids == 0) & (n_kept == 0)))
    surv = kept | final_leaf
    newid = np.cumsum(surv) - 1
    P_mod = Pn.copy()
    P_mod[:, K.LEFT] = np.where(kept, newid[np.maximum(left, 0)], -1)
    P_mod[:, K.RIGHT] = np.where(kept, newid[np.maximum(right, 0)], -1)
    P_mod[:, K.IS_LEAF] = np.where(kept, 0.0, 1.0)
    P_mod[:, K.SPLIT_FEAT] = np.where(kept, Pn[:, K.SPLIT_FEAT], -1.0)
    P_mod[:, K.SPLIT_BIN] = np.where(kept, Pn[:, K.SPLIT_BIN], 0.0)
    P_mod[:, K.SPLIT_GAIN] = np.where(kept, Pn[:, K.SPLIT_GAIN], 0.0)
    newP = _empty_packed_table(capacity, "cpu").numpy()
    newP[newid[surv]] = P_mod[surv]

    # each overgrown node maps to its unique final-leaf ancestor-or-self
    # (pointer doubling), then to that leaf's new id
    f = np.where(final_leaf, ids, parent)
    for _ in range(max(4, int(m_over).bit_length())):
        f = f[f]
    node_to_new = np.where(final_leaf[f], newid[f], 0).astype(np.int32)
    return newP, node_to_new, n_kept, np.where(surv, newid, -1)



# ---------------------------------------------------------------------------
# Streamed (out-of-core) grower steps.
#
# The in-memory growers walk a resident [n, F] matrix.  Under out-of-core
# training the matrix lives host-side in a data.BlockStore and each
# histogram pass is a host loop over blocks prefetched to the device, so
# the growers decompose into per-block row work (the partition and the
# block's histogram partial: kernel B1 once per block) and per-iteration
# table work (kernel B3 for a strict split iteration, the wave body's
# sibling / score / commit steps for a wave).  Every piece is built from
# the in-memory growers' own helpers (_strict_root, _strict_partition,
# _wave_root, _wave_plan, _wave_commit) on the plain numeric path (no
# categorical / monotone / extra-trees / interaction / bynode), so the same
# ops see the same sums: a streamed tree equals the in-memory tree bit for
# bit wherever the block partials sum exactly (the dyadic tier).  The host
# drivers live in data/stream_grow.py.
# ---------------------------------------------------------------------------


def stream_strict_init(root_hist: torch.Tensor, ctx: SplitContext,
                       feature_mask: torch.Tensor, max_depth: int,
                       capacity: int):
    """The strict grower's state from the block-accumulated root histogram
    ``[F, B, 3]``: ``(packed table [1, cap, NC], aux [1, 8], scal [1, 16],
    n_leaves i32 [1])``, as :func:`grow_tree_strict` starts one tree."""
    dev = root_hist.device
    P, aux, scal, _ = _strict_root(
        root_hist[None], SplitContext.per_element([ctx], dev),
        feature_mask.to(_F32).reshape(1, -1),
        torch.tensor([float(max_depth)], dtype=_F32, device=dev), capacity,
        arith=_xla_arith(None))
    return P, aux, scal, torch.ones(1, dtype=torch.int32, device=dev)


def stream_wave_init(root_hist: torch.Tensor, ctx: SplitContext,
                     feature_mask: torch.Tensor, capacity: int,
                     grow_leaves: int):
    """The wave grower's state from the block-accumulated root histogram
    ``[F, B, 3]``: ``(packed table [cap, NC], per-leaf histogram cache,
    node slots)``, as :func:`grow_tree_frontier` starts one tree."""
    P, _ = _wave_root(root_hist, ctx, feature_mask.to(_F32), capacity,
                      arith=_xla_arith(None))
    return (P,) + _wave_cache(root_hist, grow_leaves, capacity)


def _stream_root_block(bins_b: torch.Tensor, stats_b: torch.Tensor,
                       num_bins: int, hist_impl: str, hist_dtype: str):
    """One block's root histogram partial ``[1, F, B, 3]`` (kernel B1, one
    segment)."""
    seg = torch.zeros(bins_b.shape[0], dtype=torch.int32,
                      device=bins_b.device)
    return compute_histograms(bins_b, stats_b, seg, 1, num_bins,
                              impl=hist_impl, hist_dtype=hist_dtype)


def _stream_strict_block(bins_b: torch.Tensor, stats_b: torch.Tensor,
                         row_leaf_b: torch.Tensor, aux: torch.Tensor,
                         scal: torch.Tensor, num_bins: int, hist_impl: str,
                         hist_dtype: str):
    """One strict split iteration's row work on one block: the split leaf's
    rows partitioned into ``row_leaf_b`` (the block's view of the row
    vector, updated in place) and the two children's histogram partial
    ``[2, F, B, 3]`` (kernel B1, two segments)."""
    rl, seg = _strict_partition(bins_b, row_leaf_b[:, None], aux, scal)
    row_leaf_b.copy_(rl[:, 0])
    return compute_histograms(bins_b, stats_b, seg[:, 0], 2, num_bins,
                              impl=hist_impl, hist_dtype=hist_dtype)


def _stream_wave_block(bins_b: torch.Tensor, stats_b: torch.Tensor,
                       row_leaf_b: torch.Tensor, plan: WavePlan,
                       num_bins: int, hist_impl: str, hist_dtype: str):
    """One wave's row work on one block, the unfused wave body's: the
    plain partition routes the block's rows of the splitting leaves into
    ``row_leaf_b`` (in place) and kernel B1 builds the direct children's
    histogram partial ``[s, F, B, 3]``."""
    seg, rl = route_wave(bins_b, row_leaf_b, *plan.route_args)
    row_leaf_b.copy_(rl)
    return compute_histograms(bins_b, stats_b, seg, plan.s, num_bins,
                              impl=hist_impl, hist_dtype=hist_dtype)


def stream_strict_update(hist2: torch.Tensor, P: torch.Tensor,
                         aux: torch.Tensor, scal: torch.Tensor,
                         n_leaves: torch.Tensor, feature_mask: torch.Tensor,
                         hist_impl: str = "auto"):
    """One strict split iteration's table work on the block-accumulated
    children's histograms ``[2, F, B, 3]``: kernel B3 (:func:`split_iter`),
    the call the in-memory strict body makes; advances ``scal``'s node
    count and ``n_leaves`` in place.  Returns ``(table', aux')``."""
    grew = aux[:, 3] > 0
    P, aux = split_iter(hist2.unsqueeze(0), P,
                        feature_mask.to(_F32).reshape(1, -1).contiguous(),
                        aux, scal, impl=hist_impl)
    scal[:, 8] += 2.0 * grew.to(_F32)
    n_leaves += grew.to(torch.int32)
    return P, aux


def stream_exact_prune(P: torch.Tensor, row_leaf: torch.Tensor,
                       num_leaves: int) -> Tuple[Tree, torch.Tensor]:
    """The exact tail of the streamed wave grower (no categorical masks):
    :func:`_exact_prune` on the overgrown table, ``row_leaf`` remapped."""
    return _exact_prune(P, row_leaf, num_leaves)


def batched_wave_route(bins: torch.Tensor, row_leaf: torch.Tensor,
                       route, row_base: torch.Tensor, num_bins: int):
    """One wave's row partition for ``E`` trees (plain ops on ``[E, n]``,
    as XLA ops in the reference): ``route = (slot_of_node [E, cap + 1],
    prow [E, W, NC], direct_left [E, W], n_nodes [E], wmask)`` with
    ``wmask`` bool ``[E, W * B]`` the splitting leaves' candidate masks
    (None: no categorical split).  Returns ``(row_leaf' i64 [E, n], seg
    i32 [E, n])``: a row of a split moves to its child, and one that went
    to its split's smaller child gets its wave rank as segment (else
    -1)."""
    K = _PK
    i64 = torch.int64
    slot_of_node, prow, direct_left, n_nodes, wmask = route
    slot = slot_of_node.gather(1, row_leaf)
    sel = slot >= 0
    s_safe = slot.clamp(min=0)
    feat_row = prow[..., K.CAND_FEAT].to(i64).gather(1, s_safe)
    code = bins.reshape(-1)[row_base + feat_row].to(i64)
    go_left = code <= prow[..., K.CAND_BIN].to(i64).gather(1, s_safe)
    if wmask is not None:
        # a subset split's rows go left by their code's bit in the split
        # leaf's candidate mask
        bit = wmask.gather(1, s_safe * num_bins + code)
        go_left = torch.where(
            (prow[..., K.CAND_CAT] > 0.5).gather(1, s_safe), bit, go_left)
    row_leaf = torch.where(
        sel, n_nodes[:, None] + 2 * s_safe + (~go_left).to(i64), row_leaf)
    direct = go_left == direct_left.gather(1, s_safe)
    seg = torch.where(sel & direct, s_safe, -1).to(torch.int32)
    return row_leaf, seg


class BatchWaveRows:
    """The batched wave grower's row work on one device: the roots'
    narrow pass (kernel B6) and each wave's partition
    (:func:`batched_wave_route`) with the direct children's histograms
    (:func:`~..ops.histogram.compute_histograms_batched`, kernel B5 at the
    default widths).  A mesh supplies its own with the same methods."""

    def __init__(self, bins: torch.Tensor, stats_t: torch.Tensor,
                 num_bins: int, hist_impl: str, hist_dtype: str):
        self.bins, self.stats_t = bins, stats_t
        self.n, self.e, _ = stats_t.shape
        self.num_features = bins.shape[1]
        self.device = bins.device
        self.num_bins, self.hist_impl = num_bins, hist_impl
        self.hist_dtype = hist_dtype
        self.stats = stats_t.transpose(0, 1).contiguous()     # [E, n, 3]
        self.row_base = (torch.arange(self.n, device=self.device)
                         * self.num_features)
        self.row_leaf = torch.zeros((self.e, self.n), dtype=torch.int64,
                                    device=self.device)

    def root(self) -> torch.Tensor:
        """The roots' histograms ``[E, F, B, 3]``."""
        return histograms_rows(self.bins, self.stats_t, None, 1,
                               self.num_bins, impl=self.hist_impl,
                               hist_dtype=self.hist_dtype)[:, 0]

    def total(self) -> torch.Tensor:
        """The roots' (g, h, count) totals ``[E, 3]``."""
        return self.stats_t.sum(dim=0)

    def wave(self, route, w_width: int) -> torch.Tensor:
        """Route the wave's rows into ``row_leaf`` and return the direct
        children's histograms ``[E, W, F, B, 3]``."""
        self.row_leaf, seg = batched_wave_route(
            self.bins, self.row_leaf, route, self.row_base, self.num_bins)
        return compute_histograms_batched(
            self.bins, self.stats, seg, w_width, self.num_bins,
            impl=self.hist_impl, hist_dtype=self.hist_dtype)


def grow_tree_frontier_batched(bins: torch.Tensor, stats_t: torch.Tensor,
                               fmask: torch.Tensor, ctx: SplitContext,
                               max_depth: torch.Tensor, num_leaves: int,
                               num_bins: int, wave_width: int,
                               hist_impl: str = "auto",
                               hist_dtype: str = "f32",
                               wave_tail: str = "half",
                               overgrow_leaves: Optional[int] = None,
                               ff_bynode: Optional[torch.Tensor] = None,
                               keys: Optional[torch.Tensor] = None,
                               cat_info: Optional[CatInfo] = None,
                               mono: Optional[torch.Tensor] = None,
                               extra_trees: bool = False,
                               col_bins: Optional[torch.Tensor] = None,
                               ic_member: Optional[torch.Tensor] = None,
                               rows=None, scorer=None):
    """Wave growth of ``E`` trees at once: the reference's
    ``grow_tree_frontier`` under ``vmap`` (fused cross-validation in the
    wave regime, multiclass), on its non-fused wave path.

    ``bins`` u8 ``[n, F]`` is shared; ``stats_t`` f32 ``[n, E, 3]``,
    ``fmask`` f32 ``[E, F]``, per-element ``ctx`` ``[E]`` and ``max_depth``
    f32 ``[E]`` as for :func:`grow_tree_strict`.  Each element's tree is the
    one :func:`grow_tree_frontier` grows for it alone: every element takes
    its own wave size ``s`` (from its own budget and candidate count) and
    an element whose loop has ended takes ``s = 0``, which carries it
    unchanged while the others go on, as ``vmap`` carries a finished
    ``while_loop`` element.  Per wave, for the whole batch: the row
    partition (plain PyTorch ops on ``[E, n]``, as XLA ops in the
    reference), one histogram pass over every split's smaller child
    (:func:`~..ops.histogram.compute_histograms_batched`: kernel B5 at
    ``W * 3 >= 64``, B6 below), siblings by subtraction from a per-element
    cache ``[E, leaves, F, B, 3]``, and the fresh children scored with
    :func:`~..ops.split.find_best_split` (the reference's XLA scan
    rounding).  The root histogram takes B6.  The loop reads one flag per
    wave on the host (whether any element still has work); the exact tail
    reads the overgrown tables once, to prune them.  With ``ff_bynode`` f32
    ``[E]`` and ``keys`` int64 ``[E, 2]`` (None: off) each node is scored
    under its row of :func:`~.feature_mask.node_mask_table`, drawn once per
    tree.  With ``cat_info`` each element keeps its candidates' left-bin
    sets in a mask table ``[E, capacity, B]``, and a subset split's rows go
    left by their code's bit there.  The constraints are
    :func:`grow_tree_frontier`'s, per element (``extra_trees`` drawn under
    each element's key), the bounds in the node tables.

    Returns a :class:`GrownTrees` whose tables hold ``2 * num_leaves - 1``
    rows (the mask table None without ``cat_info``).

    On a mesh, ``rows`` (None: :class:`BatchWaveRows`) routes each shard's
    rows and hands back merged histograms, and ``scorer``
    (:func:`make_dist_scorer`) scores a merge's slices or local partials.
    """
    if rows is None:
        rows = BatchWaveRows(bins, stats_t, num_bins, hist_impl, hist_dtype)
    e = rows.e
    num_features = rows.num_features
    dev = rows.device
    K = _PK
    nc = K.NC
    exact = wave_tail == "exact"
    grow_leaves = (max(num_leaves + 1, int(overgrow_leaves or 0))
                   if exact else num_leaves)
    capacity = 2 * grow_leaves - 1
    w_width = min(int(wave_width), grow_leaves - 1)
    i64 = torch.int64
    neg_inf = torch.tensor(float("-inf"), dtype=_F32, device=dev)
    ar = torch.arange(e, device=dev)[:, None]
    iota_w = torch.arange(w_width, device=dev)
    fmask = fmask.to(_F32)
    md = max_depth.to(_F32)[:, None]
    node_masks = (None if ff_bynode is None
                  else node_mask_table(keys, ff_bynode, fmask, capacity))
    rand = (rand_bin_table(keys, num_features, num_bins, col_bins, capacity)
            if extra_trees else None)                         # [E, cap, F]

    # ---- root: the batch's narrow pass (kernel B6) ----------------------
    root_hist = rows.root()                                   # [E, F, B, 3]
    root_tot = None if scorer is None else rows.total()
    if root_tot is None:
        root_tot = root_hist[:, 0].sum(dim=1)                 # [E, 3]
    zero_e = torch.zeros(e, dtype=_F32, device=dev)
    root_out = constrained_leaf_output(
        root_tot[:, 0], root_tot[:, 1], root_tot[:, 2],
        ctx._replace(path_smooth=zero_e), float("-inf"), float("inf"),
        zero_e)
    root_mask = fmask if node_masks is None else node_masks[:, 0]
    icsets = None
    if ic_member is not None:
        member = ic_member.to(dev)
        icsets = torch.zeros((e, capacity + 1, member.shape[0]),
                             dtype=torch.bool, device=dev)
        icsets[:, 0] = True
        root_mask = root_mask * _ic_allowed(icsets[:, 0], member)
    root_best = (scorer or find_best_split)(
        root_hist, ctx, root_mask, None, root_out,
        arith=_xla_arith(cat_info, mono), cat_info=cat_info, mono=mono,
        rand_bins=None if rand is None else rand[:, 0])
    # one spare row, slot and node id past the end take every write of an
    # element's inactive wave lanes (the reference's out-of-bounds drop)
    P = torch.cat([_packed_root_table(capacity, root_out, root_tot,
                                      root_best),
                   _empty_packed_table(1, dev).expand(e, 1, nc)], dim=1)
    catmask = None
    if cat_info is not None:
        catmask = torch.zeros((e, capacity + 1, num_bins), dtype=torch.bool,
                              device=dev)
        catmask[:, 0] = root_best.cat_mask
    hist_cache = torch.zeros((e, grow_leaves + 1) + tuple(root_hist.shape[1:]),
                             dtype=_F32, device=dev)
    hist_cache[:, 0] = root_hist
    node_slot = torch.zeros((e, capacity + 1), dtype=i64, device=dev)
    n_nodes = torch.ones(e, dtype=i64, device=dev)
    n_leaves = torch.ones(e, dtype=i64, device=dev)

    while True:
        Pc = P[:, :capacity]
        is_leaf = Pc[..., K.IS_LEAF] > 0.5
        gains = torch.where(is_leaf, Pc[..., K.CAND_GAIN], neg_inf)
        n_cand = torch.isfinite(gains).sum(dim=1)
        live = (n_leaves < grow_leaves) & (n_cand > 0)
        if not bool(live.any()):                  # the wave's host read
            break
        sel_key = torch.where(is_leaf, Pc[..., K.PM], neg_inf) if exact \
            else gains
        order = torch.argsort(-sel_key, dim=1, stable=True)
        budget = grow_leaves - n_leaves
        alloc = budget.clamp(min=1) if wave_tail != "half" \
            else (budget // 2).clamp(min=1)
        s = torch.where(live, torch.minimum(n_cand, alloc).clamp(
            max=w_width), 0)                      # splits this wave [E]
        active = iota_w < s[:, None]              # [E, W]
        parent_r = order[:, :w_width]
        prow = P.gather(1, parent_r[..., None].expand(e, w_width, nc))
        direct_left = prow[..., K.CAND_LC] <= prow[..., K.CAND_RC]
        nl_r = n_nodes[:, None] + 2 * iota_w
        nr_r = nl_r + 1

        # route the rows of the splitting leaves (plain ops on [E, n]);
        # rows that go to their split's smaller child get its wave rank
        slot_of_node = torch.full((e, capacity + 1), -1, dtype=i64,
                                  device=dev)
        slot_of_node.scatter_(1, torch.where(active, parent_r, capacity),
                              torch.where(active, iota_w, -1))
        wmask = None
        if catmask is not None:
            wmask = catmask.gather(1, parent_r[..., None].expand(
                e, w_width, num_bins)).reshape(e, w_width * num_bins)
        direct_hist = rows.wave((slot_of_node, prow, direct_left, n_nodes,
                                 wmask), w_width)         # [E, W, F, B, 3]

        # siblings by subtraction from the per-element histogram cache
        parent_slot = node_slot.gather(1, parent_r)
        other_hist = hist_cache[ar, parent_slot] - direct_hist
        dl = direct_left.view(direct_left.shape
                              + (1,) * (direct_hist.dim() - 2))
        left_hist = torch.where(dl, direct_hist, other_hist)
        right_hist = torch.where(dl, other_hist, direct_hist)
        right_slot = n_leaves[:, None] + iota_w
        hist_cache[ar, torch.where(active, parent_slot, grow_leaves)] = \
            left_hist
        hist_cache[ar, torch.where(active, right_slot, grow_leaves)] = \
            right_hist
        node_slot.scatter_(1, torch.where(active, nl_r, capacity),
                           parent_slot)
        node_slot.scatter_(1, torch.where(active, nr_r, capacity),
                           right_slot)

        # score the 2W fresh children of every element
        child_nodes = torch.cat([nl_r, nr_r], dim=1)           # [E, 2W]
        child_hists = torch.cat([left_hist, right_hist], dim=1)
        child_depth1 = prow[..., K.DEPTH] + 1.0
        child_depth = torch.cat([child_depth1, child_depth1], dim=1)
        depth_ok = (md <= 0) | (child_depth < md)
        child_vals = torch.cat([prow[..., K.CAND_WL], prow[..., K.CAND_WR]],
                               dim=1)
        if node_masks is None:
            child_masks = fmask[:, None, :].expand(e, 2 * w_width,
                                                   num_features)
        else:
            # inactive lanes may point past the table; their scores are
            # dropped with the lane
            child_masks = node_masks.gather(1, child_nodes.clamp(
                max=capacity - 1)[..., None].expand(e, 2 * w_width,
                                                    num_features))
        pf = prow[..., K.CAND_FEAT].to(i64)                   # [E, W]
        lo_l, hi_l, lo_r, hi_r = _mono_child_bounds(
            mono, pf, prow[..., K.CAND_WL], prow[..., K.CAND_WR],
            prow[..., K.BOUND_LO], prow[..., K.BOUND_HI])
        child_lo = torch.cat([lo_l, lo_r], dim=1)             # [E, 2W]
        child_hi = torch.cat([hi_l, hi_r], dim=1)
        active2 = torch.cat([active, active], dim=1)
        if icsets is not None:
            child_sets = icsets.gather(1, parent_r[..., None].expand(
                e, w_width, icsets.shape[-1])) & member.t()[pf]  # [E, W, NG]
            allowed = _ic_allowed(child_sets, member)         # [E, W, F]
            child_masks = child_masks * torch.cat([allowed, allowed], dim=1)
            icsets[ar, torch.where(active2, child_nodes, capacity)] = \
                torch.cat([child_sets, child_sets], dim=1)
        child_rand = None
        if rand is not None:
            # inactive lanes may point past the table (dropped with them)
            child_rand = rand.gather(1, child_nodes.clamp(
                max=capacity - 1)[..., None].expand(e, 2 * w_width,
                                                    num_features))
        bounded = mono is not None            # as in grow_tree_frontier
        bs = (scorer or find_best_split)(
            child_hists, ctx, child_masks, depth_ok, child_vals,
            child_lo if bounded else None, child_hi if bounded else None,
            arith=_xla_arith(cat_info, mono), cat_info=cat_info, mono=mono,
            rand_bins=child_rand)

        # commit: the parents become internal, the children arrive with
        # their candidate splits; inactive lanes write the spare row
        parent_rows = prow.clone()
        parent_rows[..., K.SPLIT_FEAT] = prow[..., K.CAND_FEAT]
        parent_rows[..., K.SPLIT_BIN] = prow[..., K.CAND_BIN]
        parent_rows[..., K.LEFT] = nl_r.to(_F32)
        parent_rows[..., K.RIGHT] = nr_r.to(_F32)
        parent_rows[..., K.IS_LEAF] = 0.0
        parent_rows[..., K.SPLIT_GAIN] = gains.gather(1, parent_r)
        c2 = (e, 2 * w_width)

        def full(v):
            return torch.full(c2, v, dtype=_F32, device=dev)

        child_rows = torch.stack([
            full(-1.0), full(0.0), full(-1.0), full(-1.0),  # FEAT BIN L R
            child_vals,                                     # LEAF_VALUE
            full(1.0),                                      # IS_LEAF
            torch.cat([prow[..., K.CAND_LC], prow[..., K.CAND_RC]], dim=1),
            full(0.0), child_depth,                         # GAIN, DEPTH
            bs.gain, bs.feature.to(_F32), bs.bin.to(_F32),
            bs.left_g, bs.left_h, bs.left_c,
            bs.right_g, bs.right_h, bs.right_c,
            bs.left_out, bs.right_out,                      # CAND_WL, WR
            child_lo, child_hi,                             # BOUND_LO, HI
            full(0.0) if bs.cat is None else bs.cat.to(_F32),  # CAND_CAT
            torch.minimum(torch.cat([prow[..., K.PM], prow[..., K.PM]],
                                    dim=1), bs.gain),       # PM
        ], dim=-1)
        P[ar, torch.where(active, parent_r, capacity)] = parent_rows
        P[ar, torch.where(active2, child_nodes, capacity)] = child_rows
        if catmask is not None:
            catmask[ar, torch.where(active2, child_nodes, capacity)] = \
                bs.cat_mask
        n_nodes = n_nodes + 2 * s
        n_leaves = n_leaves + s

    P = P[:, :capacity]
    if catmask is not None:
        catmask = catmask[:, :capacity]
    row_leaf = rows.row_leaf
    if exact:
        P, catmask, node_to_new, kept = _prune_tables(P, catmask,
                                                      num_leaves)
        remap = torch.from_numpy(node_to_new).to(dev)
        row_leaf = remap.to(i64).gather(1, row_leaf)
        n_leaves = torch.tensor([k + 1 for k in kept], device=dev)

    return GrownTrees(P, n_leaves.to(torch.int32),
                      row_leaf.t().to(torch.int32), catmask)



# ---------------------------------------------------------------------------
# Tree <-> host arrays (the checkpoint codec: bit-exact, no decimal)
# ---------------------------------------------------------------------------

_TREE_OPTIONAL_FIELDS = ("is_cat_split", "cat_mask", "linear_feat",
                         "linear_coef")


def renew_leaf_values(tree: Tree, row_leaf: torch.Tensor,
                      residual: torch.Tensor, weight: torch.Tensor,
                      alpha: float) -> Tree:
    """Refit each leaf's value to the weighted alpha-quantile of its rows'
    ``residual`` (alpha 0.5: the weighted median), the reference's
    ``renew_leaf_values`` (upstream ``RenewTreeOutput``).

    One global sort of the rows by residual, one stable sort by leaf, the
    cumulative weights, and a ``searchsorted`` for every leaf's span and
    target, all on the tree's device with no host read.  Zero-weight rows
    (padding, out of bag) advance no cumulative weight and never become a
    quantile; a leaf without weight keeps its Newton value.  On CPU tensors
    the cumulative weights are summed in XLA's CPU scan order
    (:func:`~..ops.split.prefix_sum`), so the target row is the
    reference's whatever the weights; on the card in ``torch.cumsum``'s.
    """
    capacity = tree.leaf_value.shape[-1]
    n = residual.shape[0]
    order = torch.argsort(residual, stable=True)
    order = order[torch.argsort(row_leaf[order], stable=True)]
    leaf_s = row_leaf[order].to(torch.int32).contiguous()
    r_s = residual[order]
    w_s = weight[order].to(_F32)
    cw = prefix_sum(w_s) if w_s.device.type == "cpu" else \
        torch.cumsum(w_s, 0)
    ids = torch.arange(capacity, dtype=torch.int32, device=leaf_s.device)
    starts = torch.searchsorted(leaf_s, ids)
    ends = torch.searchsorted(leaf_s, ids, right=True)
    cw0 = torch.cat([cw.new_zeros(1), cw])
    w_before = cw0[starts]
    totals = cw0[ends] - w_before
    target = w_before + float(alpha) * totals      # alpha rounded to f32
    idx = torch.clamp(torch.searchsorted(cw, target), 0, n - 1)
    new_vals = torch.where((totals > 0) & tree.is_leaf, r_s[idx],
                           tree.leaf_value)
    return tree._replace(leaf_value=new_vals)


def linear_path_features(tree: Tree, k_feats: int) -> torch.Tensor:
    """Each node's first ``k_feats`` distinct split features from the root
    down to it (its own split excluded), int32 ``[M, k_feats]`` padded with
    -1: the lists the reference's ``fit_linear_leaves`` builds by a sweep
    over every node slot (``fori_loop(0, capacity)``).

    Here the sweep is by binary lifting, with no host read and launches
    bounded by the log of the depth: each node's parent, its depth and its
    ancestor at every depth (the path ``[M, D]``, ``D`` the deepest a tree
    of this capacity can be), then a feature is kept where no shallower
    ancestor split on it, and the kept ones are ranked by depth.  Unused
    slots and the root get no feature.
    """
    cap = tree.capacity
    dev = tree.left.device
    i64 = torch.int64
    ids = torch.arange(cap, dtype=i64, device=dev)
    internal = (~tree.is_leaf) & (tree.left >= 0)
    # parent of every slot; slot ``cap`` is the sentinel "no parent" (the
    # scatter drops non-children into slot ``cap + 1``)
    parent = torch.full((cap + 2,), cap, dtype=i64, device=dev)
    for child in (tree.left, tree.right):
        parent.scatter_(0, torch.where(internal, child.to(i64), cap + 1),
                        ids)
    parent = parent[:cap + 1]
    d_max = max(1, (cap - 1) // 2)
    levels = max(1, int(d_max).bit_length())
    up = [parent]
    for _ in range(levels - 1):
        up.append(up[-1][up[-1]])
    depth = torch.zeros(cap, dtype=i64, device=dev)
    cur = ids.clone()
    for j in range(levels - 1, -1, -1):
        nxt = up[j][cur]
        move = nxt != cap
        cur = torch.where(move, nxt, cur)
        depth = depth + move.to(i64) * (1 << j)
    feat_of = torch.cat([tree.split_feature.to(i64),
                         torch.full((1,), -1, dtype=i64, device=dev)])
    k = int(k_feats)
    flist = torch.full((cap, k + 1), -1, dtype=i64, device=dev)
    d_ids = torch.arange(d_max, dtype=i64, device=dev)
    # node blocks bound the [nodes, D, D] comparison
    block = max(1, (1 << 24) // (d_max * d_max))
    for s in range(0, cap, block):
        nodes = ids[s:s + block]
        dist = depth[nodes, None] - d_ids[None]          # [b, D]
        valid = dist > 0
        cur = nodes[:, None].expand(-1, d_max)
        for j in range(levels):
            cur = torch.where(valid & (((dist >> j) & 1) > 0), up[j][cur],
                              cur)
        fp = torch.where(valid, feat_of[cur], -1)        # [b, D] root first
        earlier = torch.tril(torch.ones(d_max, d_max, dtype=torch.bool,
                                        device=dev), diagonal=-1)
        dup = ((fp[:, :, None] == fp[:, None, :]) & earlier).any(-1)
        keep = valid & ~dup
        rank = torch.cumsum(keep.to(i64), dim=1) - 1
        slot = torch.where(keep & (rank < k), rank, k)
        out = torch.full((nodes.shape[0], k + 1), -1, dtype=i64, device=dev)
        out.scatter_(1, slot, torch.where(slot < k, fp, -1))
        flist[s:s + block] = out
    return flist[:, :k].to(torch.int32)


def _gram_sums(z: torch.Tensor, row_leaf: torch.Tensor, gb: torch.Tensor,
               hb: torch.Tensor, capacity: int, row_chunk: int):
    """Per-leaf ``A = Z^T H Z`` ``[M, K+1, K+1]`` and ``b = Z^T g``
    ``[M, K+1]``: one-hot matmuls over row chunks added in chunk order, the
    reference's formulation (each row's ``z z^T h`` first, then the one-hot
    contraction), with no atomics, so the sums are the same bits run to
    run."""
    n, kp1 = z.shape
    dev = z.device
    leaf_ids = torch.arange(capacity, dtype=row_leaf.dtype, device=dev)
    A = torch.zeros((capacity, kp1 * kp1), dtype=_F32, device=dev)
    bvec = torch.zeros((capacity, kp1), dtype=_F32, device=dev)
    c = row_chunk if n > row_chunk else n
    for s in range(0, n, c):
        zc, rl = z[s:s + c], row_leaf[s:s + c]
        onehot_t = (rl[None, :] == leaf_ids[:, None]).to(_F32)   # [M, c]
        zzh = (zc[:, :, None] * zc[:, None, :]).reshape(-1, kp1 * kp1) \
            * hb[s:s + c, None]
        A = A + onehot_t @ zzh
        bvec = bvec + onehot_t @ (zc * gb[s:s + c, None])
    return A.reshape(capacity, kp1, kp1), bvec


def fit_linear_leaves(tree: Tree, row_leaf: torch.Tensor, xraw: torch.Tensor,
                      g: torch.Tensor, h: torch.Tensor, bag: torch.Tensor,
                      linear_lambda: float, k_feats: int,
                      row_chunk: int = 131072,
                      row_shards=None) -> Tuple[Tree, torch.Tensor]:
    """Ridge models in every leaf (upstream ``linear_tree``), the
    reference's ``fit_linear_leaves``: per-leaf path-feature lists
    (:func:`linear_path_features`), the design ``Z = [x_path, 1]`` on the
    RAW values with NaN and unused slots at 0, ``A = Z^T H Z`` and
    ``b = Z^T g`` per leaf over row chunks (:func:`_gram_sums`), and one
    batched solve of ``(A + (lambda + 1e-6) I) beta = -b``.

    Leaves whose solve is singular or non-finite, or with fewer than
    ``k_feats + 2`` rows, keep their constant Newton value.  The solve is
    ``torch.linalg.solve_ex`` with ``check_errors=False``: a singular batch
    member raises nothing and reads nothing back to the host, and its
    ``info`` marks it for the fallback, as the reference's non-finite
    result does.  Everything runs on the tensors' device.

    ``row_shards`` (a mesh's row ranges ``[(start, stop)]``, None: one
    device) sums each shard's Gram systems over its own rows and merges
    them with one psum in shard order (the reference's ``axis_name``
    path); the solve is replicated.

    Returns ``(tree with linear_feat/linear_coef/leaf_value set, the
    per-row f(x_i) of this tree)``.
    """
    n = xraw.shape[0]
    capacity = tree.capacity
    k = int(k_feats)
    kp1 = k + 1
    dev = xraw.device
    flist = linear_path_features(tree, k)                     # [M, K]
    rl = row_leaf.to(torch.int64)
    feats = flist[rl].to(torch.int64)                         # [n, K]
    xg = xraw.gather(1, feats.clamp(min=0))
    xg = torch.where((feats >= 0) & torch.isfinite(xg), xg,
                     torch.zeros((), dtype=_F32, device=dev))
    z = torch.cat([xg, torch.ones((n, 1), dtype=_F32, device=dev)], dim=1)
    gb, hb = g * bag, h * bag
    if row_shards is None:
        A, bvec = _gram_sums(z, rl, gb, hb, capacity, int(row_chunk))
    else:
        from ..parallel.mesh import psum

        parts = [_gram_sums(z[a:b], rl[a:b], gb[a:b], hb[a:b], capacity,
                            int(row_chunk)) for a, b in row_shards]
        A = psum([x[0] for x in parts])[0]
        bvec = psum([x[1] for x in parts])[0]
    # filled on the device: a host tensor copied over would sync
    lam = torch.full((), float(linear_lambda), dtype=_F32, device=dev) \
        + torch.full((), 1e-6, dtype=_F32, device=dev)
    eye = torch.eye(kp1, dtype=_F32, device=dev)
    beta, info = torch.linalg.solve_ex(A + lam * eye[None],
                                       -bvec[..., None], check_errors=False)
    beta = beta[..., 0]                                       # [M, K+1]
    ok = (tree.is_leaf & torch.isfinite(beta).all(dim=-1) & (info == 0)
          & (tree.count >= kp1 + 1))
    zero = torch.zeros((), dtype=_F32, device=dev)
    coef = torch.where(ok[:, None], beta[:, :k], zero)
    intercept = torch.where(ok, beta[:, k], tree.leaf_value)
    new_tree = tree._replace(leaf_value=intercept, linear_feat=flist,
                             linear_coef=coef)
    delta = intercept[rl] + (coef[rl] * xg).sum(dim=1)
    return new_tree, delta


def tree_to_arrays(tree: Tree) -> dict:
    """Tree -> ``{field: np.ndarray}`` (optional None fields omitted)."""
    return {name: val.detach().cpu().numpy()
            for name, val in zip(Tree._fields, tree) if val is not None}


def tree_from_arrays(arrays: dict, device="cpu") -> Tree:
    """Inverse of :func:`tree_to_arrays`; takes the reference's arrays too,
    linear-leaf fields included."""
    kw = {}
    for name in Tree._fields:
        if name in arrays and arrays[name] is not None:
            kw[name] = torch.from_numpy(np.array(arrays[name])).to(device)
        elif name in _TREE_OPTIONAL_FIELDS:
            kw[name] = None
        else:
            raise KeyError(f"tree arrays missing field {name!r}")
    return Tree(**kw)


def pad_tree(tree: Tree, capacity: int) -> Tree:
    """A tree's node arrays padded on their last axis (``cat_mask`` and the
    linear fields on their node axis) up to ``capacity`` slots, the
    reference's ``pad_tree``: what stacks a forest of mixed ``num_leaves``
    (an ``init_model`` continuation with another leaf budget).  The padded
    slots are unreachable and carry the grower's unused-slot sentinels
    (``is_leaf=False``, children -1, zero values), so a used-node mask
    ``~is_leaf & (left >= 0)`` skips them."""
    m = tree.capacity
    if m == capacity:
        return tree
    if m > capacity:
        raise ValueError(f"cannot shrink tree capacity {m} -> {capacity}")
    extra = capacity - m

    def p(a, val=0):
        return torch.nn.functional.pad(a, (0, extra), value=val)

    def p_node2(a, val=0):
        """Pad the NODE axis of a ``[..., M, X]`` array."""
        return torch.nn.functional.pad(a, (0, 0, 0, extra), value=val)

    def opt(a, fn, val):
        return None if a is None else fn(a, val)

    return Tree(
        split_feature=p(tree.split_feature), split_bin=p(tree.split_bin),
        left=p(tree.left, -1), right=p(tree.right, -1),
        leaf_value=p(tree.leaf_value), is_leaf=p(tree.is_leaf, False),
        count=p(tree.count), split_gain=p(tree.split_gain),
        num_leaves=tree.num_leaves,
        is_cat_split=opt(tree.is_cat_split, p, False),
        cat_mask=opt(tree.cat_mask, p_node2, False),
        linear_feat=opt(tree.linear_feat, p_node2, -1),
        linear_coef=opt(tree.linear_coef, p_node2, 0.0))


def stack_trees(trees) -> Tree:
    """Trees stacked on a leading ``[T]`` axis, each padded to the largest
    capacity among them (:func:`pad_tree`) when their capacities differ."""
    cap = max(t.capacity for t in trees)
    trees = [pad_tree(t, cap) for t in trees]
    return Tree(*(None if f[0] is None else torch.stack(f)
                  for f in zip(*trees)))
