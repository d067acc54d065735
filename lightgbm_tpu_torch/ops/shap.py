"""Exact (path-dependent) TreeSHAP feature contributions — the port of
``lightgbm_tpu/ops/shap.py``.

LightGBM's ``predict(..., pred_contrib=True)`` (upstream ``TreeSHAP`` in
src/io/tree.cpp, after Lundberg et al. 2018) walks each tree recursively per
row.  The reference computes the same quantity algebraically, and so does
this module.  For one leaf ``l`` with value ``v`` and the set of *unique*
features ``P = {1..D}`` on its root path, path-dependent TreeSHAP is the
Shapley value of the product game ``g(S) = v * prod_{j in P} z_j(S)`` where
``z_j = a_j = 1{x follows every j-edge}`` when ``j in S`` and
``z_j = b_j = prod of the j-edges' cover fractions`` otherwise.  For a
product game

    phi_i = (a_i - b_i) * sum_k q_k * k! (D-1-k)! / D!

where ``q`` are the coefficients of ``prod_{j != i} (b_j + a_j t)``.  Padding
a leaf's slot list with dummy ``a = b = 1`` factors leaves every phi
unchanged, so all leaves share one slot count ``D`` (the forest's deepest
path).

:func:`tree_path_tables` decomposes each tree on the host in numpy, as the
reference does.  The forest pass is plain PyTorch on the bins' device, tree
by tree and in row chunks (rows are independent, so chunking changes no
bit): the polynomial over ``d`` ascending, then the synthetic division of
every slot at once, backward (``c[k+1] - b q``) where the row follows and
forward (``c[k] / b``) where it does not, over ``k`` descending, and the
one-hot attribution to original features as a matmul.  The Shapley weights
come from ``lgamma`` in float64 and are rounded to f32.

EFB: contributions are reported per ORIGINAL feature — each edge's slot
feature is resolved through the bundle map (``bundler.split_to_original``).

``sum_i phi_i + phi_bias == raw prediction`` holds up to f32 rounding.
"""

from __future__ import annotations

from math import lgamma
from typing import Dict, List, Optional

import numpy as np
import torch

_F32 = torch.float32
# elements of one [rows, M, D + 1] tensor per row chunk
_CHUNK_ELEMS = 1 << 25


def tree_path_tables(t: Dict[str, np.ndarray], max_depth: int,
                     node_orig: Optional[np.ndarray] = None,
                     ) -> Dict[str, np.ndarray]:
    """Host-side per-tree path decomposition (one pass over <= M nodes),
    the reference's ``tree_path_tables``.

    ``t`` holds numpy tree arrays (split_feature, split_bin, left, right,
    leaf_value, is_leaf, count, optionally is_cat_split + cat_mask);
    ``max_depth`` is the pad target of the slot/edge axes (the forest's
    deepest path); ``node_orig`` optional i64 ``[M]`` per-node ORIGINAL
    feature id (EFB).  Returns (D = E = max_depth):

      leaf_w    f32 [M]        leaf_value where is_leaf else 0
      b         f32 [M, D]     per-unique-feature "zero" fractions (pad 1)
      uniq_feat i64 [M, D]     original feature ids per slot (pad -1)
      edge_col  i64 [M, E]     training column read per edge (pad 0)
      edge_thr  i64 [M, E]     numeric threshold (pad huge: always follow)
      edge_dir  bool[M, E]     True = the path goes LEFT at this edge
      edge_cat  i64 [M, E]     node id for the cat-split mask, -1 = numeric
      slot_of   f32 [M, E, D]  one-hot edge -> unique-slot map (pad 0)
      prob      f32 [M]        P(leaf) = prod of ALL edge fractions
    """
    M = len(t["split_feature"])
    D = max(int(max_depth), 1)
    has_cat = t.get("is_cat_split") is not None
    internal = (~t["is_leaf"]) & (t["left"] >= 0)
    parent = np.full(M, -1, np.int64)
    is_left_child = np.zeros(M, bool)
    for i in np.flatnonzero(internal):
        parent[int(t["left"][i])] = i
        is_left_child[int(t["left"][i])] = True
        parent[int(t["right"][i])] = i

    leaf_w = np.where(t["is_leaf"], t["leaf_value"], 0.0).astype(np.float32)
    b = np.ones((M, D), np.float32)
    uniq_feat = np.full((M, D), -1, np.int64)
    edge_col = np.zeros((M, D), np.int64)
    edge_thr = np.full((M, D), np.iinfo(np.int32).max - 1, np.int64)
    edge_dir = np.ones((M, D), bool)
    edge_cat = np.full((M, D), -1, np.int64)
    slot_of = np.zeros((M, D, D), np.float32)
    prob = np.zeros(M, np.float32)

    for leaf in np.flatnonzero(t["is_leaf"]):
        node = int(leaf)
        edges = []          # leaf-ward order; slots are order-insensitive
        while parent[node] >= 0:
            p = int(parent[node])
            denom = max(float(t["count"][p]), 1e-12)
            frac = min(float(t["count"][node]) / denom, 1.0)
            edges.append((p, bool(is_left_child[node]), frac))
            node = p
        if len(edges) > D:
            raise ValueError(f"path length {len(edges)} > table depth {D}")
        feat_slot: Dict[int, int] = {}
        p_leaf = 1.0
        for e, (p, went_left, frac) in enumerate(edges):
            col = int(t["split_feature"][p])
            thr = int(t["split_bin"][p])
            fid = col if node_orig is None else int(node_orig[p])
            if fid not in feat_slot:
                feat_slot[fid] = len(feat_slot)
                uniq_feat[leaf, feat_slot[fid]] = fid
            d = feat_slot[fid]
            b[leaf, d] *= frac
            p_leaf *= frac
            edge_col[leaf, e] = col
            edge_dir[leaf, e] = went_left
            if has_cat and bool(t["is_cat_split"][p]):
                edge_cat[leaf, e] = p
            else:
                edge_thr[leaf, e] = thr
            slot_of[leaf, e, d] = 1.0
        prob[leaf] = p_leaf
    return {"leaf_w": leaf_w, "b": b, "uniq_feat": uniq_feat,
            "edge_col": edge_col, "edge_thr": edge_thr,
            "edge_dir": edge_dir, "edge_cat": edge_cat,
            "slot_of": slot_of, "prob": prob}


def _cat_follow(cmask: torch.Tensor, edge_cat: torch.Tensor,
                val: torch.Tensor) -> torch.Tensor:
    """cmask bool ``[M, B]``, edge_cat ``[M, E]``, val ``[n, M, E]`` ->
    bool ``[n, M, E]``: the bin code is in the edge node's LEFT set.  A
    broadcast gather: no ``[n, M, E, B]`` tensor."""
    node = edge_cat.clamp(min=0)                                # [M, E]
    return cmask[node[None].expand_as(val), val]


def _tree_depth(t: Dict[str, np.ndarray]) -> int:
    """The deepest leaf's depth (children come after parents, so one
    forward sweep resolves every depth)."""
    M = len(t["split_feature"])
    internal = (~t["is_leaf"]) & (t["left"] >= 0)
    depth = np.zeros(M, np.int64)
    for i in np.flatnonzero(internal):
        depth[int(t["left"][i])] = depth[i] + 1
        depth[int(t["right"][i])] = depth[i] + 1
    leaves = np.flatnonzero(t["is_leaf"])
    return int(depth[leaves].max()) if len(leaves) else 1


def shapley_weights(D: int) -> np.ndarray:
    """``k! (D-1-k)! / D!`` for k < D, from ``lgamma`` in float64, as f32."""
    return np.asarray([np.exp(lgamma(k + 1) + lgamma(D - k) - lgamma(D + 1))
                       for k in range(D)], np.float32)


def _tree_phi(bins: torch.Tensor, tab: Dict[str, torch.Tensor],
              cmask: Optional[torch.Tensor], wj: torch.Tensor,
              num_features: int) -> torch.Tensor:
    """One tree's contributions ``[n, F+1]`` (no shrinkage) for a chunk of
    binned rows ``[n, F_train]``."""
    n = bins.shape[0]
    M, D = tab["b"].shape
    dev = bins.device
    col = tab["edge_col"].reshape(-1)
    val = bins.index_select(1, col).reshape(n, M, D).to(torch.int64)
    go_left = val <= tab["edge_thr"][None]                      # [n, M, E]
    if cmask is not None:
        go_left = torch.where(tab["edge_cat"][None] >= 0,
                              _cat_follow(cmask, tab["edge_cat"], val),
                              go_left)
    follow = go_left == tab["edge_dir"][None]
    miss = 1.0 - follow.to(_F32)
    # edge misses per unique slot: small integer sums, exact in any order
    miss_d = torch.einsum("nme,med->nmd", miss, tab["slot_of"])
    a = (miss_d < 0.5).to(_F32)                                 # [n, M, D]
    b = tab["b"]                                                # [M, D]
    # the polynomial prod_d (b_d + a_d t): coefficients c [n, M, D+1]
    c = torch.zeros((n, M, D + 1), dtype=_F32, device=dev)
    c[..., 0] = 1.0
    for d in range(D):
        shifted = torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]],
                            dim=-1)
        c = b[:, d][None, :, None] * c + a[..., d][..., None] * shifted
    # every slot's synthetic division of c by (b_i + a_i t) at once:
    # backward where the row follows (a_i = 1, exact), forward constant
    # division where it does not (a_i = 0); the terms summed in the
    # division's order, k descending
    follows = a > 0.5
    qnext = torch.zeros((n, M, D), dtype=_F32, device=dev)
    total = torch.zeros((n, M, D), dtype=_F32, device=dev)
    b_ = b[None]
    for k in range(D - 1, -1, -1):
        q_bwd = c[..., k + 1, None] - b_ * qnext
        q_fwd = c[..., k, None] / b_
        qnext = torch.where(follows, q_bwd, q_fwd)
        total = total + qnext * wj[k]
    slot_phi = (a - b_) * total                                 # [n, M, D]
    contrib = slot_phi * tab["leaf_w"][None, :, None]
    # pads (uniq = -1) have a = b = 1, so exactly zero: they land on bias
    idx = torch.where(tab["uniq_feat"] >= 0, tab["uniq_feat"], num_features)
    onehot = torch.nn.functional.one_hot(
        idx.reshape(-1), num_features + 1).to(_F32)             # [M*D, F+1]
    phi = contrib.reshape(n, M * D) @ onehot
    phi[:, num_features] += (tab["leaf_w"] * tab["prob"]).sum()
    return phi


def _tree_dict(tree) -> Dict[str, np.ndarray]:
    """A Tree's fields as numpy arrays (None fields dropped)."""
    return {k: v.detach().cpu().numpy() for k, v in
            zip(type(tree)._fields, tree) if v is not None}


def forest_pred_contrib(trees: List, bins: torch.Tensor, num_features: int,
                        shrink: np.ndarray, bundler=None,
                        chunk_rows: Optional[int] = None) -> torch.Tensor:
    """SHAP contributions f32 ``[n, num_features + 1]`` on ``bins``'
    device, the last column the expected value.

    ``trees``: single-class Trees of one capacity M;
    ``bins`` u8 ``[n, F_train]``; ``num_features`` the ORIGINAL features;
    ``shrink`` f32 ``[T]`` per-tree multipliers; ``bundler`` an EFB
    FeatureBundler, whose per-node (column, bin) pairs resolve to original
    features in one call per tree.
    """
    dev = bins.device
    n = bins.shape[0]
    phi = torch.zeros((n, num_features + 1), dtype=_F32, device=dev)
    if not trees:
        return phi
    trees = [_tree_dict(t) for t in trees]
    depth = max(max(_tree_depth(t) for t in trees), 1)
    origs = [None] * len(trees)
    if bundler is not None:
        origs = [bundler.split_to_original(t["split_feature"],
                                           t["split_bin"]) for t in trees]
    tabs = [tree_path_tables(t, depth, o) for t, o in zip(trees, origs)]
    has_cat = any(t.get("is_cat_split") is not None
                  and np.any(t["is_cat_split"]) for t in trees)
    wj = torch.from_numpy(shapley_weights(depth)).to(dev)
    M = tabs[0]["b"].shape[0]
    rows = chunk_rows or max(1, _CHUNK_ELEMS // (M * (depth + 1)))
    bins_i = bins if bins.dtype == torch.uint8 else bins.to(torch.int64)
    sh = torch.from_numpy(np.asarray(shrink, np.float32)).to(dev)
    for t, (tree, tab) in enumerate(zip(trees, tabs)):
        tt = {k: torch.from_numpy(v).to(dev) for k, v in tab.items()}
        cmask = (torch.from_numpy(np.asarray(tree["cat_mask"], bool)).to(dev)
                 if has_cat else None)
        for s in range(0, n, rows):
            phi_t = _tree_phi(bins_i[s:s + rows], tt, cmask, wj,
                              num_features)
            phi[s:s + rows] = phi[s:s + rows] + sh[t] * phi_t
    return phi
