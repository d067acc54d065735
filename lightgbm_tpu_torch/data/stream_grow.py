"""Host drivers of out-of-core (streamed) tree growth — the port of
``lightgbm_tpu/data/stream_grow.py``.

The in-memory growers walk a resident ``[n, F]`` matrix.  Here the matrix
lives in a :class:`~.block_store.BlockStore` and every histogram pass is a
host loop over the blocks the store prefetches to the device: the per-block
steps of ``models/tree.py`` (``_stream_*_block``) partition the block's
rows and build its histogram partial with kernel B1, the partials are
summed in float64 and rounded once after the last block, and the table
steps (kernel B3 for a strict split iteration, the wave body's sibling /
score / commit steps for a wave) run on the accumulated histograms.  The
grower reads its rows through a row source: :class:`SerialSource` for one
store, ``data.stream_dp.StreamMesh`` for per-shard stores on a row mesh.

Resident O(n) state: the statistics, ``row_leaf``, the scores, labels,
weights and bag stay on the device, sized ``store.padded_rows``; what
streaming keeps off the device is the ``[n, F]`` code matrix.

GOSS at the source: under ``boosting="goss"`` the rows are sampled on the
host (exact top ``k_top`` by ``|g|``, then a seeded uniform draw of
``k_other`` from the rest, as the reference draws them) and only the
sampled rows are gathered and sent, so a round's histogram bytes shrink to
``(top_rate + other_rate) * n * F`` plus one full pass of traversal for the
train scores.  The host sampler is a different random stream from the
in-memory GOSS selection (``ops/sampling.goss_select``), so streamed GOSS
is statistically equivalent to in-memory GOSS, not bit-identical; with the
same gradients it selects the reference's streamed rows exactly.

Feature screening composes for free: on screened rounds the Booster hands
these drivers a :class:`~.block_store.ColumnViewStore`, so every block,
gather, kernel and odometer count sees the compacted ``F_active`` width.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.tree import (Tree, _stream_root_block, _stream_strict_block,
                           _stream_wave_block, _tree_from_packed,
                           _wave_commit, _wave_plan, decode_wave_width,
                           grow_tree, renew_leaf_values, stream_exact_prune,
                           stream_strict_init, stream_strict_update,
                           stream_wave_init)
from ..ops.histogram import sr_round_bf16
from ..ops.predict import forest_depth_cap, predict_tree_binned
from ..ops.split import SplitContext, fma
from ..parallel.mesh import _put

_F32 = torch.float32


def stream_hist(store, stats: torch.Tensor,
                block_fn: Callable) -> torch.Tensor:
    """One histogram pass over the store: ``block_fn(off, bins_b,
    stats_b)`` returns block ``k``'s f32 partial; the partials are summed
    in float64 in block order and rounded once after the last block (a
    single-block store returns its one partial as it is)."""
    acc = None
    single = store.num_blocks == 1
    for off, bins_b in store.device_blocks():
        nb = bins_b.shape[0]
        h = block_fn(off, bins_b, stats[off:off + nb])
        if single:
            acc = h
        elif acc is None:
            acc = h.to(torch.float64)
        else:
            acc.add_(h)
    return acc if single else acc.to(_F32)


class SerialSource:
    """The streamed grower's rows as one shard: a store (or a column view
    of one) on the statistics' device.  A row source answers three
    questions of the grower: ``split(stats)`` the per-shard statistics,
    ``hist(parts, block_fn)`` one histogram pass (``block_fn(s, off,
    bins_b, stats_b)`` is shard ``s``'s partial of its block at local row
    ``off``) and ``gather(row_leaf)`` the shards' ``row_leaf`` in global row
    order; ``data.stream_dp.StreamMesh`` answers them over a row mesh."""

    def __init__(self, store):
        self.store = store

    def split(self, stats: torch.Tensor):
        return [stats]

    def hist(self, parts, block_fn: Callable) -> torch.Tensor:
        return stream_hist(self.store, parts[0],
                           lambda off, b, st: block_fn(0, off, b, st))

    def gather(self, row_leaf):
        return row_leaf[0]


def stream_grow_tree(source, stats: torch.Tensor, feature_mask: torch.Tensor,
                     ctx: SplitContext, num_leaves: int, num_bins: int,
                     max_depth: int, wave_width: int,
                     hist_impl: str = "auto",
                     hist_dtype: str = "f32") -> Tuple[Tree, torch.Tensor]:
    """Grow one tree from a row ``source`` (:class:`SerialSource`, or a
    ``StreamMesh`` for streamed data parallelism) on the plain numeric
    path: the strict grower at width 1, else the wave grower with the
    width's tail, as :func:`~..models.tree.grow_tree` dispatches.
    ``stats`` f32 ``[padded_rows, 3]`` in global row order on the device;
    returns ``(tree, row_leaf)`` with ``row_leaf`` sized ``padded_rows``
    there.  Each shard keeps its own ``row_leaf``; the table steps run once,
    on the statistics' device."""
    if hist_dtype == "bf16sr":
        # rounded once over the global rows, as the in-memory grower rounds
        # a tree's statistics
        stats, hist_dtype = sr_round_bf16(stats), "bf16"
    width, tail, overgrow = decode_wave_width(wave_width)
    grow = (_grow_strict if width <= 1 else _grow_wave)
    return grow(source, source.split(stats), feature_mask, ctx, num_leaves,
                num_bins, max_depth, width, tail, overgrow, hist_impl,
                hist_dtype)


def _row_leaf(parts):
    return [torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
            for p in parts]


def _root_hist(source, parts, num_bins, hist_impl, hist_dtype):
    return source.hist(parts, lambda s, off, b, st: _stream_root_block(
        b, st, num_bins, hist_impl, hist_dtype))[0]          # [F, B, 3]


def _grow_strict(source, parts, feature_mask, ctx, num_leaves, num_bins,
                 max_depth, width, tail, overgrow, hist_impl, hist_dtype):
    """``num_leaves - 1`` split iterations, each one pass of B1 with two
    segments over every shard's blocks and one launch of B3."""
    capacity = 2 * num_leaves - 1
    root = _root_hist(source, parts, num_bins, hist_impl, hist_dtype)
    P, aux, scal, n_leaves = stream_strict_init(root, ctx, feature_mask,
                                                max_depth, capacity)
    row_leaf = _row_leaf(parts)
    for _ in range(num_leaves - 1):
        on = [(_put(aux, r.device), _put(scal, r.device)) for r in row_leaf]
        hist2 = source.hist(parts, lambda s, off, b, st: _stream_strict_block(
            b, st, row_leaf[s][off:off + b.shape[0]], on[s][0], on[s][1],
            num_bins, hist_impl, hist_dtype))                # [2, F, B, 3]
        P, aux = stream_strict_update(hist2, P, aux, scal, n_leaves,
                                      feature_mask, hist_impl)
    return _tree_from_packed(P[0], n_leaves[0]), source.gather(row_leaf)


def _grow_wave(source, parts, feature_mask, ctx, num_leaves, num_bins,
               max_depth, width, tail, overgrow, hist_impl, hist_dtype):
    """Waves of up to ``width`` splits, each one pass of the plain
    partition and B1 (one segment per split) over every shard's blocks,
    then the wave body's table steps; the exact tail prunes the overgrown
    tree."""
    exact = tail == "exact"
    grow_leaves = (max(num_leaves + 1, int(overgrow or 0)) if exact
                   else num_leaves)
    capacity = 2 * grow_leaves - 1
    w_width = min(int(width), grow_leaves - 1)
    root = _root_hist(source, parts, num_bins, hist_impl, hist_dtype)
    P, hist_cache, node_slot = stream_wave_init(root, ctx, feature_mask,
                                                capacity, grow_leaves)
    fmask = feature_mask.to(_F32)
    row_leaf = _row_leaf(parts)
    n_nodes, n_leaves = 1, 1
    while n_leaves < grow_leaves:
        plan = _wave_plan(P, n_nodes, n_leaves, grow_leaves, w_width, tail)
        if plan is None:
            break
        plans = [plan._replace(route_args=tuple(
            _put(a, r.device) if torch.is_tensor(a) else a
            for a in plan.route_args)) for r in row_leaf]
        direct = source.hist(parts, lambda s, off, b, st: _stream_wave_block(
            b, st, row_leaf[s][off:off + b.shape[0]], plans[s], num_bins,
            hist_impl, hist_dtype))
        n_nodes, n_leaves = _wave_commit(plan, direct, P, hist_cache,
                                         node_slot, n_leaves, ctx, max_depth,
                                         lambda node_id: fmask)
    if exact:
        return stream_exact_prune(P, source.gather(row_leaf), num_leaves)
    return _tree_from_packed(P, n_leaves), source.gather(row_leaf)


# ---------------------------------------------------------------------------
# Boosting rounds (wired from models.gbdt.Booster.update)
# ---------------------------------------------------------------------------


def stream_tree_values(store, tree: Tree,
                       depth_cap: Optional[int] = None) -> torch.Tensor:
    """One tree's leaf value for every padded row, by one traversal pass
    over the store (``[padded_rows]`` on the store's device)."""
    depth = forest_depth_cap(tree) if depth_cap is None else depth_cap
    return torch.cat([predict_tree_binned(tree, bins_b, depth)
                      for _, bins_b in store.device_blocks()])


def _renew(tree, row_leaf, y, pred, rw, renew_alpha, renew_scale):
    if renew_alpha is None:
        return tree
    if renew_scale is not None:
        rw = rw * renew_scale(y)
    return renew_leaf_values(tree, row_leaf, y - pred, rw, renew_alpha)


def stream_plain_round(source, obj, y, w, bag, pred, fmask, hyper,
                       num_leaves: int, num_bins: int, hist_impl: str,
                       hist_dtype: str, wave_width: int, is_rf: bool,
                       renew_alpha=None, renew_scale=None):
    """One plain gbdt/rf round over a row ``source`` (a BlockStore's
    :class:`SerialSource`, or a ``StreamMesh``) — the streamed restatement
    of the Booster's round body: grad/hess, the bagging-masked statistics,
    one streamed tree, the leaf renewal where the objective has one, and
    the train-score update ``fma(lr, value, pred)`` (rf returns ``pred``
    unchanged).  The gradients are elementwise, so the whole-row
    computation is every shard's."""
    g, h = obj.grad_hess(pred, y, w)
    stats = torch.stack([g * bag, h * bag, (bag > 0).to(_F32)], dim=-1)
    tree, row_leaf = stream_grow_tree(
        source, stats, fmask, hyper.ctx(), num_leaves, num_bins,
        hyper.max_depth, wave_width, hist_impl, hist_dtype)
    tree = _renew(tree, row_leaf, y, pred, w * bag, renew_alpha,
                  renew_scale)
    if is_rf:
        return tree, pred
    lr = torch.tensor(hyper.learning_rate, dtype=_F32, device=pred.device)
    return tree, fma(lr, tree.leaf_value[row_leaf.to(torch.int64)], pred)


def goss_host_select(g_abs: np.ndarray, bag: np.ndarray, goss_k,
                     top_rate: float, other_rate: float, seed: int):
    """GOSS's selection on the host, as the reference's streamed round
    draws it: the exact top ``k_top`` in-bag rows by ``|g|``
    (``argpartition``), then ``k_other`` of the remaining in-bag rows drawn
    uniformly without replacement by ``default_rng(seed)`` (an int, or a
    tuple such as streamed data parallelism's ``(seed, shard)``), each list
    sorted and zero-padded to its size.  Returns ``(row ids i64 [k_top +
    k_other], weights f32)``: 1 for a top row, ``(1 - top_rate) /
    other_rate`` for a sampled one, 0 for padding."""
    k_top, k_other = goss_k
    valid = bag > 0
    score = np.where(valid, g_abs, -1.0)
    k_top_eff = min(k_top, int(valid.sum()))
    if k_top_eff > 0:
        top_idx = np.sort(np.argpartition(-score, k_top_eff - 1)
                          [:k_top_eff].astype(np.int64))
    else:
        top_idx = np.empty(0, np.int64)
    is_top = np.zeros(score.shape[0], bool)
    is_top[top_idx] = True
    rest_idx = np.flatnonzero(valid & ~is_top)
    rng = np.random.default_rng(seed)
    k_other_eff = min(k_other, len(rest_idx))
    other_idx = np.sort(rng.choice(rest_idx, size=k_other_eff,
                                   replace=False))

    def pad_fill(idx, k):
        out = np.zeros(k, np.int64)
        out[:len(idx)] = idx
        fill = (np.arange(k) < len(idx)).astype(np.float32)
        return out, fill

    top_idx, top_fill = pad_fill(top_idx, k_top)
    other_idx, other_fill = pad_fill(other_idx, k_other)
    amp = np.float32((1.0 - top_rate) / max(other_rate, 1e-12))
    return (np.concatenate([top_idx, other_idx]),
            np.concatenate([top_fill, other_fill * amp]))


def stream_goss_round(store, obj, y, w, bag, pred, fmask, hyper, goss_k,
                      top_rate: float, other_rate: float, seed: int,
                      num_leaves: int, num_bins: int, hist_impl: str,
                      hist_dtype: str, wave_width: int, renew_alpha=None,
                      renew_scale=None):
    """One GOSS round with the rows sampled on the host before transfer
    (:func:`goss_host_select`, two host reads: ``|g|`` and the bag); one
    host gather of the sampled rows crosses to the device, the in-memory
    grower grows the tree on them (kernels B1 and B2 at the compacted
    shape), and one full pass of traversal over the store gives every
    row's value for ``fma(lr, value, pred)``."""
    g, h = obj.grad_hess(pred, y, w)
    idx_h, wt_h = goss_host_select(g.abs().cpu().numpy(), bag.cpu().numpy(),
                                   goss_k, top_rate, other_rate, seed)
    # GOSS at the source: only the k sampled rows cross to the device
    bins_h = store.gather_rows(idx_h)
    store.bytes_streamed += bins_h.nbytes
    dev = pred.device
    bins_c = torch.from_numpy(bins_h).to(dev)
    idx = torch.from_numpy(idx_h).to(dev)
    wt = torch.from_numpy(wt_h).to(dev)
    live = (bag[idx] > 0).to(_F32) * (wt > 0).to(_F32)
    wt = wt * live
    stats = torch.stack([g[idx] * wt, h[idx] * wt, live], dim=-1)
    tree, rl_c = grow_tree(bins_c, stats, fmask, hyper.ctx(), num_leaves,
                           num_bins, hyper.max_depth, hist_impl=hist_impl,
                           hist_dtype=hist_dtype, wave_width=wave_width)
    tree = _renew(tree, rl_c, y[idx], pred[idx], w[idx] * wt, renew_alpha,
                  renew_scale)
    lr = torch.tensor(hyper.learning_rate, dtype=_F32, device=dev)
    return tree, fma(lr, stream_tree_values(store, tree), pred)
