"""Forest prediction over binned rows — the port of ``lightgbm_tpu/ops/predict.py``.

Trees are tensors (struct of arrays), so traversal is a fixed-trip gather
loop: every row steps one level per iteration, and rows already at a leaf
stay put (self-loop), so the loop is a fixpoint after ``depth`` steps.

The serving path packs each class of a forest into a :class:`ForestSoA` —
depth-major node tables in the compact storage dtypes (uint8 thresholds,
int16 indices, int8/bf16 leaves for quantized forests) — and
:func:`predict_forest` sums every tree over it in one launch of the
hand-written CUDA kernel (``csrc/predict_forest.cu``, bound in
``kernels/predict.py``).  That is the port of the TPU kernel
``predict_forest_pallas``.  The wrapper dispatches on the device of the bins
tensor: a CPU tensor takes :func:`predict_forest_plain`, the plain PyTorch
version of the same function; a CUDA tensor launches the kernel or raises.
There is no fallback from one to the other.

:func:`predict_forest_binned` and :func:`predict_tree_binned` are the legacy
predictor over a stacked :class:`~lightgbm_tpu_torch.models.tree.Tree`; the
reference computes them with XLA ops outside Pallas, and categorical forests
(which the SoA tables do not carry) use them.  They are plain PyTorch here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DEFAULT_TREE_CHUNK = 32

# Node slots pad to a multiple of 128 and trees to the precision's chunk:
# the reference's layout contract, kept so the packed tables are the same
# arrays in both packages.
PREDICT_NODE_PAD = 128
PREDICT_TREE_CHUNKS = {"f32": 8, "bf16": 32, "int8": 32}

_NP_DTYPES = {"f32": (np.int32, np.int32, np.float32),
              "bf16": (np.int16, np.uint8, np.float32),
              "int8": (np.int16, np.uint8, np.int8)}


class ForestSoA(NamedTuple):
    """Depth-major SoA node tables of one class — the kernel's residency
    format.

    All tensors carry a leading padded tree axis ``Tp`` (a multiple of the
    precision's tree chunk) and a node axis ``Mp`` (a multiple of 128), in
    the compact storage dtypes of ``ops.quantize.PACKED_NODE_BYTES``.
    Leaves and dead slots self-loop (``left == right == self``), so
    traversal needs no ``is_leaf`` lookup: that table stays on the host,
    for the byte contract and for audits, whatever ``device`` the others
    are on.
    """

    split_feature: torch.Tensor  # [Tp, Mp] i16 (quantized) / i32 (f32)
    split_bin: torch.Tensor      # [Tp, Mp] u8 (quantized) / i32 (f32)
    left: torch.Tensor           # [Tp, Mp] i16 / i32 — self-loop at leaves
    right: torch.Tensor          # [Tp, Mp] i16 / i32 — self-loop at leaves
    leaf: torch.Tensor           # [Tp, Mp] i8 / bf16 / f32 leaf values
    is_leaf: torch.Tensor        # [Tp, Mp] bool, on the host
    scale: torch.Tensor          # [Tp] f32 per-tree dequant scale (1.0s
    #                              for f32/bf16)

    @property
    def precision(self) -> str:
        return {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.int8: "int8"}[self.leaf.dtype]


def soa_tree_chunk(soa: ForestSoA) -> int:
    """Tree chunk this SoA's dtypes pad to (8 or 32)."""
    narrow = min(soa.split_bin.element_size(), soa.leaf.element_size())
    return 8 if narrow >= 4 else 32


def _depth_major_order(left_t: np.ndarray, right_t: np.ndarray,
                       is_leaf_t: np.ndarray) -> np.ndarray:
    """BFS node permutation for one tree: every level's nodes contiguous
    (depth-major), unreachable slots appended last.  Terminates for any
    input because each frontier only admits unseen nodes."""
    m = left_t.shape[0]
    seen = np.zeros(m, bool)
    seen[0] = True
    frontier = np.array([0], np.int64)
    levels = []
    while frontier.size:
        levels.append(frontier)
        internal = frontier[~is_leaf_t[frontier]]
        kids = np.concatenate([left_t[internal], right_t[internal]])
        kids = np.unique(kids[(kids >= 0) & (kids < m)])
        kids = kids[~seen[kids]]
        seen[kids] = True
        frontier = kids
    dead = np.flatnonzero(~seen)
    return np.concatenate(levels + [dead]).astype(np.int64)


def pack_forest_soa(split_feature, split_bin, left, right, leaf_value,
                    is_leaf, *, precision: str = "f32",
                    leaf_scale=None, node_pad: int = PREDICT_NODE_PAD,
                    device="cpu") -> ForestSoA:
    """Host-side layout: per-node arrays of one class -> ForestSoA.

    Reorders every tree depth-major (BFS), folds leaves and dead slots into
    zero-leaf self-loops (grower sentinels in unreachable slots must never
    leak into a sum), pads nodes to a multiple of ``node_pad`` and trees to
    the precision's chunk, and keeps the compact storage dtypes.
    Thresholds stay the exact bin codes, so the kernel's ``code <=
    threshold`` is the same integer comparison at every precision.

    Args are host numpy arrays shaped ``[T, M]``; ``leaf_value`` is the
    precision's storage representation (i8 codes for int8, bf16-rounded
    values for bf16, plain f32 otherwise) and ``leaf_scale`` the int8
    per-tree dequant scale.  The tables the traversal reads land on
    ``device``; ``is_leaf`` stays on the host.
    """
    if precision not in PREDICT_TREE_CHUNKS:
        raise ValueError(f"precision must be one of "
                         f"{tuple(PREDICT_TREE_CHUNKS)}, got {precision!r}")
    feat = np.asarray(split_feature)
    thr = np.asarray(split_bin)
    left = np.asarray(left)
    right = np.asarray(right)
    leaf = np.asarray(leaf_value)
    is_leaf = np.asarray(is_leaf, bool)
    t, m = feat.shape

    mp = max(node_pad, -(-m // node_pad) * node_pad)
    chunk = PREDICT_TREE_CHUNKS[precision]
    tp = max(chunk, -(-t // chunk) * chunk)
    idx_t, thr_t, leaf_t = _NP_DTYPES[precision]
    if precision != "f32" and mp - 1 > np.iinfo(np.int16).max:
        raise ValueError(f"node capacity {mp} does not fit int16 indices")

    self_loop = np.arange(mp)
    o_feat = np.zeros((tp, mp), idx_t)
    o_thr = np.zeros((tp, mp), thr_t)
    o_left = np.broadcast_to(self_loop, (tp, mp)).astype(idx_t)
    o_right = o_left.copy()
    o_leaf = np.zeros((tp, mp), leaf_t)
    o_isleaf = np.ones((tp, mp), bool)

    for ti in range(t):
        perm = _depth_major_order(left[ti], right[ti], is_leaf[ti])
        inv = np.empty(m, np.int64)
        inv[perm] = np.arange(m)
        lf, at_leaf = leaf[ti][perm], is_leaf[ti][perm]
        l_old, r_old = left[ti][perm], right[ti][perm]
        internal = ~at_leaf & (l_old >= 0) & (r_old >= 0)
        new_i = np.arange(m)
        o_feat[ti, :m] = np.where(internal, feat[ti][perm], 0)
        o_thr[ti, :m] = np.where(internal, thr[ti][perm], 0)
        o_left[ti, :m] = np.where(internal, inv[np.clip(l_old, 0, m - 1)],
                                  new_i)
        o_right[ti, :m] = np.where(internal, inv[np.clip(r_old, 0, m - 1)],
                                   new_i)
        o_leaf[ti, :m] = np.where(at_leaf, lf, 0)
        o_isleaf[ti, :m] = ~internal

    scale = np.ones(tp, np.float32)
    if leaf_scale is not None:
        scale[:t] = np.asarray(leaf_scale, np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    leaf_dev = dev(o_leaf)
    if precision == "bf16":
        leaf_dev = leaf_dev.to(torch.bfloat16)   # exact: values are bf16
    return ForestSoA(
        split_feature=dev(o_feat), split_bin=dev(o_thr),
        left=dev(o_left), right=dev(o_right), leaf=leaf_dev,
        is_leaf=torch.from_numpy(o_isleaf), scale=dev(scale))


def tree_window(num_trees: int, num_iteration: int,
                start_iteration: int = 0):
    """Staged-predict window ``[t0, t1)`` clipped to ``[0, num_trees]``:
    trees outside it contribute nothing."""
    t0 = min(max(int(start_iteration), 0), num_trees)
    t1 = min(max(int(start_iteration) + int(num_iteration), t0), num_trees)
    return t0, t1


def forest_leaf_nodes(soa: ForestSoA, bins: torch.Tensor,
                      depth_cap: int) -> torch.Tensor:
    """Node each row reaches in each tree after ``depth_cap`` steps,
    ``[Tp, n]`` int64 (plain PyTorch).  A split feature outside ``[0, F)``
    reads code 0, as in the reference kernel."""
    n, f = bins.shape
    tp = soa.split_feature.shape[0]
    bins_t = bins.to(torch.int64).t()                      # [F, n]
    feat = soa.split_feature.to(torch.int64)
    thr = soa.split_bin.to(torch.int64)
    left = soa.left.to(torch.int64)
    right = soa.right.to(torch.int64)
    node = torch.zeros((tp, n), dtype=torch.int64, device=bins.device)
    for _ in range(int(depth_cap)):
        fi = feat.gather(1, node)
        ok = (fi >= 0) & (fi < f)
        code = torch.where(ok, bins_t.gather(0, fi.clamp(0, max(f - 1, 0))),
                           0)
        node = torch.where(code <= thr.gather(1, node),
                           left.gather(1, node), right.gather(1, node))
    return node


def forest_sums_plain(soa: ForestSoA, bins: torch.Tensor,
                      num_iteration: int, depth_cap: int,
                      start_iteration: int = 0) -> torch.Tensor:
    """``sum_t leaf_t(row) * scale_t`` over the staged window, f32 ``[n]``,
    accumulated one tree at a time in tree order — the plain PyTorch
    version of the kernel's arithmetic, rounding for rounding."""
    n = bins.shape[0]
    acc = torch.zeros(n, dtype=torch.float32, device=bins.device)
    t0, t1 = tree_window(soa.split_feature.shape[0], num_iteration,
                         start_iteration)
    if t0 == t1 or n == 0:
        return acc
    node = forest_leaf_nodes(soa, bins, depth_cap)
    lv = soa.leaf.to(torch.float32).gather(1, node)       # [Tp, n]
    for t in range(t0, t1):
        acc = acc + lv[t] * soa.scale[t]
    return acc


def predict_forest_plain(soa: ForestSoA, bins: torch.Tensor, learning_rate,
                         init_score, num_iteration: int, depth_cap: int,
                         start_iteration: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`predict_forest` (same contract)."""
    raw = forest_sums_plain(soa, bins, num_iteration, depth_cap,
                            start_iteration)
    return init_score + learning_rate * raw


def predict_forest(soa: ForestSoA, bins: torch.Tensor, learning_rate,
                   init_score, num_iteration: int, depth_cap: int,
                   start_iteration: int = 0) -> torch.Tensor:
    """Forest predict in one kernel launch: ``init_score + learning_rate *
    sum(masked, scaled leaf values)`` as f32 ``[n]``.

    ``bins`` is the binned batch ``[n, F]`` (uint8 on the card).  Trees
    ``[start_iteration, start_iteration + num_iteration)`` contribute; both
    are runtime arguments, as is ``depth_cap``, so nothing is specialised
    per model.  A CPU tensor takes :func:`predict_forest_plain`; a CUDA
    tensor launches the kernel or raises.
    """
    if bins.device.type == "cpu":
        return predict_forest_plain(soa, bins, learning_rate, init_score,
                                    num_iteration, depth_cap,
                                    start_iteration)
    if bins.device.type != "cuda":
        raise ValueError(f"predict_forest takes CPU or CUDA tensors, got "
                         f"{bins.device}")
    from ..kernels.predict import forest_sums

    t0, t1 = tree_window(soa.split_feature.shape[0], num_iteration,
                         start_iteration)
    raw = forest_sums(soa, bins, t0, t1, depth_cap)
    return init_score + learning_rate * raw


# ---------------------------------------------------------------------------
# legacy predictor over a stacked Tree (categorical forests)
# ---------------------------------------------------------------------------


def _advance(tree, bins_l: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """One traversal step for ``node`` ``[T, n]`` over trees ``[T, M]``."""
    n, f = bins_l.shape
    feat = tree.split_feature.to(torch.int64).gather(1, node)
    code = bins_l.t().gather(0, feat.clamp(0, f - 1))         # [T, n]
    go_left = code <= tree.split_bin.to(torch.int64).gather(1, node)
    if tree.is_cat_split is not None:
        nb = tree.cat_mask.shape[-1]
        m = tree.cat_mask.shape[-2]
        flat = tree.cat_mask.reshape(tree.cat_mask.shape[0], m * nb)
        cat_left = flat.gather(1, node * nb + code.clamp(0, nb - 1))
        go_left = torch.where(tree.is_cat_split.gather(1, node), cat_left,
                              go_left)
    nxt = torch.where(go_left, tree.left.to(torch.int64).gather(1, node),
                      tree.right.to(torch.int64).gather(1, node))
    return torch.where(tree.is_leaf.gather(1, node), node, nxt)


_NODE_FIELDS = ("split_feature", "split_bin", "left", "right", "leaf_value",
                "is_leaf", "is_cat_split", "cat_mask")


def map_node_arrays(tree, fn):
    """``tree`` with ``fn`` applied to every node array it carries."""
    return tree._replace(**{k: fn(getattr(tree, k)) for k in _NODE_FIELDS
                            if getattr(tree, k) is not None})


def predict_leaf_nodes(tree, bins: torch.Tensor,
                       max_depth_cap=None) -> torch.Tensor:
    """The node each row reaches in one tensorized tree (int64 ``[n]``).
    ``max_depth_cap=None`` iterates until every row sits on a leaf, bounded
    by node capacity so a malformed tree cannot hang; else exactly that many
    steps (the reference's ``_leaf_index``)."""
    t1 = map_node_arrays(tree, lambda a: a[None])   # a one-tree stack
    bins_l = bins.to(torch.int64)
    node = torch.zeros((1, bins.shape[0]), dtype=torch.int64,
                       device=bins.device)
    if max_depth_cap is None:
        capacity = tree.is_leaf.shape[-1]
        steps = 0
        while bool((~t1.is_leaf.gather(1, node)).any()) and steps < capacity:
            node = _advance(t1, bins_l, node)
            steps += 1
    else:
        for _ in range(int(max_depth_cap)):
            node = _advance(t1, bins_l, node)
    return node[0]


def predict_tree_binned(tree, bins: torch.Tensor,
                        max_depth_cap=None) -> torch.Tensor:
    """Leaf value per row for one tensorized tree (f32 ``[n]``, no
    shrinkage), at the node :func:`predict_leaf_nodes` reaches."""
    node = predict_leaf_nodes(tree, bins, max_depth_cap)
    return tree.leaf_value.to(torch.float32)[node]


def forest_depth_cap(forest) -> int:
    """Tight traversal bound: 1 + the deepest internal path in the forest.

    Host-side sweep over the node arrays, read back in one transfer:
    children are always created after their parent (higher node id), so one
    ascending id sweep settles all depths.
    """
    lr = torch.stack([torch.as_tensor(forest.left),
                      torch.as_tensor(forest.right)]).cpu().numpy()
    left = lr[0].reshape(-1, lr.shape[-1])
    right = lr[1].reshape(-1, lr.shape[-1])
    t, m = left.shape
    depth = np.zeros((t, m), np.int64)
    rows = np.arange(t)
    for node in range(m):
        lc, rc = left[:, node], right[:, node]
        has = lc >= 0
        d = depth[rows, node] + 1
        depth[rows[has], lc[has]] = d[has]
        has_r = rc >= 0
        depth[rows[has_r], rc[has_r]] = d[has_r]
    return int(depth.max()) + 1


def predict_forest_binned(
    forest,
    bins: torch.Tensor,
    learning_rate,
    init_score,
    num_iteration: int,
    max_depth_cap: int,
    start_iteration: int = 0,
    tree_chunk: int = DEFAULT_TREE_CHUNK,
) -> torch.Tensor:
    """Sum of trees ``[start_iteration, start_iteration + num_iteration)``
    over a stacked ``Tree`` (leading ``[T]`` axis), chunked over trees to
    bound the ``[chunk, n]`` node state; same contract as
    :func:`predict_forest`."""
    n = bins.shape[0]
    num_trees = forest.leaf_value.shape[0]
    bins_l = bins.to(torch.int64)
    acc = torch.zeros(n, dtype=torch.float32, device=bins.device)
    t_all = torch.arange(num_trees, device=bins.device)
    use_all = ((t_all >= int(start_iteration))
               & (t_all < int(start_iteration) + int(num_iteration)))
    chunk = max(1, min(int(tree_chunk), num_trees))
    for c0 in range(0, num_trees, chunk):
        sl = slice(c0, min(c0 + chunk, num_trees))
        part = map_node_arrays(forest, lambda a: a[sl])
        node = torch.zeros((sl.stop - sl.start, n), dtype=torch.int64,
                           device=bins.device)
        for _ in range(int(max_depth_cap)):
            node = _advance(part, bins_l, node)
        vals = part.leaf_value.to(torch.float32).gather(1, node)
        acc = acc + (vals * use_all[sl, None]).sum(dim=0)
    return init_score + learning_rate * acc
