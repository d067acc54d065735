"""Packed struct-of-arrays forest — the port of ``lightgbm_tpu/serving/packed.py``.

The serving artifact freezes a whole forest into one padded SoA stack
(``[T, capacity]`` arrays, ``[T, K, capacity]`` multiclass) plus everything a
standalone predictor needs at the edge: bin bounds for raw->binned
transformation, categorical masks, shrinkage, init scores and the
objective's params.  Arrays are host numpy here, as in the reference; the
runtime moves what it serves to the device.

The ``.npz`` artifact interchanges both ways with the reference: the same
array fields, the same ``meta_json`` schema and the same
``"framework": "lightgbm_tpu"`` tag.  :func:`packed_from_arrays` builds a
forest from exactly the numpy arrays and metadata a reference forest holds.
**Ingest validates the forest** (child indices in range, acyclic, every
reachable path ends at a closed leaf), so a corrupt or untrusted file fails
with :class:`PackedForestError` instead of hanging or mis-predicting; the
traversal depth cap is recomputed from the validated structure.
:func:`pack_booster` freezes a trained (or loaded) Booster into one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

PACKED_FORMAT_VERSION = 1

# npz entries that are numpy node arrays (everything else rides meta_json)
_ARRAY_FIELDS = ("split_feature", "split_bin", "left", "right",
                 "leaf_value", "is_leaf", "is_cat_split", "cat_mask")


class PackedForestError(ValueError):
    """A packed model file failed structural validation on ingest."""


@dataclass
class PackedForest:
    """One frozen, validated forest plus its edge-transform metadata.

    Node arrays are ``[T, M]`` (single model per round) or ``[T, K, M]``
    (multiclass: K trees per round).  ``M`` is the padded node capacity;
    unused slots carry the grower's sentinels (``is_leaf=False``,
    children ``-1``) and are unreachable from the root.
    """

    split_feature: np.ndarray           # i32 [T, (K,) M]
    split_bin: np.ndarray               # i32 [T, (K,) M]
    left: np.ndarray                    # i32 [T, (K,) M]
    right: np.ndarray                   # i32 [T, (K,) M]
    leaf_value: np.ndarray              # f32 [T, (K,) M]
    is_leaf: np.ndarray                 # bool [T, (K,) M]
    is_cat_split: Optional[np.ndarray]  # bool [T, (K,) M] or None
    cat_mask: Optional[np.ndarray]      # bool [T, (K,) M, B] or None
    shrink: float                       # predict-time shrinkage (1.0 for rf)
    init_score: np.ndarray              # f32 [K] (K=1 single-model)
    num_class: int
    best_iteration: int
    depth_cap: int                      # recomputed by validate()
    params: dict                        # booster params (objective, boosting)
    bin_mapper_dict: dict               # BinMapper.to_dict() payload
    feature_names: Optional[List[str]] = None
    _mapper_cache: object = field(default=None, repr=False, compare=False)

    # -- derived -----------------------------------------------------------
    @property
    def num_trees(self) -> int:
        return int(self.split_feature.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.split_feature.shape[-1])

    @property
    def bin_mapper(self):
        """Lazily rebuilt BinMapper for edge raw->binned transformation."""
        if self._mapper_cache is None:
            from ..dataset import BinMapper
            self._mapper_cache = BinMapper.from_dict(self.bin_mapper_dict)
        return self._mapper_cache

    def num_feature(self) -> int:
        return int(self.bin_mapper.num_features)

    def to_tree(self, device="cpu"):
        """The packed arrays as a stacked models.tree.Tree on ``device``."""
        import torch

        from ..models.tree import Tree

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        shape = self.split_feature.shape
        return Tree(
            split_feature=dev(self.split_feature, torch.int32),
            split_bin=dev(self.split_bin, torch.int32),
            left=dev(self.left, torch.int32),
            right=dev(self.right, torch.int32),
            leaf_value=dev(self.leaf_value, torch.float32),
            is_leaf=dev(self.is_leaf, torch.bool),
            count=torch.zeros(shape, dtype=torch.float32, device=device),
            split_gain=torch.zeros(shape, dtype=torch.float32, device=device),
            num_leaves=dev(np.sum(self.is_leaf, axis=-1), torch.int32),
            is_cat_split=(None if self.is_cat_split is None
                          else dev(self.is_cat_split, torch.bool)),
            cat_mask=(None if self.cat_mask is None
                      else dev(self.cat_mask, torch.bool)),
        )

    # -- validation --------------------------------------------------------
    def validate(self) -> "PackedForest":
        """Structural validation; recomputes ``depth_cap`` from the trees.

        Checks, per tree: root in range; every reachable internal node has
        BOTH children in ``[0, capacity)``; no node is reached twice
        (acyclic AND no shared subtrees — shared nodes would make the
        visited-count termination bound unsound); every reachable path
        terminates at an ``is_leaf`` node; leaf values finite.  Raises
        :class:`PackedForestError` on the first violation.
        """
        m = self.capacity
        sf = self.split_feature.reshape(-1, m)
        left = self.left.reshape(-1, m)
        right = self.right.reshape(-1, m)
        is_leaf = self.is_leaf.reshape(-1, m)
        vals = self.leaf_value.reshape(-1, m)
        n_feat = self.num_feature()
        bundler = getattr(self.bin_mapper, "bundler", None)
        n_cols = (bundler.num_columns if bundler is not None else n_feat)
        max_depth = 0
        for t in range(sf.shape[0]):
            visited = np.zeros(m, bool)
            stack = [(0, 0)]                       # (node, depth)
            while stack:
                node, d = stack.pop()
                if node < 0 or node >= m:
                    raise PackedForestError(
                        f"tree {t}: child index {node} out of range "
                        f"[0, {m})")
                if visited[node]:
                    raise PackedForestError(
                        f"tree {t}: node {node} reachable twice "
                        "(cycle or shared subtree)")
                visited[node] = True
                max_depth = max(max_depth, d)
                if is_leaf[t, node]:
                    if not np.isfinite(vals[t, node]):
                        raise PackedForestError(
                            f"tree {t}: non-finite leaf value at node "
                            f"{node}")
                    continue
                l, r = int(left[t, node]), int(right[t, node])
                if l < 0 or r < 0:
                    raise PackedForestError(
                        f"tree {t}: internal node {node} has dangling "
                        f"children ({l}, {r}) — path not closed by a leaf")
                f = int(sf[t, node])
                if f < 0 or f >= n_cols:
                    raise PackedForestError(
                        f"tree {t}: node {node} splits on feature {f} "
                        f"outside [0, {n_cols})")
                # depth-bounded by construction: visited-marking caps the
                # total pushes at m, so this loop always terminates
                stack.append((l, d + 1))
                stack.append((r, d + 1))
        self.depth_cap = max_depth + 1
        return self

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> str:
        """Write the versioned ``.npz`` serving artifact."""
        arrays = {}
        for name in _ARRAY_FIELDS:
            a = getattr(self, name)
            if a is not None:
                arrays[name] = np.asarray(a)
        meta = {
            "format_version": PACKED_FORMAT_VERSION,
            "framework": "lightgbm_tpu",
            "kind": "packed_forest",
            "shrink": float(self.shrink),
            "init_score": np.asarray(self.init_score,
                                     np.float64).tolist(),
            "num_class": int(self.num_class),
            "best_iteration": int(self.best_iteration),
            "depth_cap": int(self.depth_cap),
            "params": self.params,
            "bin_mapper": self.bin_mapper_dict,
            "feature_names": self.feature_names,
        }
        arrays["meta_json"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)
        return path

    @staticmethod
    def load(path: str, validate: bool = True) -> "PackedForest":
        """Read + (by default) structurally validate a ``.npz`` artifact."""
        with np.load(path, allow_pickle=False) as z:
            if "meta_json" not in z.files:
                raise PackedForestError(
                    f"{path}: not a lightgbm_tpu packed forest "
                    "(missing meta_json)")
            meta = json.loads(bytes(z["meta_json"]).decode())
            if meta.get("framework") != "lightgbm_tpu" or \
                    meta.get("kind") != "packed_forest":
                raise PackedForestError(
                    f"{path}: not a lightgbm_tpu packed forest")
            if int(meta.get("format_version", -1)) > PACKED_FORMAT_VERSION:
                raise PackedForestError(
                    f"{path}: packed format v{meta['format_version']} is "
                    f"newer than supported v{PACKED_FORMAT_VERSION}")
            missing = [f for f in _ARRAY_FIELDS[:6] if f not in z.files]
            if missing:
                raise PackedForestError(
                    f"{path}: missing node arrays {missing}")
            arrays = {f: z[f] for f in _ARRAY_FIELDS if f in z.files}
        pf = PackedForest(
            split_feature=arrays["split_feature"].astype(np.int32),
            split_bin=arrays["split_bin"].astype(np.int32),
            left=arrays["left"].astype(np.int32),
            right=arrays["right"].astype(np.int32),
            leaf_value=arrays["leaf_value"].astype(np.float32),
            is_leaf=arrays["is_leaf"].astype(bool),
            is_cat_split=(arrays["is_cat_split"].astype(bool)
                          if "is_cat_split" in arrays else None),
            cat_mask=(arrays["cat_mask"].astype(bool)
                      if "cat_mask" in arrays else None),
            shrink=float(meta["shrink"]),
            init_score=np.asarray(meta["init_score"], np.float32),
            num_class=int(meta["num_class"]),
            best_iteration=int(meta["best_iteration"]),
            depth_cap=int(meta["depth_cap"]),
            params=dict(meta["params"]),
            bin_mapper_dict=dict(meta["bin_mapper"]),
            feature_names=meta.get("feature_names"),
        )
        _check_shapes(pf, path)
        if validate:
            pf.validate()
        return pf

    # -- reference / fallback predictor --------------------------------------
    def predict_numpy(self, codes: np.ndarray,
                      num_iteration: Optional[int] = None,
                      raw_score: bool = True) -> np.ndarray:
        """Pure-numpy unbatched traversal over BINNED codes.

        The serving queue's graceful-degradation path (used when a device
        dispatch errors), the canary's oracle and the parity oracle in
        tests.  Vectorized over rows, sequential over trees; only the
        objective's output transform runs in torch, on the CPU, in f32.
        """
        k = self._resolve_k(num_iteration)
        n = codes.shape[0]
        codes = codes.astype(np.int64)
        nc = self.num_class
        sf = self.split_feature.reshape(self.num_trees, -1, self.capacity)
        sb = self.split_bin.reshape(sf.shape)
        lt = self.left.reshape(sf.shape)
        rt = self.right.reshape(sf.shape)
        lv = self.leaf_value.reshape(sf.shape)
        il = self.is_leaf.reshape(sf.shape)
        icb = (None if self.is_cat_split is None else
               self.is_cat_split.reshape(sf.shape))
        cmk = (None if self.cat_mask is None else
               self.cat_mask.reshape(sf.shape + (self.cat_mask.shape[-1],)))
        raw = np.tile(np.asarray(self.init_score, np.float64)[None, :],
                      (n, 1))                                   # [n, K]
        for t in range(k):
            for c in range(nc):
                node = np.zeros(n, np.int64)
                for _ in range(self.depth_cap):
                    leaf_here = il[t, c, node]
                    if leaf_here.all():
                        break
                    feat = sf[t, c, node]
                    code = codes[np.arange(n), np.maximum(feat, 0)]
                    go_left = code <= sb[t, c, node]
                    if icb is not None:
                        cat = icb[t, c, node]
                        go_left = np.where(
                            cat, cmk[t, c, node, code], go_left)
                    nxt = np.where(go_left, lt[t, c, node], rt[t, c, node])
                    node = np.where(leaf_here, node, nxt)
                raw[:, c] += self.shrink * lv[t, c, node]
        raw = self._rf_adjust(raw, k)
        out = raw if nc > 1 else raw[:, 0]
        if raw_score:
            return out.astype(np.float32)
        import torch

        raw = torch.as_tensor(out, dtype=torch.float32)
        return self._objective().transform(raw).numpy().astype(np.float32)

    # -- shared predict semantics (runtime + numpy fallback) -----------------
    def _resolve_k(self, num_iteration: Optional[int]) -> int:
        """LightGBM truncation contract shared with Booster.predict."""
        if num_iteration is None:
            k = (self.best_iteration if self.best_iteration > 0
                 else self.num_trees)
        elif num_iteration <= 0:
            k = self.num_trees
        else:
            k = num_iteration
        return min(int(k), self.num_trees)

    def _rf_adjust(self, raw: np.ndarray, k: int) -> np.ndarray:
        if self.params.get("boosting") == "rf" and k > 0:
            init = np.asarray(self.init_score, raw.dtype)[None, :]
            return (raw - init) / k + init
        return raw

    def _objective(self):
        from ..config import parse_params
        from ..objectives import create_objective

        params_dict = {kk: v for kk, v in self.params.items()
                       if v is not None}
        params_dict.pop("metric", None)
        return create_objective(parse_params(params_dict,
                                             warn_unknown=False))


def _check_shapes(pf: PackedForest, origin: str) -> None:
    expect_ndim = 3 if pf.num_class > 1 else 2
    for name in _ARRAY_FIELDS[:6]:
        a = getattr(pf, name)
        if a.ndim != expect_ndim or a.shape != pf.split_feature.shape:
            raise PackedForestError(
                f"{origin}: node array {name} has shape {a.shape}, "
                f"expected ndim={expect_ndim} matching split_feature "
                f"{pf.split_feature.shape}")


def packed_from_arrays(arrays: dict, meta: dict,
                       validate: bool = True) -> PackedForest:
    """Build a :class:`PackedForest` from numpy node arrays and metadata.

    ``arrays`` maps the node-array field names (``split_feature``,
    ``split_bin``, ``left``, ``right``, ``leaf_value``, ``is_leaf`` and,
    for categorical forests, ``is_cat_split`` and ``cat_mask``) to numpy
    arrays; ``meta`` holds ``shrink``, ``init_score``, ``num_class``,
    ``best_iteration``, ``params`` and ``bin_mapper`` (a BinMapper dict),
    optionally ``depth_cap`` and ``feature_names`` — the fields of the
    artifact's ``meta_json``, which are also the reference PackedForest's
    non-array fields (``bin_mapper_dict`` is accepted for ``bin_mapper``).
    """
    missing = [f for f in _ARRAY_FIELDS[:6] if arrays.get(f) is None]
    if missing:
        raise PackedForestError(f"missing node arrays {missing}")
    mapper = meta.get("bin_mapper", meta.get("bin_mapper_dict"))
    if mapper is None:
        raise PackedForestError("meta has no bin_mapper")

    def opt(name, dtype):
        a = arrays.get(name)
        return None if a is None else np.asarray(a).astype(dtype)

    pf = PackedForest(
        split_feature=np.asarray(arrays["split_feature"]).astype(np.int32),
        split_bin=np.asarray(arrays["split_bin"]).astype(np.int32),
        left=np.asarray(arrays["left"]).astype(np.int32),
        right=np.asarray(arrays["right"]).astype(np.int32),
        leaf_value=np.asarray(arrays["leaf_value"]).astype(np.float32),
        is_leaf=np.asarray(arrays["is_leaf"]).astype(bool),
        is_cat_split=opt("is_cat_split", bool),
        cat_mask=opt("cat_mask", bool),
        shrink=float(meta["shrink"]),
        init_score=np.atleast_1d(np.asarray(meta["init_score"], np.float32)),
        num_class=int(meta["num_class"]),
        best_iteration=int(meta["best_iteration"]),
        depth_cap=int(meta.get("depth_cap", 0)),
        params=dict(meta["params"]),
        bin_mapper_dict=dict(mapper),
        feature_names=meta.get("feature_names"),
    )
    _check_shapes(pf, "arrays")
    return pf.validate() if validate else pf


def pack_booster(booster, num_iteration: Optional[int] = None,
                 start_iteration: int = 0) -> PackedForest:
    """Freeze a trained or loaded Booster into a serving PackedForest.

    ``num_iteration``/``start_iteration`` follow save_model semantics: the
    artifact holds exactly the selected tree range, and its best_iteration
    is reset when the range is truncated.
    """
    if not booster.trees:
        raise ValueError("cannot pack a booster with no trees")
    if booster.trees[0].linear_feat is not None:
        raise NotImplementedError(
            "packed serving does not support linear_tree models yet "
            "(linear leaves need the raw feature matrix at the edge)")
    forest = booster._stacked_forest()
    t_real = len(booster.trees)
    start = max(int(start_iteration), 0)
    k = (t_real - start if num_iteration is None or num_iteration <= 0
         else min(int(num_iteration), t_real - start))
    if k <= 0:
        raise ValueError(
            f"empty tree selection: start_iteration={start_iteration}, "
            f"num_iteration={num_iteration}, num_trees={t_real}")
    sel = slice(start, start + k)
    best = booster.best_iteration
    if start > 0 or k < t_real:
        best = -1  # truncated forest: stored best no longer indexes it

    def np_sel(a, dtype):
        return a[sel].detach().cpu().numpy().astype(dtype)

    pf = PackedForest(
        split_feature=np_sel(forest.split_feature, np.int32),
        split_bin=np_sel(forest.split_bin, np.int32),
        left=np_sel(forest.left, np.int32),
        right=np_sel(forest.right, np.int32),
        leaf_value=np_sel(forest.leaf_value, np.float32),
        is_leaf=np_sel(forest.is_leaf, bool),
        is_cat_split=(None if forest.is_cat_split is None
                      else np_sel(forest.is_cat_split, bool)),
        cat_mask=(None if forest.cat_mask is None
                  else np_sel(forest.cat_mask, bool)),
        shrink=float(booster._shrink),
        init_score=np.atleast_1d(np.asarray(booster.init_score_,
                                            np.float32)),
        num_class=booster.num_model_per_iteration(),
        best_iteration=int(best),
        depth_cap=0,  # set by validate()
        params=booster.params_dict(),
        bin_mapper_dict=booster._bin_mapper_for_predict().to_dict(),
        feature_names=booster.feature_name() or None,
    )
    return pf.validate()
