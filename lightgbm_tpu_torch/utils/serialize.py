"""Model persistence — the port of ``lightgbm_tpu/utils/serialize.py``.

Bin mappers and the JSON text model use the reference's schema, so a model
file written by either package loads in the other: ``booster_to_string``,
``save_booster`` (JSON text, or the packed ``.npz`` serving artifact) and
``load_booster_into`` (both formats).  A multiclass model stores the ``[K]``
class priors as its init score and ``[K, M]`` node arrays per round; a
linear-leaf tree adds ``linear_feat``/``linear_coef``.
:func:`dump_booster_dict` is ``Booster.dump_model``'s nested view.
"""

from __future__ import annotations

import numpy as np


def mapper_to_dict(mapper) -> dict:
    """BinMapper (+ attached EFB bundler) -> JSON-ready dict."""
    return {
        "upper_bounds": [ub.tolist() for ub in mapper.upper_bounds],
        "nan_bin": mapper.nan_bin.tolist(),
        "n_bins": mapper.n_bins.tolist(),
        "is_categorical": mapper.is_categorical.astype(int).tolist(),
        "bundler": (None if mapper.bundler is None else {
            "groups": mapper.bundler.groups,
            "default_bins": mapper.bundler.default_bins.tolist(),
        }),
    }


def mapper_from_dict(bm: dict):
    from ..dataset import BinMapper, FeatureBundler

    mapper = BinMapper(
        [np.asarray(ub, np.float64) for ub in bm["upper_bounds"]],
        np.asarray(bm["nan_bin"], np.int32),
        np.asarray(bm["n_bins"], np.int32),
        np.asarray(bm["is_categorical"], bool),
    )
    if bm.get("bundler"):
        mapper.bundler = FeatureBundler(
            bm["bundler"]["groups"], mapper.n_bins,
            np.asarray(bm["bundler"]["default_bins"], np.int64))
    return mapper


# ---------------------------------------------------------------------------
# The JSON text model (``Booster.save_model`` / ``Booster(model_file=...)``):
# one document with the params, the init score, the bin mapper and every
# tree's node arrays — the reference's schema, so files interchange both
# ways.
# ---------------------------------------------------------------------------

_FORMAT_VERSION = 1


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if hasattr(t, "detach") else \
        np.asarray(t)


def _tree_to_dict(tree) -> dict:
    d = {
        "split_feature": _host(tree.split_feature).tolist(),
        "split_bin": _host(tree.split_bin).tolist(),
        "left": _host(tree.left).tolist(),
        "right": _host(tree.right).tolist(),
        "leaf_value": _host(tree.leaf_value).astype(np.float64).tolist(),
        "is_leaf": _host(tree.is_leaf).astype(int).tolist(),
        "count": _host(tree.count).astype(np.float64).tolist(),
        "split_gain": _host(tree.split_gain).astype(np.float64).tolist(),
        "num_leaves": _host(tree.num_leaves).tolist(),
    }
    if tree.is_cat_split is not None:
        # sparse: only the categorical split nodes carry their left-bin
        # sets, keyed by the flat node index over the tree's node shape
        icb = _host(tree.is_cat_split).reshape(-1)
        cm = _host(tree.cat_mask)
        d["num_bins"] = int(cm.shape[-1])
        cm2 = cm.reshape(-1, cm.shape[-1])
        d["cat_splits"] = {str(i): np.flatnonzero(cm2[i]).tolist()
                           for i in np.flatnonzero(icb)}
        d["cat_shape"] = list(_host(tree.is_cat_split).shape)
    if tree.linear_feat is not None:
        d["linear_feat"] = _host(tree.linear_feat).tolist()
        d["linear_coef"] = _host(tree.linear_coef).astype(np.float64).tolist()
    return d


def _tree_from_dict(d: dict, device):
    from ..models.tree import tree_from_arrays

    cat = {}
    if "cat_splits" in d:
        shape = tuple(d["cat_shape"])
        size = int(np.prod(shape))
        icb = np.zeros(size, bool)
        cm = np.zeros((size, int(d["num_bins"])), bool)
        for k, bins_left in d["cat_splits"].items():
            icb[int(k)] = True
            cm[int(k), np.asarray(bins_left, np.int64)] = True
        cat = {"is_cat_split": icb.reshape(shape),
               "cat_mask": cm.reshape(shape + (cm.shape[-1],))}
    if "linear_feat" in d:
        cat["linear_feat"] = np.asarray(d["linear_feat"], np.int32)
        cat["linear_coef"] = np.asarray(d["linear_coef"], np.float32)
    return tree_from_arrays({
        "split_feature": np.asarray(d["split_feature"], np.int32),
        "split_bin": np.asarray(d["split_bin"], np.int32),
        "left": np.asarray(d["left"], np.int32),
        "right": np.asarray(d["right"], np.int32),
        "leaf_value": np.asarray(d["leaf_value"], np.float32),
        "is_leaf": np.asarray(d["is_leaf"], bool),
        "count": np.asarray(d["count"], np.float32),
        "split_gain": np.asarray(d["split_gain"], np.float32),
        "num_leaves": np.asarray(d["num_leaves"], np.int32),
        **cat,
    }, device)


def booster_to_string(booster, num_iteration=None,
                      start_iteration: int = 0) -> str:
    import json

    k = (len(booster.trees) if num_iteration is None or num_iteration <= 0
         else num_iteration)
    start = max(int(start_iteration), 0)
    trees = booster.trees[start:start + k]
    doc = {
        "format_version": _FORMAT_VERSION,
        "framework": "lightgbm_tpu",
        "params": booster.params_dict(),
        "init_score": np.asarray(booster.init_score_,
                                 dtype=np.float64).tolist(),
        "num_trees": len(trees),
        "best_iteration": int(booster.best_iteration),
        "feature_names": booster.feature_name() or None,
        "bin_mapper": mapper_to_dict(booster._bin_mapper_for_predict()),
        "trees": [_tree_to_dict(t) for t in trees],
    }
    return json.dumps(doc)


def save_booster(booster, filename: str, num_iteration=None,
                 start_iteration: int = 0) -> None:
    if filename.endswith(".npz"):
        # the packed serving artifact, validated on ingest
        from ..serving.packed import pack_booster

        pack_booster(booster, num_iteration=num_iteration,
                     start_iteration=start_iteration).save(filename)
        return
    with open(filename, "w") as f:
        f.write(booster_to_string(booster, num_iteration=num_iteration,
                                  start_iteration=start_iteration))


def dump_booster_dict(booster, num_iteration=None,
                      start_iteration: int = 0) -> dict:
    """LightGBM ``Booster.dump_model()``: a nested-dict view of the model
    with RAW-VALUE thresholds (bin bounds resolved through the bin
    mapper), as the reference's ``dump_booster_dict``.

    Categorical subset splits dump ``decision_type: '=='`` with the LEFT
    bin set; numeric splits ``'<='`` with the raw threshold.  Under EFB,
    ``split_feature`` is the ORIGINAL feature; thresholds on multi-member
    bundle columns stay in bundled-bin space, marked
    ``"bundled_bin_threshold": true``.  A multiclass round dumps one tree
    per class.
    """
    import sys

    start = max(int(start_iteration), 0)
    k = (len(booster.trees) if num_iteration is None or num_iteration <= 0
         else min(int(num_iteration), len(booster.trees) - start))
    mapper = booster._bin_mapper_for_predict()
    bundler = getattr(mapper, "bundler", None)
    multi_groups = (set() if bundler is None else
                    {c for c, g in enumerate(bundler.groups) if len(g) > 1})

    def node_dict(t: dict) -> dict:
        sf, sb = t["split_feature"], t["split_bin"]
        left, right, is_leaf = t["left"], t["right"], t["is_leaf"]
        vals = t["leaf_value"].astype(np.float64)
        gains = t["split_gain"].astype(np.float64)
        counts = t["count"].astype(np.float64)
        icb, cm = t.get("is_cat_split"), t.get("cat_mask")

        def rec(node: int) -> dict:
            if is_leaf[node] or left[node] < 0:
                return {"leaf_index": int(node),
                        "leaf_value": float(vals[node]),
                        "leaf_count": int(counts[node])}
            col = int(sf[node])
            thr_bin = int(sb[node])
            feat = (col if bundler is None else int(bundler.split_to_original(
                np.array([col]), np.array([thr_bin]))[0]))
            out = {
                "split_index": int(node),
                "split_feature": feat,
                "split_gain": float(gains[node]),
                "internal_count": int(counts[node]),
                "default_left": True,
                "left_child": rec(int(left[node])),
                "right_child": rec(int(right[node])),
            }
            if icb is not None and icb[node]:
                out["decision_type"] = "=="
                out["threshold"] = [int(b) for b in np.flatnonzero(cm[node])]
            elif col in multi_groups:
                # the threshold lives on the merged EFB bin axis
                out["decision_type"] = "<="
                out["threshold"] = thr_bin
                out["bundled_bin_threshold"] = True
            else:
                out["decision_type"] = "<="
                out["threshold"] = float(mapper.bin_upper_bound(feat,
                                                                thr_bin))
            return out

        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old_limit, 2 * len(sf) + 100))
        try:
            return rec(0)
        finally:
            sys.setrecursionlimit(old_limit)

    trees_info = []
    per_iter = booster.num_model_per_iteration()
    idx = start * per_iter
    shrink = float(getattr(booster, "_base_lr",
                           booster.params.learning_rate))
    for tree in booster.trees[start:start + k]:
        host = {name: _host(v) for name, v in zip(type(tree)._fields, tree)
                if v is not None}
        if host["split_feature"].ndim == 1:
            per_round = [host]
        else:
            per_round = [{name: (v[c] if v.ndim else v)
                          for name, v in host.items()}
                         for c in range(host["split_feature"].shape[0])]
        for t in per_round:
            trees_info.append({
                "tree_index": idx,
                "num_leaves": int(np.asarray(t["num_leaves"]).max()),
                "shrinkage": shrink,
                "tree_structure": node_dict(t),
            })
            idx += 1
    return {
        "name": "tree",
        "version": "lightgbm_tpu",
        "objective": booster.params.objective,
        "num_class": per_iter,
        "num_tree_per_iteration": per_iter,
        "max_feature_idx": booster.num_feature() - 1,
        "feature_names": booster.feature_name(),
        "tree_info": trees_info,
    }


def _load_params(booster, params: dict) -> None:
    from ..config import parse_params
    from ..objectives import create_objective

    params_dict = {k: v for k, v in params.items() if v is not None}
    params_dict.pop("metric", None)
    booster.params = parse_params(params_dict, warn_unknown=False)
    booster.params.metric = params.get("metric") or []
    booster.obj = create_objective(booster.params)
    booster._base_lr = float(booster.params.learning_rate)


def _reset_loaded(booster, trees, best_iteration, feature_names, mapper):
    booster.train_set = None
    booster.trees = trees
    booster.best_iteration = int(best_iteration)
    booster.best_score = {}
    booster._valid = []
    booster._forest_cache = None
    booster._iter = len(trees)
    booster._pred_train = None
    booster._bag = None
    booster._feature_names = feature_names
    booster._bin_mapper = mapper


def load_booster_into(booster, model_file=None, model_str=None) -> None:
    """Populate a bare Booster (with ``booster.device`` set) from a saved
    model: the JSON text model or a packed ``.npz`` serving artifact."""
    import json

    if model_file is not None and model_file.endswith(".npz"):
        _load_packed_into(booster, model_file)
        return
    if model_str is None:
        with open(model_file) as f:
            model_str = f.read()
    doc = json.loads(model_str)
    if doc.get("framework") != "lightgbm_tpu":
        raise ValueError("not a lightgbm_tpu model file")
    _load_params(booster, doc["params"])
    init = doc["init_score"]
    # a scalar for binary/regression, the [K] class priors for multiclass
    booster.init_score_ = (np.asarray(init, np.float32)
                           if isinstance(init, list) else float(init))
    trees = [_tree_from_dict(t, booster.device) for t in doc["trees"]]
    _reset_loaded(booster, trees, doc.get("best_iteration", -1),
                  doc.get("feature_names"), mapper_from_dict(doc["bin_mapper"]))


def _load_packed_into(booster, path: str) -> None:
    """Populate a bare Booster from a packed ``.npz`` artifact (validated
    on ingest; counts and gains are not stored, so they load as zeros)."""
    from ..models.tree import tree_from_arrays
    from ..serving.packed import PackedForest

    pf = PackedForest.load(path)
    _load_params(booster, pf.params)
    booster.init_score_ = (np.asarray(pf.init_score, np.float32)
                           if pf.num_class > 1 else float(pf.init_score[0]))
    num_leaves = np.sum(pf.is_leaf, axis=-1).astype(np.int32)   # [T(, K)]
    zeros = np.zeros(pf.split_feature.shape[1:], np.float32)
    cat = {name: getattr(pf, name) for name in ("is_cat_split", "cat_mask")
           if getattr(pf, name) is not None}
    trees = [tree_from_arrays({
        "split_feature": pf.split_feature[t], "split_bin": pf.split_bin[t],
        "left": pf.left[t], "right": pf.right[t],
        "leaf_value": pf.leaf_value[t], "is_leaf": pf.is_leaf[t],
        "count": zeros, "split_gain": zeros,
        "num_leaves": num_leaves[t], **{k: v[t] for k, v in cat.items()}},
        booster.device) for t in range(pf.num_trees)]

    _reset_loaded(booster, trees, pf.best_iteration, pf.feature_names,
                  pf.bin_mapper)
