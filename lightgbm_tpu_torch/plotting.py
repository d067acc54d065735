"""Plotting helpers (LightGBM ``lightgbm.plotting`` equivalents) — the port
of ``lightgbm_tpu/plotting.py``.

``plot_importance`` / ``plot_metric`` render with matplotlib (Agg-safe);
``create_tree_digraph`` emits Graphviz DOT **text** from ``dump_model`` so
tree visualization needs no graphviz binding installed — any DOT renderer
(or an online viewer) consumes it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _get_ax(ax, figsize):
    if ax is not None:
        return ax
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _, ax = plt.subplots(1, 1, figsize=figsize or (8, 5))
    return ax


def plot_importance(booster, ax=None, height: float = 0.2,
                    max_num_features: Optional[int] = None,
                    importance_type: str = "split",
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features", figsize=None, **kwargs):
    """Horizontal bar chart of feature importances (lightgbm.plot_importance).

    Accepts a Booster or a fitted sklearn wrapper.
    """
    b = getattr(booster, "_Booster", booster)
    imp = b.feature_importance(importance_type=importance_type)
    names = b.feature_name()
    order = np.argsort(imp)
    order = order[imp[order] > 0]
    if max_num_features is not None:
        order = order[-max_num_features:]
    ax = _get_ax(ax, figsize)
    ypos = np.arange(len(order))
    ax.barh(ypos, imp[order], height=height, align="center")
    ax.set_yticks(ypos)
    ax.set_yticklabels([names[i] for i in order])
    for y, v in zip(ypos, imp[order]):
        ax.text(v, y, f" {v:g}", va="center")
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return ax


def plot_metric(booster_or_evals: Any, metric: Optional[str] = None,
                dataset_names=None, ax=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "auto",
                figsize=None, **kwargs):
    """Line plot of recorded eval history (lightgbm.plot_metric).

    Accepts the ``evals_result`` dict captured by
    ``callback.record_evaluation`` (or a fitted sklearn wrapper exposing
    ``evals_result_``).
    """
    evals = getattr(booster_or_evals, "evals_result_", booster_or_evals)
    if not isinstance(evals, dict) or not evals:
        raise ValueError("plot_metric needs a non-empty evals_result dict "
                         "(use callbacks=[record_evaluation(d)])")
    ax = _get_ax(ax, figsize)
    picked = None
    for ds_name, metrics in evals.items():
        if dataset_names and ds_name not in dataset_names:
            continue
        for m_name, series in metrics.items():
            if metric is not None and m_name != metric:
                continue
            picked = m_name
            ax.plot(np.arange(1, len(series) + 1), series,
                    label=f"{ds_name} {m_name}")
    if picked is None:
        raise ValueError(f"metric {metric!r} not found in evals_result")
    ax.legend()
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(picked if ylabel == "auto" else ylabel)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8,
                               title: str = "Split value histogram for "
                                            "feature with @index/name@ "
                                            "@feature@",
                               xlabel: str = "Feature split value",
                               ylabel: str = "Count", figsize=None,
                               **kwargs):
    """Histogram of a feature's split THRESHOLD values across the forest
    (lightgbm.plot_split_value_histogram): where the model keeps cutting
    this feature.  ``feature`` is an index or a feature name.

    EFB note: splits on a multi-feature bundle column carry merged-axis
    bin indices, not raw values (``bundled_bin_threshold`` in dump_model)
    — those nodes are excluded rather than plotted on a wrong axis.
    """
    b = getattr(booster, "_Booster", booster)
    names = b.feature_name()
    if isinstance(feature, str):
        fname = feature
        if feature not in names:
            raise ValueError(f"unknown feature name {feature!r}")
    else:
        fname = names[int(feature)]
    values = []

    def rec(node):
        if "leaf_value" in node:
            return
        if names[node["split_feature"]] == fname and \
                node.get("decision_type", "<=") == "<=" and \
                not node.get("bundled_bin_threshold"):
            values.append(float(node["threshold"]))
        rec(node["left_child"])
        rec(node["right_child"])

    for info in b.dump_model()["tree_info"]:
        rec(info["tree_structure"])
    if not values:
        raise ValueError(
            f"feature {fname!r} is never used for numeric splits")
    ax = _get_ax(ax, figsize)
    counts, edges = np.histogram(values, bins=bins or "auto")
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax.bar(centers, counts,
           width=width_coef * (edges[1] - edges[0]), align="center")
    ax.set_title(title.replace("@index/name@", "name")
                 .replace("@feature@", str(fname)))
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return ax


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info=None, precision: int = 3,
                        **kwargs) -> str:
    """Graphviz DOT text for one tree (lightgbm.create_tree_digraph).

    Returns the DOT source as a string (write it to a .dot file or feed any
    renderer); no graphviz python binding required.
    """
    b = getattr(booster, "_Booster", booster)
    model = b.dump_model()
    info = model["tree_info"][tree_index]
    names = model.get("feature_names") or []
    lines = ["digraph Tree {", "  node [shape=box];"]
    counter = [0]

    def emit(node) -> str:
        nid = f"n{counter[0]}"
        counter[0] += 1
        if "leaf_value" in node:
            label = (f"leaf {node['leaf_index']}\\n"
                     f"value {node['leaf_value']:.{precision}g}\\n"
                     f"count {node['leaf_count']}")
            lines.append(f'  {nid} [label="{label}", style=rounded];')
            return nid
        f = node["split_feature"]
        fname = names[f] if f < len(names) else f"f{f}"
        thr = node["threshold"]
        if node["decision_type"] == "==":
            cond = f"{fname} in {thr}"
        else:
            thr_s = (f"{thr:.{precision}g}"
                     if isinstance(thr, float) else str(thr))
            cond = f"{fname} <= {thr_s}"
        label = (f"{cond}\\ngain {node['split_gain']:.{precision}g}\\n"
                 f"count {node['internal_count']}")
        lines.append(f'  {nid} [label="{label}"];')
        lid = emit(node["left_child"])
        rid = emit(node["right_child"])
        lines.append(f'  {nid} -> {lid} [label="yes"];')
        lines.append(f'  {nid} -> {rid} [label="no"];')
        return nid

    emit(info["tree_structure"])
    lines.append("}")
    return "\n".join(lines)
