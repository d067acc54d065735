"""The tensorized tree container — the port's copy of ``Tree`` from
``lightgbm_tpu/models/tree.py``.

A tree is a struct of arrays with a static node capacity.  Traversal rule
at internal node i: go left iff ``bin_code[row, split_feature[i]] <=
split_bin[i]`` for numeric splits; for categorical k-vs-rest splits
(``is_cat_split[i]``) go left iff ``cat_mask[i, bin_code[row,
split_feature[i]]]``.  Unused slots have ``is_leaf=False`` and are
unreachable.  Here the fields are torch tensors on one device; a forest
stacks trees on a leading ``[T]`` axis.  The growers wait for the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


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

    @property
    def capacity(self) -> int:
        return self.split_feature.shape[-1]
