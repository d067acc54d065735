"""graftlint launch budgets, counted from the port's own launches — the port
of the launch-budget part of ``lightgbm_tpu/analysis/budgets.py``.

The reference lowers each entry point to compiled HLO and counts the
fusions and custom calls of its dominant loop body: the r4/r5 lesson that
the training floor is launch count, not FLOPs.  The port has no HLO; it
counts what it runs, two ways for each of the reference's three entry
points (a strict split iteration, a fused-CV split iteration at E = 8, a
serving dispatch at bucket 8):

* ``*_cpu`` — the aten ops of one split iteration or dispatch on CPU
  tensors, counted by a ``TorchDispatchMode``: the CPU regression pin (the
  kernels' plain versions run there, so it pins the plain op structure);
* ``*_card`` — the CUDA launches (kernels, memsets and copies) of one split
  iteration or dispatch on the card, counted from ``torch.profiler``'s CUDA
  activity: B3 and B1 (strict), B3 and B6 (fused CV), B4 once per class
  (serving), each with the plain ops around it.

A split iteration's count is the difference of two whole trees' counts
(31 and 16 leaves) over the 15 iterations between them, so the root and
the tree's finish drop out.  Budgets are measured values + ~25 %
headroom, never aspirations.

The reference's recompile specs (XLA's compile caches) and its analytic
budget models (TPU constants) are not ported: ROADMAP item 17.  Torch is
imported inside the measurements, so ``lint`` without ``--budgets`` never
loads it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# a split iteration = (count(LEAVES_HI) - count(LEAVES_LO)) / (HI - LO)
LEAVES_LO, LEAVES_HI = 16, 31
# the card's figures behind the *_card ceilings (measured + ~25 %)
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _count_cpu_ops(fn: Callable[[], object]) -> int:
    """aten ops dispatched by ``fn()`` on CPU tensors."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            _Count.n += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        fn()
    return _Count.n


def _count_cuda_launches(fn: Callable[[], object]) -> int:
    """CUDA activity records (kernels, memsets, copies) of ``fn()``."""
    import torch
    from torch.autograd import DeviceType

    fn()                                   # builds, caches, allocator
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def _grow_fixture(device, num_features=7, num_bins=16, n=4096, e=None,
                  seed=0):
    """The reference's tiny grower fixture (never real data)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, num_bins, size=(
        n, num_features)).astype(np.uint8)).to(device)
    shape = (n,) if e is None else (n, e)
    g = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)
    ones = torch.ones(shape, dtype=torch.float32, device=device)
    stats = torch.stack([g, ones, ones], -1)
    return bins, stats


def split_iter_grow(device, e: Optional[int], num_leaves: int,
                    num_bins: int = 16) -> Callable[[], object]:
    """A call that grows one strict tree (``e`` None: B1 pairs and B3) or
    ``e`` trees of a fused-CV batch (B6 and B3) of ``num_leaves``."""
    import torch

    from ..models.gbdt import HyperScalars, HyperScalarsBatch
    from ..models.tree import grow_tree, grow_trees_batched

    bins, stats = _grow_fixture(device, e=e)
    nf = bins.shape[1]
    scal = HyperScalars(learning_rate=0.1, lambda_l1=0.0, lambda_l2=1.0,
                        min_data_in_leaf=3.0, min_sum_hessian=1e-3,
                        min_gain_to_split=0.0, max_depth=0)
    if e is None:
        fmask = torch.ones(nf, dtype=torch.float32, device=device)
        return lambda: grow_tree(bins, stats, fmask, scal.ctx(), num_leaves,
                                 num_bins, 0, wave_width=1)
    batch = HyperScalarsBatch(*(
        torch.full((e,), float(v), dtype=torch.float32, device=device)
        for v in scal))
    fmask = torch.ones((e, nf), dtype=torch.float32, device=device)
    return lambda: grow_trees_batched(bins, stats, fmask, batch.ctx(),
                                      batch.max_depth, num_leaves, num_bins,
                                      1)


def tiny_packed_forest(num_trees: int = 3, num_features: int = 2):
    """A hand-built, validated PackedForest: one root split per tree (the
    reference's fixture: instant, no training run)."""
    import numpy as np

    from ..dataset import BinMapper
    from ..serving.packed import PackedForest

    t, m = num_trees, 3
    split_feature = np.zeros((t, m), np.int32)
    split_bin = np.zeros((t, m), np.int32)          # go left on bin 0
    left = np.full((t, m), -1, np.int32)
    right = np.full((t, m), -1, np.int32)
    left[:, 0], right[:, 0] = 1, 2
    is_leaf = np.zeros((t, m), bool)
    is_leaf[:, 1:] = True
    leaf_value = np.zeros((t, m), np.float32)
    leaf_value[:, 1], leaf_value[:, 2] = -0.5, 0.5
    mapper = BinMapper(
        upper_bounds=[np.asarray([0.5]) for _ in range(num_features)],
        nan_bin=np.full(num_features, -1, np.int32),
        n_bins=np.full(num_features, 2, np.int32))
    return PackedForest(
        split_feature=split_feature, split_bin=split_bin,
        left=left, right=right, leaf_value=leaf_value, is_leaf=is_leaf,
        is_cat_split=None, cat_mask=None, shrink=1.0,
        init_score=np.zeros(1, np.float32), num_class=1,
        best_iteration=num_trees, depth_cap=1,
        params={"objective": "regression"},
        bin_mapper_dict=mapper.to_dict()).validate()


def serving_dispatch(device, bucket: int = 8) -> Callable[[], object]:
    """A call of one packed-forest bucket program (B4 on the card)."""
    import torch

    from ..serving.runtime import PredictorRuntime

    rt = PredictorRuntime(tiny_packed_forest(), max_bucket=max(bucket, 1),
                          device=device)
    codes = torch.zeros((bucket, rt.packed.num_feature()), dtype=torch.uint8,
                        device=device)
    mask = torch.ones(bucket, dtype=torch.float32, device=device)
    fn = rt._build_fn(raw_score=False)
    return lambda: fn(codes, mask, rt.packed.num_trees)


# ---------------------------------------------------------------------------
# declarative launch budgets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LaunchBudget:
    """One entry point, one measured launch count, one ceiling.

    ``kind`` selects the measurement: ``split_iter`` grows strict trees
    (``e`` None) or an E-batched fused-CV batch; ``serving_predict`` runs
    the packed-forest bucket program.  ``where`` is ``"cpu"`` (aten ops on
    CPU tensors) or ``"card"`` (CUDA launches on the card).  ``floor`` is
    the least count a real measurement shows (on the card, the kernels
    the entry point must launch): a profiler that lost the window's
    records reads below it and fails the check instead of passing it.
    """

    name: str
    budget: int
    kind: str = "split_iter"            # "split_iter" | "serving_predict"
    where: str = "cpu"                  # "cpu" | "card"
    e: Optional[int] = None
    bucket: int = 8
    floor: int = 1
    note: str = ""

    def measure(self) -> int:
        import torch

        if self.where == "card":
            device, count = torch.device("cuda", 0), _count_cuda_launches
        elif self.where == "cpu":
            device, count = torch.device("cpu"), _count_cpu_ops
        else:
            raise ValueError(f"unknown budget place {self.where!r}")
        if self.kind == "split_iter":
            lo = count(split_iter_grow(device, self.e, LEAVES_LO))
            hi = count(split_iter_grow(device, self.e, LEAVES_HI))
            return -(-(hi - lo) // (LEAVES_HI - LEAVES_LO))
        if self.kind == "serving_predict":
            return count(serving_dispatch(device, self.bucket))
        raise ValueError(f"unknown budget kind {self.kind!r}")

    def check(self) -> Dict[str, object]:
        measured = self.measure()
        return {"name": self.name, "kind": self.kind, "where": self.where,
                "measured": measured, "budget": self.budget,
                "floor": self.floor,
                "ok": self.floor <= measured <= self.budget,
                "note": self.note}


LAUNCH_BUDGETS: Tuple[LaunchBudget, ...] = (
    LaunchBudget("strict_cpu", 584,
                 note="strict split iteration, plain versions of B1 and B3; "
                      "aten ops on CPU tensors (measured 467; CPU "
                      "regression pin)"),
    LaunchBudget("cv_cpu", 573, e=8,
                 note="fused-CV split iteration at E = 8, plain versions "
                      "of B6 and B3; aten ops on CPU tensors (measured "
                      "458)"),
    LaunchBudget("serving_predict_b8_cpu", 63, kind="serving_predict",
                 note="bucket-8 dispatch, B4's plain version; aten ops on "
                      "CPU tensors (measured 50)"),
    LaunchBudget("strict_card", 45, where="card", floor=2,
                 note=f"B1 (two segments) + B3 + the plain ops around "
                      f"them per split iteration (measured 36, {CARD})"),
    LaunchBudget("cv_card", 48, where="card", e=8, floor=2,
                 note=f"B6 + B3 + the plain ops around them per fused-CV "
                      f"split iteration at E = 8 (measured 38, {CARD})"),
    LaunchBudget("serving_predict_b8_card", 5, kind="serving_predict",
                 where="card", floor=1,
                 note=f"B4 once per class + its wrapper's ops per bucket-8 "
                      f"dispatch (measured 4, {CARD})"),
)


def budget_by_name(name: str) -> LaunchBudget:
    for b in LAUNCH_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_launch_budgets(names: Optional[List[str]] = None
                         ) -> List[Dict[str, object]]:
    """Check ``names`` (default: every budget this host can measure — the
    ``*_card`` ones only with a CUDA device)."""
    if names is None:
        import torch

        card = torch.cuda.is_available()
        specs = [b for b in LAUNCH_BUDGETS if b.where == "cpu" or card]
    else:
        specs = [budget_by_name(n) for n in names]
    return [b.check() for b in specs]
