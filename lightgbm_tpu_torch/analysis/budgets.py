"""graftlint's layer 2 — the port of ``lightgbm_tpu/analysis/budgets.py``:
launch budgets counted from the port's own launches, the analytic budget
models on the card's own figures, and the anchors that pin both to live
code.

**Launch budgets.** The reference lowers each entry point to compiled HLO
and counts the
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

**Analytic budget models** (pure arithmetic, every ``lint`` pass): nine
families — comm bytes, comm time, stream prefetch, streamed dp, serve SLO,
checkpoint, freshness, screen and sweep — with the reference's formulas,
specs and bars.  Every device constant is a figure measured on the card by
``chip_smoke.py`` phase 26 (its key beside each); every model function also
takes each constant as a keyword argument, so given the reference's TPU
constants it returns the reference's numbers to the bit.  A spec the
card's figures make miss its bar reports ``ok: false``; the known misses
(:data:`CARD_MISSES`, each a ROADMAP C fault) do not fail ``lint``, any
other miss does.  :data:`BUDGET_ANCHORS` pins each family to the port's
live symbols (pure ``ast``).

The reference's recompile specs measure XLA's compile caches, which the
port does not have, and are not ported.  Torch is imported inside the
launch measurements only, so nothing the default ``lint`` pass runs here
loads it.
"""

from __future__ import annotations

import math
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


# ---------------------------------------------------------------------------
# the card's constants (chip_smoke.py phase 26)
# ---------------------------------------------------------------------------
# Each device constant of the reference's models, measured on the card
# named by CARD; the phase 26 key each came from is in brackets.  Each
# value is the median of its readings over the runs of phase 26 that
# PERF.md §6 lists run by run, never one run's pick.  The reference's TPU
# figures are its own and appear nowhere here.  Shapes, bars, the daemon
# tick, the SLOs and the wire cell sizes are settings, not device
# figures, and keep the reference's values.
#
# [link] one ring hop of the port's merge on virtual shards of the one
# card: a device-to-device ``copy_`` in HBM, timed by CUDA events over
# back-to-back copies.  The rate is the slope between 64 MiB and 256 MiB
# copies (beyond the 50 MB L2, so HBM bounds it: each byte is read and
# written); the latency is a 1 B hop.  Distinct cards (NVLink peers) are
# not measured (ROADMAP "One card").
LINK_BYTES_PER_S = 1.52321e+12
LINK_HOP_LATENCY_S = 1.92384e-06
# [hist_equiv_flops] the models' unit of histogram work, 2·rows·B·3S·F,
# over B1's f32 time (CUDA events) at the reference block: 131,072 rows ×
# 136 features, B = 256, S = 2 segments.  B1 is a scatter of rows into
# shared-memory bins, not a matmul: this is the card's histogram rate in
# the reference's unit, and it holds at this shape.
HIST_EQUIV_FLOPS = 2.38668e+14
REF_ROWS_PER_SHARD = 131072
# [h2d] pinned host -> device copies on a side stream (the block store's
# copy stream), CUDA events: the rate is the slope between 1 B and one
# 131,072 × 136 block (17,825,792 B); the latency is the 1 B copy.
H2D_BYTES_PER_S = 5.34451e+10
H2D_PUT_LATENCY_S = 9.5504e-06
# [serve_dispatch] B4's wrapper plus its launch at bucket 8
# (``kernels.predict.forest_sums``, host time, no synchronize), and the
# rate of the scores' device -> pinned host copy (slope between 64 KiB
# and 1 MiB).
SERVE_DISPATCH_FIXED_S = 3.54904e-05
SERVE_GATHER_BYTES_PER_S = 7.16152e+10
# [ckpt] ``training.checkpoint.save_state_checkpoint`` on the card's host
# at 4 MiB and 64 MiB of state: the digest leg (the npz payload with its
# per-field crc32s, and its sha256) timed alone; the write leg (header,
# write, fsync, rename) is the rest, its line through the two sizes gives
# the rate and the fixed cost.  [train_rows] the north star's
# rows × rounds / s (phase 6, bf16, the median of its runs in turns).
HOST_WRITE_BYTES_PER_S = 7.57368e+08
CKPT_DIGEST_BYTES_PER_S = 3.93184e+08
CKPT_FIXED_LATENCY_S = 0.00237173
TRAIN_ROWS_PER_S = 2.58202e+07


# ---------------------------------------------------------------------------
# histogram-merge communication bytes (r9)
# ---------------------------------------------------------------------------
#
# Per-round bytes RECEIVED per shard for one merged histogram wave — the
# quantity the reduce-scatter merge shrinks.  A full psum (allreduce) must
# deliver the ENTIRE [S, F, B, 3] merged histogram to every shard; a
# reduce-scatter delivers only that shard's F/D feature slice, because
# split finding then runs on the slice and only an O(D) BestSplit gather
# follows.  The BestSplit gather is ~64 B/shard and is charged to every
# mode, so it never flatters the ratio.  The ring modes' wire bytes are the
# port's own hop messages (``ops.histogram.ring_reduce_scatter*`` through
# ``ops.quantize.wire_transfer``), byte for byte.

_WIRE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}


def hist_merge_comm_bytes(mode: str, n_shards: int, num_features: int,
                          num_bins: int, num_segments: int,
                          top_k: int = 20, dtype_bytes: int = 4,
                          wire_dtype: str = "f32", n_chunks: int = 4
                          ) -> Dict[str, int]:
    """Modeled communication for ONE merged histogram wave: received bytes
    per shard and the ring wire bytes for the same payload.

    ``num_segments`` is the wave width; histograms are ``[S, F, B, 3]``
    ``dtype_bytes`` cells.  ``voting`` charges the votes psum (int32 per
    feature per segment) plus the reduce-scatter over the padded candidate
    union ``Kc = min(2*top_k, F)``.  ``reduce_scatter_pipelined`` pads the
    feature axis to a ``D * n_chunks`` multiple; ``wire_dtype`` shrinks
    ring-hop cells to 2 B (bf16) or 1 B (int8, plus a 12 B scale sidecar
    per feature of each hop message) and needs a ring mode.
    """
    d = max(int(n_shards), 1)
    cell = num_bins * 3 * dtype_bytes
    full = num_segments * num_features * cell
    bestsplit = d * 16 * dtype_bytes       # O(D) BestSplit all-gather
    ring_modes = ("reduce_scatter_ring", "reduce_scatter_pipelined")
    if wire_dtype not in _WIRE_BYTES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}")
    if wire_dtype != "f32" and mode not in ring_modes:
        raise ValueError(
            f"wire_dtype={wire_dtype!r} models ring-hop compression and "
            f"needs a ring merge mode, not {mode!r}")
    if mode == "psum":
        recv = full
        wire = (2 * (d - 1) * full) // d
    elif mode == "reduce_scatter" or mode in ring_modes:
        chunks = max(int(n_chunks), 1) \
            if mode == "reduce_scatter_pipelined" else 1
        mult = d * chunks
        f_pad = -(-num_features // mult) * mult
        wcell = num_bins * 3 * _WIRE_BYTES[wire_dtype]
        # int8 hop messages carry a 12 B (3 f32 stats) scale sidecar per
        # FEATURE: (d-1)*chunks messages of f_pad/(d*chunks) features each
        sidecar = ((d - 1) * (f_pad // d) * 12
                   if wire_dtype == "int8" else 0)
        recv = num_segments * (f_pad // d) * wcell + sidecar
        wire = ((d - 1) * num_segments * f_pad * wcell) // d + sidecar
    elif mode == "voting":
        kc = min(2 * max(int(top_k), 1), num_features)
        kc_pad = -(-kc // d) * d
        votes = num_segments * num_features * 4
        recv = votes + num_segments * (kc_pad // d) * cell
        wire = (2 * (d - 1) * votes) // d \
            + ((d - 1) * num_segments * kc_pad * cell) // d
    else:
        raise ValueError(f"unknown histogram merge mode {mode!r}")
    return {"received_bytes_per_shard": recv + bestsplit,
            "ring_wire_bytes_per_shard": wire + bestsplit}


@dataclass(frozen=True)
class CommBudget:
    """One merge mode at one reference shape, one minimum drop vs psum
    (``psum_received / mode_received``; the r9 bar is >= 4x at D = 8).
    ``baseline_bytes``, when set, replaces the modeled psum as the
    reference byte count (the int8-wire gate against r9's shipped
    reduce-scatter figure, 104,960 B/shard)."""

    name: str
    mode: str
    min_drop_x: float
    n_shards: int = 8
    num_features: int = 136
    num_bins: int = 256
    num_segments: int = 2
    top_k: int = 20
    wire_dtype: str = "f32"
    n_chunks: int = 4
    baseline_bytes: Optional[int] = None
    note: str = ""

    def check(self) -> Dict[str, object]:
        base = hist_merge_comm_bytes(
            "psum", self.n_shards, self.num_features, self.num_bins,
            self.num_segments, self.top_k)
        ours = hist_merge_comm_bytes(
            self.mode, self.n_shards, self.num_features, self.num_bins,
            self.num_segments, self.top_k,
            wire_dtype=self.wire_dtype, n_chunks=self.n_chunks)
        ref = (self.baseline_bytes if self.baseline_bytes is not None
               else base["received_bytes_per_shard"])
        drop = ref / ours["received_bytes_per_shard"]
        return {"name": self.name, "mode": self.mode,
                "psum_bytes": ref,
                "measured": ours["received_bytes_per_shard"],
                "ring_wire_bytes": ours["ring_wire_bytes_per_shard"],
                "budget": int(ref / self.min_drop_x),
                "drop_x": round(drop, 2), "min_drop_x": self.min_drop_x,
                "ok": drop >= self.min_drop_x, "note": self.note}


# the r9 acceptance scenario: D=8, ragged F=136 (17/shard), B=256, a wave
# of 2 leaves: psum receives 835,584 B/shard, reduce-scatter 104,448 (an
# 8x drop against the >=4x floor)
COMM_BUDGETS: Tuple[CommBudget, ...] = (
    CommBudget("hist_rs_d8", "reduce_scatter", 4.0,
               note="r9 tentpole: F/D feature slice per shard"),
    CommBudget("hist_rs_ring_d8", "reduce_scatter_ring", 4.0,
               note="ppermute ring, same received payload as psum_scatter"),
    CommBudget("hist_voting_d8", "voting", 4.0,
               note="PV-Tree: votes psum + 2k-candidate union scatter"),
    CommBudget("hist_rs_pipelined_d8", "reduce_scatter_pipelined", 4.0,
               note="r10 tentpole: chunked ring, f32 wire, C=4"),
    CommBudget("hist_wire_int8_d8", "reduce_scatter_pipelined", 2.0,
               wire_dtype="int8", baseline_bytes=104_960,
               note="quantized wire vs r9 rs bytes (104,960 B/shard)"),
)


def comm_budget_by_name(name: str) -> CommBudget:
    for b in COMM_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_comm_budgets(names: Optional[List[str]] = None
                       ) -> List[Dict[str, object]]:
    specs = (COMM_BUDGETS if names is None
             else [comm_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# comm TIME model (r10): bytes -> milliseconds, overlap -> hidden fraction
# ---------------------------------------------------------------------------


def hist_merge_comm_time(mode: str, n_shards: int, num_features: int,
                         num_bins: int, num_segments: int,
                         top_k: int = 20, wire_dtype: str = "f32",
                         n_chunks: int = 4,
                         rows_per_shard: int = REF_ROWS_PER_SHARD, *,
                         link_bytes_per_s: float = LINK_BYTES_PER_S,
                         link_hop_latency_s: float = LINK_HOP_LATENCY_S,
                         hist_equiv_flops: float = HIST_EQUIV_FLOPS
                         ) -> Dict[str, float]:
    """Modeled wall clock of one merged wave: comm against overlapped
    histogram work.

    Comm charges the ring wire bytes at ``link_bytes_per_s`` plus
    ``link_hop_latency_s`` per hop message; compute is the wave's histogram
    work, ``2 * rows * B * 3S * F`` in the models' unit at
    ``hist_equiv_flops``.  Non-pipelined modes sit in program order between
    build and scan, so their comm is exposed; the pipelined mode's makespan
    is ``chunk_comm + (C-1) * max(chunk_comm, chunk_compute) +
    chunk_compute``, so when compute-bound ``hidden_frac -> 1 - 1/C``.
    """
    d = max(int(n_shards), 1)
    chunks = (max(int(n_chunks), 1)
              if mode == "reduce_scatter_pipelined" else 1)
    b = hist_merge_comm_bytes(
        mode, n_shards, num_features, num_bins, num_segments,
        top_k=top_k, wire_dtype=wire_dtype, n_chunks=n_chunks)
    if mode == "psum":
        hops = 2 * (d - 1)          # allreduce = scatter + gather phases
    elif mode == "voting":
        hops = 2 * (d - 1) + (d - 1)
    else:
        hops = (d - 1) * chunks     # one hop message per hop/chunk
    comm_s = (b["ring_wire_bytes_per_shard"] / link_bytes_per_s
              + hops * link_hop_latency_s)
    flops = 2.0 * rows_per_shard * num_bins * 3 * num_segments \
        * num_features
    compute_s = flops / hist_equiv_flops
    if mode == "reduce_scatter_pipelined":
        cc = comm_s / chunks
        ck = compute_s / chunks
        makespan = cc + (chunks - 1) * max(cc, ck) + ck
        exposed_s = max(makespan - compute_s, 0.0)
    else:
        exposed_s = comm_s
    hidden_s = comm_s - exposed_s
    return {"comm_ms": comm_s * 1e3, "compute_ms": compute_s * 1e3,
            "exposed_ms": exposed_s * 1e3, "hidden_ms": hidden_s * 1e3,
            "hidden_frac": hidden_s / comm_s if comm_s > 0 else 0.0,
            "compute_bound": compute_s / max(chunks, 1)
            >= comm_s / max(chunks, 1)}


@dataclass(frozen=True)
class CommTimeBudget:
    """Floor on the hidden fraction of merge comm at a reference shape (the
    r10 bar: >= 60 % hidden behind the histogram work at D=8/F=136/B=256)."""

    name: str
    mode: str
    min_hidden_frac: float
    n_shards: int = 8
    num_features: int = 136
    num_bins: int = 256
    num_segments: int = 2
    top_k: int = 20
    wire_dtype: str = "f32"
    n_chunks: int = 4
    rows_per_shard: int = REF_ROWS_PER_SHARD
    note: str = ""

    def check(self) -> Dict[str, object]:
        t = hist_merge_comm_time(
            self.mode, self.n_shards, self.num_features, self.num_bins,
            self.num_segments, top_k=self.top_k,
            wire_dtype=self.wire_dtype, n_chunks=self.n_chunks,
            rows_per_shard=self.rows_per_shard)
        frac = t["hidden_frac"]
        return {"name": self.name, "mode": self.mode,
                "measured": round(frac, 4),
                "budget": self.min_hidden_frac,
                "comm_ms": round(t["comm_ms"], 4),
                "exposed_ms": round(t["exposed_ms"], 4),
                "compute_ms": round(t["compute_ms"], 3),
                "ok": frac >= self.min_hidden_frac, "note": self.note}


COMM_TIME_BUDGETS: Tuple[CommTimeBudget, ...] = (
    CommTimeBudget("merge_hidden_pipelined_d8",
                   "reduce_scatter_pipelined", 0.60,
                   note="r10 acceptance: >=60% of merge time hidden"),
    CommTimeBudget("merge_hidden_pipelined_int8_d8",
                   "reduce_scatter_pipelined", 0.60, wire_dtype="int8",
                   note="int8 wire keeps the same overlap floor"),
)


def comm_time_budget_by_name(name: str) -> CommTimeBudget:
    for b in COMM_TIME_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_comm_time_budgets(names: Optional[List[str]] = None
                            ) -> List[Dict[str, object]]:
    specs = (COMM_TIME_BUDGETS if names is None
             else [comm_time_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# out-of-core streaming: the host -> device time model
# ---------------------------------------------------------------------------


def stream_prefetch_time(block_rows: int = REF_ROWS_PER_SHARD,
                         num_features: int = 136, num_bins: int = 256,
                         num_segments: int = 2, n_blocks: int = 8,
                         code_bytes: int = 1,
                         prefetch_blocks: int = 1, *,
                         h2d_bytes_per_s: float = H2D_BYTES_PER_S,
                         h2d_put_latency_s: float = H2D_PUT_LATENCY_S,
                         hist_equiv_flops: float = HIST_EQUIV_FLOPS
                         ) -> Dict[str, float]:
    """Modeled wall clock of one streamed histogram pass: transfer against
    overlapped histogram work under the block store's prefetch ring.

    Per block the copy moves ``block_rows * F * code_bytes`` at
    ``h2d_bytes_per_s`` (plus one put's latency); the compute term is the
    merge model's ``2 * block_rows * B * 3S * F`` at ``hist_equiv_flops``.
    The makespan is ``transfer + (K-1) * max(transfer, compute) +
    compute``: only the first block's copy is exposed when compute-bound.
    With ``prefetch_blocks`` >= 2 the next put's launch overlaps the copy
    in flight, so the steady state pays the link's byte time alone.  What
    the model leaves out: the host's work on each block (the port's crc32
    screen, its routing), which phase 22a finds is most of a streamed
    round.
    """
    k = max(int(n_blocks), 1)
    depth = max(int(prefetch_blocks), 1)
    bytes_per_block = float(block_rows) * num_features * code_bytes
    byte_s = bytes_per_block / h2d_bytes_per_s
    fill_s = byte_s + h2d_put_latency_s
    steady_s = byte_s + (h2d_put_latency_s if depth == 1 else 0.0)
    flops = 2.0 * block_rows * num_bins * 3 * num_segments * num_features
    compute_s = flops / hist_equiv_flops
    total_transfer_s = fill_s + (k - 1) * steady_s
    total_compute_s = k * compute_s
    makespan = (fill_s + (k - 1) * max(steady_s, compute_s)
                + compute_s)
    exposed_s = max(makespan - total_compute_s, 0.0)
    hidden_s = total_transfer_s - exposed_s
    return {"transfer_ms": total_transfer_s * 1e3,
            "compute_ms": total_compute_s * 1e3,
            "exposed_ms": exposed_s * 1e3,
            "hidden_ms": hidden_s * 1e3,
            "hidden_frac": (hidden_s / total_transfer_s
                            if total_transfer_s > 0 else 0.0),
            "compute_bound": compute_s >= steady_s}


@dataclass(frozen=True)
class StreamTimeBudget:
    """Floor on the hidden fraction of streamed-transfer time at a
    reference shape (the r11 bar: >= 60 % of a pass's copies hidden behind
    the histogram work at the 131,072 × 136 uint8 block)."""

    name: str
    min_hidden_frac: float
    block_rows: int = REF_ROWS_PER_SHARD
    num_features: int = 136
    num_bins: int = 256
    num_segments: int = 2
    n_blocks: int = 8
    code_bytes: int = 1
    prefetch_blocks: int = 1
    note: str = ""

    def check(self) -> Dict[str, object]:
        t = stream_prefetch_time(
            self.block_rows, self.num_features, self.num_bins,
            self.num_segments, n_blocks=self.n_blocks,
            code_bytes=self.code_bytes,
            prefetch_blocks=self.prefetch_blocks)
        frac = t["hidden_frac"]
        return {"name": self.name, "mode": "stream_prefetch",
                "measured": round(frac, 4),
                "budget": self.min_hidden_frac,
                "comm_ms": round(t["transfer_ms"], 4),
                "exposed_ms": round(t["exposed_ms"], 4),
                "compute_ms": round(t["compute_ms"], 3),
                "ok": frac >= self.min_hidden_frac, "note": self.note}


STREAM_TIME_BUDGETS: Tuple[StreamTimeBudget, ...] = (
    StreamTimeBudget("stream_prefetch_hidden_ref", 0.60,
                     note="r11 acceptance: >=60% of the host->device "
                          "transfer hidden behind the per-block histogram "
                          "pass"),
    StreamTimeBudget("stream_prefetch_hidden_strict_ref", 0.60,
                     num_segments=2, n_blocks=16,
                     note="deeper stores only hide more (1 - 1/K)"),
    StreamTimeBudget("stream_prefetch_hidden_deep_ref", 0.60,
                     prefetch_blocks=2,
                     note="r19 satellite: depth-2 lookahead overlaps the "
                          "put launch latency too"),
)


def stream_budget_by_name(name: str) -> StreamTimeBudget:
    for b in STREAM_TIME_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_stream_budgets(names: Optional[List[str]] = None
                         ) -> List[Dict[str, object]]:
    specs = (STREAM_TIME_BUDGETS if names is None
             else [stream_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# streamed x dp (r19): per-block-round merge overlap + the GOSS x wire
# combined byte model
# ---------------------------------------------------------------------------


def stream_dp_time_model(block_rows: int = REF_ROWS_PER_SHARD,
                         num_features: int = 136, num_bins: int = 256,
                         num_segments: int = 2,
                         n_blocks_per_shard: int = 8, n_shards: int = 8,
                         mode: str = "reduce_scatter_pipelined",
                         wire_dtype: str = "f32", n_chunks: int = 4,
                         code_bytes: int = 1,
                         prefetch_blocks: int = 1, *,
                         link_bytes_per_s: float = LINK_BYTES_PER_S,
                         link_hop_latency_s: float = LINK_HOP_LATENCY_S,
                         h2d_bytes_per_s: float = H2D_BYTES_PER_S,
                         h2d_put_latency_s: float = H2D_PUT_LATENCY_S,
                         hist_equiv_flops: float = HIST_EQUIV_FLOPS
                         ) -> Dict[str, float]:
    """Modeled wall clock of ONE streamed-dp histogram pass: the prefetch
    pipeline composed with one ring merge a block-round
    (``data/stream_dp.py``), a three-stage pipeline::

        span = h2d_fill + (K-1) * max(h2d, compute, merge)
               + compute + merge [+ gather]

    Exposed merge time is what the merge adds over the merge-free
    :func:`stream_prefetch_time` makespan, plus (reduce-scatter modes) the
    one gather of the feature-sharded accumulator a split iteration
    (``(D-1)/D`` of the f32 histogram; psum pays no gather).
    """
    k = max(int(n_blocks_per_shard), 1)
    d = max(int(n_shards), 1)
    base = stream_prefetch_time(
        block_rows, num_features, num_bins, num_segments, n_blocks=k,
        code_bytes=code_bytes, prefetch_blocks=prefetch_blocks,
        h2d_bytes_per_s=h2d_bytes_per_s,
        h2d_put_latency_s=h2d_put_latency_s,
        hist_equiv_flops=hist_equiv_flops)
    b = hist_merge_comm_bytes(
        mode, d, num_features, num_bins, num_segments,
        wire_dtype=wire_dtype, n_chunks=n_chunks)
    chunks = (max(int(n_chunks), 1)
              if mode == "reduce_scatter_pipelined" else 1)
    if mode == "psum":
        hops = 2 * (d - 1)
    else:
        hops = (d - 1) * chunks
    merge_s = (b["ring_wire_bytes_per_shard"] / link_bytes_per_s
               + hops * link_hop_latency_s)
    h2d_byte_s = float(block_rows) * num_features * code_bytes \
        / h2d_bytes_per_s
    steady_h2d_s = h2d_byte_s + (
        h2d_put_latency_s if max(int(prefetch_blocks), 1) == 1 else 0.0)
    fill_s = h2d_byte_s + h2d_put_latency_s
    compute_s = (2.0 * block_rows * num_bins * 3 * num_segments
                 * num_features) / hist_equiv_flops
    span = (fill_s + (k - 1) * max(steady_h2d_s, compute_s, merge_s)
            + compute_s + merge_s)
    # rs modes: ONE gather per split iteration of the (D-1)/D remote f32
    # slice; psum returns replicated partials every round instead
    hist_f32_bytes = (float(num_features) * num_bins * 3 * num_segments
                      * 4)
    gather_s = (0.0 if mode == "psum"
                else hist_f32_bytes * (d - 1) / d / link_bytes_per_s
                + (d - 1) * link_hop_latency_s)
    base_span_s = fill_s + (k - 1) * max(steady_h2d_s, compute_s) \
        + compute_s
    exposed_merge_s = max(span - base_span_s, 0.0) + gather_s
    total_merge_s = k * merge_s + gather_s
    hidden_s = max(total_merge_s - exposed_merge_s, 0.0)
    return {"pcie_ms": base["transfer_ms"],
            "compute_ms": base["compute_ms"],
            "merge_ms": total_merge_s * 1e3,
            "gather_ms": gather_s * 1e3,
            "exposed_merge_ms": exposed_merge_s * 1e3,
            "hidden_ms": hidden_s * 1e3,
            "merge_hidden_frac": (hidden_s / total_merge_s
                                  if total_merge_s > 0 else 0.0),
            "span_ms": (span + gather_s) * 1e3,
            "compute_bound": compute_s >= max(merge_s, steady_h2d_s)}


def stream_dp_bytes_model(rows_per_shard: int = REF_ROWS_PER_SHARD,
                          num_features: int = 136, num_bins: int = 256,
                          num_segments: int = 2, n_shards: int = 8,
                          top_rate: float = 0.1, other_rate: float = 0.1,
                          wire_dtype: str = "int8", n_chunks: int = 4,
                          code_bytes: int = 1,
                          iters_per_pass: int = 1) -> Dict[str, float]:
    """GOSS x wire compounding: the host->device plus ring bytes one shard
    moves a histogram pass, sampled with a lossy wire against the full-f32
    streamed-dp baseline.  GOSS at the source shrinks the host->device term
    by ``top_rate + other_rate``; the wire shrinks the ring-hop term.  Pure
    bytes: no device constant."""
    d = max(int(n_shards), 1)
    pcie_full = float(rows_per_shard) * num_features * code_bytes
    sample = min(max(float(top_rate) + float(other_rate), 0.0), 1.0)
    pcie_goss = pcie_full * sample
    full = hist_merge_comm_bytes(
        "reduce_scatter_pipelined", d, num_features, num_bins,
        num_segments, wire_dtype="f32", n_chunks=n_chunks)
    wire = hist_merge_comm_bytes(
        "reduce_scatter_pipelined", d, num_features, num_bins,
        num_segments, wire_dtype=wire_dtype, n_chunks=n_chunks)
    it = max(int(iters_per_pass), 1)
    ici_full = full["ring_wire_bytes_per_shard"] * it
    ici_wire = wire["ring_wire_bytes_per_shard"] * it
    baseline = pcie_full + ici_full
    combined = pcie_goss + ici_wire
    return {"pcie_baseline_bytes": pcie_full,
            "pcie_goss_bytes": pcie_goss,
            "ici_f32_bytes": ici_full,
            "ici_wire_bytes": ici_wire,
            "baseline_bytes": baseline,
            "combined_bytes": combined,
            "reduction_factor": (baseline / combined
                                 if combined > 0 else float("inf")),
            "pcie_factor": (pcie_full / pcie_goss
                            if pcie_goss > 0 else float("inf")),
            "ici_factor": (ici_full / ici_wire
                           if ici_wire > 0 else float("inf"))}


@dataclass(frozen=True)
class StreamDpBudget:
    """One streamed-dp line at the D=8/F=136/B=256 reference: a floor on
    :func:`stream_dp_time_model`'s merge-hidden fraction (``kind=
    "hidden"``) or on :func:`stream_dp_bytes_model`'s combined reduction
    (``kind="bytes"``)."""

    name: str
    kind: str                   # "hidden" | "bytes"
    floor: float
    n_shards: int = 8
    num_features: int = 136
    num_bins: int = 256
    num_segments: int = 2
    block_rows: int = REF_ROWS_PER_SHARD
    n_blocks_per_shard: int = 8
    mode: str = "reduce_scatter_pipelined"
    wire_dtype: str = "f32"
    n_chunks: int = 4
    top_rate: float = 0.1
    other_rate: float = 0.1
    note: str = ""

    def check(self) -> Dict[str, object]:
        if self.kind == "hidden":
            t = stream_dp_time_model(
                self.block_rows, self.num_features, self.num_bins,
                self.num_segments, self.n_blocks_per_shard,
                self.n_shards, self.mode, self.wire_dtype, self.n_chunks)
            measured = t["merge_hidden_frac"]
            detail = {"merge_ms": round(t["merge_ms"], 4),
                      "exposed_ms": round(t["exposed_merge_ms"], 4),
                      "compute_ms": round(t["compute_ms"], 3)}
        else:
            m = stream_dp_bytes_model(
                self.block_rows, self.num_features, self.num_bins,
                self.num_segments, self.n_shards, self.top_rate,
                self.other_rate, self.wire_dtype, self.n_chunks)
            measured = m["reduction_factor"]
            detail = {"baseline_mb": round(m["baseline_bytes"] / 1e6, 3),
                      "combined_mb": round(m["combined_bytes"] / 1e6, 3),
                      "pcie_factor": round(m["pcie_factor"], 2),
                      "ici_factor": round(m["ici_factor"], 2)}
        return {"name": self.name, "mode": f"stream_dp_{self.kind}",
                "measured": round(measured, 4), "budget": self.floor,
                "ok": measured >= self.floor, "note": self.note,
                **detail}


STREAM_DP_BUDGETS: Tuple[StreamDpBudget, ...] = (
    StreamDpBudget(
        "stream_dp_merge_hidden_ref", "hidden", 0.60,
        note="r19 acceptance: >=60% of the per-block-round ring merge "
             "hidden behind block compute at D=8/F=136/B=256"),
    StreamDpBudget(
        "stream_dp_merge_hidden_int8_ref", "hidden", 0.60,
        wire_dtype="int8",
        note="int8 wire shrinks hops 4x — overlap floor unchanged"),
    StreamDpBudget(
        "stream_dp_merge_hidden_psum_ref", "hidden", 0.60,
        mode="psum",
        note="the A/B baseline merge must also stay hidden (no gather "
             "term, 2x the ring bytes)"),
    StreamDpBudget(
        "stream_dp_goss_int8_bytes_ref", "bytes", 4.0,
        wire_dtype="int8",
        note="r19 acceptance: GOSS(0.1/0.1) x int8 wire moves >=4x "
             "fewer combined host->device + ring bytes than full-f32 "
             "streamed-dp"),
)


def stream_dp_budget_by_name(name: str) -> StreamDpBudget:
    for b in STREAM_DP_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_stream_dp_budgets(names: Optional[List[str]] = None
                            ) -> List[Dict[str, object]]:
    specs = (STREAM_DP_BUDGETS if names is None
             else [stream_dp_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# serving SLO budgets (r12): shed-before-miss + bounded fault inflation
# ---------------------------------------------------------------------------
# A fluid-limit queue model of the micro-batched server (capacity is
# ``max_batch / dispatch_s`` rows/s): below saturation waits are the
# coalescing delay plus one dispatch; past it, admission OFF lets the
# backlog grow until every admitted request misses its deadline, while
# admission ON (the ``deadline`` shed policy) holds the backlog where the
# predicted wait is the deadline, so misses -> 0 and sheds -> 1 - 1/util.
# Rejections are cheap and typed (``Overloaded`` at submit); a deadline miss
# burns a dispatch slot to serve nobody.  "Shed before miss."


def serve_queue_model(arrival_rps: float, dispatch_ms: float,
                      max_batch: int = 128, max_delay_ms: float = 5.0,
                      deadline_ms: float = 50.0,
                      shed_policy: str = "deadline"
                      ) -> Dict[str, float]:
    """Steady-state ``utilization``, ``served_frac``, ``shed_frac``,
    ``miss_frac`` and ``wait_ms`` of a micro-batched server under the fluid
    model above; ``shed_policy`` is "off" or "deadline"."""
    dispatch_s = dispatch_ms / 1e3
    deadline_s = deadline_ms / 1e3
    capacity_rps = max_batch / dispatch_s if dispatch_s > 0 else \
        float("inf")
    util = arrival_rps / capacity_rps if capacity_rps > 0 else \
        float("inf")
    if util <= 1.0:
        # stable: wait = batch fill time (capped by the delay bound) + 1
        # dispatch
        fill_s = (min(max_delay_ms / 1e3, max_batch / arrival_rps)
                  if arrival_rps > 0 else 0.0)
        wait_s = fill_s + dispatch_s
        miss = 0.0 if wait_s <= deadline_s else 1.0
        return {"utilization": util, "served_frac": 1.0 - miss,
                "shed_frac": 0.0, "miss_frac": miss,
                "wait_ms": wait_s * 1e3}
    if shed_policy == "off":
        # unbounded backlog: every admitted request eventually waits past
        # the deadline
        return {"utilization": util, "served_frac": 0.0,
                "shed_frac": 0.0, "miss_frac": 1.0,
                "wait_ms": float("inf")}
    # admission control pins the backlog at predicted wait == deadline
    served = 1.0 / util
    return {"utilization": util, "served_frac": served,
            "shed_frac": 1.0 - served, "miss_frac": 0.0,
            "wait_ms": deadline_ms}


def serve_fault_p99_model(deadline_ms: float = 50.0,
                          dispatch_ms: float = 2.0,
                          max_delay_ms: float = 5.0,
                          shedding: bool = True) -> Dict[str, float]:
    """p99 inflation under ONE injected device fault mid-predict: with
    admission control no served request waits longer than ``deadline +
    dispatch``; without it the tail is open-ended (modeled as one full
    deadline of backlog on top of the stall)."""
    clean_p99 = max_delay_ms + dispatch_ms
    if shedding:
        fault_p99 = deadline_ms + dispatch_ms
    else:
        fault_p99 = deadline_ms + clean_p99 + deadline_ms
    return {"clean_p99_ms": clean_p99, "fault_p99_ms": fault_p99,
            "inflation_x": fault_p99 / clean_p99 if clean_p99 > 0
            else float("inf")}


def serve_mesh_dispatch_model(n_devices: int, dispatch_ms: float = 2.0,
                              bucket: int = 16384,
                              out_bytes_per_row: int = 4, *,
                              serve_dispatch_fixed_s: float =
                              SERVE_DISPATCH_FIXED_S,
                              serve_gather_bytes_per_s: float =
                              SERVE_GATHER_BYTES_PER_S
                              ) -> Dict[str, float]:
    """Dispatch time of one dp-sharded bucket on ``n_devices`` devices:
    traversal divides by D, the fixed dispatch cost and the scores' gather
    do not.  Returns ``dispatch_ms_sharded``, ``speedup_x``, ``qps_x`` and
    ``overhead_frac`` (the fixed cost over the per-device compute slice)."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    t1 = dispatch_ms / 1e3
    compute = t1 / n_devices
    fixed = (0.0 if n_devices == 1 else
             serve_dispatch_fixed_s
             + bucket * out_bytes_per_row / serve_gather_bytes_per_s)
    td = compute + fixed
    return {"dispatch_ms_sharded": td * 1e3,
            "speedup_x": t1 / td,
            "qps_x": t1 / td,
            "overhead_frac": fixed / compute if compute > 0 else 0.0}


# -- B4 as the port builds it -------------------------------------------------
#
# Copies of the port's layout constants (``ops/predict.py``,
# ``ops/quantize.py``, ``kernels/predict.py``), kept here so the default
# lint pass imports no torch; tests/test_torch_budgets.py pins each to its
# live module.  The ForestSoA keeps the compact storage dtypes (i16 feature
# + u8 threshold + 2 x i16 child + i8/bf16 leaf + the is_leaf byte), and B4
# reads node tables of its own built beside it on the first launch: an
# 8-byte record and the slot's f32 ``leaf * scale`` at every precision.
PREDICT_NODE_PAD = 128
PREDICT_TREE_CHUNKS = {"f32": 8, "bf16": 32, "int8": 32}
PREDICT_SOA_NODE_BYTES = {"f32": 21, "bf16": 10, "int8": 9}
PACKED_SCALE_BYTES_PER_TREE = {"f32": 0, "bf16": 0, "int8": 4}
B4_RECORD_BYTES, B4_LEAF_VALUE_BYTES = 8, 4
SMEM_LIMIT = 232_448                # kSmemLimit: opt-in shared memory
_B4_PLAN = {"max_cluster": 8, "max_threads": 512, "target_blocks": 528,
            "min_rows": 4, "max_rows": 512, "value_bytes": 16 * 1024,
            "record_bytes": 32 * 1024, "staged_codes_limit": 32 * 1024}
# Launches per dispatch, counted from the code.  B4's wrapper around its one
# launch a class (serving_predict_b8_card measures 4 at one class); and the
# plain walk (``ops.predict.forest_sums_plain``, B4's plain version), the
# port's counterpart of the reference's per-node path: its ops before the
# walk (one more where the leaves widen to f32), a depth step's gathers,
# compares and selects, and a tree's multiply-add into the sum.
B4_WRAPPER_LAUNCHES = 3
PLAIN_WALK_FIXED_LAUNCHES = 8
PLAIN_WALK_STEP_LAUNCHES = 12
PLAIN_WALK_TREE_LAUNCHES = 2


def _align16(x: int) -> int:
    return (x + 15) & ~15


def b4_smem_bytes(num_features: int, mp: int, window: int, n: int) -> int:
    """Dynamic shared memory of one B4 block in the launch
    ``kernels.predict.plan(num_features, mp, window, n)`` picks."""
    p = _B4_PLAN
    per_block = max(1, -(-window // p["max_cluster"]))
    cluster = max(1, -(-window // per_block))
    rows = max(min(p["min_rows"], n),
               min(p["max_rows"], n, n * cluster // p["target_blocks"],
                   cluster * p["max_threads"]))
    if rows >= 32:
        rows -= rows % 32
    trees = max(1, min(per_block, p["value_bytes"] // (4 * rows)))
    prefix = 0
    if mp % 2 == 0:
        prefix = min(mp, p["record_bytes"] // (8 * trees) // 2 * 2)
    codes = (_align16(rows * num_features)
             if rows * num_features <= p["staged_codes_limit"] else 0)
    per = -(-rows // cluster)
    return (codes + _align16(4 * cluster * trees * per)
            + _align16(8 * trees * prefix) + 16)


def resident_model_bytes(num_trees: int, capacity: int, num_class: int = 1,
                         precision: str = "f32") -> int:
    """Device bytes one served model keeps resident: the packed layout
    (``ops.quantize.packed_model_bytes``) plus B4's node tables, 12 bytes
    a slot at every precision."""
    if precision not in PREDICT_SOA_NODE_BYTES:
        raise ValueError(f"precision must be one of "
                         f"{tuple(PREDICT_SOA_NODE_BYTES)}, got "
                         f"{precision!r}")
    slots = int(num_trees) * int(num_class) * int(capacity)
    return ((PREDICT_SOA_NODE_BYTES[precision] + B4_RECORD_BYTES
             + B4_LEAF_VALUE_BYTES) * slots
            + PACKED_SCALE_BYTES_PER_TREE[precision]
            * int(num_trees) * int(num_class))


def models_per_byte_gain(precision: str, num_trees: int = 200,
                         capacity: int = 509, num_class: int = 1) -> float:
    """How many models at ``precision`` fit in an f32 model's resident
    device bytes."""
    f32 = resident_model_bytes(num_trees, capacity, num_class, "f32")
    q = resident_model_bytes(num_trees, capacity, num_class, precision)
    return f32 / q


def predict_kernel_time(num_trees: int = 800, node_slots: int = 509,
                        depth_cap: int = 12, num_class: int = 1,
                        precision: str = "int8", bucket: int = 16384,
                        num_features: int = 32) -> Dict[str, float]:
    """Launch/shared-memory/HBM model of one B4 dispatch at the reference
    serving shape (an 800-tree, 255-leaf int8 forest serving full 16k
    buckets of 32 features).  Returns:

    * ``launches_fused`` / ``launches_plain_model`` / ``launch_drop_x`` —
      launches a dispatch: B4's wrapper and one launch a class, against
      the plain walk's (which relaunches its gathers every depth step and
      adds every tree's values in a launch of their own);
    * ``smem_block_bytes`` — one B4 block's dynamic shared memory in the
      launch the plan picks, against ``smem_limit_bytes``;
    * ``hbm_node_table_bytes`` / ``f32_node_table_bytes`` — what the
      served forest keeps resident (the ForestSoA and B4's node tables),
      and how much of it is f32 node data: B4's f32 leaf-value table at
      every precision, the SoA's own tables as well at f32;
    * ``hbm_bytes_per_row`` vs ``plain_hbm_bytes_per_row`` — per-row
      traffic with the tables amortized over the bucket: B4 reads uint8
      codes and its node tables; the plain walk widens codes and tables
      to int64.
    """
    if precision not in PREDICT_SOA_NODE_BYTES:
        raise ValueError(f"precision must be one of "
                         f"{tuple(PREDICT_SOA_NODE_BYTES)}, "
                         f"got {precision!r}")
    chunk = PREDICT_TREE_CHUNKS[precision]
    tp = max(chunk, -(-num_trees // chunk) * chunk)
    mp = max(PREDICT_NODE_PAD,
             -(-node_slots // PREDICT_NODE_PAD) * PREDICT_NODE_PAD)
    walk = (PLAIN_WALK_FIXED_LAUNCHES + (precision != "f32")
            + PLAIN_WALK_STEP_LAUNCHES * depth_cap
            + PLAIN_WALK_TREE_LAUNCHES * num_trees)
    launches_fused = B4_WRAPPER_LAUNCHES + num_class
    launches_plain = B4_WRAPPER_LAUNCHES + num_class * walk
    smem = b4_smem_bytes(num_features, mp, num_trees, bucket)

    slots = num_class * tp * mp
    soa_bytes = slots * PREDICT_SOA_NODE_BYTES[precision]
    b4_bytes = slots * (B4_RECORD_BYTES + B4_LEAF_VALUE_BYTES)
    scale_bytes = num_class * tp * 4
    f32_table = slots * B4_LEAF_VALUE_BYTES + (
        soa_bytes if precision == "f32" else 0)
    per_row = num_features * 1 + b4_bytes / bucket
    plain_per_row = num_features * 8 + slots * (4 * 8 + 4) / bucket
    return {
        "launches_fused": launches_fused,
        "launches_plain_model": launches_plain,
        "launch_drop_x": launches_plain / launches_fused,
        "smem_block_bytes": smem,
        "smem_limit_bytes": SMEM_LIMIT,
        "hbm_node_table_bytes": soa_bytes + b4_bytes,
        "hbm_scale_bytes": scale_bytes,
        "f32_node_table_bytes": f32_table,
        "hbm_bytes_per_row": per_row,
        "plain_hbm_bytes_per_row": plain_per_row,
        "bytes_per_row_drop_x": plain_per_row / per_row,
    }


def predict_kernels_summary(bucket: int = 8) -> Dict[str, object]:
    """The serving launch figures in one dict: the bucket's aten ops on CPU
    tensors (measured, torch loaded), B4's launches a dispatch against
    the ``serving_predict_b8_card`` ceiling, and the model above — so a
    report and the lint gate cannot disagree."""
    cpu = LaunchBudget("predict_summary_cpu", 0, kind="serving_predict",
                       bucket=bucket).measure()
    m = predict_kernel_time()
    budget = budget_by_name("serving_predict_b8_card").budget
    return {
        "predict_ops_cpu": cpu,
        "predict_launches_model": m["launches_fused"],
        "predict_budget_card": budget,
        "predict_within_budget": bool(m["launches_fused"] <= budget),
        "predict_launches_plain_model": m["launches_plain_model"],
        "predict_launch_drop_x": round(m["launch_drop_x"], 2),
        "predict_launch_drop_floor": 4.0,
        "predict_drop_within_floor": bool(m["launch_drop_x"] >= 4.0),
        "predict_smem_block_bytes": m["smem_block_bytes"],
        "predict_f32_node_table_bytes": m["f32_node_table_bytes"],
        "predict_hbm_bytes_per_row": round(m["hbm_bytes_per_row"], 1),
        "predict_plain_hbm_bytes_per_row":
            round(m["plain_hbm_bytes_per_row"], 1),
    }


@dataclass(frozen=True)
class ServeSLOBudget:
    """One serving SLO invariant at a reference operating point.

    ``kind`` selects the measurement: ``queue_miss`` (misses at
    ``utilization_x`` overload with admission on; <= 1 %),
    ``queue_miss_off`` (the same with admission off, budgeted from below:
    the model separates the policies), ``served_frac`` (throughput kept
    under shedding), ``fault_inflation`` (p99 under one device fault),
    ``models_per_byte`` (resident models per device byte against f32,
    :func:`models_per_byte_gain`), ``dp_overhead`` / ``dp_speedup`` (the
    dp route at ``mesh_devices``), ``fused_launch_drop`` (the plain walk's
    launches over B4's), ``fused_smem_bytes`` (one B4 block's shared
    memory, ceiling the card's opt-in limit) and ``fused_f32_table_bytes``
    (f32 node-table bytes resident at ``precision``: zero is the r18
    acceptance).  ``cmp`` is "le" or "ge".  Reference point: 2 ms
    dispatches, 128-row batches, 5 ms coalescing, 50 ms deadlines.
    """

    name: str
    kind: str
    budget: float
    cmp: str = "le"
    utilization_x: float = 2.0
    dispatch_ms: float = 2.0
    max_batch: int = 128
    max_delay_ms: float = 5.0
    deadline_ms: float = 50.0
    precision: str = "int8"
    mesh_devices: int = 8
    note: str = ""

    def measure(self) -> float:
        cap_rps = self.max_batch / (self.dispatch_ms / 1e3)
        arrival = self.utilization_x * cap_rps
        if self.kind in ("queue_miss", "queue_miss_off", "served_frac"):
            m = serve_queue_model(
                arrival, self.dispatch_ms, self.max_batch,
                self.max_delay_ms, self.deadline_ms,
                shed_policy=("off" if self.kind == "queue_miss_off"
                             else "deadline"))
            return m["served_frac"] if self.kind == "served_frac" \
                else m["miss_frac"]
        if self.kind == "fault_inflation":
            return serve_fault_p99_model(
                self.deadline_ms, self.dispatch_ms,
                self.max_delay_ms, shedding=True)["inflation_x"]
        if self.kind == "models_per_byte":
            return models_per_byte_gain(self.precision)
        if self.kind == "dp_overhead":
            return serve_mesh_dispatch_model(
                self.mesh_devices, self.dispatch_ms)["overhead_frac"]
        if self.kind == "dp_speedup":
            return serve_mesh_dispatch_model(
                self.mesh_devices, self.dispatch_ms)["speedup_x"]
        if self.kind == "fused_launch_drop":
            return predict_kernel_time(
                precision=self.precision)["launch_drop_x"]
        if self.kind == "fused_smem_bytes":
            return float(predict_kernel_time(
                precision=self.precision)["smem_block_bytes"])
        if self.kind == "fused_f32_table_bytes":
            return float(predict_kernel_time(
                precision=self.precision)["f32_node_table_bytes"])
        raise ValueError(f"unknown SLO budget kind {self.kind!r}")

    def check(self) -> Dict[str, object]:
        measured = self.measure()
        ok = (measured <= self.budget if self.cmp == "le"
              else measured >= self.budget)
        return {"name": self.name, "kind": self.kind,
                "measured": round(measured, 4), "budget": self.budget,
                "cmp": self.cmp, "ok": ok, "note": self.note}


SERVE_SLO_BUDGETS: Tuple[ServeSLOBudget, ...] = (
    ServeSLOBudget("serve_shed_before_miss", "queue_miss", 0.01,
                   note="r12 acceptance: <=1% deadline misses at 2x "
                        "overload with admission control on"),
    ServeSLOBudget("serve_miss_without_admission", "queue_miss_off",
                   0.99, cmp="ge",
                   note="counterfactual: admission off at 2x overload "
                        "misses ~everything — the model separates the "
                        "policies"),
    ServeSLOBudget("serve_capacity_under_shed", "served_frac", 0.45,
                   cmp="ge",
                   note="shedding keeps throughput at capacity: "
                        ">=45% of a 2x-overload arrival stream served"),
    ServeSLOBudget("serve_fault_p99_inflation", "fault_inflation", 8.0,
                   note="one device fault inflates p99 <=8x (capped at "
                        "deadline+dispatch by shed-before-miss)"),
    ServeSLOBudget("serve_int8_models_per_byte", "models_per_byte", 1.9,
                   cmp="ge", precision="int8",
                   note="r14 acceptance: an int8 model holds >=1.9x "
                        "models per device byte vs f32"),
    ServeSLOBudget("serve_bf16_models_per_byte", "models_per_byte", 1.5,
                   cmp="ge", precision="bf16",
                   note="bf16 residency floor: >=1.5x models per device "
                        "byte"),
    ServeSLOBudget("serve_dp_dispatch_overhead", "dp_overhead", 0.10,
                   mesh_devices=8,
                   note="fixed dp-shard dispatch cost (launch + output "
                        "gather) <=10% of the per-device compute slice "
                        "at D=8"),
    ServeSLOBudget("serve_dp_speedup_d4", "dp_speedup", 3.0, cmp="ge",
                   mesh_devices=4,
                   note="r14 acceptance: dp route delivers >=3x QPS at "
                        "D=4 under the dispatch model"),
    ServeSLOBudget("serve_fused_launch_drop", "fused_launch_drop", 4.0,
                   cmp="ge", precision="int8",
                   note="r18 acceptance: the fused kernel cuts launches "
                        "per dispatch >=4x vs the per-node path (here the "
                        "plain walk) at the reference forest"),
    ServeSLOBudget("serve_fused_smem_int8", "fused_smem_bytes",
                   float(SMEM_LIMIT), precision="int8",
                   note="one B4 block's dynamic shared memory fits the "
                        "card's opt-in limit (232,448 B) at the int8 "
                        "reference shape"),
    ServeSLOBudget("serve_fused_no_f32_table_int8",
                   "fused_f32_table_bytes", 0.0, precision="int8",
                   note="r18 acceptance: int8 residency keeps ZERO f32 "
                        "node-table bytes on the device"),
    ServeSLOBudget("serve_fused_no_f32_table_bf16",
                   "fused_f32_table_bytes", 0.0, precision="bf16",
                   note="bf16 residency likewise keeps no f32 node "
                        "table resident"),
)


def serve_slo_budget_by_name(name: str) -> ServeSLOBudget:
    for b in SERVE_SLO_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_serve_slo_budgets(names: Optional[List[str]] = None
                            ) -> List[Dict[str, object]]:
    specs = (SERVE_SLO_BUDGETS if names is None
             else [serve_slo_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# checkpoint-overhead budgets (r13): auto-checkpointing at the default
# cadence stays <= 5 % of round wall clock
# ---------------------------------------------------------------------------


def ckpt_overhead_time(n_rows: int = 11_000_000, num_leaves: int = 255,
                       trees_so_far: int = 200, rounds_between: int = 10,
                       num_class: int = 1, *,
                       host_write_bytes_per_s: float =
                       HOST_WRITE_BYTES_PER_S,
                       ckpt_digest_bytes_per_s: float =
                       CKPT_DIGEST_BYTES_PER_S,
                       ckpt_fixed_latency_s: float = CKPT_FIXED_LATENCY_S,
                       train_rows_per_s: float = TRAIN_ROWS_PER_S
                       ) -> Dict[str, float]:
    """Checkpoint cost against the training time between checkpoints.

    Bytes = the state vectors (``pred_train`` [n, K] + ``bag`` [n], f32)
    + the forest (29 B a node slot) + header/meta.  The write and the
    integrity digest are charged serially (both on the host thread between
    rounds) plus the fixed fsync/rename cost; the denominator is
    ``rounds_between`` rounds at ``train_rows_per_s``.
    """
    n_pad = -(-int(n_rows) // 256) * 256
    nodes = 2 * int(num_leaves) - 1
    node_bytes = 7 * 4 + 1
    state_bytes = 4 * n_pad * int(num_class) + 4 * n_pad
    forest_bytes = int(trees_so_far) * int(num_class) * nodes * node_bytes
    ckpt_bytes = state_bytes + forest_bytes + 4096
    write_s = ckpt_bytes / host_write_bytes_per_s
    digest_s = ckpt_bytes / ckpt_digest_bytes_per_s
    ckpt_s = write_s + digest_s + ckpt_fixed_latency_s
    round_s = int(n_rows) / train_rows_per_s
    span_s = max(int(rounds_between), 1) * round_s
    return {
        "ckpt_bytes": float(ckpt_bytes),
        "ckpt_mb": ckpt_bytes / 1e6,
        "write_ms": write_s * 1e3,
        "digest_ms": digest_s * 1e3,
        "ckpt_ms": ckpt_s * 1e3,
        "round_ms": round_s * 1e3,
        "overhead_frac": ckpt_s / span_s,
    }


@dataclass(frozen=True)
class CkptBudget:
    """One checkpoint-overhead invariant: ``cmp`` "le" for the acceptance
    bars, "ge" for a point that is MEANT to be expensive (the model must
    separate cadences)."""

    name: str
    budget: float
    cmp: str = "le"
    n_rows: int = 11_000_000
    num_leaves: int = 255
    trees_so_far: int = 200
    rounds_between: int = 10
    num_class: int = 1
    note: str = ""

    def check(self) -> Dict[str, object]:
        t = ckpt_overhead_time(
            self.n_rows, self.num_leaves, self.trees_so_far,
            self.rounds_between, self.num_class)
        frac = t["overhead_frac"]
        ok = frac <= self.budget if self.cmp == "le" else frac >= self.budget
        return {"name": self.name, "mode": "ckpt_overhead",
                "measured": round(frac, 5), "budget": self.budget,
                "cmp": self.cmp, "ckpt_mb": round(t["ckpt_mb"], 2),
                "ckpt_ms": round(t["ckpt_ms"], 2),
                "round_ms": round(t["round_ms"], 2),
                "ok": ok, "note": self.note}


CKPT_BUDGETS: Tuple[CkptBudget, ...] = (
    CkptBudget("ckpt_overhead_ref", 0.05,
               note="r13 acceptance: <=5% throughput overhead at "
                    "checkpoint_rounds=10, Higgs-scale rows, 200-tree "
                    "forest"),
    CkptBudget("ckpt_overhead_deep_forest", 0.05, trees_so_far=2000,
               note="the forest term stays amortized even at 2000 "
                    "trees (state vectors dominate at 11M rows)"),
    CkptBudget("ckpt_overhead_small_shard", 0.05, n_rows=1_048_576,
               trees_so_far=500,
               note="1M-row shard, 500 trees: fixed fsync+digest costs "
                    "still amortize under the default cadence"),
    CkptBudget("ckpt_every_round_uneconomic", 0.05, cmp="ge",
               n_rows=131_072, trees_so_far=500, rounds_between=1,
               note="guard-the-model: checkpointing EVERY round at one "
                    "131k-row shard costs >5% of the round — the "
                    "default cadence is load-bearing, not decorative"),
)


def ckpt_budget_by_name(name: str) -> CkptBudget:
    for b in CKPT_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_ckpt_budgets(names: Optional[List[str]] = None
                       ) -> List[Dict[str, object]]:
    specs = (CKPT_BUDGETS if names is None
             else [ckpt_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# freshness budgets (r15): the model-staleness SLO, decomposed
# ---------------------------------------------------------------------------
# staleness <= wait (daemon tick) + train (refresh_rounds rounds)
#            + publish (pack + atomic artifact write) + warm (the first
#            dispatch at each bucket) + canary (device dispatch + host
#            oracle replay) + flip
# at the reference shape (11M × 28 rows, 20 continuation rounds, 255-leaf
# trees, a ~220-tree forest, 4 warmed buckets, 8 canary rows): 60 s.
# ``pipeline/staleness.py`` measures the same legs on the card.
#
# [warm] the first dispatch at a new bucket of a warmed runtime, host time
# to its scores: the port compiles nothing per shape, so this is a
# dispatch, not a compile.  [canary] the canary's host oracle replay
# (``PackedForest``'s numpy walk) a row and tree.  [flip] the flip leg of
# phase 25a's unfaulted generations (their median).
WARM_S_PER_SHAPE = 0.000941856
DAEMON_TICK_S = 1.0
CANARY_ORACLE_S_PER_ROW_TREE = 2.08016e-05
FLIP_S = 4.147e-06
FRESHNESS_SLO_S = 60.0


def staleness_model(n_rows: int = 11_000_000, refresh_rounds: int = 20,
                    num_leaves: int = 255, trees_total: int = 220,
                    num_class: int = 1, warm_shapes: int = 4,
                    canary_rows: int = 8,
                    tick_s: float = DAEMON_TICK_S,
                    screen_round_factor: float = 1.0, *,
                    train_rows_per_s: float = TRAIN_ROWS_PER_S,
                    host_write_bytes_per_s: float = HOST_WRITE_BYTES_PER_S,
                    ckpt_fixed_latency_s: float = CKPT_FIXED_LATENCY_S,
                    warm_s_per_shape: float = WARM_S_PER_SHAPE,
                    serve_dispatch_fixed_s: float = SERVE_DISPATCH_FIXED_S,
                    canary_oracle_s_per_row_tree: float =
                    CANARY_ORACLE_S_PER_ROW_TREE,
                    flip_s: float = FLIP_S) -> Dict[str, float]:
    """Closed-form staleness decomposition at one operating point.

    ``trees_total`` is the forest size after the refresh (a cold retrain
    sets ``refresh_rounds = trees_total``).  ``screen_round_factor`` scales
    the train leg's rounds by EMA screening's amortized factor
    (:func:`feature_screen_time_model`).  Returns each leg, ``staleness_s``
    and ``train_frac``.
    """
    round_s = int(n_rows) / train_rows_per_s * float(screen_round_factor)
    train_s = max(int(refresh_rounds), 0) * round_s
    nodes = 2 * int(num_leaves) - 1
    node_bytes = 7 * 4 + 1
    artifact_bytes = (int(trees_total) * int(num_class) * nodes
                      * node_bytes + 4096)
    publish_s = artifact_bytes / host_write_bytes_per_s \
        + ckpt_fixed_latency_s
    warm_s = int(warm_shapes) * warm_s_per_shape
    canary_s = (2 * serve_dispatch_fixed_s
                + int(canary_rows) * int(trees_total) * int(num_class)
                * canary_oracle_s_per_row_tree)
    staleness_s = (float(tick_s) + train_s + publish_s + warm_s
                   + canary_s + flip_s)
    return {
        "wait_s": float(tick_s),
        "train_s": train_s,
        "publish_s": publish_s,
        "warm_s": warm_s,
        "canary_s": canary_s,
        "flip_s": flip_s,
        "artifact_mb": artifact_bytes / 1e6,
        "staleness_s": staleness_s,
        "train_frac": train_s / staleness_s,
    }


@dataclass(frozen=True)
class FreshnessBudget:
    """One staleness invariant: ``metric`` is a :func:`staleness_model`
    output ("staleness_s" or "train_frac"), ``cmp`` "le" for the bars and
    "ge" for the points MEANT to breach (refresh against retrain)."""

    name: str
    budget: float
    cmp: str = "le"
    metric: str = "staleness_s"
    n_rows: int = 11_000_000
    refresh_rounds: int = 20
    num_leaves: int = 255
    trees_total: int = 220
    num_class: int = 1
    warm_shapes: int = 4
    canary_rows: int = 8
    tick_s: float = DAEMON_TICK_S
    # a keep ratio prices the train leg under EMA screening
    screen_keep_ratio: Optional[float] = None
    screen_refresh_rounds: int = 10
    screen_num_features: int = 136
    note: str = ""

    def check(self) -> Dict[str, object]:
        factor = 1.0
        if self.screen_keep_ratio is not None:
            factor = feature_screen_time_model(
                n_rows=self.n_rows,
                num_features=self.screen_num_features,
                keep_ratio=self.screen_keep_ratio,
                refresh_rounds=self.screen_refresh_rounds,
            )["avg_round_factor"]
        t = staleness_model(
            self.n_rows, self.refresh_rounds, self.num_leaves,
            self.trees_total, self.num_class, self.warm_shapes,
            self.canary_rows, self.tick_s,
            screen_round_factor=factor)
        measured = t[self.metric]
        ok = (measured <= self.budget if self.cmp == "le"
              else measured >= self.budget)
        return {"name": self.name, "mode": "freshness",
                "metric": self.metric, "measured": round(measured, 4),
                "budget": self.budget, "cmp": self.cmp,
                "train_s": round(t["train_s"], 3),
                "warm_s": round(t["warm_s"], 3),
                "canary_s": round(t["canary_s"], 5),
                "staleness_s": round(t["staleness_s"], 3),
                "screen_round_factor": round(factor, 4),
                "ok": ok, "note": self.note}


FRESHNESS_BUDGETS: Tuple[FreshnessBudget, ...] = (
    FreshnessBudget("freshness_slo_ref", FRESHNESS_SLO_S,
                    note="r15 acceptance: 20 continuation rounds at "
                         "Higgs-scale rows land a fresh model inside "
                         "the 60 s staleness SLO, warm+canary "
                         "included"),
    FreshnessBudget("freshness_train_warm_canary_ref", FRESHNESS_SLO_S,
                    tick_s=0.0,
                    note="train + warm + canary (+publish/flip) <= SLO "
                         "with the wait leg excluded"),
    FreshnessBudget("freshness_small_shard_fast", 5.0, n_rows=1_048_576,
                    refresh_rounds=5, trees_total=120,
                    note="a 1M-row shard refresh of 5 rounds serves "
                         "fresh in under 5 s — the interactive "
                         "operating point"),
    FreshnessBudget("freshness_train_bound_ref", 0.5, cmp="ge",
                    metric="train_frac",
                    note="decomposition shape: the train leg dominates "
                         "staleness at the reference shape"),
    FreshnessBudget("freshness_cold_retrain_blows_slo", FRESHNESS_SLO_S,
                    cmp="ge", refresh_rounds=220,
                    note="guard-the-model: retraining the full "
                         "220-tree forest from scratch at the same "
                         "shape CANNOT meet the SLO — continuation is "
                         "load-bearing, not an optimization"),
    FreshnessBudget("freshness_screen_train_leg", 20.0,
                    screen_keep_ratio=0.25,
                    note="r20: EMA-FS screening at keep=0.25/F=136 "
                         "lands total staleness well inside the SLO"),
)


def freshness_budget_by_name(name: str) -> FreshnessBudget:
    for b in FRESHNESS_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_freshness_budgets(names: Optional[List[str]] = None
                            ) -> List[Dict[str, object]]:
    specs = (FRESHNESS_BUDGETS if names is None
             else [freshness_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# feature screening budgets (r20)
# ---------------------------------------------------------------------------
# EMA-FS screening compacts each non-refresh round to F_active =
# max(1, ceil(keep_ratio * F)) columns.  A round splits into an F-scaling
# part (histograms, split scans, merges) and an F-invariant part; every
# refresh_rounds-th round runs full width, so the amortized factor is the
# mean of one full and refresh_rounds - 1 screened rounds.
#
# [round_f_axis] the share of a north-star round that scales with F: the
# north star's rounds at its 28 columns and at 7, on the line t = a + b·F.
ROUND_F_AXIS_FRAC = 0.0332539


def active_feature_count(num_features: int, keep_ratio: float) -> int:
    """``models.feature_mask.active_feature_count``: ``ceil(keep_ratio *
    F)``, at least 1 (a copy, so lint imports no torch)."""
    return max(1, int(math.ceil(float(keep_ratio) * int(num_features))))


def feature_screen_time_model(n_rows: int = 11_000_000,
                              num_features: int = 136,
                              keep_ratio: float = 0.25,
                              refresh_rounds: int = 10,
                              n_shards: int = 8, num_bins: int = 256,
                              num_segments: int = 2,
                              wire_dtype: str = "f32", *,
                              round_f_axis_frac: float = ROUND_F_AXIS_FRAC,
                              train_rows_per_s: float = TRAIN_ROWS_PER_S
                              ) -> Dict[str, float]:
    """Closed-form round-time / comm decomposition of EMA screening:
    ``avg_round_factor`` (one full + ``refresh_rounds - 1`` screened rounds
    per cycle, relative to an unscreened round; :func:`staleness_model`
    takes it), ``comm_drop_x`` (ring wire bytes full/screened, F padded to
    a shard multiple) and ``stream_drop_x`` (host->device bytes, exactly
    F / F_active: the column view slices on the host)."""
    f = int(num_features)
    f_active = active_feature_count(f, keep_ratio)
    r = max(int(refresh_rounds), 1)
    screened_factor = ((1.0 - round_f_axis_frac)
                       + round_f_axis_frac * f_active / f)
    avg_round_factor = (1.0 + (r - 1) * screened_factor) / r
    round_full_s = int(n_rows) / train_rows_per_s
    full_wire = hist_merge_comm_bytes(
        "reduce_scatter_ring", n_shards, f, num_bins, num_segments,
        wire_dtype=wire_dtype)["ring_wire_bytes_per_shard"]
    screened_wire = hist_merge_comm_bytes(
        "reduce_scatter_ring", n_shards, f_active, num_bins,
        num_segments, wire_dtype=wire_dtype)["ring_wire_bytes_per_shard"]
    return {
        "f_active": float(f_active),
        "screened_factor": screened_factor,
        "avg_round_factor": avg_round_factor,
        "round_full_s": round_full_s,
        "screened_round_s": round_full_s * screened_factor,
        "avg_round_s": round_full_s * avg_round_factor,
        "speedup_x": 1.0 / avg_round_factor,
        "comm_drop_x": full_wire / screened_wire,
        "stream_drop_x": f / f_active,
    }


@dataclass(frozen=True)
class ScreenBudget:
    """One screening invariant: ``metric`` a
    :func:`feature_screen_time_model` output, ``cmp`` "ge" for the bars and
    "le" for the exactness guards (points where screening must be a
    no-op)."""

    name: str
    budget: float
    metric: str = "speedup_x"
    cmp: str = "ge"
    num_features: int = 136
    keep_ratio: float = 0.25
    refresh_rounds: int = 10
    n_shards: int = 8
    note: str = ""

    def check(self) -> Dict[str, object]:
        t = feature_screen_time_model(
            num_features=self.num_features, keep_ratio=self.keep_ratio,
            refresh_rounds=self.refresh_rounds, n_shards=self.n_shards)
        measured = float(t[self.metric])
        ok = (measured >= self.budget if self.cmp == "ge"
              else measured <= self.budget)
        return {"name": self.name, "mode": "screen",
                "metric": self.metric, "measured": round(measured, 4),
                "budget": self.budget, "cmp": self.cmp,
                "f_active": int(t["f_active"]),
                "avg_round_factor": round(t["avg_round_factor"], 4),
                "ok": ok, "note": self.note}


SCREEN_BUDGETS: Tuple[ScreenBudget, ...] = (
    ScreenBudget("screen_speedup_f136", 1.5,
                 note="r20 acceptance: amortized round-time speedup at "
                      "the wide reference (F=136, keep=0.25, refresh "
                      "every 10) clears 1.5x"),
    ScreenBudget("screen_comm_drop_f136", 3.0, metric="comm_drop_x",
                 note="screened ring merges move >=3x fewer wire bytes "
                      "per shard at D=8 (F pads to a shard multiple)"),
    ScreenBudget("screen_stream_drop_f136", 3.0, metric="stream_drop_x",
                 note="ColumnViewStore slices host blocks before the "
                      "copy, so streamed bytes drop by exactly "
                      "F / F_active = 4x at keep=0.25"),
    ScreenBudget("screen_keep1_no_op", 1.001, cmp="le",
                 keep_ratio=1.0,
                 note="guard-the-model: keep_ratio=1 keeps every "
                      "feature, so the modeled speedup MUST collapse "
                      "to 1x"),
    ScreenBudget("screen_refresh1_exact", 1.001, cmp="le",
                 refresh_rounds=1,
                 note="guard-the-model: refresh_rounds=1 makes every "
                      "round a full-width refresh, so the amortized "
                      "factor MUST be 1x"),
)


def screen_budget_by_name(name: str) -> ScreenBudget:
    for b in SCREEN_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_screen_budgets(names: Optional[List[str]] = None
                         ) -> List[Dict[str, object]]:
    specs = (SCREEN_BUDGETS if names is None
             else [screen_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# sweep throughput + tune->serve staleness budgets (r17)
# ---------------------------------------------------------------------------
# The scheduler packs the grid into fused-CV hyper-batches over a configs x
# devices plan; a bucket pays its set-up and its batched rounds
# (straggler-inflated: it runs until its slowest config stops), device
# groups run buckets side by side, and the makespan is the slowest group's
# chain.  Reference shape: 108 configs × 5-fold CV on 46k rows, ~150
# rounds, 9 buckets.  A retune generation's tune->serve time is the sweep,
# the winner's cold train and the freshness legs, bounded by
# TUNE_SERVE_SLO_S.
#
# From the card ([sweep]): the set-up of a fused bucket (a one-round fused
# cv() less one round); the serial loop's host time a round (an lgb.train
# round on the diamonds split less its rows at TRAIN_ROWS_PER_S); the
# fused batch's efficiency (B = configs × folds serial rounds of work over
# a fused round of phase 8c's sweep); the straggler factor (8c's bucket
# rounds over the rounds its configs need alone, best iteration + early
# stopping); device-group scaling (phase 24c's group of 2 against 13c's
# single device, per group member; virtual shards of one card, so this is
# the code path's cost, not a scaling across cards); one ledger commit
# (``SweepLedger.record``: tmp + fsync + rename).
SWEEP_SETUP_S_PER_BUCKET = 0.00344239
HOST_ROUND_LATENCY_S = 0.0192678
FUSED_BATCH_EFF = 0.882794
SWEEP_STRAGGLER = 1.13726
GROUP_OVERLAP_EFF = 0.242833
LEDGER_SAVE_S = 0.00215334
TUNE_SERVE_SLO_S = 300.0


def sweep_time_model(n_configs: int = 108, n_rows: int = 46_000,
                     nfold: int = 5, rounds_mean: int = 150,
                     n_buckets: int = 9, n_devices: int = 1,
                     group_size: int = 1, *,
                     train_rows_per_s: float = TRAIN_ROWS_PER_S,
                     host_round_latency_s: float = HOST_ROUND_LATENCY_S,
                     ledger_save_s: float = LEDGER_SAVE_S,
                     fused_batch_eff: float = FUSED_BATCH_EFF,
                     group_overlap_eff: float = GROUP_OVERLAP_EFF,
                     sweep_setup_s_per_bucket: float =
                     SWEEP_SETUP_S_PER_BUCKET,
                     sweep_straggler: float = SWEEP_STRAGGLER
                     ) -> Dict[str, float]:
    """Closed-form sweep cost at one operating point: ``serial_s`` (the
    per-config host loop: every fold × round pays the row pass and the host
    latency, plus a ledger commit a config) against ``makespan_s`` (each
    bucket's set-up and straggler-inflated batched rounds, buckets spread
    over ``n_devices // group_size`` groups, the slowest group's chain)."""
    round_s = int(n_rows) / train_rows_per_s
    serial_s = (int(n_configs) * int(nfold) * int(rounds_mean)
                * (round_s + host_round_latency_s)
                + int(n_configs) * ledger_save_s)

    cfg_per_bucket = int(n_configs) / max(int(n_buckets), 1)
    batch = cfg_per_bucket * int(nfold)
    exec_eff = fused_batch_eff * (
        1.0 if group_size <= 1 else int(group_size) * group_overlap_eff)
    bucket_s = (sweep_setup_s_per_bucket
                + int(rounds_mean) * round_s * batch / exec_eff
                * sweep_straggler)
    n_groups = max(int(n_devices) // max(int(group_size), 1), 1)
    chain = -(-int(n_buckets) // n_groups)   # ceil: slowest group's load
    makespan_s = chain * bucket_s + int(n_buckets) * ledger_save_s
    return {
        "round_s": round_s,
        "serial_s": serial_s,
        "configs_per_hour_serial": int(n_configs) / serial_s * 3600.0,
        "bucket_s": bucket_s,
        "n_groups": float(n_groups),
        "chain_buckets": float(chain),
        "makespan_s": makespan_s,
        "configs_per_hour": int(n_configs) / makespan_s * 3600.0,
        "speedup": serial_s / makespan_s,
    }


def sweep_staleness_model(n_configs: int = 108, n_rows: int = 46_000,
                          nfold: int = 5, rounds_mean: int = 150,
                          n_buckets: int = 9, n_devices: int = 8,
                          group_size: int = 1, num_leaves: int = 127,
                          warm_shapes: int = 4, canary_rows: int = 8,
                          serial: bool = False, **consts
                          ) -> Dict[str, float]:
    """Tune->serve staleness of a retune generation: the sweep (fused, or
    the serial loop when ``serial=True``) + the winner's cold train + the
    freshness legs (publish, warm, canary, flip) on the constants
    :func:`staleness_model` uses.  ``consts`` overrides any constant of
    :func:`sweep_time_model` or of the freshness legs by its keyword."""
    sweep_keys = ("train_rows_per_s", "host_round_latency_s",
                  "ledger_save_s", "fused_batch_eff", "group_overlap_eff",
                  "sweep_setup_s_per_bucket", "sweep_straggler")
    c = {"host_write_bytes_per_s": HOST_WRITE_BYTES_PER_S,
         "ckpt_fixed_latency_s": CKPT_FIXED_LATENCY_S,
         "warm_s_per_shape": WARM_S_PER_SHAPE,
         "serve_dispatch_fixed_s": SERVE_DISPATCH_FIXED_S,
         "canary_oracle_s_per_row_tree": CANARY_ORACLE_S_PER_ROW_TREE,
         "flip_s": FLIP_S}
    unknown = set(consts) - set(c) - set(sweep_keys)
    if unknown:
        raise TypeError(f"unknown constants {sorted(unknown)}")
    c.update({k: v for k, v in consts.items() if k in c})
    t = sweep_time_model(n_configs, n_rows, nfold, rounds_mean,
                         n_buckets, n_devices, group_size,
                         **{k: v for k, v in consts.items()
                            if k in sweep_keys})
    sweep_s = t["serial_s"] if serial else t["makespan_s"]
    round_s = t["round_s"]
    train_s = int(rounds_mean) * round_s
    nodes = 2 * int(num_leaves) - 1
    node_bytes = 7 * 4 + 1
    artifact_bytes = int(rounds_mean) * nodes * node_bytes + 4096
    publish_s = artifact_bytes / c["host_write_bytes_per_s"] \
        + c["ckpt_fixed_latency_s"]
    warm_s = int(warm_shapes) * c["warm_s_per_shape"]
    canary_s = (2 * c["serve_dispatch_fixed_s"]
                + int(canary_rows) * int(rounds_mean)
                * c["canary_oracle_s_per_row_tree"])
    tune_serve_s = sweep_s + train_s + publish_s + warm_s + canary_s \
        + c["flip_s"]
    return {
        "sweep_s": sweep_s,
        "winner_train_s": train_s,
        "publish_s": publish_s,
        "warm_s": warm_s,
        "canary_s": canary_s,
        "flip_s": c["flip_s"],
        "tune_serve_s": tune_serve_s,
        "sweep_frac": sweep_s / tune_serve_s,
    }


@dataclass(frozen=True)
class SweepBudget:
    """One sweep-throughput / tune->serve invariant: ``model`` "time"
    (:func:`sweep_time_model`) or "staleness"
    (:func:`sweep_staleness_model`), ``metric`` the compared output,
    ``cmp`` "le" for the bars and "ge" for points MEANT to breach."""

    name: str
    budget: float
    metric: str
    cmp: str = "ge"
    model: str = "time"
    n_configs: int = 108
    n_rows: int = 46_000
    nfold: int = 5
    rounds_mean: int = 150
    n_buckets: int = 9
    n_devices: int = 1
    group_size: int = 1
    serial: bool = False
    note: str = ""

    def check(self) -> Dict[str, object]:
        if self.model == "time":
            t = sweep_time_model(
                self.n_configs, self.n_rows, self.nfold,
                self.rounds_mean, self.n_buckets, self.n_devices,
                self.group_size)
        else:
            t = sweep_staleness_model(
                self.n_configs, self.n_rows, self.nfold,
                self.rounds_mean, self.n_buckets, self.n_devices,
                self.group_size, serial=self.serial)
        measured = t[self.metric]
        ok = (measured <= self.budget if self.cmp == "le"
              else measured >= self.budget)
        return {"name": self.name, "mode": "sweep",
                "metric": self.metric, "measured": round(measured, 4),
                "budget": self.budget, "cmp": self.cmp,
                "n_devices": self.n_devices, "ok": ok,
                "note": self.note}


SWEEP_BUDGETS: Tuple[SweepBudget, ...] = (
    SweepBudget("sweep_speedup_d8", 2.0, "speedup", n_devices=8,
                note="r17 acceptance: the 8-device mesh sweeps the "
                     "reference grid >= 2x faster than the serial "
                     "ledger loop"),
    SweepBudget("sweep_fused_gain_d1", 1.5, "speedup", n_devices=1,
                note="the fused hyper-batch alone (one device, no "
                     "mesh) beats the serial loop >= 1.5x"),
    SweepBudget("sweep_configs_per_hour_d8", 3000.0,
                "configs_per_hour", n_devices=8,
                note="throughput floor: >= 3000 configs/hour at D=8 on "
                     "the reference shape"),
    SweepBudget("sweep_tune_serve_slo", TUNE_SERVE_SLO_S,
                "tune_serve_s", cmp="le", model="staleness",
                n_devices=8,
                note="closed-loop bar: a retune generation (full "
                     "sweep + winner train + publish/warm/canary/"
                     "flip) lands inside the 300 s tune->serve SLO "
                     "at D=8"),
    SweepBudget("sweep_serial_blows_tune_slo", TUNE_SERVE_SLO_S,
                "tune_serve_s", cmp="ge", model="staleness",
                serial=True,
                note="guard-the-model: the serial reference loop "
                     "CANNOT meet the tune->serve SLO at the same "
                     "shape"),
)


def sweep_budget_by_name(name: str) -> SweepBudget:
    for b in SWEEP_BUDGETS:
        if b.name == name:
            return b
    raise KeyError(name)


def check_sweep_budgets(names: Optional[List[str]] = None
                        ) -> List[Dict[str, object]]:
    specs = (SWEEP_BUDGETS if names is None
             else [sweep_budget_by_name(n) for n in names])
    return [b.check() for b in specs]


# ---------------------------------------------------------------------------
# the card's known misses
# ---------------------------------------------------------------------------
# Specs whose bar the committed figures (or the port's design) miss, each
# a fault in ROADMAP C with its figures.  The bars stay the reference's: the
# check reports ``ok: false``, and ``lint`` accepts exactly these misses.
# A new miss fails ``lint``, and so does a listed spec that passes again
# (close its ROADMAP entry and drop it here).
CARD_MISSES: Dict[str, str] = {
    # B4's node tables: 12 bytes a slot, an f32 leaf value among them, at
    # every precision (C.9)
    "serve_int8_models_per_byte": "ROADMAP C.9",
    "serve_fused_no_f32_table_int8": "ROADMAP C.9",
    "serve_fused_no_f32_table_bf16": "ROADMAP C.9",
    # B4's wrapper and launch against a D = 8 dispatch slice (C.10)
    "serve_dp_dispatch_overhead": "ROADMAP C.10",
    # the checkpoint's host legs against the card's round (C.11)
    "ckpt_overhead_ref": "ROADMAP C.11",
    "ckpt_overhead_deep_forest": "ROADMAP C.11",
    "ckpt_overhead_small_shard": "ROADMAP C.11",
    # a host-bound north-star round barely grows with F (C.12)
    "screen_speedup_f136": "ROADMAP C.12",
    # the host->device rate against B1's pass at the reference block (C.13)
    "stream_prefetch_hidden_ref": "ROADMAP C.13",
    "stream_prefetch_hidden_deep_ref": "ROADMAP C.13",
}


# every device constant above, by its module name: what phase 26
# measures and :func:`with_constants` replaces
DEVICE_CONSTANTS: Tuple[str, ...] = (
    "LINK_BYTES_PER_S", "LINK_HOP_LATENCY_S", "HIST_EQUIV_FLOPS",
    "H2D_BYTES_PER_S", "H2D_PUT_LATENCY_S", "SERVE_DISPATCH_FIXED_S",
    "SERVE_GATHER_BYTES_PER_S", "HOST_WRITE_BYTES_PER_S",
    "CKPT_DIGEST_BYTES_PER_S", "CKPT_FIXED_LATENCY_S", "TRAIN_ROWS_PER_S",
    "WARM_S_PER_SHAPE", "CANARY_ORACLE_S_PER_ROW_TREE", "FLIP_S",
    "ROUND_F_AXIS_FRAC", "SWEEP_SETUP_S_PER_BUCKET", "HOST_ROUND_LATENCY_S",
    "FUSED_BATCH_EFF", "SWEEP_STRAGGLER", "GROUP_OVERLAP_EFF",
    "LEDGER_SAVE_S")


def with_constants(consts: Dict[str, float]):
    """This module run again with ``consts`` (device constants by name) in
    place of the committed values, so every keyword default and spec
    reads them: the models on one run's own figures."""
    import re
    import sys
    import types

    with open(__file__, encoding="utf-8") as f:
        src = f.read()
    for name, value in consts.items():
        if name not in DEVICE_CONSTANTS:
            raise KeyError(f"{name} is not a device constant")
        src, n = re.subn(rf"^{name} = .*$", f"{name} = {float(value)!r}",
                         src, flags=re.M)
        assert n == 1, (name, n)
    mod = types.ModuleType(f"{__name__}._at")
    mod.__file__, mod.__package__ = __file__, __package__
    sys.modules[mod.__name__] = mod        # dataclasses look the module up
    try:
        exec(compile(src, __file__, "exec"), mod.__dict__)
    finally:
        del sys.modules[mod.__name__]
    return mod


def misses_at(consts: Dict[str, float]) -> List[str]:
    """The specs that miss their bar on ``consts`` (the rest committed)."""
    return sorted(r["name"] for res in with_constants(consts)
                  .model_sections().values() for r in res if not r["ok"])


def model_sections() -> Dict[str, List[Dict[str, object]]]:
    """Every model family's results, keyed by the ``lint`` section name,
    each known miss marked with its ROADMAP entry (``known_miss``)."""
    sections = {
        "comm_budgets": check_comm_budgets(),
        "comm_time": check_comm_time_budgets(),
        "stream_time": check_stream_budgets(),
        "stream_dp": check_stream_dp_budgets(),
        "serve_slo": check_serve_slo_budgets(),
        "ckpt": check_ckpt_budgets(),
        "freshness": check_freshness_budgets(),
        "sweep": check_sweep_budgets(),
        "screen": check_screen_budgets(),
    }
    for res in sections.values():
        for r in res:
            if r["name"] in CARD_MISSES:
                r["known_miss"] = CARD_MISSES[r["name"]]
    return sections


def section_failed(results: List[Dict[str, object]]) -> bool:
    """A section fails on a miss that is not known, or on a known miss
    that passes again (its entry is stale)."""
    return any(r["ok"] == ("known_miss" in r) for r in results)


# ---------------------------------------------------------------------------
# budget anchors — stale-entry reporting (r16)
# ---------------------------------------------------------------------------
# Every budget family models a live entry point of the port; rename the
# function (or delete its module) and the budget would keep passing against
# nothing.  The anchors pin each section to the symbols it models, checked
# with pure ``ast`` in the default lint pass (no torch, no execution).

BUDGET_ANCHORS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    # section -> ((repo-relative file, top-level symbol), ...)
    "launch": (
        ("lightgbm_tpu_torch/models/tree.py", "grow_tree"),
        ("lightgbm_tpu_torch/models/tree.py", "grow_trees_batched"),
        ("lightgbm_tpu_torch/models/fused.py", "run_fused_cv_batch"),
        ("lightgbm_tpu_torch/ops/split.py", "SplitContext"),
    ),
    "comm": (
        ("lightgbm_tpu_torch/parallel/feature_parallel.py",
         "reduce_best_split"),
        ("lightgbm_tpu_torch/ops/histogram.py", "histogram_merge"),
        ("lightgbm_tpu_torch/ops/histogram.py", "ring_reduce_scatter"),
        ("lightgbm_tpu_torch/ops/histogram.py",
         "ring_reduce_scatter_pipelined"),
        ("lightgbm_tpu_torch/ops/quantize.py", "wire_transfer"),
    ),
    "stream": (
        ("lightgbm_tpu_torch/data/block_store.py", "BlockStore"),
        ("lightgbm_tpu_torch/data/stream_grow.py", "stream_hist"),
        ("lightgbm_tpu_torch/data/stream_grow.py", "stream_goss_round"),
    ),
    "stream_dp": (
        # the per-shard store splitter, the lockstep block-round assembler,
        # the one streamed grower (serial and mesh row sources) and its
        # mesh pass, the GOSS round, the models themselves, and the
        # elastic-resume gate
        ("lightgbm_tpu_torch/data/block_store.py", "shard_block_store"),
        ("lightgbm_tpu_torch/data/stream_dp.py", "dp_block_rounds"),
        ("lightgbm_tpu_torch/data/stream_dp.py", "StreamMesh"),
        ("lightgbm_tpu_torch/data/stream_dp.py", "stream_dp_pass"),
        ("lightgbm_tpu_torch/data/stream_grow.py", "stream_grow_tree"),
        ("lightgbm_tpu_torch/data/stream_dp.py", "stream_dp_goss_round"),
        ("lightgbm_tpu_torch/analysis/budgets.py", "stream_dp_time_model"),
        ("lightgbm_tpu_torch/analysis/budgets.py",
         "stream_dp_bytes_model"),
        ("lightgbm_tpu_torch/training/checkpoint.py",
         "validate_parallel_topology"),
    ),
    "serve_slo": (
        ("lightgbm_tpu_torch/serving/runtime.py", "PredictorRuntime"),
        ("lightgbm_tpu_torch/serving/packed.py", "PackedForest"),
        ("lightgbm_tpu_torch/serving/queue.py", "MicroBatcher"),
        ("lightgbm_tpu_torch/serving/mesh.py", "choose_route"),
        ("lightgbm_tpu_torch/serving/mesh.py", "ServingMesh"),
        ("lightgbm_tpu_torch/ops/quantize.py", "packed_model_bytes"),
        ("lightgbm_tpu_torch/analysis/budgets.py", "models_per_byte_gain"),
    ),
    "predict": (
        # the SoA layout and its packer, B4's wrapper, plan, shared memory
        # and node tables, and the tp shard path the launch/shared-memory/
        # HBM model (predict_kernel_time) charges
        ("lightgbm_tpu_torch/ops/predict.py", "ForestSoA"),
        ("lightgbm_tpu_torch/ops/predict.py", "pack_forest_soa"),
        ("lightgbm_tpu_torch/ops/predict.py", "predict_forest"),
        ("lightgbm_tpu_torch/ops/predict.py", "forest_sums_plain"),
        ("lightgbm_tpu_torch/kernels/predict.py", "forest_sums"),
        ("lightgbm_tpu_torch/kernels/predict.py", "plan"),
        ("lightgbm_tpu_torch/kernels/predict.py", "smem_bytes"),
        ("lightgbm_tpu_torch/kernels/predict.py", "build_node_tables"),
        ("lightgbm_tpu_torch/serving/mesh.py", "tp_raw_margins_fused"),
    ),
    "ckpt": (
        ("lightgbm_tpu_torch/training/checkpoint.py", "save_checkpoint"),
        ("lightgbm_tpu_torch/training/checkpoint.py",
         "save_state_checkpoint"),
        ("lightgbm_tpu_torch/training/checkpoint.py", "load_latest"),
    ),
    "freshness": (
        ("lightgbm_tpu_torch/pipeline/daemon.py", "RefreshDaemon"),
        ("lightgbm_tpu_torch/pipeline/staleness.py", "StalenessTracker"),
        ("lightgbm_tpu_torch/serving/bank.py", "ModelBank"),
    ),
    "sweep": (
        ("lightgbm_tpu_torch/sweep/service.py", "SweepService"),
        ("lightgbm_tpu_torch/sweep/scheduler.py", "SweepScheduler"),
        ("lightgbm_tpu_torch/sweep/ledger.py", "SweepLedger"),
    ),
    "screen": (
        # the screener and the mask layer the growers share, the host-side
        # column view the stream byte term charges, and the model itself
        ("lightgbm_tpu_torch/models/feature_mask.py", "FeatureScreener"),
        ("lightgbm_tpu_torch/models/feature_mask.py", "node_mask_fn"),
        ("lightgbm_tpu_torch/models/feature_mask.py",
         "active_feature_count"),
        ("lightgbm_tpu_torch/data/block_store.py", "ColumnViewStore"),
        ("lightgbm_tpu_torch/analysis/budgets.py",
         "feature_screen_time_model"),
    ),
}


def _top_level_symbols(path: str) -> Optional[set]:
    """Top-level def/class names of ``path``, or None when unreadable."""
    import ast as _ast
    import os as _os

    if not _os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        try:
            tree = _ast.parse(f.read())
        except SyntaxError:
            return None
    return {n.name for n in tree.body
            if isinstance(n, (_ast.FunctionDef, _ast.AsyncFunctionDef,
                              _ast.ClassDef))}


def check_budget_anchors(anchors: Optional[Dict[str, Tuple]] = None
                         ) -> List[Dict[str, object]]:
    """One result a pinned symbol; ``ok=False`` means the budget section
    references a dead file or a renamed symbol."""
    import os as _os

    repo_root = _os.path.dirname(_os.path.dirname(
        _os.path.dirname(_os.path.abspath(__file__))))
    out: List[Dict[str, object]] = []
    cache: Dict[str, Optional[set]] = {}
    for section, pins in sorted((anchors or BUDGET_ANCHORS).items()):
        for rel, symbol in pins:
            path = _os.path.join(repo_root, rel.replace("/", _os.sep))
            if rel not in cache:
                cache[rel] = _top_level_symbols(path)
            syms = cache[rel]
            if syms is None:
                ok, why = False, f"{rel}: file missing or unparseable"
            elif symbol not in syms:
                ok, why = False, (f"`{symbol}` not found at top level of "
                                  f"{rel} — renamed or deleted; update "
                                  f"the budget spec's anchor")
            else:
                ok, why = True, ""
            out.append({"name": f"{section}:{symbol}", "section": section,
                        "path": rel, "symbol": symbol, "ok": ok,
                        "why": why})
    return out
