"""Port parity: the analytic budget models of ``analysis/budgets.py`` against
the reference's, and the port's own pins.

* every model function, given the reference's TPU constants as keyword
  arguments, returns the reference function's dict to the bit on a grid of
  shapes (D 1-8, F 6-136, every merge mode and wire, prefetch depths 1-3);
  only the constants differ;
* the reference's own model tests, as port cases;
* spec names and bars equal to the reference's (the one spec that names a
  TPU quantity renamed to what it measures on the card);
* the models' layout constants equal to the live port modules they copy
  (the default ``lint`` pass imports no torch, so it cannot read them);
* the ring modes' wire bytes are the bytes the port's merge hands to
  ``wire_transfer``; the plain walk's launches are its ops;
* the card's misses are exactly ``CARD_MISSES`` and the specs ROADMAP C
  names, and ``misses_at`` gives them on other figures;
* the default pass imports no torch.
"""

import inspect
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu.analysis import budgets as R
from lightgbm_tpu_torch.analysis import budgets as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# port keyword -> the reference's constant
REF = {
    "link_bytes_per_s": R.ICI_BYTES_PER_S,
    "link_hop_latency_s": R.ICI_HOP_LATENCY_S,
    "hist_equiv_flops": R.MXU_EFF_FLOPS,
    "h2d_bytes_per_s": R.PCIE_BYTES_PER_S,
    "h2d_put_latency_s": R.PCIE_PUT_LATENCY_S,
    "serve_dispatch_fixed_s": R.SERVE_DISPATCH_FIXED_S,
    "serve_gather_bytes_per_s": R.SERVE_GATHER_BYTES_PER_S,
    "host_write_bytes_per_s": R.HOST_WRITE_BYTES_PER_S,
    "ckpt_digest_bytes_per_s": R.CKPT_DIGEST_BYTES_PER_S,
    "ckpt_fixed_latency_s": R.CKPT_FIXED_LATENCY_S,
    "train_rows_per_s": R.TRAIN_ROWS_PER_S,
    "warm_s_per_shape": R.WARM_COMPILE_S_PER_SHAPE,
    "canary_oracle_s_per_row_tree": R.CANARY_ORACLE_S_PER_ROW_TREE,
    "flip_s": R.FLIP_S,
    "round_f_axis_frac": R.ROUND_F_AXIS_FRAC,
    "sweep_setup_s_per_bucket": R.SWEEP_COMPILE_S_PER_BUCKET,
    "host_round_latency_s": R.HOST_ROUND_LATENCY_S,
    "fused_batch_eff": R.FUSED_BATCH_EFF,
    "sweep_straggler": R.SWEEP_STRAGGLER,
    "group_overlap_eff": R.GROUP_OVERLAP_EFF,
    "ledger_save_s": R.LEDGER_SAVE_S,
}
# port constant -> its keyword (the device figures phase 26 measures)
CONSTANTS = {k.upper(): k for k in REF}
CONSTANTS["WARM_S_PER_SHAPE"] = "warm_s_per_shape"
RENAMED = {"serve_fused_vmem_int8": "serve_fused_smem_int8"}
MODES = ("psum", "reduce_scatter", "reduce_scatter_ring",
         "reduce_scatter_pipelined", "voting")
RING = ("reduce_scatter_ring", "reduce_scatter_pipelined")


def ref_kw(fn):
    """The reference's constants for every keyword-only argument of the
    port's ``fn``."""
    return {n: REF[n] for n, p in inspect.signature(fn).parameters.items()
            if p.kind is p.KEYWORD_ONLY}


def same(a, b):
    """Equal dicts to the bit (floats by their bits, inf included)."""
    assert set(a) == set(b), (sorted(a), sorted(b))
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) or isinstance(y, float):
            assert type(x) is type(y) and (
                np.float64(x).tobytes() == np.float64(y).tobytes()), (k, x, y)
        else:
            assert x == y and type(x) is type(y), (k, x, y)


def wires(mode):
    return ("f32", "bf16", "int8") if mode in RING else ("f32",)


# -- every model function against the reference's, to the bit -------------


@pytest.mark.parametrize("mode", MODES)
def test_comm_bytes_equal_reference(mode):
    for d in (1, 2, 3, 4, 8):
        for f in (6, 28, 136):
            for wire in wires(mode):
                for chunks in (1, 3, 4):
                    for top_k in (2, 20):
                        args = (mode, d, f, 256, 2)
                        kw = dict(top_k=top_k, wire_dtype=wire,
                                  n_chunks=chunks)
                        same(P.hist_merge_comm_bytes(*args, **kw),
                             R.hist_merge_comm_bytes(*args, **kw))
    with pytest.raises(ValueError):
        P.hist_merge_comm_bytes(mode, 8, 136, 256, 2, wire_dtype="fp8")


@pytest.mark.parametrize("mode", MODES)
def test_comm_time_equal_reference(mode):
    for d in (1, 2, 4, 8):
        for f in (6, 28, 136):
            for wire in wires(mode):
                for s in (1, 2, 8):
                    for rows in (4096, 131072):
                        args = (mode, d, f, 256, s)
                        kw = dict(wire_dtype=wire, n_chunks=4,
                                  rows_per_shard=rows)
                        same(P.hist_merge_comm_time(
                            *args, **kw, **ref_kw(P.hist_merge_comm_time)),
                             R.hist_merge_comm_time(*args, **kw))


@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_stream_prefetch_equal_reference(prefetch):
    for rows in (4096, 131072):
        for f in (6, 28, 136):
            for s in (2, 8):
                for k in (1, 8, 16):
                    for code in (1, 2):
                        args = (rows, f, 256, s)
                        kw = dict(n_blocks=k, code_bytes=code,
                                  prefetch_blocks=prefetch)
                        same(P.stream_prefetch_time(
                            *args, **kw, **ref_kw(P.stream_prefetch_time)),
                             R.stream_prefetch_time(*args, **kw))


@pytest.mark.parametrize("mode", ["psum", "reduce_scatter",
                                  "reduce_scatter_ring",
                                  "reduce_scatter_pipelined"])
def test_stream_dp_time_equal_reference(mode):
    for d in (1, 2, 4, 8):
        for f in (6, 28, 136):
            for wire in wires(mode):
                for prefetch in (1, 2, 3):
                    for k in (1, 2, 8):
                        kw = dict(num_features=f, n_blocks_per_shard=k,
                                  n_shards=d, mode=mode, wire_dtype=wire,
                                  prefetch_blocks=prefetch)
                        same(P.stream_dp_time_model(
                            **kw, **ref_kw(P.stream_dp_time_model)),
                             R.stream_dp_time_model(**kw))


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_stream_dp_bytes_equal_reference(wire):
    for d in (1, 2, 4, 8):
        for f in (6, 28, 136):
            for rates in ((0.1, 0.1), (0.2, 0.05), (1.0, 0.0), (0.0, 0.0)):
                kw = dict(num_features=f, n_shards=d, top_rate=rates[0],
                          other_rate=rates[1], wire_dtype=wire)
                same(P.stream_dp_bytes_model(**kw),
                     R.stream_dp_bytes_model(**kw))


def test_serve_models_equal_reference():
    for arrival in (0.0, 1000.0, 64000.0, 128000.0, 1e6):
        for disp in (0.5, 2.0, 20.0):
            for policy in ("off", "deadline"):
                args = (arrival, disp, 128, 5.0, 50.0, policy)
                same(P.serve_queue_model(*args), R.serve_queue_model(*args))
    for shed in (True, False):
        for disp in (0.0, 2.0, 10.0):
            args = (50.0, disp, 5.0, shed)
            same(P.serve_fault_p99_model(*args),
                 R.serve_fault_p99_model(*args))
    for d in range(1, 9):
        for disp in (0.5, 2.0):
            for bucket in (8, 16384):
                args = (d, disp, bucket, 4)
                same(P.serve_mesh_dispatch_model(
                    *args, **ref_kw(P.serve_mesh_dispatch_model)),
                     R.serve_mesh_dispatch_model(*args))
    with pytest.raises(ValueError):
        P.serve_mesh_dispatch_model(0)


def test_ckpt_and_staleness_equal_reference():
    for rows in (131_072, 1_048_576, 11_000_000):
        for leaves in (31, 255):
            for trees in (10, 200, 2000):
                for between in (1, 10):
                    for k in (1, 7):
                        args = (rows, leaves, trees, between, k)
                        same(P.ckpt_overhead_time(
                            *args, **ref_kw(P.ckpt_overhead_time)),
                             R.ckpt_overhead_time(*args))
    for rows in (1_048_576, 11_000_000):
        for rounds in (0, 5, 20, 220):
            for k in (1, 3):
                for tick in (0.0, 1.0):
                    for factor in (1.0, 0.4375):
                        args = (rows, rounds, 255, 220, k, 4, 8, tick,
                                factor)
                        same(P.staleness_model(
                            *args, **ref_kw(P.staleness_model)),
                             R.staleness_model(*args))


def test_screen_equal_reference():
    for f in (6, 28, 136):
        for keep in (0.1, 0.25, 1.0):
            for refresh in (1, 4, 10):
                for d in (2, 8):
                    kw = dict(num_features=f, keep_ratio=keep,
                              refresh_rounds=refresh, n_shards=d)
                    same(P.feature_screen_time_model(
                        **kw, **ref_kw(P.feature_screen_time_model)),
                         R.feature_screen_time_model(**kw))


def test_sweep_equal_reference():
    for d in (1, 2, 4, 8):
        for g in (1, 2, 4):
            for buckets in (1, 9):
                for rounds in (20, 150):
                    args = (108, 46_000, 5, rounds, buckets, d, g)
                    same(P.sweep_time_model(*args,
                                            **ref_kw(P.sweep_time_model)),
                         R.sweep_time_model(*args))
                    for serial in (False, True):
                        kw = dict(n_devices=d, group_size=g,
                                  n_buckets=buckets, rounds_mean=rounds,
                                  serial=serial)
                        consts = {k: REF[k] for k in (
                            "train_rows_per_s", "host_round_latency_s",
                            "ledger_save_s", "fused_batch_eff",
                            "group_overlap_eff", "sweep_setup_s_per_bucket",
                            "sweep_straggler", "host_write_bytes_per_s",
                            "ckpt_fixed_latency_s", "warm_s_per_shape",
                            "serve_dispatch_fixed_s",
                            "canary_oracle_s_per_row_tree", "flip_s")}
                        same(P.sweep_staleness_model(**kw, **consts),
                             R.sweep_staleness_model(**kw))
    with pytest.raises(TypeError, match="unknown constants"):
        P.sweep_staleness_model(ici_bytes_per_s=1.0)


def test_every_model_takes_each_device_constant_as_a_keyword():
    fns = (P.hist_merge_comm_time, P.stream_prefetch_time,
           P.stream_dp_time_model, P.serve_mesh_dispatch_model,
           P.ckpt_overhead_time, P.staleness_model,
           P.feature_screen_time_model, P.sweep_time_model)
    taken = set()
    for fn in fns:
        params = inspect.signature(fn).parameters
        for name, p in params.items():
            if p.kind is p.KEYWORD_ONLY:
                assert p.default == getattr(P, name.upper()), name
                taken.add(name)
    # the sweep's staleness takes the rest through **consts
    assert taken == set(REF)


# -- B4 as the port builds it ---------------------------------------------


def test_predict_model_layout_constants_are_the_live_ones():
    import lightgbm_tpu_torch.kernels.predict as KP
    from lightgbm_tpu_torch.ops import predict as OP
    from lightgbm_tpu_torch.ops import quantize as Q

    assert P.PREDICT_NODE_PAD == OP.PREDICT_NODE_PAD
    assert P.PREDICT_TREE_CHUNKS == OP.PREDICT_TREE_CHUNKS
    assert P.PREDICT_SOA_NODE_BYTES == Q.PACKED_NODE_BYTES
    assert P.PACKED_SCALE_BYTES_PER_TREE == Q.PACKED_SCALE_BYTES_PER_TREE
    assert P.SMEM_LIMIT == KP.SMEM_LIMIT
    assert P._B4_PLAN == {
        "max_cluster": KP.MAX_CLUSTER, "max_threads": KP.MAX_THREADS,
        "target_blocks": KP.TARGET_BLOCKS, "min_rows": KP.MIN_ROWS,
        "max_rows": KP.MAX_ROWS, "value_bytes": KP.VALUE_BYTES,
        "record_bytes": KP.RECORD_BYTES,
        "staged_codes_limit": KP.STAGED_CODES_LIMIT}
    for f in (1, 28, 32, 300):
        for mp in (128, 512, 4096, 16384):
            for window in (1, 7, 100, 800):
                for n in (1, 8, 100, 16384):
                    KP.plan.cache_clear()
                    assert P.b4_smem_bytes(f, mp, window, n) == \
                        KP.plan(f, mp, window, n).smem, (f, mp, window, n)


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_b4_tables_and_plain_walk_counted_from_the_code(precision):
    """B4's node tables are 8 + 4 bytes a slot; the plain walk's launches
    (non-view aten ops, the wrapped scalar of ``where`` aside) are
    FIXED + STEP · depth + TREE · trees."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from lightgbm_tpu_torch.kernels.predict import build_node_tables
    from lightgbm_tpu_torch.ops.predict import forest_sums_plain
    from lightgbm_tpu_torch.serving.runtime import PredictorRuntime

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view and func.__name__ != "scalar_tensor.default":
                Count.n += 1
            return func(*args, **(kwargs or {}))

    bins = torch.zeros((8, 2), dtype=torch.uint8)
    for trees in (3, 5):
        rt = PredictorRuntime(P.tiny_packed_forest(num_trees=trees),
                              max_bucket=8, device=torch.device("cpu"),
                              forest_precision=precision)
        soa = rt._soa[0]
        records, leafv = build_node_tables(soa)
        assert records.element_size() == P.B4_RECORD_BYTES
        assert leafv.dtype == torch.float32 and \
            leafv.element_size() == P.B4_LEAF_VALUE_BYTES
        for depth in (1, 2, 4):
            Count.n = 0
            with Count():
                forest_sums_plain(soa, bins, trees, depth)
            assert Count.n == (P.PLAIN_WALK_FIXED_LAUNCHES
                               + (precision != "f32")
                               + P.PLAIN_WALK_STEP_LAUNCHES * depth
                               + P.PLAIN_WALK_TREE_LAUNCHES * trees)
    m = P.predict_kernel_time(num_trees=trees, node_slots=3, depth_cap=4,
                              precision=precision, bucket=8,
                              num_features=2)
    assert m["launches_plain_model"] - P.B4_WRAPPER_LAUNCHES == \
        P.PLAIN_WALK_FIXED_LAUNCHES + (precision != "f32") \
        + P.PLAIN_WALK_STEP_LAUNCHES * 4 + P.PLAIN_WALK_TREE_LAUNCHES * trees
    # the wrapper's launches: serving_predict_b8_card's count at one class
    assert P.B4_WRAPPER_LAUNCHES + 1 == 4
    assert "measured 4" in P.budget_by_name("serving_predict_b8_card").note


@pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
def test_predict_model_shares_the_reference_soa(precision):
    for trees, slots, k in ((800, 509, 1), (200, 255, 3), (1, 1, 1)):
        kw = dict(num_trees=trees, node_slots=slots, num_class=k,
                  precision=precision)
        got, want = P.predict_kernel_time(**kw), R.predict_kernel_time(**kw)
        chunk = P.PREDICT_TREE_CHUNKS[precision]
        tp = max(chunk, -(-trees // chunk) * chunk)
        mp = max(128, -(-slots // 128) * 128)
        b4 = k * tp * mp * (P.B4_RECORD_BYTES + P.B4_LEAF_VALUE_BYTES)
        assert got["hbm_node_table_bytes"] == want["hbm_node_table_bytes"] + b4
        assert got["hbm_scale_bytes"] == want["hbm_scale_bytes"]
        assert got["f32_node_table_bytes"] == \
            want["f32_node_table_bytes"] + k * tp * mp * 4
        assert got["launches_fused"] == P.B4_WRAPPER_LAUNCHES + k
        assert got["smem_block_bytes"] <= got["smem_limit_bytes"]
    with pytest.raises(ValueError):
        P.predict_kernel_time(precision="fp8")


def test_predict_kernels_summary_crosses_the_budgets():
    s = P.predict_kernels_summary()
    m = P.predict_kernel_time()
    assert s["predict_ops_cpu"] > 0
    assert s["predict_launches_model"] == m["launches_fused"] == 4
    assert s["predict_budget_card"] == \
        P.budget_by_name("serving_predict_b8_card").budget
    assert s["predict_within_budget"] and s["predict_drop_within_floor"]
    assert s["predict_smem_block_bytes"] == m["smem_block_bytes"] <= \
        P.SMEM_LIMIT


def test_resident_bytes_are_the_packed_layout_plus_b4_tables():
    from lightgbm_tpu_torch.ops.quantize import packed_model_bytes

    for precision in ("f32", "bf16", "int8"):
        for trees, cap, k in ((200, 509, 1), (10, 31, 7)):
            slots = trees * cap * k
            assert P.resident_model_bytes(trees, cap, k, precision) == \
                packed_model_bytes(trees, cap, k, precision) + 12 * slots
    assert P.models_per_byte_gain("f32") == 1.0
    with pytest.raises(ValueError):
        P.resident_model_bytes(1, 1, 1, "fp8")


def test_active_feature_count_is_the_screeners():
    from lightgbm_tpu_torch.models.feature_mask import active_feature_count

    for f in (1, 6, 28, 136):
        for keep in (0.0, 0.01, 0.25, 0.5, 1.0):
            assert P.active_feature_count(f, keep) == \
                active_feature_count(f, keep)


@pytest.mark.parametrize("mode,wire", [
    ("reduce_scatter_ring", "f32"), ("reduce_scatter_ring", "int8"),
    ("reduce_scatter_pipelined", "f32"), ("reduce_scatter_pipelined", "bf16"),
    ("reduce_scatter_pipelined", "int8")])
def test_ring_wire_bytes_are_the_ports_hop_messages(mode, wire, monkeypatch):
    """One shard's hop messages through the port's merge, spied at
    ``wire_transfer``: cells at the wire's width plus the int8 wire's
    scale (3 f32 a feature of a message) — the model's ring wire bytes
    less the BestSplit gather."""
    import lightgbm_tpu_torch.ops.quantize as Q
    from lightgbm_tpu_torch.ops.histogram import histogram_merge

    real, cell = Q.wire_transfer, {"f32": 4, "bf16": 2, "int8": 1}[wire]
    for d in (2, 4, 8):
        for f in (6, 28, 136):
            sent = []

            def spy(ts, perm, wire_dtype, f_axis=1):
                t = ts[0]
                side = t.shape[f_axis] * 12 if wire_dtype == "int8" else 0
                sent.append(t.numel() * cell + side)
                return real(ts, perm, wire_dtype, f_axis=f_axis)

            monkeypatch.setattr(Q, "wire_transfer", spy)
            g = torch.Generator().manual_seed(d * 1000 + f)
            hists = [torch.rand((2, f, 16, 3), generator=g)
                     for _ in range(d)]
            histogram_merge(hists, mode, wire_dtype=wire, n_chunks=4)
            m = P.hist_merge_comm_bytes(mode, d, f, 16, 2, wire_dtype=wire)
            assert sum(sent) == m["ring_wire_bytes_per_shard"] - d * 64, \
                (d, f)


# -- the reference's model tests, as port cases ---------------------------


def test_comm_budget_model_and_gate():
    ps = P.hist_merge_comm_bytes("psum", 8, 136, 256, 2)
    rs = P.hist_merge_comm_bytes("reduce_scatter", 8, 136, 256, 2)
    bestsplit = 8 * 16 * 4
    assert ps["received_bytes_per_shard"] == 2 * 136 * 256 * 3 * 4 \
        + bestsplit
    assert rs["received_bytes_per_shard"] == 2 * 17 * 256 * 3 * 4 \
        + bestsplit
    results = P.check_comm_budgets()
    assert all(r["ok"] for r in results), results
    assert {r["mode"] for r in results} == {
        "reduce_scatter", "reduce_scatter_ring",
        "reduce_scatter_pipelined", "voting"}
    with pytest.raises(ValueError):
        P.hist_merge_comm_bytes("gather", 8, 136, 256, 2)
    with pytest.raises(KeyError):
        P.comm_budget_by_name("nope")


def test_comm_time_model_and_pipelined_budgets():
    pipe = P.hist_merge_comm_bytes("reduce_scatter_pipelined", 8, 136,
                                   256, 2)
    assert pipe["received_bytes_per_shard"] == 2 * 20 * 256 * 3 * 4 + 512
    q = P.hist_merge_comm_bytes("reduce_scatter_pipelined", 8, 136, 256, 2,
                                wire_dtype="int8")
    assert q["received_bytes_per_shard"] == 2 * 20 * 256 * 3 + 7 * 20 * 12 \
        + 512
    assert 104_960 / q["received_bytes_per_shard"] >= 2.0
    assert P.comm_budget_by_name("hist_wire_int8_d8").check()["ok"]
    with pytest.raises(ValueError, match="ring"):
        P.hist_merge_comm_bytes("psum", 8, 136, 256, 2, wire_dtype="bf16")
    # compute-bound at the reference on both sets of constants: 1 - 1/C
    for kw in (ref_kw(P.hist_merge_comm_time), {}):
        t = P.hist_merge_comm_time("reduce_scatter_pipelined", 8, 136, 256,
                                   2, **kw)
        assert t["compute_bound"] and t["hidden_frac"] == pytest.approx(0.75)
    assert all(r["ok"] for r in P.check_comm_time_budgets())
    with pytest.raises(KeyError):
        P.comm_time_budget_by_name("nope")


def test_stream_prefetch_budget_model():
    t = P.stream_prefetch_time(**ref_kw(P.stream_prefetch_time))
    assert t["hidden_frac"] >= 0.60 and t["compute_bound"]
    # on the card a 131,072 x 136 block's copy outlasts B1 on it, and the
    # 8-block pass hides less than 60 % of its copies: a card miss
    # (ROADMAP C.13)
    card = P.stream_prefetch_time()
    assert not card["compute_bound"] and card["hidden_frac"] < 0.60
    missed = {r["name"] for r in P.check_stream_budgets() if not r["ok"]}
    assert "stream_prefetch_hidden_ref" in missed
    assert all(P.CARD_MISSES[n] == "ROADMAP C.13" for n in missed)
    assert {r["name"] for r in P.check_stream_budgets()} == {
        b.name for b in R.STREAM_TIME_BUDGETS}
    with pytest.raises(KeyError):
        P.stream_budget_by_name("nope")


def test_stream_dp_budgets_and_models():
    res = P.check_stream_dp_budgets()
    assert {r["name"] for r in res} >= {
        "stream_dp_merge_hidden_ref", "stream_dp_goss_int8_bytes_ref"}
    for r in res:
        assert r["ok"], r
    ref = ref_kw(P.stream_dp_time_model)
    t = P.stream_dp_time_model(**ref)
    assert t["merge_hidden_frac"] >= 0.60 and t["compute_bound"]
    assert P.stream_dp_time_model(prefetch_blocks=2, **ref)[
        "merge_hidden_frac"] >= 0.60
    m = P.stream_dp_bytes_model()
    assert m["reduction_factor"] >= 4.0
    assert m["reduction_factor"] > min(m["pcie_factor"], m["ici_factor"])
    f32 = P.stream_dp_bytes_model(wire_dtype="f32", top_rate=1.0,
                                  other_rate=0.0)
    assert abs(f32["reduction_factor"] - 1.0) < 1e-9
    shallow = P.stream_prefetch_time(prefetch_blocks=1)
    deep = P.stream_prefetch_time(prefetch_blocks=2)
    assert deep["transfer_ms"] <= shallow["transfer_ms"]
    with pytest.raises(KeyError):
        P.stream_dp_budget_by_name("nope")


def test_serve_queue_fault_and_slo_budgets():
    stable = P.serve_queue_model(1000.0, dispatch_ms=2.0, max_batch=128)
    assert stable["utilization"] < 1.0
    assert stable["miss_frac"] == 0.0 and stable["shed_frac"] == 0.0
    over_off = P.serve_queue_model(2 * 64000.0, 2.0, shed_policy="off")
    assert over_off["miss_frac"] == 1.0 and over_off["shed_frac"] == 0.0
    over_on = P.serve_queue_model(2 * 64000.0, 2.0, shed_policy="deadline")
    assert over_on["miss_frac"] == 0.0
    assert abs(over_on["shed_frac"] - 0.5) < 1e-9
    shed = P.serve_fault_p99_model(shedding=True)
    unshed = P.serve_fault_p99_model(shedding=False)
    assert shed["fault_p99_ms"] < unshed["fault_p99_ms"]
    assert shed["fault_p99_ms"] == pytest.approx(52.0)
    assert shed["inflation_x"] <= 8.0
    res = P.check_serve_slo_budgets()
    assert len(res) == len(P.SERVE_SLO_BUDGETS) == 12
    assert {r["name"] for r in res if not r["ok"]} == {
        n for n in P.CARD_MISSES if n.startswith("serve_")}
    assert P.serve_slo_budget_by_name("serve_shed_before_miss").check()["ok"]
    with pytest.raises(KeyError):
        P.serve_slo_budget_by_name("nope")
    with pytest.raises(ValueError):
        P.ServeSLOBudget("x", "nope", 1.0).measure()


def test_ckpt_overhead_model_and_budgets():
    ref = ref_kw(P.ckpt_overhead_time)
    assert P.ckpt_overhead_time(**ref)["overhead_frac"] <= 0.05
    uneco = P.ckpt_budget_by_name("ckpt_every_round_uneconomic")
    assert uneco.cmp == "ge" and uneco.check()["ok"]
    res = P.check_ckpt_budgets()
    assert [r["name"] for r in res] == [b.name for b in R.CKPT_BUDGETS]
    with pytest.raises(KeyError):
        P.ckpt_budget_by_name("nope")


def test_staleness_model_and_budgets():
    m = P.staleness_model()
    for key in ("wait_s", "train_s", "publish_s", "warm_s", "canary_s",
                "flip_s", "staleness_s", "train_frac"):
        assert key in m
    assert m["staleness_s"] > m["train_s"] > 0
    res = P.check_freshness_budgets()
    assert len(res) == len(P.FRESHNESS_BUDGETS) == 6
    assert all(r["ok"] for r in res), res
    screened = next(r for r in res
                    if r["name"] == "freshness_screen_train_leg")
    assert 0.0 < screened["screen_round_factor"] < 1.0
    cold = P.freshness_budget_by_name("freshness_cold_retrain_blows_slo")
    assert cold.cmp == "ge" and cold.check()["ok"]
    sub = P.check_freshness_budgets(names=["freshness_slo_ref"])
    assert len(sub) == 1 and sub[0]["name"] == "freshness_slo_ref"
    with pytest.raises(KeyError):
        P.freshness_budget_by_name("nope")


def test_screen_model_and_budgets():
    ref = ref_kw(P.feature_screen_time_model)
    t = P.feature_screen_time_model(**ref)
    assert t["speedup_x"] >= 1.5 and t["f_active"] == 34.0
    assert P.feature_screen_time_model(keep_ratio=1.0)["speedup_x"] == 1.0
    assert P.feature_screen_time_model(
        refresh_rounds=1)["avg_round_factor"] == 1.0
    res = P.check_screen_budgets()
    assert {r["name"] for r in res if not r["ok"]} == {
        n for n in P.CARD_MISSES if n.startswith("screen_")}
    with pytest.raises(KeyError):
        P.screen_budget_by_name("nope")


def test_sweep_model_and_budgets():
    results = P.check_sweep_budgets()
    assert len(results) == len(P.SWEEP_BUDGETS) == 5
    assert all(r["ok"] for r in results), results
    by = {r["name"]: r for r in results}
    assert by["sweep_speedup_d8"]["measured"] >= 2.0
    assert by["sweep_fused_gain_d1"]["measured"] >= 1.5
    assert by["sweep_tune_serve_slo"]["measured"] <= 300.0
    assert by["sweep_serial_blows_tune_slo"]["measured"] > 300.0
    t1 = P.sweep_time_model(n_devices=1)
    t8 = P.sweep_time_model(n_devices=8)
    assert t8["makespan_s"] < t1["makespan_s"] < t1["serial_s"]
    assert t8["chain_buckets"] == 2
    s = P.sweep_staleness_model(n_devices=8)
    assert s["tune_serve_s"] == pytest.approx(
        s["sweep_s"] + s["winner_train_s"] + s["publish_s"]
        + s["warm_s"] + s["canary_s"] + s["flip_s"])
    assert P.sweep_staleness_model(serial=True)["sweep_s"] \
        == pytest.approx(t1["serial_s"])
    with pytest.raises(KeyError):
        P.sweep_budget_by_name("nope")


# -- specs, bars, constants and the card's misses -------------------------

FAMILIES = (("COMM_BUDGETS", "COMM_BUDGETS"),
            ("COMM_TIME_BUDGETS", "COMM_TIME_BUDGETS"),
            ("STREAM_TIME_BUDGETS", "STREAM_TIME_BUDGETS"),
            ("STREAM_DP_BUDGETS", "STREAM_DP_BUDGETS"),
            ("SERVE_SLO_BUDGETS", "SERVE_SLO_BUDGETS"),
            ("CKPT_BUDGETS", "CKPT_BUDGETS"),
            ("FRESHNESS_BUDGETS", "FRESHNESS_BUDGETS"),
            ("SCREEN_BUDGETS", "SCREEN_BUDGETS"),
            ("SWEEP_BUDGETS", "SWEEP_BUDGETS"))


@pytest.mark.parametrize("port_name,ref_name", FAMILIES)
def test_spec_names_and_bars_are_the_references(port_name, ref_name):
    """Every spec keeps the reference's name, operating point and bar; the
    one that names a TPU quantity is renamed and measures the card's
    (B4's shared memory against the opt-in limit)."""
    ports = {b.name: b for b in getattr(P, port_name)}
    refs = {RENAMED.get(b.name, b.name): b for b in getattr(R, ref_name)}
    assert list(ports) == list(refs)
    for name, b in ports.items():
        r = refs[name]
        for field in r.__dataclass_fields__:
            if field == "note" or (name in RENAMED.values()
                                   and field in ("name", "kind", "budget")):
                continue
            assert getattr(b, field) == getattr(r, field), (name, field)
    smem = P.serve_slo_budget_by_name("serve_fused_smem_int8")
    assert smem.kind == "fused_smem_bytes" and smem.budget == P.SMEM_LIMIT


def roadmap_card_misses():
    """``{spec name: "ROADMAP C.k"}`` for every model spec that an entry of
    ROADMAP C names (in backticks): the misses' one written source."""
    with open(os.path.join(ROOT, "ROADMAP.md"), encoding="utf-8") as f:
        text = f.read()
    c = text[text.index("### C. "):]
    c = c[:c.index("\n## ")]
    specs = {r["name"] for res in P.model_sections().values() for r in res}
    out = {}
    for m in re.finditer(r"^- \*\*(C\.\d+)\. ", c, flags=re.M):
        entry = c[m.start():]
        ends = [i for i in (entry.find("\n\n"), entry.find("\n- **", 1))
                if i > 0]
        entry = entry[:min(ends, default=len(entry))]
        for name in re.findall(r"`([a-z0-9_]+)`", entry):
            if name in specs:
                out[name] = f"ROADMAP {m.group(1)}"
    return out


def test_card_misses_are_pinned():
    """The specs the card's figures miss are exactly CARD_MISSES, and
    exactly the specs ROADMAP C's entries name, each under its own entry;
    no bar moved to hide one."""
    sections = P.model_sections()
    missed = {r["name"] for res in sections.values() for r in res
              if not r["ok"]}
    assert missed == set(P.CARD_MISSES)
    assert roadmap_card_misses() == P.CARD_MISSES
    assert not any(P.section_failed(res) for res in sections.values())
    # a known miss that passes again is stale and fails its section
    fake = [{"name": "x", "ok": True, "known_miss": "ROADMAP C.9"}]
    assert P.section_failed(fake)
    assert P.section_failed([{"name": "y", "ok": False}])


def test_misses_at_another_runs_constants():
    """``misses_at`` runs the models on other figures (phase 26 calls it
    with its own run's): the committed figures give CARD_MISSES, a slower
    or faster host->device copy moves the stream specs across their bar,
    and only device constants can be replaced."""
    assert set(P.DEVICE_CONSTANTS) == set(CONSTANTS)
    committed = {n: getattr(P, n) for n in P.DEVICE_CONSTANTS}
    assert P.misses_at(committed) == sorted(P.CARD_MISSES)
    stream = {b.name for b in P.STREAM_TIME_BUDGETS}
    slow = set(P.misses_at({"H2D_BYTES_PER_S": 1e10}))
    fast = set(P.misses_at({"H2D_BYTES_PER_S": 1e12}))
    assert stream <= slow and not stream & fast
    assert slow - stream == fast - stream == set(P.CARD_MISSES) - stream
    assert P.H2D_BYTES_PER_S == committed["H2D_BYTES_PER_S"]
    with pytest.raises(KeyError):
        P.with_constants({"DAEMON_TICK_S": 2.0})


def test_constants_are_the_cards_not_a_tpus():
    for const, kw in CONSTANTS.items():
        v = getattr(P, const)
        assert math.isfinite(v) and v >= 0, const
        if const != "ROUND_F_AXIS_FRAC":
            assert v > 0, const
        assert v != REF[kw], f"{const} is the reference's TPU figure"
    assert P.CARD == "NVIDIA H100 80GB HBM3, 700.00 W"
    # the settings that are not device figures keep the reference's values
    assert (P.DAEMON_TICK_S, P.FRESHNESS_SLO_S, P.TUNE_SERVE_SLO_S,
            P.REF_ROWS_PER_SHARD, P._WIRE_BYTES) == (
        R.DAEMON_TICK_S, R.FRESHNESS_SLO_S, R.TUNE_SERVE_SLO_S,
        R.REF_ROWS_PER_SHARD, R._WIRE_BYTES)
    src = inspect.getsource(P)
    for figure in ("45e9", "2.0e13", "16e9", "7.2e6", "16 MB"):
        assert figure not in src, figure


def test_default_pass_imports_no_torch():
    """``lint``'s default pass (AST rules, GL010, GL014, the nine model
    families, the anchors) with the package's ``__init__`` left out — it
    loads torch for the public API — imports no torch and exits 0."""
    code = (
        "import sys, types\n"
        "pkg = types.ModuleType('lightgbm_tpu_torch')\n"
        f"pkg.__path__ = [{os.path.join(ROOT, 'lightgbm_tpu_torch')!r}]\n"
        "sys.modules['lightgbm_tpu_torch'] = pkg\n"
        "from lightgbm_tpu_torch.analysis.cli import main\n"
        "rc = main(['-q'])\n"
        "print('RESULT', rc, 'torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "RESULT 0 False", \
        proc.stdout[-2000:]
