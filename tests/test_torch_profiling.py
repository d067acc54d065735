"""Port parity: ``utils/profiling.py`` ``profile_training`` against the
reference's, on CPU tensors.

The report carries the reference's key set; ``rows``, ``hist_dtype`` and
the wave fields are the reference's on the same small problem (the wave
grower's regime: 4,096 rows, 16 leaves); the timed rounds are the rounds
``lgb.train`` grows with the same params, bit for bit; ``trace_dir``
exports a ``torch.profiler`` Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as P
from lightgbm_tpu.utils.profiling import profile_training as ref_profile
from lightgbm_tpu_torch.models.gbdt import Booster
from lightgbm_tpu_torch.models.tree import tree_to_arrays
from lightgbm_tpu_torch.utils.profiling import profile_training

PARAMS = {"objective": "binary", "num_leaves": 16, "learning_rate": 0.1,
          "verbose": -1}
ROUNDS = 2
TIMES = ("bin_construct_s", "histogram_pass_s", "split_scan_s",
         "partition_s", "tree_grow_s", "round_s", "train_total_s")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the growers run many small ops, which several
    test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=4096, f=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + rng.normal(0, 0.5, n) > 0).astype(
        np.float32)
    return X, y


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    X, y = _problem()
    trace = str(tmp_path_factory.mktemp("trace"))
    boosters = []
    orig = Booster.update_many

    def spy(self, k):
        orig(self, k)
        boosters.append(self)

    Booster.update_many = spy
    try:
        port = profile_training(dict(PARAMS), X, y, ROUNDS,
                                trace_dir=trace, device="cpu")
    finally:
        Booster.update_many = orig
    ref = ref_profile(dict(PARAMS), X, y, ROUNDS)
    return port, ref, boosters, trace


def test_report_has_the_reference_keys(reports):
    port, ref, _, _ = reports
    assert sorted(port) == sorted(ref)
    for k in TIMES:
        assert port[k] > 0, k
    assert port["rows_per_s"] == port["rows"] * ROUNDS / \
        port["train_total_s"]


@pytest.mark.parametrize("key", ["rows", "num_boost_round", "hist_dtype",
                                 "wave_width", "wave_tail",
                                 "wave_overgrow_leaves"])
def test_report_fields_equal_the_reference(reports, key):
    port, ref, _, _ = reports
    assert key in ref
    assert port[key] == ref[key]


def test_timed_rounds_equal_train(reports):
    _, _, boosters, _ = reports
    X, y = _problem()
    # the warm-up round, the timed round, the timed num_boost_round rounds
    assert [len(b.trees) for b in boosters] == [1, 1, ROUNDS]
    want = P.train(dict(PARAMS), P.Dataset(X, label=y, device="cpu"),
                   ROUNDS)
    got = boosters[-1]
    assert len(got.trees) == len(want.trees) == ROUNDS
    for a, b in zip(got.trees, want.trees):
        ta, tb = tree_to_arrays(a), tree_to_arrays(b)
        assert ta.keys() == tb.keys()
        for k in ta:
            assert np.array_equal(ta[k], tb[k], equal_nan=True), k


def test_trace_dir_writes_a_chrome_trace(reports):
    _, _, _, trace = reports
    path = os.path.join(trace, "profile_training.trace.json")
    with open(path) as f:
        doc = json.load(f)
    assert doc["traceEvents"]
