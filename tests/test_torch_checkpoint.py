"""Port parity: checkpoints and resume (``training/checkpoint.py``,
``training/loop.py``, ``Booster.checkpoint_state``) on the CPU.

The contract is BIT-IDENTITY, not tolerance: a run killed at ANY round and
resumed from its checkpoint grows the same forest (every tree buffer
``np.array_equal``) with the same train scores and bag as the run that was
never interrupted — for the strict grower, the wave grower, multiclass
(K = 3) and ``hist_dtype="int8"`` (the reference's
``tests/test_checkpoint.py``).  Then the durability half: torn and corrupt
files are rejected naming the damaged field, ``load_latest`` falls back past
them, ``keep_last`` prunes.  And interchange, both ways: a checkpoint the
reference wrote resumes in the port (every array of the resumed state equal
to the reference's bit for bit; the continued forest structure-equal to the
reference's own continuation, leaves and predictions within rtol 1e-5 /
atol 1e-6, PARITY.md's regime), and one the port wrote loads and resumes in
the reference.  ``schema_digest`` equals the reference's.
"""

import hashlib
import io
import os
import signal

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.training as RT
import lightgbm_tpu_torch as P
from lightgbm_tpu.data.sketch import schema_digest as r_digest
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.data import schema_digest
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.training import (
    CKPT_FORMAT_VERSION, CorruptCheckpointError, IncompatibleCheckpointError,
    latest_checkpoint, list_checkpoints, load_checkpoint, load_latest,
    resume_booster, save_checkpoint, train_resumable)
from lightgbm_tpu_torch.training.checkpoint import _HEADER_LEN, CKPT_MAGIC

RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves")
ROUNDS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the strict grower runs thousands of small ops,
    which several test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(n=700, f=5, seed=0, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    s = X @ w + 0.3 * rng.normal(size=n)
    if classes > 2:
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-s))).astype(np.float32)
    return X, y


BASE = dict(objective="binary", num_leaves=7, learning_rate=0.2, max_bin=31,
            min_data_in_leaf=5, verbose=-1, seed=7, bagging_fraction=0.8,
            bagging_freq=1, feature_fraction=0.8)
CASES = {
    "strict": {},
    "wave": {"grow_policy": "frontier"},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "int8": {"hist_dtype": "int8", "grow_policy": "frontier"},
}


def _make(case="strict", seed=0):
    p = dict(BASE, **CASES[case])
    X, y = _problem(seed=seed, classes=p.get("num_class", 2))

    def make_ds():
        return P.Dataset(X, label=y, params=dict(p), device="cpu")
    return p, make_ds, X, y


def _uninterrupted(p, make_ds, rounds=ROUNDS):
    b = P.Booster(dict(p), make_ds())
    for _ in range(rounds):
        b.update()
    return b


def _assert_same_run(ref, got):
    assert len(ref.trees) == len(got.trees)
    for ta, tb in zip(ref.trees, got.trees):
        a, b = p_arrays(ta), p_arrays(tb)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert torch.equal(ref._pred_train, got._pred_train)
    assert torch.equal(ref._bag, got._bag)


@pytest.mark.parametrize("case", list(CASES))
def test_kill_at_every_round_resumes_bit_identical(tmp_path, case):
    """Checkpoint every round, then resume from EVERY generation k and train
    the remaining rounds: each resumed run equals the uninterrupted one bit
    for bit."""
    p, make_ds, _, _ = _make(case)
    ref = _uninterrupted(p, make_ds)
    d = str(tmp_path / "ckpts")
    res = train_resumable(dict(p), make_ds(), ROUNDS, checkpoint_dir=d,
                          checkpoint_rounds=1, keep_last=ROUNDS + 1,
                          resume=False)
    assert res.completed and not res.preempted
    assert res.rounds_done == ROUNDS and res.checkpoint_failures == 0
    _assert_same_run(ref, res.booster)

    paths = list_checkpoints(d)
    assert [load_checkpoint(q)[1]["iter"] for q in paths] \
        == list(range(1, ROUNDS + 1))
    for k, path in zip(range(1, ROUNDS), paths):
        b = resume_booster(path, make_ds())
        assert b._iter == k and b.device.type == "cpu"
        for _ in range(ROUNDS - k):
            b.update()
        _assert_same_run(ref, b)
    if case == "multiclass":
        arrays, meta = load_checkpoint(paths[0])
        assert arrays["init_score"].shape == (3,)
        assert meta["init_score"] is None
        assert arrays["pred_train"].shape == (768, 3)     # padded rows


def test_sigterm_drains_checkpoints_and_resumes(tmp_path):
    """A real SIGTERM mid-run: the in-flight round completes, a checkpoint
    lands, and a second invocation resumes to the uninterrupted run."""
    p, make_ds, _, _ = _make("strict")
    ref = _uninterrupted(p, make_ds, 6)
    d = str(tmp_path / "ckpts")

    def kill_at(booster, i):
        if i == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    res = train_resumable(dict(p), make_ds(), 6, checkpoint_dir=d,
                          checkpoint_rounds=10, resume=False,
                          round_callbacks=[kill_at])
    assert signal.getsignal(signal.SIGTERM) == before
    assert res.preempted and not res.completed
    assert res.rounds_done == 3          # round index 2 finished
    assert load_checkpoint(res.last_checkpoint)[1]["iter"] == 3

    res2 = train_resumable(dict(p), make_ds(), 6, checkpoint_dir=d,
                           checkpoint_rounds=10, resume=True)
    assert res2.completed and res2.resumed_from == res.last_checkpoint
    _assert_same_run(ref, res2.booster)


# -- durability: torn / corrupt artifacts --------------------------------


def _one_checkpoint(tmp_path, rounds=2):
    p, make_ds, _, _ = _make("strict")
    b = _uninterrupted(p, make_ds, rounds)
    return save_checkpoint(b, str(tmp_path / "ckpts")), make_ds


def _rewrite_payload(path, mutate):
    """Re-serialize a checkpoint with one array mutated and the OUTER sha256
    recomputed — so only the per-field crc can catch it."""
    with open(path, "rb") as f:
        blob = f.read()
    with np.load(io.BytesIO(blob[_HEADER_LEN:])) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    mutate(arrays)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    header = (CKPT_MAGIC + np.uint32(CKPT_FORMAT_VERSION).tobytes()
              + hashlib.sha256(payload).digest())
    with open(path, "wb") as f:
        f.write(header + payload)


@pytest.mark.parametrize("field", ["pred_train", "key", "bag",
                                   "tree00000/leaf_value",
                                   "tree00001/split_bin"])
def test_per_field_corruption_rejected_naming_field(tmp_path, field):
    path, _ = _one_checkpoint(tmp_path)

    def flip(arrays):
        arrays[field].view(np.uint8).reshape(-1)[0] ^= 0xFF
    _rewrite_payload(path, flip)
    with pytest.raises(CorruptCheckpointError) as ei:
        load_checkpoint(path)
    assert ei.value.field == field
    assert field in str(ei.value)


def test_torn_write_bitrot_magic_and_version_rejected(tmp_path):
    path, _ = _one_checkpoint(tmp_path)
    with open(path, "rb") as f:
        blob = f.read()
    for cut in (0, _HEADER_LEN - 5, _HEADER_LEN + 10, len(blob) - 1):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(CorruptCheckpointError):
            load_checkpoint(path)
    rot = bytearray(blob)
    rot[_HEADER_LEN + 100] ^= 0x01
    with open(path, "wb") as f:
        f.write(bytes(rot))
    with pytest.raises(CorruptCheckpointError, match="sha256"):
        load_checkpoint(path)
    with open(path, "wb") as f:
        f.write(blob.replace(CKPT_MAGIC, b"NOTLGBTP", 1))
    with pytest.raises(CorruptCheckpointError, match="magic"):
        load_checkpoint(path)
    skew = bytearray(blob)
    skew[len(CKPT_MAGIC):len(CKPT_MAGIC) + 4] = \
        np.uint32(CKPT_FORMAT_VERSION + 9).tobytes()
    with open(path, "wb") as f:
        f.write(bytes(skew))
    with pytest.raises(IncompatibleCheckpointError) as ei:
        load_checkpoint(path)
    assert ei.value.field == "format_version"


def test_schema_drift_rejected(tmp_path):
    path, _ = _one_checkpoint(tmp_path)
    X2, y2 = _problem(seed=99)
    other = P.Dataset(X2 * 3.0 + 1.0, label=y2, device="cpu")
    with pytest.raises(IncompatibleCheckpointError, match="binning") as ei:
        resume_booster(path, other)
    assert ei.value.field == "schema_digest"


def test_load_latest_falls_back_past_corrupt_newest(tmp_path):
    p, make_ds, _, _ = _make("strict")
    d = str(tmp_path / "ckpts")
    b = P.Booster(dict(p), make_ds())
    b.update()
    save_checkpoint(b, d)
    b.update()
    newest = save_checkpoint(b, d)
    blob = bytearray(open(newest, "rb").read())
    blob[-1] ^= 0xFF
    with open(newest, "wb") as f:
        f.write(bytes(blob))

    path, found = load_latest(d)
    assert path is not None and path != newest
    assert found["meta"]["iter"] == 1
    assert [q for q, _ in found["rejected"]] == [newest]

    ref = _uninterrupted(p, make_ds)
    with pytest.warns(UserWarning, match="corrupt checkpoint"):
        res = train_resumable(dict(p), make_ds(), ROUNDS, checkpoint_dir=d,
                              checkpoint_rounds=10, resume=True)
    assert res.completed and res.resumed_from == path
    _assert_same_run(ref, res.booster)


def test_keep_last_prunes_old_generations(tmp_path):
    p, make_ds, _, _ = _make("strict")
    d = str(tmp_path / "ckpts")
    res = train_resumable(dict(p), make_ds(), 5, checkpoint_dir=d,
                          checkpoint_rounds=1, keep_last=2, resume=False)
    assert res.completed
    paths = list_checkpoints(d)
    assert len(paths) == 2 and latest_checkpoint(d) == paths[-1]
    assert load_checkpoint(paths[-1])[1]["iter"] == 5
    assert not [n for n in os.listdir(d) if n.startswith(".tmp-")]


# -- interchange with the reference ---------------------------------------


def _dyadic(n=4096, f=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    order = np.argsort(X @ w + 0.6 * np.sin(X[:, 0] * 2))
    y = np.zeros(n, np.float32)
    y[order[n // 2:]] = 1.0
    return X, y


def _assert_regime(ref_booster, port_booster, X):
    assert len(ref_booster.trees) == len(port_booster.trees)
    for tr, tp in zip(ref_booster.trees, port_booster.trees):
        a, b = r_arrays(tr), p_arrays(tp)
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port_booster.predict(X), ref_booster.predict(X),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("tier", ["dyadic", "general"])
def test_reference_checkpoint_resumes_in_port(tmp_path, tier):
    if tier == "dyadic":
        X, y = _dyadic()
        p = dict(objective="l2", num_leaves=15, learning_rate=0.5,
                 min_data_in_leaf=5, max_bin=63, verbose=-1)
        at, rounds = 1, 3
    else:
        p, _, X, y = _make("strict")
        at, rounds = 2, ROUNDS
    rb = R.Booster(dict(p), R.Dataset(X, label=y, params=dict(p)))
    for _ in range(at):
        rb.update()
    path = RT.save_checkpoint(rb, str(tmp_path / "ref"))
    pb = resume_booster(path, P.Dataset(X, label=y, params=dict(p),
                                        device="cpu"))
    # the resumed state is the reference's, bit for bit, in either layout
    want, wmeta = RT.load_checkpoint(path)
    got, gmeta = pb.checkpoint_state()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    assert {k: v for k, v in gmeta.items() if k != "params"} \
        == {k: v for k, v in wmeta.items()
            if k not in ("params", "format_version", "field_crcs")}
    if tier == "dyadic":
        assert np.array_equal(pb.predict(X), rb.predict(X))
    for _ in range(rounds - at):
        rb.update()
        pb.update()
    _assert_regime(rb, pb, X)


def test_port_checkpoint_resumes_in_reference(tmp_path):
    p, make_ds, X, y = _make("strict")
    pb = P.Booster(dict(p), make_ds())
    for _ in range(2):
        pb.update()
    path = save_checkpoint(pb, str(tmp_path / "port"))
    want = P.Booster(dict(p), make_ds())
    for _ in range(ROUNDS):
        want.update()
    rb = RT.resume_booster(path, R.Dataset(X, label=y, params=dict(p)))
    assert rb._iter == 2
    assert np.array_equal(np.asarray(rb._key), pb._key)
    for _ in range(ROUNDS - 2):
        rb.update()
    _assert_regime(rb, want, X)
    assert RT.latest_checkpoint(str(tmp_path / "port")) == path


def test_schema_digest_equals_reference_and_tells_binnings_apart():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(600, 10))
    X[rng.random(600) < 0.1, 2] = np.nan
    # six sparse, mutually exclusive columns: exclusive feature bundling
    # joins them
    X[:, 4:] = 0.0
    hot = np.flatnonzero(rng.random(600) < 0.3)
    X[hot, 4 + rng.integers(0, 6, hot.size)] = rng.uniform(1, 2, hot.size)
    y = rng.normal(size=600)
    digests = {}
    for max_bin in (31, 63):
        r = R.Dataset(X, label=y, params={"max_bin": max_bin})
        q = P.Dataset(X, label=y, params={"max_bin": max_bin}, device="cpu")
        r.construct()
        q.construct()
        assert q.bin_mapper.bundler is not None
        assert q.bin_mapper.bundler.groups == r.bin_mapper.bundler.groups
        digests[max_bin] = schema_digest(q.bin_mapper)
        assert digests[max_bin] == r_digest(r.bin_mapper)
    assert digests[31] != digests[63]
