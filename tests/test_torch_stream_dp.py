"""Port parity: streamed data-parallel training (``data/stream_dp.py``,
``shard_block_store``, the Booster's ``_maybe_setup_stream_dp``) against
the reference's ``lightgbm_tpu/data/stream_dp.py`` on the CPU.

The reference runs on the 8 virtual JAX CPU devices of
``tests/conftest.py``; the port on 8 virtual shards
(``parallel.set_virtual_devices(8)``).  Tolerances (the module docstring of
``data/stream_dp.py`` states the summation order):

* dyadic tier (l2 on y in {0, 1} with exactly n/2 ones: every round-1
  histogram sum exact in any order): the round-1 tree and train scores are
  bit for bit the reference's streamed dp ones, the port's serial streamed
  ones and the port's in-memory mesh ones — strict, wave and exact-tail
  growers, every merge mode at f32 wire, one and two blocks a shard, D = 2,
  4 and 8;
* general data, three rounds: split structure equal and leaf values and
  scores within rtol 1e-5 / atol 1e-6 of the reference's streamed dp and of
  the port's serial streamed run;
* GOSS at the source: each shard's odometer moves the reference's bytes
  (its sampled gather and one traversal pass); at f32 wire the tree is the
  reference's within the regime, at int8 wire its structure is the
  reference's and its leaves within the wire's stated 3% of the largest
  (``tests/test_torch_parallel.py``: an int8 hop may round an ulp apart);
* ``shard_block_store``, ``choose_stream_dp_devices`` and the odometers
  keep the reference's contract; the fallbacks warn and the voting merge
  raises ``StreamScopeError`` as the reference's do;
* elastic resume: the same D bit for bit, D = 8 -> 4, the first round
  bit-identical across D, and the refusals by field.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.data.block_store as RB
import lightgbm_tpu.data.stream_dp as RS
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.data.block_store as PB
import lightgbm_tpu_torch.data.stream_dp as PS
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.faults import StreamScopeError
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.parallel import set_virtual_devices
from lightgbm_tpu_torch.training import (IncompatibleCheckpointError,
                                         resume_booster)

BASE = dict(objective="l2", num_leaves=15, learning_rate=0.5,
            min_data_in_leaf=5, max_bin=63, verbose=-1, seed=7)
GROWERS = {"strict": {"wave_width": 1}, "wave": {"wave_width": 4},
           "exact": {"wave_width": 4, "wave_tail": "exact"}}
MERGES = ("psum", "reduce_scatter", "reduce_scatter_ring",
          "reduce_scatter_pipelined")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def virtual8():
    set_virtual_devices(8)
    yield
    set_virtual_devices(0)


def _problem(n, f, seed=0, dyadic=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    w = rng.normal(0, 1, f)
    s = (X @ w) * 0.7 + 0.6 * np.sin(X[:, 0] * 2)
    if dyadic:
        y = np.zeros(n, np.float32)
        y[np.argsort(s, kind="stable")[n // 2:]] = 1.0
    else:
        y = (s + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _blocks(X, y, br):
    return [(X[lo:lo + br], y[lo:lo + br]) for lo in range(0, len(X), br)]


def _port(params, X, y, br=256, rounds=1, streamed=True):
    p = dict(params, stream_block_rows=br)
    ds = (P.Dataset.from_blocks(_blocks(X, y, br), params=dict(p),
                                device="cpu") if streamed
          else P.Dataset(X, label=y, params=dict(p), device="cpu"))
    b = P.Booster(p, ds)
    for _ in range(rounds):
        b.update()
    return b


def _ref(params, X, y, br=256, rounds=1):
    p = dict(params, stream_block_rows=br)
    b = R.Booster(p, R.Dataset.from_blocks(_blocks(X, y, br), params=dict(p)))
    assert b._stream_dp
    for _ in range(rounds):
        b.update()
    return b


def _bit_equal(ta, tb):
    assert set(ta) == set(tb)
    for k in ta:
        assert np.array_equal(ta[k], tb[k]), k


def _regime(a, b, n_trees):
    for i in range(n_trees):
        ta = p_arrays(a.trees[i])
        tb = (p_arrays if isinstance(b, P.Booster) else r_arrays)(b.trees[i])
        for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
            assert np.array_equal(ta[k], tb[k]), (i, k)
        np.testing.assert_allclose(ta["leaf_value"], tb["leaf_value"],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a._pred_train.numpy(),
                               np.asarray(b._pred_train), rtol=1e-5,
                               atol=1e-6)


# -- the block stores --------------------------------------------------------


def test_shard_block_store_and_devices_match_reference():
    for nb in range(1, 17):
        for d in range(1, 9):
            assert PS.choose_stream_dp_devices(nb, d) == \
                RS.choose_stream_dp_devices(nb, d)
    codes = (np.arange(8 * 256 * 3) % 250).astype(np.uint8).reshape(-1, 3)
    # 1,800 real rows: the last shard's block is a padded tail
    for rows, n_sh in ((codes, 4), (codes[:1800], 4), (codes[:1800], 8)):
        store, rstore = (PB.BlockStore.from_binned(rows, 256),
                         RB.BlockStore.from_binned(rows, 256))
        store.max_read_retries, store.verify_checksums = 5, False
        shards = PB.shard_block_store(store, n_sh)
        rshards = RB.shard_block_store(rstore, n_sh)
        assert [(s.num_blocks, s.num_rows, s.padded_rows) for s in shards] \
            == [(s.num_blocks, s.num_rows, s.padded_rows) for s in rshards]
        assert all(a is b for s_i, s in enumerate(shards)
                   for a, b in zip(s.blocks, store.blocks[
                       s_i * s.num_blocks:]))
        assert all(s.max_read_retries == 5 and not s.verify_checksums
                   for s in shards)
        got = np.concatenate([b.numpy() for s in shards
                              for _, b in s.device_blocks()])
        assert np.array_equal(got, np.concatenate(store.blocks))
        assert [s.bytes_streamed for s in shards] == \
            [sum(b.nbytes for b in s.blocks) for s in shards]
        assert store.bytes_streamed == 0
        # a column view of a shard counts its bytes on the real shard
        view = PB.ColumnViewStore(shards[0], [0, 2])
        before = shards[0].bytes_streamed
        assert all(b.shape[1] == 2 for _, b in view.device_blocks())
        assert shards[0].bytes_streamed - before == \
            shards[0].padded_rows * 2
        PS.drain_shard_odometers(store, shards)
        assert store.bytes_streamed == sum(s.bytes_streamed for s in shards)
    for bad in (3, 0):
        with pytest.raises(ValueError, match="n_shards|shard"):
            PB.shard_block_store(store, bad)


def test_setup_warnings_and_refusals():
    X, y = _problem(2000, 5, dyadic=False)
    p = dict(BASE, tree_learner="data")
    b = _port(p, X, y, rounds=0)
    assert isinstance(b._mesh, PS.StreamMesh) and b._mesh.n_devices == 8
    assert b._mesh.mode == "reduce_scatter_pipelined" and b._mesh.chunks == 4
    assert all(sh.num_blocks == 1 for sh in b._mesh.shards)
    assert b.parallel_meta() == {"tree_learner": "data", "n_devices": 8,
                                 "merge_mode": "reduce_scatter_pipelined",
                                 "voting_k": 0}
    b = _port(dict(p, stream_dp_devices=3, stream_prefetch_blocks=2), X, y,
              rounds=0)
    assert b._mesh.n_devices == 2          # the largest divisor of 8 <= 3
    assert all(sh.prefetch_blocks == 2 for sh in b._mesh.shards)
    with pytest.warns(UserWarning, match="lockstep"):
        b = _port(p, X[:500], y[:500], br=512, rounds=0)
    assert b._mesh is None and b._streamed
    with pytest.warns(UserWarning, match="serial block loop"):
        b = _port(dict(p, objective="l1"), X, y, rounds=0)
    assert b._mesh is None
    with pytest.raises(StreamScopeError) as ei:
        _port(dict(p, histogram_merge="voting"), X, y, rounds=0)
    assert ei.value.key == "histogram_merge"
    set_virtual_devices(0)
    with pytest.warns(UserWarning, match="only one device"):
        assert _port(p, X, y, rounds=0)._mesh is None


# -- parity ------------------------------------------------------------------


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("grower", sorted(GROWERS))
def test_dyadic_bit_identical(grower, merge):
    """One block a shard (8 blocks, a ragged tail): the reference's streamed
    dp, the port's serial streamed and in-memory mesh trees, bit for bit."""
    X, y = _problem(2000, 13)
    p = dict(BASE, tree_learner="data", histogram_merge=merge,
             **GROWERS[grower])
    ours = _port(p, X, y)
    assert ours._mesh.n_devices == 8 and ours._mesh.mode == merge
    ta = p_arrays(ours.trees[0])
    _bit_equal(r_arrays(_ref(p, X, y).trees[0]), ta)
    serial = _port(dict(p, tree_learner="serial"), X, y)
    _bit_equal(p_arrays(serial.trees[0]), ta)
    mem = _port(p, X, y, streamed=False)
    assert mem._mesh is not None and mem._mesh.n_devices == 8
    _bit_equal(p_arrays(mem.trees[0]), ta)
    assert torch.equal(ours._pred_train, serial._pred_train)


@pytest.mark.parametrize("d", [8, 4, 2])
def test_dyadic_two_blocks_a_shard(d):
    """16 blocks (a ragged tail) at D = 8, 4, 2: two to eight blocks a
    shard, each block-round merged, accumulated in float64."""
    X, y = _problem(3996, 13)
    p = dict(BASE, tree_learner="data", stream_dp_devices=d)
    ours = _port(p, X, y)
    assert ours._mesh.n_devices == d
    assert all(sh.num_blocks == 16 // d for sh in ours._mesh.shards)
    serial = _port(dict(p, tree_learner="serial"), X, y)
    _bit_equal(p_arrays(serial.trees[0]), p_arrays(ours.trees[0]))
    assert torch.equal(ours._pred_train, serial._pred_train)
    if d == 8:
        _bit_equal(r_arrays(_ref(p, X, y).trees[0]), p_arrays(ours.trees[0]))
    # each shard streamed its 1/D of the serial run's bytes
    per = [sh.bytes_streamed for sh in ours._mesh.shards]
    assert len(set(per)) == 1
    assert ours.train_set.block_store.bytes_streamed == sum(per) == \
        serial.train_set.block_store.bytes_streamed


@pytest.mark.parametrize("merge", ["psum", "reduce_scatter_pipelined"])
@pytest.mark.parametrize("grower", ["strict", "wave"])
def test_general_data_regime(grower, merge):
    X, y = _problem(3996, 13, seed=4, dyadic=False)
    p = dict(BASE, tree_learner="data", histogram_merge=merge,
             learning_rate=0.2, **GROWERS[grower])
    ours = _port(p, X, y, rounds=3)
    _regime(ours, _ref(p, X, y, rounds=3), 3)
    _regime(ours, _port(dict(p, tree_learner="serial"), X, y, rounds=3), 3)


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_goss_at_the_source(wire):
    """GOSS samples each shard's rows on the host under ``(seed, shard)``:
    the same rows the reference samples, so each shard's odometer moves the
    reference's bytes, and the compacted shards grow the reference's tree
    (the int8 wire's ring hops included)."""
    X, y = _problem(3996, 13)
    p = dict(BASE, tree_learner="data", boosting="goss", top_rate=0.1,
             other_rate=0.1, histogram_merge="reduce_scatter_ring",
             histogram_wire=wire)
    ours, ref = _port(p, X, y), _ref(p, X, y)
    assert ours._mesh.wire == wire
    assert [sh.bytes_streamed for sh in ours._mesh.shards] == \
        [sh.bytes_streamed for sh in ref._stream_shards]
    full = sum(b.nbytes for b in ours.train_set.block_store.blocks) / 8
    assert all(full < s.bytes_streamed < 1.5 * full
               for s in ours._mesh.shards)
    if wire == "f32":
        _regime(ours, ref, 1)
        return
    # an int8 hop rounds an ulp apart where XLA fuses the dequantize-and-add
    # and the next quantizer may take the other step: the structure is the
    # reference's, the leaves within the wire's stated 3% of the largest
    ta, tb = p_arrays(ours.trees[0]), r_arrays(ref.trees[0])
    for k in ("split_feature", "split_bin", "left", "right", "is_leaf"):
        assert np.array_equal(ta[k], tb[k]), k
    lv = np.abs(tb["leaf_value"]).max()
    assert np.abs(ta["leaf_value"] - tb["leaf_value"]).max() <= 0.03 * lv


def test_goss_codes_go_to_their_own_shards(monkeypatch):
    """Each shard's sampled codes go to that shard's device only: the
    round builds its layout from the per-shard blocks (never from codes
    concatenated on one device), and that layout is the one the
    concatenation would give."""
    from lightgbm_tpu_torch.parallel.data_parallel import MeshLayout

    built = []
    real = MeshLayout.of_row_blocks.__func__

    def spy(cls, mesh, blocks, *a, **k):
        built.append(real(cls, mesh, blocks, *a, **k))
        return built[-1]

    def refuse(*a, **k):
        raise AssertionError("a layout built from concatenated codes")

    monkeypatch.setattr(MeshLayout, "of_row_blocks", classmethod(spy))
    monkeypatch.setattr(MeshLayout, "__init__", refuse)
    X, y = _problem(3996, 13)
    p = dict(BASE, tree_learner="data", boosting="goss", top_rate=0.1,
             other_rate=0.1, histogram_merge="reduce_scatter")
    ours = _port(p, X, y, rounds=2)
    monkeypatch.undo()
    assert len(built) == 2
    lay = built[-1]
    devices = ours._mesh.mesh.devices
    assert [row[0].device for row in lay.blocks] == list(devices)
    whole = MeshLayout(lay.mesh, torch.cat([row[0] for row in lay.blocks]),
                       lay.num_bins, lay.mode, lay.wire, lay.chunks)
    for k in ("dr", "dc", "num_features", "f_loc", "num_bins", "bounds",
              "mode", "wire", "chunks", "voting_k"):
        assert getattr(lay, k) == getattr(whole, k), k
    for a, b in zip(lay.blocks, whole.blocks):
        assert torch.equal(a[0], b[0])


def test_screened_stream_dp_matches_serial_streamed():
    """Feature screening composes: each shard streams the active columns
    through a column view, counted on the shard; the trees are the serial
    streamed run's within the regime."""
    X, y = _problem(3996, 13, seed=5, dyadic=False)
    p = dict(BASE, tree_learner="data", learning_rate=0.2,
             feature_screen="ema", screen_keep_ratio=0.4,
             screen_refresh_rounds=3)
    ours = _port(p, X, y, rounds=4)
    _regime(ours, _port(dict(p, tree_learner="serial"), X, y, rounds=4), 4)


# -- elastic resume ------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt():
    """A D = 8 run checkpointed after 2 rounds and continued for 1 more."""
    set_virtual_devices(8)
    X, y = _problem(3996, 13)
    p = dict(BASE, tree_learner="data")
    b = _port(p, X, y, rounds=2)
    arrays, meta = b.checkpoint_state()
    b.update()
    set_virtual_devices(0)
    return X, y, p, b, arrays, meta


def _ds(p, X, y):
    return P.Dataset.from_blocks(_blocks(X, y, 256),
                                 params=dict(p, stream_block_rows=256),
                                 device="cpu")


def test_elastic_resume_same_d_and_d8_to_d4(ckpt):
    X, y, p, b8, arrays, meta = ckpt
    same = resume_booster((arrays, meta), _ds(p, X, y))
    assert same._mesh.n_devices == 8
    same.update()
    for ta, tb in zip(b8.trees, same.trees):
        _bit_equal(p_arrays(ta), p_arrays(tb))
    assert torch.equal(b8._pred_train, same._pred_train)
    meta4 = dict(meta, params=dict(meta["params"], stream_dp_devices=4))
    b4 = resume_booster((arrays, meta4), _ds(p, X, y))
    assert b4._mesh.n_devices == 4 and len(b4.trees) == 2
    for ta, tb in zip(b4.trees, b8.trees):
        _bit_equal(p_arrays(ta), p_arrays(tb))
    b4.update()
    _regime(b4, b8, 3)


def test_elastic_resume_first_round_bit_identical_across_d():
    X, y = _problem(3996, 13)
    p = dict(BASE, tree_learner="data")
    arrays, meta = _port(p, X, y, rounds=0).checkpoint_state()
    outs = []
    for d in (8, 4, 2):
        m = dict(meta, params=dict(meta["params"], stream_dp_devices=d))
        b = resume_booster((arrays, m), _ds(p, X, y))
        assert b._mesh.n_devices == d
        b.update()
        outs.append(b)
    for b in outs[1:]:
        _bit_equal(p_arrays(outs[0].trees[0]), p_arrays(b.trees[0]))
        assert torch.equal(outs[0]._pred_train, b._pred_train)


@pytest.mark.parametrize("case", ["foreign_d", "non_divisible",
                                  "requested_merge", "resolved_merge"])
def test_elastic_resume_refusals_by_field(ckpt, case):
    X, y, p, _, arrays, meta = ckpt
    par = dict(meta["parallel"])
    assert par["merge_mode"] == "reduce_scatter_pipelined"
    kw = {}
    if case == "foreign_d":
        par["n_devices"] = 3
    elif case == "non_divisible":
        par["n_devices"] = 6
    elif case == "requested_merge":
        kw["params"] = dict(p, histogram_merge="psum")
    else:
        par["merge_mode"] = "psum"
    field = ("n_devices" if case in ("foreign_d", "non_divisible")
             else "merge_mode")
    with pytest.raises(IncompatibleCheckpointError) as ei:
        resume_booster((arrays, dict(meta, parallel=par)), _ds(p, X, y),
                       **kw)
    assert ei.value.field == field and field in str(ei.value)
