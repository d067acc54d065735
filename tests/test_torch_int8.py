"""Port parity: quantized-histogram training (``hist_dtype="int8"``, kernel
B1's int8 mode) against the reference on the CPU.

Every input is made from a numpy seed and goes through ``lightgbm_tpu`` (the
reference, its Pallas kernels in interpret mode, ``hist_impl="pallas"``, as
``tests/test_exact_wave.py`` runs them) and ``lightgbm_tpu_torch`` (the
plain versions):

* ``quantize_int8`` and ``hist_fused_plain(mode="int8")`` equal
  ``hist_fused_pallas(..., hist_dtype="int8")`` bit for bit (several seeds
  and segment counts, out-of-range segment ids, zero padding rows): the
  quantization is the same f32 arithmetic and the sums are exact integers;
* dyadic tier (l2 on y in {0, 1} with exactly n/2 ones: every round-1
  gradient is +-0.5, so every quantized value is exactly +-127 and every
  histogram cell exact): one wave-grower tree and the round-1 tree of a
  2-round ``train`` are bit-identical to the reference's, and the strict
  grower's round-1 tree too; the second round's tree (general gradients:
  quantized sums that are not exact, summed over bins in another order
  than XLA's) has the same split structure and leaf values within rtol
  1e-5, the port's regime for general data;
* binary on general data (XLA's f32 ``exp`` differs from torch's by an ulp
  in some rows, which can move a quantized value by one quantum): the split
  structure equal, leaf values and predictions within rtol 1e-5;
* int8 ``cv()`` and multiclass training equal their f32 runs in the port
  (the batched histograms run at full precision, as in the reference);
* the route: kernel B2 is never called under int8 or past 256 features;
* the int8 row limit (16,909,320) as a pure function, and
  ``use_quantized_grad`` resolving to bf16;
* the int8 kernel's launch plan (pure arithmetic): every row covered, a
  shared histogram within a block's memory and dense enough, else the
  global mode.

The kernel itself runs only on the card: its cases are in
``tests/test_torch_kernels_on_card.py`` (``gpu`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import grow_tree as r_grow
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops.histogram_pallas import (INT8_ACC_ROW_LIMIT,
                                               hist_fused_pallas)
from lightgbm_tpu.ops.split import SplitContext as RCtx
from lightgbm_tpu_torch.config import parse_params
from lightgbm_tpu_torch.models import gbdt as pg
from lightgbm_tpu_torch.models import tree as pt
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops.split import SplitContext as PCtx

RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves")
CTX = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=5.0,
           min_sum_hessian=1e-3, min_gain_to_split=0.0, max_delta_step=0.0,
           path_smooth=0.0)
DYADIC = dict(objective="regression", num_leaves=15, learning_rate=0.5,
              min_data_in_leaf=5, max_bin=31, hist_dtype="int8", verbose=-1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the growers run many small ops, which several
    test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


# ------------------------------------------------------ the histogram itself
@pytest.mark.parametrize("seed,n,f,nb,k", [(0, 2000, 4, 32, 7),
                                           (1, 3000, 3, 16, 1),
                                           (2, 1500, 6, 32, 3)])
def test_plain_int8_histogram_bit_equal_to_pallas(seed, n, f, nb, k):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    stats = np.column_stack([rng.normal(0, 1, n) * 3.0,
                             rng.uniform(0, 0.25, n),
                             rng.random(n) < 0.8]).astype(np.float32)
    stats[-37:] = 0.0                         # the Dataset's padding rows
    seg = rng.integers(-2, k + 2, n).astype(np.int32)
    want = hist_fused_pallas(jnp.asarray(bins), jnp.asarray(stats),
                             jnp.asarray(seg), k, nb, hist_dtype="int8",
                             interpret=True)
    got = th.hist_fused_plain(torch.from_numpy(bins),
                              torch.from_numpy(stats),
                              torch.from_numpy(seg), k, nb, "int8")
    assert np.array_equal(_bits(got), _bits(want))
    # the dispatching entry points take the same quantized contract
    auto = th.compute_histograms(torch.from_numpy(bins),
                                 torch.from_numpy(stats),
                                 torch.from_numpy(seg), k, nb,
                                 hist_dtype="int8")
    assert torch.equal(auto, got)


def test_quantize_int8_bit_equal_to_pallas():
    """One row per segment (feature 0, bin 0) makes the reference's output
    ``q_i * scale``, so equal bits mean equal quantized rows and scales; the
    rows cover both channel maxima, zeros and values next to a quantum."""
    rng = np.random.default_rng(5)
    n = 64
    stats = np.column_stack([rng.normal(0, 1, n),
                             rng.uniform(0, 1, n)]).astype(np.float32)
    stats[3, 0] = -np.abs(stats[:, 0]).max() * 1.5     # the channel max
    stats[4] = 0.0
    stats[5, 1] = stats[:, 1].max() * (126.5 / 127)
    bins = np.zeros((n, 1), np.uint8)
    seg = np.arange(n, dtype=np.int32)
    want = np.asarray(hist_fused_pallas(
        jnp.asarray(bins), jnp.asarray(stats), jnp.asarray(seg), n, 1,
        hist_dtype="int8", interpret=True))[:, 0, 0, :]
    q, scale = th.quantize_int8(torch.from_numpy(stats))
    assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
    assert int(q[3, 0]) == -127
    got = q.to(torch.int32).to(torch.float32) * scale
    assert np.array_equal(_bits(got), _bits(want))


def test_int8_row_limit_and_quantized_grad():
    assert INT8_ACC_ROW_LIMIT == th.INT8_ACC_ROW_LIMIT == 16_909_320
    p = parse_params({"objective": "regression", "hist_dtype": "int8"})
    pg.check_int8_row_limit(p, 16_909_320)
    with pytest.raises(ValueError, match="16,909,320"):
        pg.check_int8_row_limit(p, 16_909_321)
    pg.check_int8_row_limit(p, 2 * 16_909_320, n_shards=2)
    # only int8 is limited
    pg.check_int8_row_limit(parse_params({"objective": "regression"}),
                            10 ** 9)
    th.check_int8_rows(16_909_320)
    with pytest.raises(ValueError, match="int8"):
        th.check_int8_rows(16_909_321)
    q = parse_params({"use_quantized_grad": True, "hist_dtype": "int8"})
    assert pg.resolve_hist_dtype(q, 1000) == "bf16"
    assert pg.resolve_hist_dtype(p, 1000) == "int8"


# ------------------------------------------------------------ the growers
def _dyadic(n=3000, f=6, seed=0, num_bins=32):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    order = np.argsort(X @ rng.normal(0, 1, f) + 0.6 * np.sin(X[:, 0] * 2))
    y = np.zeros(n, np.float32)
    y[order[n // 2:]] = 1.0
    return X, y


@pytest.fixture(scope="module")
def dyadic_data():
    return _dyadic()


@pytest.mark.parametrize("enc", [-7, 40 * 1024 + 7])     # greedy, exact
def test_wave_tree_dyadic_bit_identical(enc):
    rng = np.random.default_rng(7)
    n, f, nb = 3000, 5, 32
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    g = np.where(rng.random(n) < 0.5 + 0.3 * (bins[:, 0] > 15), 0.5, -0.5)
    stats = np.stack([g, np.ones(n), np.ones(n)], 1).astype(np.float32)
    stats[-40:] = 0.0
    tr, rl_r = r_grow(jnp.asarray(bins), jnp.asarray(stats),
                      jnp.ones(f, jnp.float32),
                      RCtx(**{k: jnp.float32(v) for k, v in CTX.items()}),
                      15, nb, -1, wave_width=enc, hist_impl="pallas",
                      hist_dtype="int8")
    tp, rl_p = pt.grow_tree(torch.from_numpy(bins), torch.from_numpy(stats),
                            torch.ones(f), PCtx(**CTX), 15, nb, -1,
                            wave_width=enc, hist_dtype="int8")
    a, b = r_arrays(tr), p_arrays(tp)
    assert int(b["num_leaves"]) == 15
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    assert np.array_equal(np.asarray(rl_r), rl_p.numpy())


def _train_both(params, X, y, rounds):
    br = R.train(dict(params, hist_impl="pallas"), R.Dataset(X, label=y),
                 rounds)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), rounds)
    return br, bp


def _same_structure(br, bp, i):
    a, b = r_arrays(br.trees[i]), p_arrays(bp.trees[i])
    for key in STRUCTURE:
        assert np.array_equal(a[key], b[key]), (i, key)
    np.testing.assert_allclose(b["leaf_value"], a["leaf_value"], rtol=RTOL,
                               atol=ATOL)


def test_train_l2_int8_matches_reference(dyadic_data):
    """Two rounds on the wave grower: round 1 bit-identical (trees and the
    train scores), round 2 structure-equal within rtol 1e-5."""
    X, y = dyadic_data
    params = dict(DYADIC, grow_policy="frontier")
    br, bp = _train_both(params, X, y, 2)
    a, b = r_arrays(br.trees[0]), p_arrays(bp.trees[0])
    assert int(b["num_leaves"]) == 15
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    _same_structure(br, bp, 1)
    np.testing.assert_allclose(bp.predict(X), br.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_strict_grower_int8_round1_bit_identical(dyadic_data):
    """The strict grower: B1 int8 with two segments, then B3."""
    X, y = dyadic_data
    params = dict(DYADIC, grow_policy="leafwise", num_leaves=7)
    br, bp = _train_both(params, X, y, 1)
    a, b = r_arrays(br.trees[0]), p_arrays(bp.trees[0])
    assert int(b["num_leaves"]) == 7
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    assert np.array_equal(br.predict(X), bp.predict(X))


def test_train_binary_int8_structure_equal():
    rng = np.random.default_rng(11)
    n = 3000
    X = rng.normal(size=(n, 6))
    logits = 1.5 * X[:, 0] - X[:, 1] + X[:, 2] * X[:, 3]
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    params = dict(objective="binary", num_leaves=15, max_bin=31,
                  min_data_in_leaf=20, learning_rate=0.3, hist_dtype="int8",
                  grow_policy="frontier", verbose=-1)
    br, bp = _train_both(params, X, y, 2)
    for i in range(2):
        _same_structure(br, bp, i)
    np.testing.assert_allclose(bp.predict(X), br.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_int8_cv_and_multiclass_equal_f32(dyadic_data):
    """Batched histograms take the full-precision route under int8: int8
    ``cv()`` (fused, strict) and multiclass training equal their f32 runs."""
    X, y = dyadic_data
    ds = P.Dataset(X, label=y, device="cpu")
    base = dict(objective="regression", num_leaves=7, max_bin=31,
                learning_rate=0.3, bagging_fraction=0.8, bagging_freq=2,
                verbose=-1)
    q8 = P.cv(dict(base, hist_dtype="int8"), ds, 6, nfold=3,
              early_stopping_rounds=3, seed=2)
    f32 = P.cv(dict(base, hist_dtype="f32"), ds, 6, nfold=3,
               early_stopping_rounds=3, seed=2)
    assert q8.best_iter == f32.best_iter and q8.best_score == f32.best_score
    for key in f32:
        np.testing.assert_array_equal(q8[key], f32[key])
    yc = (X[:, 0] > 0).astype(np.float64) + (X[:, 1] > 0.5)
    mc = dict(objective="multiclass", num_class=3, num_leaves=7, max_bin=31,
              grow_policy="frontier", verbose=-1)
    dm = P.Dataset(X, label=yc, device="cpu")
    m8 = P.train(dict(mc, hist_dtype="int8"), dm, 1)
    m32 = P.train(dict(mc, hist_dtype="f32"), dm, 1)
    for key, v in p_arrays(m32.trees[0]).items():
        assert np.array_equal(p_arrays(m8.trees[0])[key], v), key


# ------------------------------------------------------------------ the route
def _spy_b2(monkeypatch):
    calls = {"b2": 0, "b1": 0}

    def spy(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(pt, "hist_partition_fused",
                        spy("b2", pt.hist_partition_fused))
    monkeypatch.setattr(pt, "hist_partition_plain",
                        spy("b2", pt.hist_partition_plain))
    monkeypatch.setattr(pt, "compute_histograms",
                        spy("b1", pt.compute_histograms))
    return calls


@pytest.mark.parametrize("f,hist_dtype,fused", [(6, "int8", False),
                                                (6, "bf16", True),
                                                (257, "f32", False),
                                                (256, "f32", True)])
def test_wave_route(monkeypatch, f, hist_dtype, fused):
    assert pt.wave_fuses_partition(f, 7, 32, hist_dtype) is fused
    rng = np.random.default_rng(f)
    n = 600
    bins = torch.from_numpy(rng.integers(0, 16, (n, f)).astype(np.uint8))
    stats = torch.from_numpy(np.stack(
        [rng.normal(size=n), np.ones(n), np.ones(n)], 1).astype(np.float32))
    calls = _spy_b2(monkeypatch)
    tree, _ = pt.grow_tree(bins, stats, torch.ones(f), PCtx(**CTX), 8, 16,
                           -1, wave_width=-7, hist_dtype=hist_dtype)
    waves = calls["b2"] if fused else calls["b1"] - 1
    assert int(tree.num_leaves) == 8 and waves >= 1
    assert (calls["b2"] > 0) is fused
    assert calls["b1"] == (1 if fused else 1 + waves)


@pytest.mark.parametrize("n,f,k,nb", [(1_000_192, 28, 1, 256),
                                      (1_000_192, 28, 42, 256),
                                      (1_000_192, 28, 2, 256),
                                      (100_003, 28, 42, 256),
                                      (20_011, 300, 70, 64),
                                      (4_099, 3, 5, 2), (10, 3, 1, 256)])
def test_int8_launch_plan(n, f, k, nb):
    """The int8 kernel's plan (pure arithmetic, no card): feature groups
    cover every feature and fit ``INT8_BLOCKS_PER_SM`` blocks to an SM
    (``INT8_ROOT_BLOCKS_PER_SM`` for one segment);
    items hold at least ``INT8_ROWS_PER_CELL`` rows per bin (or every
    row); one segment's row ranges cover every row in about ``target``
    blocks; for more, the item slots bound ``sum_k ceil(rows_k / R)`` for
    any split of any number of the rows, whatever size the device picks
    (at least the least size ``rows``)."""
    from lightgbm_tpu_torch.kernels import histogram as kh

    rows, fg, slots, target, part = kh.plan_int8(n, f, 3, k, nb, 132)
    assert 1 <= fg <= f and 1 <= part <= target
    groups = -(-f // fg)
    assert -(-f // groups) == fg                  # balanced groups
    least = -(-kh.INT8_ROWS_PER_CELL * nb // 32) * 32
    wide = k == 1 and -(-n // least) >= kh.INT8_ROOT_BLOCKS_PER_SM * 132
    per_sm = kh.INT8_ROOT_BLOCKS_PER_SM if wide else kh.INT8_BLOCKS_PER_SM
    assert kh.int8_smem_bytes(3, nb, fg) <= kh.SMEM_PER_SM // per_sm
    assert target == per_sm * 132
    if k == 1:
        assert rows == n or (rows >= least and rows % 32 == 0)
        assert slots * rows >= n > (slots - 1) * rows
        assert slots * groups <= max(target, groups * -(-n // least)) + \
            groups
    else:
        assert rows == min(least, -(-n // 32) * 32)
        rng = np.random.default_rng(n + k)
        for valid in (n, n // 3, k + 1, 1):
            r = kh.int8_item_rows(valid, rows, groups, target)
            assert r >= rows and r % 32 == 0
            # K - 1 one-row segments and the rest, and random splits
            splits = [[1] * (k - 1) + [valid - (k - 1)]] if valid >= k \
                else []
            splits += [rng.multinomial(valid, np.ones(k) / k)
                       for _ in range(3)]
            for counts in splits:
                assert sum(-(-c // r) for c in counts) <= slots


@pytest.mark.parametrize("seed,n,f,nb,k,lo", [(0, 3000, 4, 32, 1, 0),
                                              (1, 3001, 6, 64, 7, -3),
                                              (2, 2500, 3, 2, 3, 0)])
@pytest.mark.parametrize("rows,fg,target", [(512, 2, 1), (96, 6, 64),
                                             (4096, 4, 8)])
def test_int8_kernel_passes_bit_equal_to_pallas(seed, n, f, nb, k, lo, rows,
                                                fg, target):
    """The int8 kernel's passes repeated in PyTorch (one-pass channel
    scale, the rows grouped by segment into work items, one histogram per
    (item, feature group), the rescale) equal the reference's
    ``hist_fused_pallas`` in interpret mode bit for bit at several plans."""
    from lightgbm_tpu_torch.kernels import histogram as kh

    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nb, (n, f)).astype(np.uint8)
    stats = rng.normal(size=(n, 3)).astype(np.float32)
    stats[:, 2] = 0.0                              # an all-zero channel
    seg = rng.integers(lo, k + 2, n).astype(np.int32)
    want = hist_fused_pallas(jnp.asarray(bins), jnp.asarray(stats),
                             jnp.asarray(seg), k, nb, interpret=True,
                             hist_dtype="int8")
    got = kh.int8_passes_plain(torch.from_numpy(bins),
                               torch.from_numpy(stats),
                               torch.from_numpy(seg), k, nb, rows, fg,
                               target)
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("kind", ["normal", "zeros", "neg_zero", "tiny",
                                  "huge", "one_row"])
def test_int8_one_pass_scale_equals_quantize_int8(kind):
    """The kernel's one-pass channel scale (the largest bit pattern of
    ``|x|``) is ``quantize_int8``'s bit for bit, the all-zero channel's
    1e-30 floor included."""
    from lightgbm_tpu_torch.kernels import histogram as kh

    rng = np.random.default_rng(5)
    st = rng.normal(size=(997, 3)).astype(np.float32)
    if kind == "zeros":
        st[:, 1] = 0.0
    elif kind == "neg_zero":
        st[:, 0] = -0.0
        st[:, 2] = -st[:, 2] ** 2
    elif kind == "tiny":
        st *= np.float32(1e-38)
    elif kind == "huge":
        st *= np.float32(1e37)
    elif kind == "one_row":
        st = st[:1]
    t = torch.from_numpy(st)
    want = th.quantize_int8(t)[1]
    assert torch.equal(kh.int8_scale_plain(t).view(torch.int32),
                       want.view(torch.int32))
