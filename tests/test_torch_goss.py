"""Port parity: ``boosting="goss"`` (gradient-based one-side sampling,
Ke et al., NeurIPS 2017) against the reference on the CPU.

(a) the sort-free selection ``approx_top_mask`` (2 passes) and the
    multiclass row weights ``goss_weights`` are bit-equal to the reference's
    jitted functions over heavy-tailed, tied, padded and edge-count inputs,
    and with rows on the final bucket's edges: the reference's jitted
    passes contract ``lo + tb * w`` and, after the first pass,
    ``(tb + 1) * w - lo`` into fused multiply-adds, which the port rounds
    the same way; ``sample_bag`` (one pass) stays bit-equal;
(b) one compacted single-class round: the selected rows and their weights
    (the grower's statistics ``[g * wt, h * wt, live]``, bit-equal), the tree
    and the train scores against the reference's ``_goss_compact_round``
    under ``jax.jit``;
(c) ``train`` for 5 rounds on the strict grower (a = 0.2, b = 0.1) and the
    wave grower (a = 0.4, b = 0.3 at 7,000 rows: 4,900 compacted rows), l1
    renewal on the compacted rows, 3-class GOSS (rows re-weighted, not
    compacted), and per-fold ``cv()`` with early stopping: tree structure
    equal, leaf values, metrics and predictions within the parity regime
    (rtol 1e-5, atol 1e-6); the reference's train runs its scanned rounds,
    the port its host loop;
(d) GOSS resolves its histogram precision at the compacted row count,
    ``reset_parameter`` refuses ``top_rate``/``other_rate`` as the
    reference does, a killed and resumed run is bit-identical, and the
    sklearn estimator takes ``boosting_type="goss"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.models.gbdt as RG
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops import sampling as RS
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.models.gbdt import (resolve_hist_dtype,
                                            resolve_wave_width)
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.ops import sampling as PS
from lightgbm_tpu_torch.training import (list_checkpoints, resume_booster,
                                         train_resumable)
from lightgbm_tpu_torch.utils.random import fold_in, prng_key


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves", "count")
N_SEL = 4000
_ref_top = jax.jit(RS.approx_top_mask, static_argnums=(3, 4))
_ref_goss = jax.jit(RS.goss_weights)
_ref_bag = jax.jit(RS.sample_bag)


def _selection_input(seed):
    """|g|-like values of one of five kinds, a validity mask with padding,
    and a count that hits the edges (0, n_valid) on some seeds."""
    rng = np.random.default_rng(seed)
    kind = seed % 5
    x = np.abs(rng.standard_cauchy(N_SEL)).astype(np.float32)
    if kind == 1:                        # one outlier 1e6 x the rest
        x = rng.random(N_SEL).astype(np.float32)
        x[rng.integers(N_SEL)] = 1e6
    elif kind == 2:                      # heavy ties
        x = np.round(rng.random(N_SEL) * 4).astype(np.float32) / 4
    elif kind == 3:                      # all equal
        x = np.full(N_SEL, 0.5, np.float32)
    valid = np.ones(N_SEL, bool)
    valid[-int(rng.integers(0, 300)):] = False      # padded rows
    valid &= rng.random(N_SEL) < 0.95
    n_valid = int(valid.sum())
    k = {0: 0, 1: n_valid}.get(seed % 7, int(rng.integers(1, n_valid)))
    return x, valid, k


@pytest.mark.parametrize("seed", range(24))
def test_approx_top_mask_bit_equal(seed):
    x, valid, k = _selection_input(seed)
    want = np.asarray(_ref_top(jnp.asarray(x), jnp.asarray(valid), k, 2048,
                               2))
    got = PS.approx_top_mask(torch.from_numpy(x), torch.from_numpy(valid), k)
    assert np.array_equal(got.numpy(), want)
    assert int(got.sum()) == min(k, int(valid.sum()))
    # a device-tensor count selects the same rows
    got_t = PS.approx_top_mask(torch.from_numpy(x), torch.from_numpy(valid),
                               torch.tensor(k))
    assert torch.equal(got_t, got)


def _edges(x, valid, k, nb=2048):
    """The second pass's bucket ``[lo, hi)`` in numpy, rounded as the
    reference's jitted selection rounds it: ``lo + tb * w`` fused, and
    after the first pass (lo the constant 0) ``hi - lo`` fused as well."""
    f32 = np.float32
    x = np.where(valid, x, f32(0))
    hi = f32(max(x.max(), f32(1e-30))) * f32(1.0 + 1e-6)
    lo, span = f32(0), hi
    for p in range(2):
        w = f32(max(span / f32(nb), f32(1e-38)))
        in_rng = valid & (x >= lo) & (x < hi)
        code = np.clip(((x - lo) / w).astype(np.int32), 0, nb - 1)
        cnt_ge = np.bincount(code[in_rng], minlength=nb)[::-1].cumsum()[::-1]
        tb = max(int((cnt_ge >= k - (valid & (x >= hi)).sum()).sum()) - 1, 0)
        lo, hi = (f32(float(tb) * float(w) + float(lo)),
                  f32(float(tb + 1) * float(w) + float(lo)))
        span = (f32(float(tb + 1) * float(w) - float(lo)) if p == 0
                else hi - lo)
    return lo, hi


@pytest.mark.parametrize("seed", range(6))
def test_approx_top_mask_bit_equal_at_bucket_edges(seed):
    """Rows placed on the final bucket's edges and one ulp either side:
    where the reference's fused roundings decide membership (its jitted
    second pass contracts ``lo + tb * w`` and, after the first pass,
    ``(tb + 1) * w - lo``)."""
    rng = np.random.default_rng(83 + seed)
    x = np.abs(rng.standard_cauchy(3000)).astype(np.float32)
    valid = rng.random(3000) < 0.9
    k = int(rng.integers(1, valid.sum()))
    for e in _edges(x, valid, k):
        for v in (e, np.nextafter(e, np.float32(0)),
                  np.nextafter(e, np.float32(np.inf))):
            x2, v2 = x.copy(), valid.copy()
            x2[seed], v2[seed] = v, True
            want = np.asarray(_ref_top(jnp.asarray(x2), jnp.asarray(v2), k,
                                       2048, 2))
            got = PS.approx_top_mask(torch.from_numpy(x2),
                                     torch.from_numpy(v2), k)
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(20))
def test_goss_weights_bit_equal(seed):
    x, valid, _ = _selection_input(seed)
    a, b = [(0.2, 0.1), (0.3, 0.5), (0.0, 0.3), (0.5, 0.5), (0.1, 0.05)][
        seed % 5]                  # (0.5, 0.5): the a + b = 1 passthrough
    key = fold_in(prng_key(seed), 0x7FFFFFFF)
    mask = valid.astype(np.float32)
    want = np.asarray(_ref_goss(jnp.asarray(np.asarray(key, np.uint32)),
                                jnp.asarray(x), jnp.asarray(mask),
                                jnp.float32(a), jnp.float32(b),
                                jnp.float32(mask.sum())))
    m = torch.from_numpy(mask)
    got = PS.goss_weights(key, torch.from_numpy(x), m, a, b, m.sum())
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_sample_bag_stays_bit_equal(seed):
    _, valid, _ = _selection_input(seed)
    mask = valid.astype(np.float32)
    key = fold_in(prng_key(3 + seed), seed)
    for frac in (0.3, 0.632, 0.9):
        want = np.asarray(_ref_bag(jnp.asarray(np.asarray(key, np.uint32)),
                                   jnp.asarray(mask), jnp.float32(frac),
                                   jnp.float32(mask.sum())))
        got = PS.sample_bag(key, torch.from_numpy(mask), frac,
                            float(mask.sum()))
        assert np.array_equal(got.numpy(), want)


# ------------------------------------------------------------ (b) one round
def _problem(n, seed=3, classes=0, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    s = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n)
    if classes:
        y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float32)
    else:
        y = s.astype(np.float32)
    return X, y


@pytest.mark.parametrize("grower", ["strict", "wave"])
def test_goss_compact_round_matches_reference(grower, monkeypatch):
    n = 2000 if grower == "strict" else 6000
    a, b = (0.2, 0.1) if grower == "strict" else (0.4, 0.3)
    params = dict(objective="binary", boosting="goss", top_rate=a,
                  other_rate=b, num_leaves=15 if grower == "strict" else 31,
                  min_data_in_leaf=5, max_bin=63, verbose=-1, seed=11)
    X, s = _problem(n)
    y = (s > 0).astype(np.float32)
    rb = R.Booster(dict(params), R.Dataset(X, label=y))
    pb = P.Booster(dict(params), P.Dataset(X, label=y, device="cpu"))
    # scores of a model some rounds in: gradients of every size
    n_pad = int(pb._pred_train.shape[0])
    pred0 = (0.7 * np.random.default_rng(1).standard_normal(n_pad)
             ).astype(np.float32)
    ds = rb.train_set
    g, h = rb.obj.grad_hess(jnp.asarray(pred0), ds.y, rb._w_eff)
    goss_k = pb._goss_k()
    assert goss_k == (int(a * n), int(b * n))
    eff = sum(goss_k)
    assert (RG.resolve_wave_width(rb.params, eff) != 1) == (grower == "wave")
    seen = {}
    real_grow = RG.grow_tree

    def spy(bins_c, stats, *args, **kw):
        seen["stats"] = stats
        return real_grow(bins_c, stats, *args, **kw)

    monkeypatch.setattr(RG, "grow_tree", spy)
    key = jax.random.fold_in(rb._key, 1)
    p_pred0 = torch.from_numpy(pred0)

    @jax.jit
    def ref_round(pred, g, h):
        tree, new_pred = RG._goss_compact_round(
            ds.X_binned, ds.y, rb._w_eff, rb._bag, pred, jnp.ones(6),
            rb._hyper, key, g, h, goss_k, params["num_leaves"], rb._num_bins,
            "auto",
            131072, RG.resolve_hist_dtype(rb.params, eff),
            RG.resolve_wave_width(rb.params, eff), None, None)
        return tree, new_pred, seen["stats"]

    r_tree, r_pred, r_stats = ref_round(jnp.asarray(pred0), g, h)
    pds = pb.train_set
    pg, ph = pb.obj.grad_hess(p_pred0, pds.y, pb._w_eff)
    idx, wt, live = PS.goss_select(pb._round_key(1), pg, pb._bag, goss_k, a,
                                   b)
    p_stats = torch.stack([pg[idx] * wt, ph[idx] * wt, live], dim=-1)
    assert np.array_equal(p_stats.numpy(), np.asarray(r_stats))
    assert int(live.sum()) == eff
    assert torch.equal(idx[:goss_k[0]], idx[:goss_k[0]].sort().values)
    p_tree, p_pred = pb._round_body(p_pred0, pb._bag,
                                    torch.ones(6), pb._round_key(1))
    ra, pa = r_arrays(r_tree), p_arrays(p_tree)
    for k in STRUCTURE:
        assert np.array_equal(ra[k], pa[k]), k
    np.testing.assert_allclose(pa["leaf_value"], ra["leaf_value"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p_pred.numpy(), np.asarray(r_pred),
                               rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------- (c) train
GOSS = dict(boosting="goss", min_data_in_leaf=5, max_bin=63, verbose=-1,
            seed=5)
TRAIN_CASES = {
    "strict": (2000, dict(objective="binary", num_leaves=15)),
    "wave": (7500, dict(objective="regression", num_leaves=31,
                        top_rate=0.4, other_rate=0.3)),
    "l1": (2000, dict(objective="regression_l1", num_leaves=15)),
    "multiclass": (2000, dict(objective="multiclass", num_class=3,
                              num_leaves=15)),
}
ROUNDS = 5


def _labels(case, s):
    if case == "strict":
        return (s > 0).astype(np.float32)
    return s


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def trained(request):
    case = request.param
    n, extra = TRAIN_CASES[case]
    params = dict(GOSS, **extra)
    X, s = _problem(n, classes=3 if case == "multiclass" else 0)
    y = _labels(case, s)
    tr, va = slice(0, n - 500), slice(n - 500, None)
    out = {}
    for name, pkg, kw in (("ref", R, {}), ("port", P, {"device": "cpu"})):
        dtr = pkg.Dataset(X[tr], label=y[tr], **kw)
        dva = pkg.Dataset(X[va], label=y[va], reference=dtr)
        hist = {}
        b = pkg.train(dict(params, is_provide_training_metric=True), dtr,
                      ROUNDS, valid_sets=[dva], valid_names=["valid"],
                      callbacks=[pkg.record_evaluation(hist)])
        out[name] = (b, hist)
    # the reference's scanned rounds (no callbacks): the same trees
    fused = (R.train(dict(params), R.Dataset(X[tr], label=y[tr]), ROUNDS)
             if case == "strict" else None)
    return case, params, X, out, fused


def _assert_trees(ref_trees, port_trees):
    assert len(ref_trees) == len(port_trees)
    for ta, tb in zip(ref_trees, port_trees):
        a, b = r_arrays(ta), p_arrays(tb)
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), k
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)


def test_goss_train_matches_reference(trained):
    case, params, X, out, fused = trained
    (rb, rhist), (pb, phist) = out["ref"], out["port"]
    _assert_trees(rb.trees, pb.trees)
    if fused is not None:
        _assert_trees([fused.trees[i] for i in range(ROUNDS)], pb.trees)
    assert phist.keys() == rhist.keys() == {"training", "valid"}
    for ds in rhist:
        for m in rhist[ds]:
            np.testing.assert_allclose(phist[ds][m], rhist[ds][m],
                                       rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pb.predict(X[:500], raw_score=True),
                               rb.predict(X[:500], raw_score=True),
                               rtol=RTOL, atol=ATOL)


def test_goss_precision_and_grower_at_compacted_rows(trained):
    case, params, X, out, _ = trained
    pb = out["port"][0]
    n_pad = int(pb.train_set.row_mask.shape[0])
    if case == "multiclass":
        assert pb._eff_rows() == n_pad       # re-weighted, not compacted
    else:
        assert pb._eff_rows() == sum(pb._goss_k()) < n_pad
    waves = resolve_wave_width(pb.params, pb._eff_rows()) != 1
    assert waves == (case == "wave")
    # the north star's 300,000 compacted rows (of 1,000,000) train in f32
    p = P.parse_params(dict(boosting="goss"))
    assert resolve_hist_dtype(p, 300_000) == "f32"
    assert resolve_hist_dtype(p, 1_000_000) == "bf16"


def test_goss_cv_per_fold_with_early_stopping():
    X, s = _problem(1000, seed=4)
    params = dict(GOSS, objective="regression", num_leaves=7,
                  learning_rate=0.6)
    want = R.cv(params, R.Dataset(X, label=s), 25, nfold=3,
                stratified=False, seed=2, early_stopping_rounds=3)
    got = P.cv(params, P.Dataset(X, label=s, device="cpu"), 25, nfold=3,
               stratified=False, seed=2, early_stopping_rounds=3)
    assert got.best_iter == want.best_iter < 25
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=RTOL)
    np.testing.assert_allclose(got["valid l2-mean"], want["valid l2-mean"],
                               rtol=RTOL, atol=ATOL)


def test_goss_reset_parameter_and_bagging_as_reference():
    X, s = _problem(600)
    with pytest.warns(UserWarning, match="bagging is disabled"):
        got = P.parse_params(dict(boosting="goss", bagging_fraction=0.5,
                                  bagging_freq=1))
    assert (got.bagging_fraction, got.bagging_freq) == (1.0, 0)
    b = P.Booster(dict(GOSS, objective="regression", num_leaves=7),
                  P.Dataset(X, label=s, device="cpu"))
    b.update()
    with pytest.raises(ValueError, match="top_rate"):
        b.reset_parameter({"top_rate": 0.3})
    b.reset_parameter({"learning_rate": 0.05})
    b.update()
    assert b.num_trees() == 2


def test_goss_kill_and_resume_bit_identical(tmp_path):
    """GOSS keeps no state beyond the base key and the round index: a run
    killed after any round and resumed grows the uninterrupted run."""
    X, s = _problem(900, seed=6)
    params = dict(GOSS, objective="regression", num_leaves=7,
                  feature_fraction=0.8)

    def ds():
        return P.Dataset(X, label=s, params=dict(params), device="cpu")

    whole = P.Booster(dict(params), ds())
    for _ in range(ROUNDS):
        whole.update()
    d = str(tmp_path / "ck")
    train_resumable(dict(params), ds(), ROUNDS, checkpoint_dir=d,
                    checkpoint_rounds=1, keep_last=ROUNDS + 1, resume=False)
    for path in list_checkpoints(d)[:-1]:
        b = resume_booster(path, ds())
        for _ in range(ROUNDS - b._iter):
            b.update()
        for ta, tb in zip(whole.trees, b.trees):
            x, z = p_arrays(ta), p_arrays(tb)
            for f in x:
                assert np.array_equal(x[f], z[f]), f
        assert torch.equal(whole._pred_train, b._pred_train)


def test_goss_sklearn_estimator_trains_goss():
    X, s = _problem(800)
    kw = dict(boosting_type="goss", n_estimators=3, num_leaves=7,
              min_child_samples=5, random_state=3, verbose=-1)
    est = P.LGBMRegressor(device="cpu", **kw).fit(X, s)
    assert est.booster_.params.boosting == "goss"
    want = P.train(dict(boosting="goss", num_leaves=7, min_data_in_leaf=5,
                        seed=3, verbose=-1, objective="regression"),
                   P.Dataset(X, label=s, device="cpu"), 3)
    np.testing.assert_array_equal(est.predict(X[:300]), want.predict(X[:300]))
