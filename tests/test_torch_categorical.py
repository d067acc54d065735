"""Port parity: categorical features — the k-vs-rest subset scan, binning,
routing edges, model files and serving — against the reference on the CPU.

(a) ``ops/split.py`` ``find_best_split`` with a ``CatInfo`` is bit-equal to
    the reference's (every field: gain, winner, child statistics and
    outputs, ``cat``, ``cat_mask``) on histograms with empty bins, tied
    raw scores with -0.0 beside 0.0, ``max_cat_threshold`` 1, 2 and 32, a
    descending-order winner and mixed numeric and categorical columns, at
    the reference's eager rounding (``arith="scan"``); the batched layout
    ``[E, W, F, B, 3]`` with per-element regularizers against the
    reference's call per leaf; the batched growers (configs x folds,
    per-element regularizers: strict, half and exact tails) bit-equal to
    the reference's ``vmap`` of its grower on exact sums, and equal up to
    subset orientation (ROADMAP C.4) on general statistics;
(b) ``Dataset(categorical_feature=)``: indices and names, an unknown name,
    the codes (one bin per kept category, the rest in the overflow bin past
    254 kept categories), EFB never bundling a categorical column, and a
    validation set sharing the mapper;
(c) routing edges on the dyadic tier (y in {0, 1} with n/2 ones: round-1
    sums are exact, so the trees are bit-identical): an unseen category,
    a category past the kept ones, ``max_cat_threshold``, NaN categories;
(d) the text model, the ``.npz`` artifact and checkpoints interchange both
    ways, and a killed and resumed categorical run is bit-identical;
(e) serving: a port-trained categorical forest takes the legacy traversal
    (no B4 launch, as the reference routes it) in ``PredictorRuntime``,
    ``ModelBank`` and ``MicroBatcher``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.training as RT
from lightgbm_tpu.models.tree import grow_tree as r_grow
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.ops import split as rs
from lightgbm_tpu.serving.packed import pack_booster as r_pack
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch import serving as ts
from lightgbm_tpu_torch.models.tree import _tree_from_packed, \
    grow_trees_batched
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.ops import split as ps
from lightgbm_tpu_torch.training import (list_checkpoints, resume_booster,
                                         save_checkpoint, train_resumable)
from test_torch_categorical_train import assert_equal_up_to_orientation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F, B = 6, 24
IS_CAT = np.array([True, False, True, True, False, True])
BEST_FIELDS = ("gain", "feature", "bin", "left_g", "left_h", "left_c",
               "right_g", "right_h", "right_c", "left_out", "right_out",
               "cat", "cat_mask")


# ------------------------------------------------------------- (a) the scan
def _hist(rng, rows=3000, used=B - 5):
    """Per-bin (grad, hess, count) sums of real rows; bins ``used..B-1``
    and bin 3 stay empty."""
    codes = rng.integers(0, used, (rows, F))
    codes[codes == 3] = 4
    g = rng.normal(0.1, 1.0, rows) * (1 + (codes[:, 0] % 3))
    h = rng.uniform(0.05, 0.25, rows)
    hist = np.zeros((F, B, 3), np.float32)
    for j in range(F):
        for k, v in enumerate((g, h, np.ones(rows))):
            hist[j, :, k] = np.bincount(codes[:, j], weights=v, minlength=B)
    return hist


def _ties(rng):
    """Tied raw scores (equal bins) and -0.0 beside 0.0 gradients."""
    h = _hist(rng)
    h[:, 6] = h[:, 2]
    h[:, 9] = h[:, 2]
    h[:, 1, 0], h[:, 5, 0], h[:, 8, 0] = -0.0, 0.0, -0.0
    return h


def _desc(rng):
    """One category far above the rest on feature 2: with one category per
    subset the descending scan must win there."""
    h = _hist(rng)
    h[2, 7] = (900.0, 60.0, 400.0)
    return h


def _ctx(**kw):
    base = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20.0,
                min_sum_hessian=1e-3, min_gain_to_split=0.0,
                max_delta_step=0.0, path_smooth=0.0)
    base.update(kw)
    return base


def _ref_best(hist, ctx, mask, depth_ok, parent_out, mct, is_cat):
    jctx = rs.SplitContext(**{k: jnp.float32(v) for k, v in ctx.items()})
    ci = rs.CatInfo(jnp.asarray(is_cat), jnp.float32(10.0),
                    jnp.float32(10.0), mct)
    return rs.find_best_split(jnp.asarray(hist), jctx, jnp.asarray(mask),
                              jnp.bool_(depth_ok), ci,
                              parent_out=jnp.float32(parent_out))


def _assert_same(want, got, i):
    for name in BEST_FIELDS:
        a = np.asarray(getattr(want, name))
        b = getattr(got, name)[i].numpy().astype(a.dtype)
        assert a.tobytes() == b.tobytes(), (name, i, a, b)


CASES = {
    "empty_bins_mct32": (_hist, 32, {}),
    "empty_bins_mct2": (_hist, 2, {}),
    "ties_neg_zero_mct1": (_ties, 1, {}),
    "ties_neg_zero_mct32": (_ties, 32, {}),
    "descending_wins": (_desc, 1, {}),
    "regularized": (_hist, 32, dict(lambda_l1=0.3, lambda_l2=1.0,
                                    max_delta_step=0.4, min_gain_to_split=0.2,
                                    path_smooth=2.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cat_scan_bit_equal(case):
    make, mct, kw = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    k = 5
    hists = np.stack([make(rng) for _ in range(k)])
    masks = np.ones((k, F), np.float32)
    masks[1, 2] = 0.0                         # a categorical column masked
    depth_ok = np.ones(k, bool)
    depth_ok[3] = False
    parent_out = rng.normal(0, 0.1, k).astype(np.float32)
    got = ps.find_best_split(
        torch.from_numpy(hists), ps.SplitContext(**_ctx(**kw)),
        torch.from_numpy(masks), torch.from_numpy(depth_ok),
        torch.from_numpy(parent_out), arith="scan",
        cat_info=ps.CatInfo(torch.from_numpy(IS_CAT), 10.0, 10.0, mct))
    for i in range(k):
        _assert_same(_ref_best(hists[i], _ctx(**kw), masks[i], depth_ok[i],
                               parent_out[i], mct, IS_CAT), got, i)
    assert np.isneginf(got.gain[3].numpy())
    assert bool(got.cat[[0, 2, 4]].any())          # subset winners occur
    for i in np.flatnonzero(got.cat.numpy()):
        assert int(got.cat_mask[i].sum()) <= mct
        assert not got.cat_mask[i, B - 5:].any()   # empty bins go right
    if case == "descending_wins":
        hit = [i for i in range(k) if int(got.feature[i]) == 2]
        assert hit and all(got.cat_mask[i].nonzero().flatten().tolist()
                           == [7] for i in hit)


def test_cat_scan_batched_layout_per_element_context():
    """``[E, W, F, B, 3]`` with per-element regularizers ``[E]`` against
    the reference's call per (element, leaf)."""
    rng = np.random.default_rng(21)
    e, w = 3, 4
    hists = np.stack([np.stack([_hist(rng) for _ in range(w)])
                      for _ in range(e)])
    masks = (rng.random((e, w, F)) < 0.8).astype(np.float32)
    parent_out = rng.normal(0, 0.1, (e, w)).astype(np.float32)
    ctxs = [_ctx(), _ctx(lambda_l1=0.5, lambda_l2=2.0, min_data_in_leaf=40.0),
            _ctx(max_delta_step=0.2, min_gain_to_split=0.5)]
    tctx = ps.SplitContext(*(torch.tensor([c[f] for c in ctxs],
                                          dtype=torch.float32)
                             for f in ps.SplitContext._fields))
    got = ps.find_best_split(
        torch.from_numpy(hists), tctx, torch.from_numpy(masks),
        torch.ones((e, w), dtype=torch.bool), torch.from_numpy(parent_out),
        arith="scan",
        cat_info=ps.CatInfo(torch.from_numpy(IS_CAT), 10.0, 10.0, 32))
    flat = ps.BestSplit(*(v.reshape((e * w,) + tuple(v.shape[2:]))
                          for v in got))
    for i in range(e):
        for j in range(w):
            _assert_same(_ref_best(hists[i, j], ctxs[i], masks[i, j], True,
                                   parent_out[i, j], 32, IS_CAT),
                         flat, i * w + j)


# ------------------------------------ the batched growers (E = 3), (a) ctd
GN, GF, GB, LEAVES, E = 2048, 5, 32, 15, 3
G_IS_CAT = np.array([True, False, True, False, True])
CTX = np.array([[0.0, 0.0, 5.0, 1e-3, 0.0, 0.0, 0.0],
                [0.5, 1.0, 20.0, 0.5, 0.1, 0.3, 0.0],
                [0.0, 2.0, 10.0, 1e-3, 0.0, 0.0, 0.0]], np.float32)
MAX_DEPTH = np.array([-1, 5, 2], np.int32)
WIDTHS = {"strict": 1, "half": 7, "exact": 22 * 1024 + 7}


def _grower_inputs(dyadic, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, GB, (GN, GF)).astype(np.uint8)
    effect = rng.normal(size=(GF, GB))
    stats = np.zeros((E, GN, 3), np.float32)
    for e in range(E):
        if dyadic:
            g = np.where(rng.random(GN) < 0.5, -0.5, 0.5)
            h = np.ones(GN)
        else:
            g = rng.normal(size=GN) + effect[2, bins[:, 2]] + effect[
                e, bins[:, e]]
            g -= g.mean()
            h = rng.uniform(0.1, 0.3, GN)
        bag = (rng.random(GN) < 0.9).astype(np.float64)
        stats[e] = np.stack([g * bag, h * bag, bag], axis=1)
    fmask = (rng.random((E, GF)) < 0.8).astype(np.float32)
    fmask[:, 2] = 1.0
    return bins, stats, fmask


_REF = {}


def _ref_batched(bins, stats, fmask, ww):
    if ww not in _REF:
        ci = rs.CatInfo(jnp.asarray(G_IS_CAT), jnp.float32(10.0),
                        jnp.float32(10.0), 32)

        def one(st, fm, c, md, b):
            return r_grow(b, st, fm, rs.SplitContext(*c), LEAVES, GB, md,
                          wave_width=ww, cat_info=ci)

        _REF[ww] = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
    ctx = tuple(jnp.asarray(CTX[:, i]) for i in range(CTX.shape[1]))
    tree, rl = _REF[ww](jnp.asarray(stats), jnp.asarray(fmask), ctx,
                        jnp.asarray(MAX_DEPTH), jnp.asarray(bins))
    return r_arrays(tree), np.asarray(rl)


def _port_batched(bins, stats, fmask, ww):
    ctx = ps.SplitContext(*(torch.from_numpy(CTX[:, i].copy())
                            for i in range(CTX.shape[1])))
    P_, n_leaves, rl, catmask = grow_trees_batched(
        torch.from_numpy(bins), torch.from_numpy(stats).transpose(0, 1),
        torch.from_numpy(fmask), ctx,
        torch.from_numpy(MAX_DEPTH.astype(np.float32)), LEAVES, GB, ww,
        cat_info=ps.CatInfo(torch.from_numpy(G_IS_CAT), 10.0, 10.0, 32))
    return p_arrays(_tree_from_packed(P_, n_leaves, catmask)), rl.t().numpy()


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_batched_growers_match_vmapped_reference(width):
    ww = WIDTHS[width]
    bins, stats, fmask = _grower_inputs(dyadic=True)
    a, rla = _ref_batched(bins, stats, fmask, ww)
    b, rlb = _port_batched(bins, stats, fmask, ww)
    assert set(a) == set(b)
    assert np.array_equal(rla, rlb)
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert (b["is_cat_split"].sum(axis=1) >= 1).all()
    # general statistics: equal up to subset orientation on in-bag rows
    bins, stats, fmask = _grower_inputs(dyadic=False, seed=1)
    a, _ = _ref_batched(bins, stats, fmask, ww)
    b, _ = _port_batched(bins, stats, fmask, ww)
    for e in range(E):
        rows = np.flatnonzero(stats[e, :, 2] > 0)
        assert_equal_up_to_orientation(
            {k: v[e] for k, v in a.items()}, {k: v[e] for k, v in b.items()},
            bins[rows].astype(np.int64))


# ----------------------------------------------------------- (b) the dataset
def _cat_frame(n=4096, seed=0, n_b=30):
    """Columns: a (12 categories, values 10 k + 3, NaN in 2 % of rows), x1,
    b (``n_b`` categories), x2; the dyadic label from per-category effects
    (exactly n/2 ones)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 12, n)
    b = rng.integers(0, n_b, n)
    x1, x2 = rng.normal(size=n), rng.normal(size=n)
    s = (rng.normal(size=12)[a] + rng.normal(size=n_b)[b] + 0.7 * x1
         + 0.3 * np.sin(2 * x2))
    y = np.zeros(n)
    y[np.argsort(s)[n // 2:]] = 1.0
    av = (10.0 * a + 3.0).astype(np.float64)
    av[rng.random(n) < 0.02] = np.nan
    return np.column_stack([av, x1, b, x2]), y


def test_dataset_categorical_binning_matches_reference():
    X, y = _cat_frame()
    names = ["a", "x1", "b", "x2"]
    for cf in ([2, 0, 2], ["b", "a"]):
        rd = R.Dataset(X, label=y, feature_name=names, categorical_feature=cf)
        pd = P.Dataset(X, label=y, feature_name=names, categorical_feature=cf,
                       device="cpu")
        rd.construct()
        pd.construct()
        assert pd.col_is_categorical.tolist() == [True, False, True, False]
        assert np.array_equal(pd.X_binned.numpy(), np.asarray(rd.X_binned))
        assert pd.bin_mapper.to_dict() == rd.bin_mapper.to_dict()
    with pytest.raises(ValueError, match="'c' not in feature names"):
        P.Dataset(X, label=y, feature_name=names, categorical_feature=["c"],
                  device="cpu").construct()
    # past 254 kept categories the rarest share the overflow bin (254)
    rng = np.random.default_rng(5)
    Xw = np.column_stack([rng.zipf(1.3, 20000) % 400, rng.normal(size=20000)])
    rd = R.Dataset(Xw, categorical_feature=[0])
    pd = P.Dataset(Xw, categorical_feature=[0], device="cpu")
    rd.construct()
    pd.construct()
    assert np.array_equal(pd.X_binned.numpy(), np.asarray(rd.X_binned))
    assert int(pd.X_binned[:, 0].max()) == 254
    assert pd.feature_num_bin(0) == 255
    # a validation set shares the mapper: its unseen categories overflow
    Xv = Xw[:50].copy()
    Xv[:10, 0] = 12345.0
    vd = P.Dataset(Xv, reference=pd)
    vd.construct()
    assert (vd.X_binned[:10, 0] == 254).all()
    assert torch.equal(vd.X_binned[10:50], pd.X_binned[10:50])


def test_efb_never_bundles_a_categorical_column():
    rng = np.random.default_rng(9)
    n = 2000
    X = np.zeros((n, 5))
    pick = rng.integers(0, 10, n)
    for j in range(4):                        # mutually exclusive, sparse
        rows = np.flatnonzero(pick == j)
        X[rows, j] = rng.integers(1, 5, len(rows))
    X[:, 4] = rng.normal(size=n)
    for cf in ([], [1]):
        rd = R.Dataset(X, label=X[:, 4], categorical_feature=cf)
        pd = P.Dataset(X, label=X[:, 4], categorical_feature=cf,
                       device="cpu")
        assert pd.col_is_categorical.tolist() == \
            list(rd.col_is_categorical)
        assert np.array_equal(pd.X_binned.numpy(), np.asarray(rd.X_binned))
    assert pd.bin_mapper.bundler is not None
    assert [1] in pd.bin_mapper.bundler.groups


# ---------------------------------------------------- (c) routing edges
DYADIC = dict(objective="l2", num_leaves=15, learning_rate=0.5,
              min_data_in_leaf=5, max_bin=63, verbose=-1)


def _train_both(params, X, y, rounds, cats=(0, 2)):
    rb = R.train(dict(params), R.Dataset(X, label=y, params=dict(params),
                                         categorical_feature=list(cats)),
                 rounds)
    pb = P.train(dict(params), P.Dataset(X, label=y, params=dict(params),
                                         categorical_feature=list(cats),
                                         device="cpu"), rounds)
    return rb, pb


def _assert_trees_equal(rb, pb):
    for ta, tb in zip(rb.trees, pb.trees):
        a, b = r_arrays(ta), p_arrays(tb)
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def dyadic_pair():
    """One dyadic round on both growers' default (waves at 4,096 rows):
    80 categories in b at max_bin 63, so the overflow bin holds rows."""
    X, y = _cat_frame(n_b=80)
    rb, pb = _train_both(dict(DYADIC, grow_policy="frontier", wave_width=8),
                         X, y, 1)
    return X, y, rb, pb


def test_dyadic_trees_and_routing_edges_match_reference(dyadic_pair):
    X, y, rb, pb = dyadic_pair
    _assert_trees_equal(rb, pb)
    tree = pb.trees[0]
    assert int(tree.is_cat_split.sum()) >= 3
    overflow = int(pb.train_set.bin_mapper.n_bins[2]) - 1
    assert (pb.train_set.X_binned[:len(y), 2] == overflow).any()
    q = X[:40].copy()
    q[:10, 0] = 999.0                 # unseen: a's overflow bin, empty
    q[10:20, 2] = 1e6                 # b's overflow bin, with rows
    q[20:30, 0] = np.nan              # a has NaN rows: its NaN bin
    q[30:40, 2] = np.nan              # b has no NaN: the overflow bin
    assert np.array_equal(pb.predict(q), rb.predict(q))
    codes = pb._bin_mapper_for_predict().transform(q)
    a_over = int(pb.train_set.bin_mapper.upper_bounds[0].shape[0])
    assert (codes[:10, 0] == a_over).all() and (codes[30:, 2] == overflow
                                                ).all()
    # an unseen category goes right at every subset split on its column
    cm, icb = tree.cat_mask, tree.is_cat_split
    sf = tree.split_feature
    for node in torch.nonzero(icb).flatten().tolist():
        if int(sf[node]) == 0:
            assert not bool(cm[node, a_over])


def test_max_cat_threshold_is_respected(dyadic_pair):
    X, y, _, _ = dyadic_pair
    rb, pb = _train_both(dict(DYADIC, grow_policy="leafwise",
                              max_cat_threshold=2), X, y, 1)
    _assert_trees_equal(rb, pb)
    t = pb.trees[0]
    sizes = t.cat_mask[t.is_cat_split].sum(dim=1)
    assert len(sizes) >= 2 and int(sizes.max()) <= 2


# ------------------------------------------------------ (d) model files
def test_text_and_npz_models_interchange_both_ways(dyadic_pair, tmp_path):
    X, y, rb, pb = dyadic_pair
    want = rb.predict(X)
    pt, rt = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    pb.save_model(pt)
    rb.save_model(rt)
    with open(pt) as f1, open(rt) as f2:
        dp, dr = __import__("json").load(f1), __import__("json").load(f2)
    assert dp["trees"] == dr["trees"]
    assert dp["bin_mapper"] == dr["bin_mapper"]
    assert np.array_equal(R.Booster(model_file=pt).predict(X), want)
    loaded = P.Booster(model_file=rt, device="cpu")
    assert np.array_equal(loaded.predict(X), want)
    _assert_trees_equal(R.Booster(model_file=rt), loaded)
    pn, rn = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    pb.save_model(pn)
    r_pack(rb).save(rn)
    assert np.array_equal(R.Booster(model_file=pn).predict(X), want)
    assert np.array_equal(P.Booster(model_file=rn, device="cpu").predict(X),
                          want)
    back = P.Booster(model_file=pn, device="cpu")
    assert torch.equal(back.trees[0].cat_mask, pb.trees[0].cat_mask)


GENERAL = dict(objective="regression", num_leaves=15, learning_rate=0.3,
               min_data_in_leaf=10, bagging_fraction=0.7, bagging_freq=1,
               feature_fraction=0.8, verbose=-1, grow_policy="leafwise")


def _general_frame(n=3000, seed=2):
    X, _ = _cat_frame(n, seed)
    rng = np.random.default_rng(seed + 1)
    y = np.where(np.isnan(X[:, 0]), 0.0, X[:, 0]) / 30.0 + X[:, 1] \
        + rng.normal(0, 0.3, n)
    return X, y


def test_checkpoints_interchange_and_resume_bit_identical(tmp_path):
    X, y = _general_frame()

    def pds():
        return P.Dataset(X, label=y, params=dict(GENERAL),
                         categorical_feature=[0, 2], device="cpu")

    def rds():
        return R.Dataset(X, label=y, params=dict(GENERAL),
                         categorical_feature=[0, 2])

    want = P.Booster(dict(GENERAL), pds())
    for _ in range(4):
        want.update()
    d = str(tmp_path / "ck")
    res = train_resumable(dict(GENERAL), pds(), 4, checkpoint_dir=d,
                          checkpoint_rounds=1, keep_last=5, resume=False)
    paths = list_checkpoints(d)
    b = resume_booster(paths[1], pds())           # killed after round 2
    for _ in range(2):
        b.update()
    for got in (res.booster, b):
        for ta, tb in zip(want.trees, got.trees):
            for k, v in p_arrays(ta).items():
                assert np.array_equal(v, p_arrays(tb)[k]), k
        assert torch.equal(want._pred_train, got._pred_train)
    # the port's checkpoint resumes in the reference, and the other way
    rb = RT.resume_booster(paths[1], rds())
    assert rb._iter == 2
    for ta, tb in zip(rb.trees, want.trees[:2]):
        a, bb = r_arrays(ta), p_arrays(tb)
        for k in a:
            assert np.array_equal(a[k], bb[k]), k
    ref = R.Booster(dict(GENERAL), rds())
    ref.update()
    path = RT.save_checkpoint(ref, str(tmp_path / "ref"))
    pb = resume_booster(path, pds())
    got, _ = pb.checkpoint_state()
    want_arrays, _ = RT.load_checkpoint(path)
    assert got.keys() == want_arrays.keys()
    for k in want_arrays:
        assert np.array_equal(got[k], want_arrays[k]), k
    assert np.array_equal(pb.predict(X), ref.predict(X))
    save_checkpoint(pb, str(tmp_path / "again"))


# ------------------------------------------------------------ (e) serving
def test_port_trained_categorical_forest_serves_on_the_legacy_path(
        dyadic_pair, tmp_path):
    X, y, _, pb = dyadic_pair
    pf = ts.pack_booster(pb)
    assert pf.is_cat_split is not None
    rt = ts.PredictorRuntime(pf, max_bucket=64, device="cpu")
    assert not rt.fused_predict
    np.testing.assert_allclose(rt.predict(X[:50]), pb.predict(X[:50]),
                               rtol=1e-6, atol=1e-7)
    snap = rt.stats.snapshot()
    assert snap["predict_kernel_launches"] == 0
    assert snap["fused_path"]["legacy_dispatches"] >= 1
    path = str(tmp_path / "cat.npz")
    pf.save(path)
    bank = ts.ModelBank(max_bucket=32, canary_rows=16, device="cpu")
    assert bank.deploy("cat", path)["ok"]
    np.testing.assert_allclose(bank.predict("cat", X[:20]),
                               pb.predict(X[:20]), rtol=1e-6, atol=1e-7)
    mb = ts.MicroBatcher(rt, max_batch=4, max_delay_ms=0.0)
    hs = [mb.submit(X[i]) for i in range(6)]
    mb.flush()
    np.testing.assert_allclose([h.result() for h in hs], pb.predict(X[:6]),
                               rtol=1e-6, atol=1e-7)
