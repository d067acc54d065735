"""Port parity: linear leaves (``linear_tree``) against the reference on the
CPU.

The parity regime:

(a) the fit's pieces: the per-leaf path-feature lists
    (``linear_path_features``) equal the reference's ``fit_linear_leaves``
    lists exactly on seed-made trees of both growers; the fit on the same
    tree, rows, raw matrix and g/h has the same ``linear_feat``, and its
    coefficients, intercepts and per-row deltas agree within ROADMAP C.7's
    bounds (the per-leaf Gram sums round differently: the reference's one-hot
    contraction is a dot that XLA's CPU backend hands to a matmul library,
    whose summation order the port does not copy);
(b) training: ``train(linear_tree=True)`` on the strict and the wave
    grower has the reference's split structure and path features exactly,
    and predictions within rtol 1e-5, atol 1e-5 (C.7: the regime's atol
    1e-6 loosened for linear leaves, the coefficients' ulps times raw
    values);
(c) valid sets and early stopping, NaN raw values, the guardrails (EFB,
    no raw matrix, objectives, boosting, a valid set without raw values,
    ``pred_contrib``) raising as the reference's do; a rank-deficient leaf
    solved singular keeps its constant value in both packages;
(d) the chunked fit against one pass; ``cv()`` (the per-fold route,
    whose row subsets carry no raw matrix, so both packages raise); the
    text model both ways, the checkpoint codec, ``pack_booster``'s refusal;
    a killed and resumed run bit for bit; the CLI's keys.

``examples/advanced_features.py``'s sections run on both packages in
``test_torch_advanced_features.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as R
from lightgbm_tpu.models.tree import fit_linear_leaves as r_fit
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu.serving.packed import pack_booster as r_pack
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.models.fused as PF
from lightgbm_tpu_torch.__main__ import main as port_main
from lightgbm_tpu_torch.config import parse_params
from lightgbm_tpu_torch.models.tree import (_gram_sums, fit_linear_leaves,
                                            linear_path_features,
                                            tree_from_arrays)
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.serving import pack_booster as p_pack
from lightgbm_tpu_torch.training import (list_checkpoints, resume_booster,
                                         train_resumable)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-5            # (b): C.7's atol for linear leaves
STRUCT = ("split_feature", "split_bin", "left", "right", "is_leaf")
GROWERS = {"strict": {"num_leaves": 8},
           "wave": {"num_leaves": 31, "grow_policy": "frontier"}}
BASE = {"objective": "regression", "verbosity": -1, "linear_tree": True}


def _frame(n=3000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (np.where(X[:, 0] > 0, 3.0 * X[:, 0], -1.0 * X[:, 0])
         + 0.5 * X[:, 1] + X[:, 2] * X[:, 3] + 0.3 * X[:, 4]
         + 0.05 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def fit_case():
    """A reference tree of 15 leaves on the wave grower, its row_leaf,
    a raw matrix with NaNs, and seed-made g/h."""
    X, y = _frame()
    rb = R.train({"objective": "regression", "num_leaves": 15,
                  "verbosity": -1, "grow_policy": "frontier"},
                 R.Dataset(X, label=y), 2)
    tree = rb.trees[1]
    bins = jnp.asarray(rb.train_set.X_binned)
    row_leaf = np.asarray(rb._leaf_index(tree, bins))
    n_pad = row_leaf.shape[0]
    rng = np.random.default_rng(1)
    xr = np.zeros((n_pad, X.shape[1]), np.float32)
    xr[:len(X)] = X
    xr[rng.integers(0, len(X), 40), rng.integers(0, X.shape[1], 40)] = np.nan
    g = rng.normal(size=n_pad).astype(np.float32)
    h = rng.uniform(0.5, 1.0, n_pad).astype(np.float32)
    bag = np.asarray(rb.train_set.row_mask)
    return tree, row_leaf, xr, g, h, bag


# ------------------------------------------------------------- (a) the fit
@pytest.mark.parametrize("k", [1, 8])
def test_path_features_equal_reference(fit_case, k):
    tree, row_leaf, xr, g, h, bag = fit_case
    rt, _ = r_fit(tree, jnp.asarray(row_leaf), jnp.asarray(xr),
                  jnp.asarray(g), jnp.asarray(h), jnp.asarray(bag), 0.0, k)
    pt = tree_from_arrays(r_arrays(tree))
    got = linear_path_features(pt, k).numpy()
    np.testing.assert_array_equal(got, np.asarray(rt.linear_feat))
    # deep paths truncate to k: some leaf of this tree fills its list
    assert (got[np.asarray(tree.is_leaf)] >= 0).sum(1).max() == \
        min(k, 4 if k > 3 else k)


def test_path_features_strict_tree_equal_reference():
    X, y = _frame(seed=3)
    rb = R.train({"objective": "regression", "num_leaves": 31,
                  "verbosity": -1, "grow_policy": "leafwise"},
                 R.Dataset(X, label=y), 1)
    tree = rb.trees[0]
    n_pad = int(rb.train_set.row_mask.shape[0])
    z = jnp.zeros(n_pad, jnp.float32)
    rt, _ = r_fit(tree, jnp.zeros(n_pad, jnp.int32),
                  jnp.zeros((n_pad, 6), jnp.float32), z, z + 1, z, 0.0, 5)
    got = linear_path_features(tree_from_arrays(r_arrays(tree)), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(rt.linear_feat))


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_fit_linear_leaves_against_reference(fit_case, lam):
    """Same tree, rows, raw matrix and g/h: ``linear_feat`` exact; the
    coefficients and intercepts within C.7's bound (rtol 1e-3, atol 1e-4:
    the Gram sums' ulps through an ill-conditioned solve), the per-row
    deltas within rtol 1e-5, atol 1e-5."""
    tree, row_leaf, xr, g, h, bag = fit_case
    rt, rd = r_fit(tree, jnp.asarray(row_leaf), jnp.asarray(xr),
                   jnp.asarray(g), jnp.asarray(h), jnp.asarray(bag), lam, 8)
    pt, pd = fit_linear_leaves(tree_from_arrays(r_arrays(tree)),
                               _t(row_leaf), _t(xr), _t(g), _t(h), _t(bag),
                               lam, 8)
    np.testing.assert_array_equal(pt.linear_feat.numpy(),
                                  np.asarray(rt.linear_feat))
    np.testing.assert_allclose(pt.linear_coef.numpy(),
                               np.asarray(rt.linear_coef), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(pt.leaf_value.numpy(),
                               np.asarray(rt.leaf_value), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=RTOL,
                               atol=ATOL)
    assert np.isfinite(pd.numpy()).all()


def test_c7_gram_sums_round_differently(fit_case):
    """ROADMAP C.7, pinned: the port's per-leaf ``A = Z^T H Z`` is not the
    reference's bit for bit (XLA's CPU dot sums in its library's order),
    but within 2e-6 of its magnitude per leaf."""
    tree, row_leaf, xr, g, h, bag = fit_case
    pt = tree_from_arrays(r_arrays(tree))
    rl = _t(row_leaf).to(torch.int64)
    feats = linear_path_features(pt, 8)[rl].to(torch.int64)
    xg = _t(xr).gather(1, feats.clamp(min=0))
    xg = torch.where((feats >= 0) & torch.isfinite(xg), xg, 0.0)
    z = torch.cat([xg, torch.ones((len(rl), 1))], dim=1)
    A, _ = _gram_sums(z, rl, _t(g) * _t(bag), _t(h) * _t(bag),
                      pt.capacity, 131072)
    zn = z.numpy()
    onehot = (row_leaf[:, None] == np.arange(pt.capacity)[None]) \
        .astype(np.float32)
    zz = zn[:, :, None] * zn[:, None, :]
    A_ref = np.asarray(jnp.einsum("cm,cij,c->mij", jnp.asarray(onehot),
                                  jnp.asarray(zz), jnp.asarray(h * bag)))
    assert not np.array_equal(A.numpy(), A_ref)
    scale = np.abs(A_ref).max(axis=(1, 2), keepdims=True) + 1e-30
    assert (np.abs(A.numpy() - A_ref) / scale).max() <= 2e-6


def test_singular_leaf_keeps_its_constant(fit_case):
    """A design with a duplicated raw column and no ridge is exactly
    singular: ``solve_ex`` flags it (no raise, no host read) and the leaf
    keeps its Newton value, as the reference's non-finite solve does; a
    leaf of fewer than k + 2 rows keeps it too."""
    tree, row_leaf, xr, g, h, bag = fit_case
    xd = xr.copy()
    xd[:, 1] = xd[:, 0]                 # path features 0 and 1 coincide
    xd = np.nan_to_num(xd)
    lam = -1e-6                         # A + (lam + 1e-6) I == A
    rt, rd = r_fit(tree, jnp.asarray(row_leaf), jnp.asarray(xd),
                   jnp.asarray(g), jnp.asarray(h), jnp.asarray(bag), lam, 8)
    pt, pd = fit_linear_leaves(tree_from_arrays(r_arrays(tree)),
                               _t(row_leaf), _t(xd), _t(g), _t(h), _t(bag),
                               lam, 8)
    feats = pt.linear_feat.numpy()
    is_leaf = np.asarray(tree.is_leaf)
    both = is_leaf & (feats == 0).any(1) & (feats == 1).any(1)
    assert both.any()
    const = np.asarray(tree.leaf_value)
    for got in (pt.linear_coef.numpy(), np.asarray(rt.linear_coef)):
        assert (got[both] == 0).all()
    for got in (pt.leaf_value.numpy(), np.asarray(rt.leaf_value)):
        np.testing.assert_array_equal(got[both], const[both])
    # a leaf with too few rows for its k + 2: the constant, in both
    small = tree_from_arrays(r_arrays(tree))
    small = small._replace(count=torch.where(small.is_leaf, 9.0,
                                             small.count))
    pt2, _ = fit_linear_leaves(small, _t(row_leaf), _t(xr), _t(g), _t(h),
                               _t(bag), 0.0, 8)
    np.testing.assert_array_equal(pt2.leaf_value.numpy(), const)
    assert (pt2.linear_coef.numpy() == 0).all()


def test_chunked_fit_equals_one_pass(fit_case):
    """Row chunks add their partial Gram sums in chunk order: within the
    reference's own chunked-vs-single bound (rtol 1e-4, atol 1e-5) of one
    pass, and each exactly reproducible."""
    tree, row_leaf, xr, g, h, bag = fit_case
    args = (_t(row_leaf), _t(xr), _t(g), _t(h), _t(bag), 0.0, 8)
    one, d1 = fit_linear_leaves(tree_from_arrays(r_arrays(tree)), *args)
    many, d2 = fit_linear_leaves(tree_from_arrays(r_arrays(tree)), *args,
                                 row_chunk=512)
    again, d3 = fit_linear_leaves(tree_from_arrays(r_arrays(tree)), *args,
                                  row_chunk=512)
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=1e-4, atol=1e-5)
    assert torch.equal(d2, d3) and torch.equal(many.linear_coef,
                                               again.linear_coef)


# --------------------------------------------------------- (b) training
def _struct_equal(rb, pb):
    for i, (a, b) in enumerate(zip(rb.trees, pb.trees)):
        ra, pa = r_arrays(a), p_arrays(b)
        for f in STRUCT + ("linear_feat",):
            assert np.array_equal(ra[f], pa[f]), (i, f)


@pytest.mark.parametrize("grower", sorted(GROWERS))
def test_train_matches_reference(grower):
    X, y = _frame(n=4096, seed=4)
    params = dict(BASE, **GROWERS[grower])
    rb = R.train(dict(params), R.Dataset(X, label=y), 6)
    pb = P.train(dict(params), P.Dataset(X, label=y, device="cpu"), 6)
    _struct_equal(rb, pb)
    Xt, _ = _frame(n=500, seed=5)
    np.testing.assert_allclose(pb.predict(Xt), rb.predict(Xt), rtol=RTOL,
                               atol=ATOL)
    # the train scores are the linear predictor's
    np.testing.assert_allclose(pb._pred_train[:4096].numpy(),
                               pb.predict(X, raw_score=True), rtol=RTOL,
                               atol=ATOL)
    # staged truncation through the linear path
    np.testing.assert_allclose(pb.predict(Xt, num_iteration=2),
                               rb.predict(Xt, num_iteration=2), rtol=RTOL,
                               atol=ATOL)


def test_valid_sets_early_stopping_and_nan():
    X, y = _frame(n=2500, seed=6)
    Xv, yv = _frame(n=600, seed=7)
    X = X.copy()
    X[::37, 2] = np.nan                 # NaN raw values read as 0
    Xv = Xv.copy()
    Xv[::11, 0] = np.nan
    params = dict(BASE, num_leaves=5, learning_rate=0.3, metric="l2")
    res = {}
    for name, L, kw in (("ref", R, {}), ("port", P, {"device": "cpu"})):
        ds = L.Dataset(X, label=y, **kw)
        dv = L.Dataset(Xv, label=yv, reference=ds)
        ev = {}
        b = L.train(dict(params), ds, 40, valid_sets=[dv],
                    callbacks=[L.early_stopping(3, verbose=False),
                               L.record_evaluation(ev)])
        res[name] = (b, ev["valid_0"]["l2"])
    (rb, rh), (pb, ph) = res["ref"], res["port"]
    assert pb.best_iteration == rb.best_iteration < 40
    np.testing.assert_allclose(ph, rh, rtol=1e-5)
    np.testing.assert_allclose(pb.predict(Xv), rb.predict(Xv), rtol=RTOL,
                               atol=ATOL)
    # the incremental valid scores are the linear predictor's
    vpred = pb._valid[0][2][:600].numpy()
    np.testing.assert_allclose(
        vpred, pb.predict(Xv, raw_score=True,
                          num_iteration=pb.current_iteration()),
        rtol=1e-6, atol=1e-6)


def test_guardrails_raise_as_the_reference():
    X, y = _frame(n=800, seed=8)
    for L, kw in ((R, {}), (P, {"device": "cpu"})):
        # EFB: sparse columns bundle
        Xs = np.zeros((800, 6), np.float32)
        for j in range(6):
            Xs[j::6, j] = 1.0 + j
        with pytest.raises(ValueError, match="EFB"):
            L.train(dict(BASE), L.Dataset(Xs, label=y, **kw), 1)
        for params, err in (
                ({"objective": "multiclass", "num_class": 3},
                 NotImplementedError),
                ({"objective": "lambdarank"}, NotImplementedError),
                ({"boosting": "goss"}, NotImplementedError),
                ({"boosting": "dart"}, NotImplementedError),
                ({"linear_lambda": -1.0}, ValueError)):
            with pytest.raises(err, match="linear"):
                L.train(dict(BASE, **params), L.Dataset(X, label=y, **kw), 1)
        ds = L.Dataset(X, label=y, **kw)
        b = L.train(dict(BASE, num_leaves=4), ds, 2)
        with pytest.raises(NotImplementedError, match="linear_tree"):
            b.predict(X, pred_contrib=True)
        # a Dataset without its raw matrix (a row subset)
        with pytest.raises(ValueError, match="raw feature values"):
            L.train(dict(BASE), ds.subset(np.arange(400)), 1)
        with pytest.raises(ValueError, match="raw feature values"):
            L.train(dict(BASE), ds, 1,
                    valid_sets=[ds.subset(np.arange(100))])
    assert not PF.fused_cv_eligible(parse_params(dict(BASE)), None, None,
                                    None)


def test_cv_takes_the_per_fold_route_as_the_reference():
    """``cv()`` with linear leaves is refused by the fused route and runs
    per fold, whose row subsets carry no raw matrix: both packages raise
    the same ``ValueError``."""
    X, y = _frame(n=600, seed=9)
    msgs = []
    for L, kw in ((R, {}), (P, {"device": "cpu"})):
        with pytest.raises(ValueError, match="raw feature values") as ei:
            L.cv(dict(BASE, num_leaves=4), L.Dataset(X, label=y, **kw), 3,
                 nfold=3, stratified=False)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


# -------------------------------------------------------- (d) model files
def test_model_files_both_ways_and_packed_refusal(tmp_path):
    X, y = _frame(n=1500, seed=10)
    params = dict(BASE, num_leaves=7)
    rb = R.train(dict(params), R.Dataset(X, label=y), 4)
    pb = P.train(dict(params), P.Dataset(X, label=y, device="cpu"), 4)
    pth = str(tmp_path / "p.txt")
    pb.save_model(pth)
    back = P.Booster(model_file=pth, device="cpu")
    assert back.trees[0].linear_feat is not None
    assert np.array_equal(back.predict(X), pb.predict(X))
    assert np.array_equal(R.Booster(model_file=pth).predict(X, raw_score=True),
                          R.Booster(model_file=pth).predict(X,
                                                            raw_score=True))
    np.testing.assert_allclose(R.Booster(model_file=pth).predict(X),
                               pb.predict(X), rtol=RTOL, atol=ATOL)
    rth = str(tmp_path / "r.txt")
    rb.save_model(rth)
    np.testing.assert_allclose(P.Booster(model_file=rth, device="cpu")
                               .predict(X), rb.predict(X), rtol=RTOL,
                               atol=ATOL)
    # the checkpoint codec round-trips the linear fields bit for bit
    for t in pb.trees:
        a = p_arrays(t)
        b = p_arrays(tree_from_arrays(a))
        assert set(a) == set(b) >= {"linear_feat", "linear_coef"}
        for f in a:
            assert np.array_equal(a[f], b[f]), f
    # packed serving refuses linear leaves by name, in both packages
    for b, pack in ((rb, r_pack), (pb, p_pack)):
        with pytest.raises(NotImplementedError, match="linear_tree"):
            pack(b)
        with pytest.raises(NotImplementedError, match="linear_tree"):
            b.save_model(str(tmp_path / "m.npz"))


def test_kill_and_resume_bit_identical(tmp_path):
    """The raw matrix is rebuilt from the Dataset at resume, not stored: a
    run resumed from any checkpoint grows the uninterrupted run, bit for
    bit, with bagging on."""
    X, y = _frame(n=1500, seed=11)
    rounds = 4
    params = dict(BASE, num_leaves=7, bagging_fraction=0.8, bagging_freq=1)

    def ds():
        return P.Dataset(X, label=y, device="cpu")

    whole = P.Booster(dict(params), ds())
    for _ in range(rounds):
        whole.update()
    d = str(tmp_path / "ck")
    train_resumable(dict(params), ds(), rounds, checkpoint_dir=d,
                    checkpoint_rounds=1, keep_last=rounds + 1, resume=False)
    paths = list_checkpoints(d)[:-1]
    assert paths
    for path in paths:
        b = resume_booster(path, ds())
        for _ in range(rounds - b._iter):
            b.update()
        for ta, tb in zip(whole.trees, b.trees):
            x, z = p_arrays(ta), p_arrays(tb)
            assert "linear_coef" in x
            for f in x:
                assert np.array_equal(x[f], z[f]), f
        assert torch.equal(whole._pred_train, b._pred_train)


def test_cli_linear_keys(tmp_path):
    X, y = _frame(n=1200, seed=12)
    csv = tmp_path / "train.csv"
    with open(csv, "w") as f:
        f.write(",".join([f"x{j}" for j in range(6)] + ["y"]) + "\n")
        for xr, yv in zip(X, y):
            f.write(",".join(f"{t:.9g}" for t in [*xr, yv]) + "\n")
    model = tmp_path / "m.txt"
    assert port_main([
        "task=train", f"data={csv}", "header=true", "label_column=name:y",
        "objective=regression", "num_trees=3", "num_leaves=7", "verbose=-1",
        "device=cpu", "linear_tree=true", "linear_lambda=0.5",
        f"output_model={model}"]) == 0
    cli = P.Booster(model_file=str(model), device="cpu")
    assert cli.params.linear_tree and cli.params.linear_lambda == 0.5
    Xf = np.loadtxt(csv, delimiter=",", skiprows=1)
    want = P.train(dict(BASE, num_leaves=7, linear_lambda=0.5),
                   P.Dataset(Xf[:, :6], label=Xf[:, 6], device="cpu"), 3)
    assert np.array_equal(cli.predict(Xf[:, :6]), want.predict(Xf[:, :6]))


def test_reset_parameter_scales_coefficients_as_the_reference():
    X, y = _frame(n=1500, seed=13)
    params = dict(BASE, num_leaves=7, learning_rate=0.3)

    def sched(i):
        return 0.3 * 0.8 ** i

    rb = R.train(dict(params), R.Dataset(X, label=y), 4,
                 callbacks=[R.reset_parameter(learning_rate=sched)])
    pb = P.train(dict(params), P.Dataset(X, label=y, device="cpu"), 4,
                 callbacks=[P.reset_parameter(learning_rate=sched)])
    _struct_equal(rb, pb)
    np.testing.assert_allclose(pb.predict(X[:300]), rb.predict(X[:300]),
                               rtol=RTOL, atol=ATOL)
