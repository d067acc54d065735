"""Port parity: constraints and randomized splits at the split level and in
their helpers, against the reference on the CPU.

(a) ``ops/split.py`` ``find_best_split`` and ``feature_best_gains`` with
    ``mono`` (monotone signs), bounds ``lo``/``hi`` and ``rand_bins``
    (extra-trees positions) equal the reference's on the same seed-made
    histograms, numeric and categorical, at the reference's eager rounding
    (the port's default ``arith``): every field bit for bit (winner, gain,
    child statistics and outputs, the subset mask), under each
    regularizer;
(b) the helpers: ``_mono_child_bounds`` and ``_ic_allowed`` bit-equal to
    the reference's on random operands (infinite bounds included), and the
    rand-bin table (every node of a tree at once) bit-equal to the
    reference's ``_rand_bins_for_node`` row by row, with and without
    per-column bin counts;
(c) the resolvers: the training-column constraints equal the reference's
    Booster's (``_mono_key``, ``_ic_key``, ``_nbins_key``) with and without
    EFB bundles, and a list of the wrong length, a constraint on a
    categorical column, one on an EFB-bundled feature, an interaction group
    that splits a bundle and an index past the features raise
    ``ValueError`` with the reference's message;
(d) the batched multiclass growers with every option against the
    reference's ``vmap`` over classes (each class drawn under its own key),
    in the regime of ``test_torch_constraints_train.py``: the wave grower's
    trees equal, and the strict grower's up to ROADMAP C.6, pinned here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
from lightgbm_tpu.models import tree as rt
from lightgbm_tpu.ops import split as rs
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.models import gbdt as pg
from lightgbm_tpu_torch.models import tree as pt
from lightgbm_tpu_torch.ops import split as ps
from lightgbm_tpu_torch.utils.random import key_tensor
from test_torch_constraints_train import (ATOL, BASE, GROUPS, GROWERS,
                                          KINDS, RTOL, _assert_class_routing,
                                          _assert_routing, _bins_of,
                                          _kind_data, _train_both,
                                          assert_paths_in_groups)
from test_torch_constraints_train import MONO as MONO6
from test_torch_constraints_train import p_arrays, r_arrays

F, B = 6, 32
MONO = np.array([1, -1, 0, 1, 0, -1], np.int32)
FIELDS = ("gain", "feature", "bin", "left_g", "left_h", "left_c", "right_g",
          "right_h", "right_c", "left_out", "right_out")


def _hist(rng, rows=3000, dyadic=False, empty=()):
    codes = rng.integers(0, B, (rows, F))
    for b in empty:
        codes[codes == b] = b + 1
    if dyadic:
        g = np.where(rng.random(rows) < 0.5, -0.5, 0.5)
        h = np.ones(rows)
    else:
        g = rng.normal(0.2, 1.0, rows) * (1 + (codes[:, 0] % 3))
        h = rng.uniform(0.05, 0.25, rows)
    hist = np.zeros((F, B, 3), np.float32)
    for j in range(F):
        for k, v in enumerate((g, h, np.ones(rows))):
            hist[j, :, k] = np.bincount(codes[:, j], weights=v, minlength=B)
    return hist


def _ctx(**kw):
    base = dict(lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20.0,
                min_sum_hessian=1e-3, min_gain_to_split=0.0,
                max_delta_step=0.0, path_smooth=0.0)
    base.update(kw)
    return (rs.SplitContext(**{k: jnp.float32(v) for k, v in base.items()}),
            ps.SplitContext(**base))


def _bounds(rng, i):
    """Bounds of four kinds: none, a cap (left of an increasing split), a
    floor (its right side), and both (a node under two splits)."""
    mid = np.float32(rng.normal(0.0, 0.15))
    lo, hi = [(-np.inf, np.inf), (-np.inf, mid), (mid, np.inf),
              (mid - np.float32(0.2), mid)][i % 4]
    return np.float32(lo), np.float32(hi)


def _cases(rng, k, dyadic=False, rand=False):
    hists = np.stack([_hist(rng, dyadic=dyadic and i % 2 == 0,
                            empty=(3,) if i % 3 == 0 else ())
                      for i in range(k)])
    bounds = [_bounds(rng, i) for i in range(k)]
    lo = np.array([b[0] for b in bounds], np.float32)
    hi = np.array([b[1] for b in bounds], np.float32)
    po = rng.normal(0.0, 0.1, k).astype(np.float32)
    rb = rng.integers(0, B, (k, F)).astype(np.int32) if rand else None
    return hists, lo, hi, po, rb


def _assert_same(want, got, i, fields=FIELDS):
    for name in fields:
        a = np.asarray(getattr(want, name))
        b = getattr(got, name)[i].numpy().astype(a.dtype)
        assert a.tobytes() == b.tobytes(), (name, i, a, b)


REGS = {
    "plain": {},
    "l1_l2": dict(lambda_l1=0.5, lambda_l2=2.0),
    "max_delta_step": dict(max_delta_step=0.05),
    "path_smooth": dict(path_smooth=3.0),
    "min_gain": dict(min_gain_to_split=0.5, min_data_in_leaf=200.0),
}


# ------------------------------------------------------------ (a) the scans
@pytest.mark.parametrize("rand", [False, True], ids=["mono", "mono_rand"])
@pytest.mark.parametrize("reg", sorted(REGS))
def test_find_best_split_mono_bounds_rand_bit_equal(reg, rand):
    rng = np.random.default_rng(sorted(REGS).index(reg) + 10 * rand)
    k = 8
    hists, lo, hi, po, rb = _cases(rng, k, dyadic=True, rand=rand)
    jctx, pctx = _ctx(**REGS[reg])
    mask = np.ones((k, F), np.float32)
    mask[1, 2] = 0.0
    got = ps.find_best_split(
        torch.from_numpy(hists), pctx, torch.from_numpy(mask), None,
        torch.from_numpy(po), torch.from_numpy(lo), torch.from_numpy(hi),
        mono=torch.from_numpy(MONO),
        rand_bins=None if rb is None else torch.from_numpy(rb))
    for i in range(k):
        want = rs.find_best_split(
            jnp.asarray(hists[i]), jctx, jnp.asarray(mask[i]),
            jnp.bool_(True), None, jnp.asarray(MONO), jnp.float32(lo[i]),
            jnp.float32(hi[i]), jnp.float32(po[i]),
            None if rb is None else jnp.asarray(rb[i]))
        _assert_same(want, got, i)
        if np.isfinite(np.float32(want.gain)):
            f = int(want.feature)
            wl, wr = float(want.left_out), float(want.right_out)
            # the winner honours its column's sign and the bounds (which
            # give way to max_delta_step's cap where the two cross)
            assert MONO[f] * (wr - wl) >= 0
            if "max_delta_step" not in REGS[reg]:
                assert lo[i] <= min(wl, wr) and max(wl, wr) <= hi[i]
            if rb is not None:
                assert int(want.bin) == rb[i, f]


def test_mono_rejects_and_rand_restricts():
    """Off the reference too: a sign flipped on every column moves the
    winner off the constrained columns' best, and one drawn position per
    column leaves one candidate per column."""
    rng = np.random.default_rng(41)
    h = torch.from_numpy(_hist(rng))[None]
    _, pctx = _ctx()
    ones = torch.ones(1, F)
    free = ps.find_best_split(h, pctx, ones)
    f0 = int(free.feature[0])
    sign = 1 if float(free.right_out[0]) < float(free.left_out[0]) else -1
    mono = torch.zeros(F, dtype=torch.int32)
    mono[f0] = sign                       # the free winner runs against it
    held = ps.find_best_split(h, pctx, ones, mono=mono)
    assert (int(held.feature[0]), int(held.bin[0])) != \
        (f0, int(free.bin[0]))
    assert float(held.gain[0]) <= float(free.gain[0])
    rb = torch.full((1, F), 7, dtype=torch.int64)
    g = ps._scan(h, pctx, ones, None, None, rand_bins=rb)[0][0]
    finite = torch.isfinite(g)
    assert bool(finite[:, 7].any()) and not bool(
        finite[:, torch.arange(B) != 7].any())


@pytest.mark.parametrize("reg", ["plain", "l1_l2", "path_smooth"])
def test_feature_best_gains_mono_bounds_rand(reg):
    rng = np.random.default_rng(sorted(REGS).index(reg) + 20)
    k = 6
    hists, lo, hi, po, rb = _cases(rng, k, rand=True)
    jctx, pctx = _ctx(**REGS[reg])
    for use_rand in (False, True):
        got = ps.feature_best_gains(
            torch.from_numpy(hists), pctx, torch.ones(k, F), None,
            torch.from_numpy(po), torch.from_numpy(lo), torch.from_numpy(hi),
            mono=torch.from_numpy(MONO),
            rand_bins=torch.from_numpy(rb) if use_rand else None)
        for i in range(k):
            want = rs.feature_best_gains(
                jnp.asarray(hists[i]), jctx, jnp.ones(F), jnp.bool_(True),
                mono=jnp.asarray(MONO), bound_lo=jnp.float32(lo[i]),
                bound_hi=jnp.float32(hi[i]), parent_out=jnp.float32(po[i]),
                rand_bins=jnp.asarray(rb[i]) if use_rand else None)
            assert np.asarray(want).tobytes() == got[i].numpy().tobytes()


IS_CAT = np.array([True, False, True, False, False, True])


@pytest.mark.parametrize("rand", [False, True], ids=["mono", "mono_rand"])
@pytest.mark.parametrize("mct", [1, 32])
def test_cat_scan_with_mono_and_rand_bit_equal(mct, rand):
    """Categorical columns: a constrained one (0 and 5 here) takes no subset
    split; an unconstrained one (2) keeps its subset scan, restricted to
    its drawn sorted position under extra-trees."""
    rng = np.random.default_rng(mct + 50 * rand)
    k = 6
    hists, lo, hi, po, rb = _cases(rng, k, rand=rand)
    hists[:, 2, 7] = (900.0, 60.0, 400.0)        # a strong category
    jctx, pctx = _ctx(lambda_l2=1.0)
    ci_r = rs.CatInfo(jnp.asarray(IS_CAT), jnp.float32(10.0),
                      jnp.float32(10.0), mct)
    ci_p = ps.CatInfo(torch.from_numpy(IS_CAT), 10.0, 10.0, mct)
    got = ps.find_best_split(
        torch.from_numpy(hists), pctx, torch.ones(k, F), None,
        torch.from_numpy(po), torch.from_numpy(lo), torch.from_numpy(hi),
        cat_info=ci_p, mono=torch.from_numpy(MONO),
        rand_bins=None if rb is None else torch.from_numpy(rb))
    for i in range(k):
        want = rs.find_best_split(
            jnp.asarray(hists[i]), jctx, jnp.ones(F), jnp.bool_(True),
            ci_r, jnp.asarray(MONO), jnp.float32(lo[i]), jnp.float32(hi[i]),
            jnp.float32(po[i]), None if rb is None else jnp.asarray(rb[i]))
        _assert_same(want, got, i, FIELDS + ("cat", "cat_mask"))
        if bool(want.cat) and np.isfinite(np.float32(want.gain)):
            assert MONO[int(want.feature)] == 0


def test_grower_rounding_under_mono():
    """The growers score a monotone tree at ``arith="cat"`` (the reference's
    program contracts the clipped outputs' leaf objective); without
    constraints or categories, at ``"scan"``."""
    assert pt._xla_arith(None) == "scan"
    assert pt._xla_arith(None, torch.tensor([1, 0])) == "cat"


# --------------------------------------------------------------- (b) helpers
def test_mono_child_bounds_bit_equal():
    rng = np.random.default_rng(3)
    n = 64
    feat = rng.integers(0, F, n).astype(np.int32)
    wl = rng.normal(0, 0.3, n).astype(np.float32)
    wr = rng.normal(0, 0.3, n).astype(np.float32)
    lo = np.where(rng.random(n) < 0.4, -np.inf,
                  rng.normal(-0.5, 0.2, n)).astype(np.float32)
    hi = np.where(rng.random(n) < 0.4, np.inf,
                  rng.normal(0.5, 0.2, n)).astype(np.float32)
    want = rt._mono_child_bounds(jnp.asarray(MONO), jnp.asarray(feat),
                                 jnp.asarray(wl), jnp.asarray(wr),
                                 jnp.asarray(lo), jnp.asarray(hi))
    got = pt._mono_child_bounds(torch.from_numpy(MONO),
                                torch.from_numpy(feat), torch.from_numpy(wl),
                                torch.from_numpy(wr), torch.from_numpy(lo),
                                torch.from_numpy(hi))
    for a, b in zip(want, got):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()
    same = pt._mono_child_bounds(None, torch.from_numpy(feat),
                                 torch.from_numpy(wl), torch.from_numpy(wr),
                                 torch.from_numpy(lo), torch.from_numpy(hi))
    assert same[0] is same[2] and same[1] is same[3]


def test_ic_allowed_bit_equal():
    rng = np.random.default_rng(4)
    member = rng.random((5, 9)) < 0.3
    sets = rng.random((3, 7, 5)) < 0.5
    want = rt._ic_allowed(jnp.asarray(sets), jnp.asarray(member))
    got = pt._ic_allowed(torch.from_numpy(sets), torch.from_numpy(member))
    assert np.asarray(want).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("col_bins", [None, (2, 255, 17, 1, 64, 3)],
                         ids=["global", "per_column"])
def test_rand_bin_table_bit_equal(col_bins):
    """Every row of the table is the reference's draw for that node id,
    bit for bit, for several grower keys (the multiclass split keys
    among them) and node ids past the strict capacity."""
    keys = [jax.random.PRNGKey(0), jax.random.PRNGKey(12345),
            jax.random.fold_in(jax.random.PRNGKey(7), 3),
            *jax.random.split(jax.random.PRNGKey(9), 2)]
    cap, num_bins = 253, 256
    cb = None if col_bins is None else np.asarray(col_bins, np.int32)
    table = pt.rand_bin_table(
        key_tensor([tuple(int(w) for w in np.asarray(k)) for k in keys],
                   "cpu"), F, num_bins,
        None if cb is None else torch.from_numpy(cb), cap)
    assert table.shape == (len(keys), cap, F)
    draw = jax.jit(jax.vmap(lambda k, i: rt._rand_bins_for_node(
        k, i, F, num_bins, None if cb is None else jnp.asarray(cb)),
        in_axes=(None, 0)))
    for e, k in enumerate(keys):
        want = np.asarray(draw(k, jnp.arange(cap)))
        assert np.array_equal(want, table[e].numpy())
        # eager, one node at a time, agrees with the batched draw
        for i in (0, 1, 2, cap - 1):
            one = np.asarray(rt._rand_bins_for_node(
                k, i, F, num_bins, None if cb is None else jnp.asarray(cb)))
            assert np.array_equal(one, table[e, i].numpy())
    if cb is not None:
        hi = np.maximum(cb - 1, 1)
        assert bool((table.numpy() < hi).all())


# ------------------------------------------------------------- (c) resolvers
def _sparse(n=1200, seed=0):
    """Columns 0-4 one-hot (EFB bundles 0 and 1), 5-6 dense, 7
    categorical."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, 5, n)
    onehot = (hot[:, None] == np.arange(5)[None, :]) * 1.0
    dense = rng.normal(size=(n, 2))
    cat = rng.integers(0, 6, n).astype(float)
    X = np.column_stack([onehot, dense, cat])
    y = dense[:, 0] + onehot[:, 1] + 0.1 * rng.normal(size=n)
    return X, y


def _boosters(params, bundle=True):
    X, y = _sparse()
    dp = {"enable_bundle": bundle}
    rb = R.Booster(dict(params), R.Dataset(X, label=y, params=dp,
                                           categorical_feature=[7]))
    pd_ = P.Dataset(X, label=y, params=dp, categorical_feature=[7],
                    device="cpu")
    pd_.construct()
    return rb, pd_


@pytest.mark.parametrize("bundle", [True, False], ids=["efb", "no_efb"])
def test_resolvers_match_reference(bundle):
    params = {"objective": "regression", "verbose": -1, "extra_trees": True,
              "monotone_constraints": ([0] * 5 if bundle else [0, 1, 0, 0,
                                                               -1])
              + [1, -1, 0],
              "interaction_constraints": [[5, 6], [7]]}
    rb, pd_ = _boosters(params, bundle)
    assert (rb.train_set.bin_mapper.bundler is not None) == bundle
    assert (pd_.bin_mapper.bundler is not None) == bundle
    pp = pg.parse_params(dict(params))
    assert pg.resolve_monotone_constraints(pp, pd_.bin_mapper) == \
        rb._mono_key
    assert pg.resolve_interaction_constraints(pp, pd_.bin_mapper) == \
        rb._ic_key
    assert pg.extra_trees_col_bins(pd_.bin_mapper) == rb._nbins_key
    # a Booster resolves the same onto its device
    b = P.Booster(dict(params), pd_)
    assert tuple(b._constraints["mono"].tolist()) == rb._mono_key
    assert tuple(map(tuple, b._constraints["ic_member"].int().tolist())) \
        == rb._ic_key
    assert tuple(b._constraints["col_bins"].tolist()) == rb._nbins_key


BAD = {
    "length": ({"monotone_constraints": [1, 0, 0]}, True,
               "monotone_constraints has 3 entries"),
    "categorical": ({"monotone_constraints": [0] * 7 + [1]}, False,
                    "monotone constraint on categorical feature 7"),
    "bundled": ({"monotone_constraints": [0, 1] + [0] * 6}, True,
                "monotone constraint on an EFB-bundled feature"),
    "ic_bundle": ({"interaction_constraints": [[0, 5], [1, 6]]}, True,
                  "interaction_constraints split an EFB bundle"),
    "ic_index": ({"interaction_constraints": [[0, 9]]}, False,
                 r"reference feature indices \[9\]"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_resolvers_raise_as_reference(case):
    extra, bundle, msg = BAD[case]
    params = dict({"objective": "regression", "verbose": -1}, **extra)
    X, y = _sparse()
    dp = {"enable_bundle": bundle}
    with pytest.raises(ValueError, match=msg):
        R.Booster(dict(params), R.Dataset(X, label=y, params=dp,
                                          categorical_feature=[7]))
    with pytest.raises(ValueError, match=msg):
        P.Booster(dict(params), P.Dataset(X, label=y, params=dp,
                                          categorical_feature=[7],
                                          device="cpu"))


def test_all_zero_and_absent_constraints_resolve_to_none():
    _, pd_ = _boosters({"objective": "regression"})
    for extra in ({}, {"monotone_constraints": [0] * 8},
                  {"interaction_constraints": []}):
        pp = pg.parse_params(dict({"objective": "regression"}, **extra))
        assert pg.resolve_monotone_constraints(pp, pd_.bin_mapper) is None
        assert pg.resolve_interaction_constraints(pp,
                                                  pd_.bin_mapper) is None


# ------------------------------------------------ (d) multiclass growers
def test_multiclass_waves_extra_trees_interaction_match_reference():
    """The batched wave grower draws each class's extra-trees positions
    under the class's key and carries each class's interaction sets (the
    batched strict grower: the multiclass case above)."""
    params = dict(BASE, num_leaves=15, objective="multiclass", num_class=3,
                  extra_trees=True, interaction_constraints=GROUPS,
                  **GROWERS["wave"])
    X, y, _ = _kind_data("multiclass", seed=4)
    rb, pb = _train_both(params, X, y, 2)
    _assert_class_routing(rb.trees, pb.trees, _bins_of(pb, X), 3)
    np.testing.assert_allclose(pb.predict(X), rb.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_c6_noop_split_of_clipped_children():
    """ROADMAP C.6, pinned: the batched strict grower (multiclass, 2,048
    rows) with all three options.  In tree 2, class 1, the reference splits
    node 7 into two children that both clip to the node's own output (a
    split that changes no score; its gain, 3e-8, is the rounding of two
    equal objectives), where the port's gain rounds to at most 0 and node 7
    stays a leaf.  Every other class tree of the run agrees with the
    regime, and the scores agree within it."""
    params = dict(BASE, num_leaves=15, monotone_constraints=MONO6,
                  **KINDS["multiclass"], extra_trees=True,
                  interaction_constraints=GROUPS)
    X, y, _ = _kind_data("multiclass")
    rb, pb = _train_both(params, X, y, 3)
    bins = _bins_of(pb, X)
    _assert_class_routing(rb.trees[:2], pb.trees[:2], bins, 3)

    def cls(t, c):
        return type(t)(*(None if f is None else f[c] for f in t))

    for c in (0, 2):
        _assert_routing([cls(rb.trees[2], c)], [cls(pb.trees[2], c)], bins)
    x, z = r_arrays(cls(rb.trees[2], 1)), p_arrays(cls(pb.trees[2], 1))
    x = {f: np.asarray(v) for f, v in x.items()}
    lv = x["leaf_value"]
    kids = x["left"][7], x["right"][7]
    assert not x["is_leaf"][7] and z["is_leaf"][7]
    assert 0 < x["split_gain"][7] < 1e-6
    assert lv[kids[0]] == lv[kids[1]] == lv[7]
    np.testing.assert_allclose(z["leaf_value"][7], lv[7], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(pb.predict(X), rb.predict(X), rtol=RTOL,
                               atol=ATOL)
    for t in pb.trees:
        for c in range(3):
            assert_paths_in_groups(type("B", (), {"trees": [cls(t, c)]}),
                                   GROUPS, X.shape[1])
