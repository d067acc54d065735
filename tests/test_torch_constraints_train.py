"""Port parity: training with monotone constraints, interaction constraints
and extra-trees against the reference on the CPU.

The parity regime:

(a) the dyadic tier (y in {0, 1} with exactly n/2 ones, l2: every round-1
    statistic is +-0.5 or 1, so every sum is exact): the round-1 trees
    (every field) and scores are bit-identical, on the strict grower and on
    the wave grower (its exact tail), for each option alone and all three
    at once;
(b) elsewhere: split structure equal up to ROADMAP C.1's near-tied
    thresholds (every node splits the same training rows on the same
    feature into the same two row sets, and each leaf holds the same rows;
    a threshold may differ only where no training row lies between the
    two), leaf values and predictions within rtol 1e-5, atol 1e-6, for
    those options and growers, for monotone constraints with rf, GOSS,
    DART, multiclass and lambdarank (the batched multiclass growers with
    every option: ``test_torch_constraints.py``);
(c) ``cv()`` with any of the options takes the per-fold route, as the
    reference's does (all three at once): histories within rtol 1e-5,
    ``best_iter`` equal;
(d) ``LGBMRegressor(monotone_constraints=)``, the CLI's config keys, and a
    killed and resumed extra-trees run (bit for bit);
(e) section 1 of ``examples/advanced_features.py`` (seed 7, 4,000 training
    rows, ``monotone_constraints=[1, -1, 0, 0, 0]``, 60 rounds) on both
    packages, ROADMAP C.6 pinned there.

Every single-class model here is also held to its constraints outright:
swept over all of a constrained column's bins, the raw score of each of
64 rows never moves against the column's sign, exactly, and every
root-to-leaf path stays inside one interaction group.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.models.fused as PF
from lightgbm_tpu_torch.config import parse_params
from lightgbm_tpu_torch.__main__ import main as port_main
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.training import (list_checkpoints, resume_booster,
                                         train_resumable)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCT = ("split_feature", "split_bin", "left", "right", "is_leaf")
MONO = [1, -1, 0, 0, 1, 0]
GROUPS = [[0, 1, 2], [3, 4]]
OPTIONS = {
    "mono": {"monotone_constraints": MONO},
    "extra_trees": {"extra_trees": True},
    "interaction": {"interaction_constraints": GROUPS},
}
ALL = {k: v for o in OPTIONS.values() for k, v in o.items()}
GROWERS = {"strict": {"grow_policy": "leafwise"},
           "wave": {"grow_policy": "frontier"}}
BASE = {"objective": "regression", "num_leaves": 31, "verbose": -1,
        "seed": 5}


def _frame(n=2048, seed=0, dyadic=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    s = 1.2 * X[:, 0] - 0.8 * X[:, 1] + np.sin(2 * X[:, 2]) \
        + 0.5 * X[:, 3] * X[:, 4] + 0.3 * X[:, 5]
    if dyadic:
        y = np.zeros(n)
        y[np.argsort(s)[n // 2:]] = 1.0
    else:
        y = s + 0.3 * rng.normal(size=n)
    return X, y


def _train_both(params, X, y, rounds, **ds_kw):
    rb = R.train(dict(params), R.Dataset(X, label=y, params=dict(params),
                                         **ds_kw), rounds)
    pb = P.train(dict(params), P.Dataset(X, label=y, params=dict(params),
                                         device="cpu", **ds_kw), rounds)
    return rb, pb


def _assert_trees(rtrees, ptrees, exact=False):
    """(a) every field bit for bit, or the structure with leaves within the
    regime."""
    for a, b in zip(rtrees, ptrees):
        x, z = r_arrays(a), p_arrays(b)
        fields = [f for f in z if f in x] if exact else STRUCT
        for f in fields:
            assert np.array_equal(np.asarray(x[f]), z[f]), f
        if not exact:
            np.testing.assert_allclose(z["leaf_value"], x["leaf_value"],
                                       rtol=RTOL, atol=ATOL)


def _routing(t, bins):
    """Per internal node, keyed by its row set: (feature, the left row
    set); per leaf: row set -> value."""
    internal, leaves = {}, {}
    stack = [(0, np.arange(bins.shape[0]))]
    while stack:
        node, rows = stack.pop()
        if t["is_leaf"][node] or t["left"][node] < 0:
            leaves[rows.tobytes()] = t["leaf_value"][node]
            continue
        f = int(t["split_feature"][node])
        go = bins[rows, f] <= t["split_bin"][node]
        internal[rows.tobytes()] = (f, rows[go].tobytes())
        stack += [(int(t["left"][node]), rows[go]),
                  (int(t["right"][node]), rows[~go])]
    return internal, leaves


def _assert_routing(rtrees, ptrees, bins):
    """(b): the trees split the training rows alike (C.1's near-tied
    thresholds route them alike too); returns the thresholds that
    differ."""
    swaps = 0
    for a, b in zip(rtrees, ptrees):
        x, z = r_arrays(a), p_arrays(b)
        ia, la = _routing({f: np.asarray(v) for f, v in x.items()}, bins)
        ib, lb = _routing(z, bins)
        assert ia == ib and la.keys() == lb.keys()
        for k in la:
            np.testing.assert_allclose(lb[k], la[k], rtol=RTOL, atol=ATOL)
        swaps += int((np.asarray(x["split_bin"]) != z["split_bin"]).sum())
    return swaps


def _bins_of(booster, X):
    return booster.train_set.bin_mapper.transform(np.asarray(X))


def assert_monotone(booster, X, mono, rows=64):
    """Each held-out row swept over every bin of each constrained column:
    the raw score never moves against the column's sign, exactly (binned
    rows, one traversal of the whole forest)."""
    from lightgbm_tpu_torch.ops.predict import predict_forest_binned

    forest = booster._stacked_forest()
    codes = _bins_of(booster, X[:rows])
    n_bins = booster.train_set.bin_mapper.n_bins
    for f, sign in enumerate(mono):
        if sign == 0:
            continue
        nb = int(n_bins[f])
        grid = np.repeat(codes, nb, axis=0)
        grid[:, f] = np.tile(np.arange(nb), rows)
        raw = predict_forest_binned(
            forest, torch.from_numpy(grid), booster._shrink,
            float(booster.init_score_), len(booster.trees),
            booster._depth_cap).numpy().reshape(rows, nb)
        step = np.diff(raw.astype(np.float64), axis=1) * sign
        assert (step >= 0).all(), (f, step.min())


def assert_paths_in_groups(booster, groups, num_features):
    """Every root-to-leaf path of every tree splits only on columns of one
    group (unlisted columns are groups of their own)."""
    listed = set().union(*map(set, groups))
    sets = [set(g) for g in groups] + [{f} for f in range(num_features)
                                       if f not in listed]
    for t in booster.trees:
        a = p_arrays(t)
        stack = [(0, frozenset())]
        while stack:
            node, used = stack.pop()
            if a["is_leaf"][node] or a["left"][node] < 0:
                assert any(used <= s for s in sets), sorted(used)
                continue
            used = used | {int(a["split_feature"][node])}
            stack += [(int(a["left"][node]), used),
                      (int(a["right"][node]), used)]


def _assert_constraints(booster, params, X):
    if "monotone_constraints" in params:
        assert_monotone(booster, X, params["monotone_constraints"])
    if "interaction_constraints" in params:
        assert_paths_in_groups(booster, params["interaction_constraints"],
                               X.shape[1])


# ------------------------------------------------- (a) + (b) both growers
@pytest.mark.parametrize("grower", sorted(GROWERS))
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_train_matches_reference(option, grower):
    params = dict(BASE, **GROWERS[grower], **OPTIONS[option])
    X, yd = _frame(dyadic=True)
    # as many rounds as the general run: the reference compiles once
    rb, pb = _train_both(params, X, yd, 3)
    _assert_trees(rb.trees[:1], pb.trees[:1], exact=True)
    assert np.array_equal(rb.predict(X, num_iteration=1, raw_score=True),
                          pb.predict(X, num_iteration=1, raw_score=True))
    X, y = _frame(seed=1)
    rb, pb = _train_both(params, X, y, 3)
    _assert_routing(rb.trees, pb.trees, _bins_of(pb, X))
    np.testing.assert_allclose(pb.predict(X), rb.predict(X), rtol=RTOL,
                               atol=ATOL)
    _assert_constraints(pb, params, X)
    if option == "extra_trees":
        # a randomized tree differs from the greedy one
        free = P.train(dict(BASE, **GROWERS[grower]),
                       P.Dataset(X, label=y, device="cpu"), 1)
        assert not all(np.array_equal(p_arrays(pb.trees[0])[f],
                                      p_arrays(free.trees[0])[f])
                       for f in ("split_feature", "split_bin"))


def test_greedy_tail_keeps_bounds():
    """The greedy tail carries the bounds as the exact tail (the matrix
    above) does."""
    X, y = _frame(n=4096, seed=2)
    params = dict(BASE, monotone_constraints=MONO, wave_tail="greedy",
                  grow_policy="frontier")
    rb, pb = _train_both(params, X, y, 3)
    _assert_routing(rb.trees, pb.trees, _bins_of(pb, X))
    _assert_constraints(pb, params, X)


def _assert_class_routing(rtrees, ptrees, bins, k):
    """:func:`_assert_routing` for each class's trees of multiclass
    rounds (fields ``[K, M]``)."""
    def cls(t, c):
        return type(t)(*(None if f is None else f[c] for f in t))

    for c in range(k):
        _assert_routing([cls(a, c) for a in rtrees],
                        [cls(b, c) for b in ptrees], bins)


# ------------------------------------------------------- (b) round kinds
KINDS = {
    "rf": {"boosting": "rf", "bagging_fraction": 0.6, "bagging_freq": 1},
    "goss": {"boosting": "goss", "top_rate": 0.3, "other_rate": 0.2},
    "dart": {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
    "multiclass": {"objective": "multiclass", "num_class": 3},
    "lambdarank": {"objective": "lambdarank", "eval_at": [5]},
}


def _kind_data(kind, seed=3):
    X, y = _frame(seed=seed)
    kw = {}
    if kind == "multiclass":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    elif kind == "lambdarank":
        y = np.digitize(y, np.quantile(y, [0.5, 0.8, 0.95])).astype(float)
        kw["group"] = [16] * (len(y) // 16)
    return X, y, kw


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_mono_round_kinds_match_reference(kind):
    params = dict(BASE, num_leaves=15, monotone_constraints=MONO,
                  **KINDS[kind])
    X, y, kw = _kind_data(kind)
    rb, pb = _train_both(params, X, y, 3, **kw)
    bins = _bins_of(pb, X)
    if kind == "multiclass":
        _assert_class_routing(rb.trees, pb.trees, bins, 3)
    else:
        _assert_routing(rb.trees, pb.trees, bins)
        assert_monotone(pb, X, MONO)
    np.testing.assert_allclose(pb.predict(X), rb.predict(X), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ (c) cv()
def test_cv_takes_the_per_fold_route(monkeypatch):
    for extra in OPTIONS.values():
        pp = parse_params(dict(BASE, **extra))
        assert not PF.fused_cv_eligible(pp, None, None)
    params = dict(BASE, num_leaves=7, **ALL)

    def refuse(*a, **k):
        raise AssertionError("the fused cv() route ran")

    monkeypatch.setattr(PF, "run_fused_cv_batch", refuse)
    X, y = _frame(n=1200, seed=6)
    kw = dict(num_boost_round=8, nfold=3, stratified=False, seed=3,
              early_stopping_rounds=3)
    want = R.cv(dict(params), R.Dataset(X, label=y), **kw)
    got = P.cv(dict(params), P.Dataset(X, label=y, device="cpu"), **kw)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
    assert got.best_iter == want.best_iter


# ---------------------------------------- (d) sklearn, the CLI, recovery
def test_lgbm_regressor_monotone_constraints():
    X, y = _frame(seed=7)
    kw = dict(n_estimators=4, num_leaves=15, monotone_constraints=MONO,
              verbose=-1)
    r = R.LGBMRegressor(**kw).fit(X, y)
    p = P.LGBMRegressor(device="cpu", **kw).fit(X, y)
    assert p.get_params()["monotone_constraints"] == MONO
    np.testing.assert_allclose(p.predict(X), r.predict(X), rtol=RTOL,
                               atol=ATOL)
    assert_monotone(p.booster_, X, MONO)


def test_cli_constraint_keys(tmp_path):
    """``monotone_constraints``, ``interaction_constraints`` and
    ``extra_trees`` in the CLI's config reach the Booster: the model file
    equals, bit for bit in its predictions, the one ``train`` grows from
    the same params."""
    X, y = _frame(n=1500, seed=8)
    csv = tmp_path / "train.csv"
    with open(csv, "w") as f:
        f.write(",".join([f"x{j}" for j in range(6)] + ["y"]) + "\n")
        for xr, yv in zip(X, y):
            f.write(",".join(f"{t:.9g}" for t in [*xr, yv]) + "\n")
    model = tmp_path / "m.txt"
    assert port_main([
        "task=train", f"data={csv}", "header=true", "label_column=name:y",
        "objective=regression", "num_trees=3", "num_leaves=15",
        "verbose=-1", "device=cpu", "monotone_constraints=1,-1,0,0,1,0",
        "interaction_constraints=[0,1,2],[3,4]", "extra_trees=true",
        f"output_model={model}"]) == 0
    cli = P.Booster(model_file=str(model), device="cpu")
    Xf = np.loadtxt(csv, delimiter=",", skiprows=1)
    params = dict(objective="regression", num_leaves=15, verbose=-1,
                  monotone_constraints=MONO, extra_trees=True,
                  interaction_constraints=GROUPS)
    want = P.train(params, P.Dataset(Xf[:, :6], label=Xf[:, 6],
                                     device="cpu"), 3)
    assert np.array_equal(cli.predict(Xf[:, :6]), want.predict(Xf[:, :6]))
    assert cli.params.monotone_constraints == MONO
    assert cli.params.interaction_constraints == GROUPS
    assert cli.params.extra_trees


@pytest.mark.parametrize("grower", sorted(GROWERS))
def test_extra_trees_kill_and_resume_bit_identical(tmp_path, grower):
    """The draws are keyed by round and node: a run killed after any round
    and resumed grows the uninterrupted run, bit for bit."""
    X, y = _frame(n=1500, seed=9)
    rounds = 4
    params = dict(BASE, num_leaves=15, extra_trees=True,
                  monotone_constraints=MONO, bagging_fraction=0.8,
                  bagging_freq=1, **GROWERS[grower])

    def ds():
        return P.Dataset(X, label=y, params=dict(params), device="cpu")

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
            for f in x:
                assert np.array_equal(x[f], z[f]), f
        assert torch.equal(whole._pred_train, b._pred_train)


# -------------------------------------- (e) examples/advanced_features.py
def _advanced_features_data():
    rng = np.random.default_rng(7)
    n = 5000
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = (1.2 * X[:, 0] - 0.8 * X[:, 1]
         + np.where(X[:, 2] > 0, 2.0 * X[:, 2], 0.3 * X[:, 2])
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, y


def _forest_arrays(rtrees, ptrees):
    """Both forests' fields ``[T, M]`` as numpy arrays, the reference's read
    from its stacked segments in one transfer per field."""
    runs = rtrees.stacked_runs()
    fields = STRUCT + ("leaf_value",)
    ref = {f: np.concatenate([np.asarray(getattr(r, f)) for r in runs])
           for f in fields}
    port = {f: np.stack([p_arrays(t)[f] for t in ptrees]) for f in fields}
    return ref, port


def _first_structure_difference(ref, port):
    for i in range(ref["is_leaf"].shape[0]):
        if not all(np.array_equal(ref[f][i], port[f][i]) for f in STRUCT):
            return i
    return None


def test_advanced_features_monotone_call_on_both_packages():
    """Section 1 of examples/advanced_features.py, as the script calls it.

    ROADMAP C.6, pinned: the trees agree in structure, leaves within the
    regime, up to tree 50, where the exact tail's replay keeps a different
    split (a gain of a clipped candidate 1.3e-6 relative apart between the
    packages); from there the models part, and the held-out RMSEs differ
    by 1.7e-4 relative (0.2066916 against 0.2066575).  Both models are
    monotone."""
    X, y = _advanced_features_data()
    tr, te = slice(0, 4000), slice(4000, None)
    params = {"objective": "regression", "verbosity": -1,
              "monotone_constraints": [1, -1, 0, 0, 0]}
    rb = R.train(dict(params), R.Dataset(X[tr], label=y[tr]),
                 num_boost_round=60)
    pb = P.train(dict(params), P.Dataset(X[tr], label=y[tr], device="cpu"),
                 num_boost_round=60)
    ref, port = _forest_arrays(rb.trees, pb.trees)
    first = _first_structure_difference(ref, port)
    assert first in (None, 50), first
    upto = 60 if first is None else first
    np.testing.assert_allclose(port["leaf_value"][:upto],
                               ref["leaf_value"][:upto], rtol=RTOL,
                               atol=ATOL)

    def rmse(b):
        return float(np.sqrt(np.mean((b.predict(X[te]) - y[te]) ** 2)))

    r_rmse, p_rmse = rmse(rb), rmse(pb)
    assert abs(p_rmse - r_rmse) <= 2e-4 * r_rmse, (p_rmse, r_rmse)
    assert p_rmse < 0.25
    assert_monotone(pb, X[te], params["monotone_constraints"])
