"""Port parity: continued training (``init_model``) against the reference
on the CPU.

The parity regime:

(a) the replay: a Booster that ingests a model (the port's Booster, or a
    model file the reference wrote) rebuilds its train scores by the live
    round's update, so right after ingestion ``_pred_train`` equals the
    reference's bit for bit, at the same learning rate and at another
    (the leaves rescaled by ``prev_lr / cur_lr`` in f32), with a Dataset
    ``init_score`` on top;
(b) continued rounds against the reference's continuation from the same
    file: split structure equal, leaf values and predictions within rtol
    1e-5 / atol 1e-6 (the continued rounds' histograms sum in other
    orders, as in every general-data test); multiclass, linear leaves
    (ROADMAP C.7's bounds: intercepts rtol 1e-3 / atol 1e-4, predictions
    atol 1e-5, path features exact) and lambdarank (C.5's atol 1e-5) too;
(c) the port's own continuation, 3 + 3 rounds, equals 6 uninterrupted
    rounds bit for bit (every tree field and the train scores) through
    ``train(init_model=<Booster>)``, ``train(init_model=<model file>)``,
    ``Booster(model_file).update(ds)`` and ``train_resumable(init_model=)``
    (the counterpart of the reference's streamed ``tests/test_freshness.py``
    case, on an in-memory Dataset), for gbdt with bagging and feature
    fraction, multiclass, linear leaves and lambdarank;
(d) a forest of mixed node capacities (a continuation at another
    ``num_leaves``) through ``predict``, ``pred_leaf``, ``pred_contrib``,
    ``dump_model``, ``feature_importance``, ``pack_booster`` and a DART
    continuation, against the reference's same continuation;
(e) every refusal with the reference's exception type and message.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch.models.tree import pad_tree
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays
from lightgbm_tpu_torch.serving import pack_booster
from lightgbm_tpu_torch.training import train_resumable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
STRUCT = ("split_feature", "split_bin", "left", "right", "is_leaf",
          "num_leaves")
BASE = {"objective": "regression", "num_leaves": 15, "verbosity": -1,
        "min_data_in_leaf": 10, "bagging_fraction": 0.8, "bagging_freq": 1,
        "feature_fraction": 0.8}


def _frame(n=3000, f=6, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.5 * X[:, 2] * X[:, 3]
         + 0.3 * rng.normal(size=n))
    return X, y


def _pds(X, y, **kw):
    return P.Dataset(X, label=y, device="cpu", **kw)


def _same_trees(a, b):
    """Every field of every tree equal, bit for bit."""
    assert len(a.trees) == len(b.trees)
    for i, (ta, tb) in enumerate(zip(a.trees, b.trees)):
        fa, fb = p_arrays(ta), p_arrays(tb)
        assert fa.keys() == fb.keys(), i
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), (i, k)


def _assert_parity(ref, port, atol=ATOL, rtol=RTOL):
    """Structure equal, leaves within the regime (multiclass rounds hold
    ``[K, M]`` fields)."""
    assert len(ref.trees) == len(port.trees)
    for i, (tr, tp) in enumerate(zip(ref.trees, port.trees)):
        a, b = r_arrays(tr), p_arrays(tp)
        for k in STRUCT:
            assert np.array_equal(a[k], b[k]), (i, k)
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=rtol, atol=atol, err_msg=str(i))


@pytest.fixture(scope="module")
def frame():
    return _frame()


@pytest.fixture(scope="module")
def ref_model(frame, tmp_path_factory):
    """Three reference rounds and their model file."""
    X, y = frame
    r = R.train(BASE, R.Dataset(X, label=y), 3)
    path = str(tmp_path_factory.mktemp("ref") / "ref3.txt")
    r.save_model(path)
    return r, path


# ------------------------------------------------------------ (a) + (b)
@pytest.mark.parametrize("lr", [0.1, 0.05, 0.07])
def test_replay_equals_the_reference_bit_for_bit(frame, ref_model, lr):
    X, y = frame
    r, path = ref_model
    params = dict(BASE, learning_rate=lr)
    rb = R.Booster(params, R.Dataset(X, label=y))
    rb.ingest_init_model(R.Booster(model_file=path))
    pb = P.Booster(params, _pds(X, y))
    pb.ingest_init_model(P.Booster(model_file=path, device="cpu"))
    assert pb.current_iteration() == 3 and pb.init_score_ == rb.init_score_
    np.testing.assert_array_equal(pb._pred_train.numpy(),
                                  np.asarray(rb._pred_train))
    for tr, tp in zip(rb.trees, pb.trees):
        np.testing.assert_array_equal(p_arrays(tp)["leaf_value"],
                                      r_arrays(tr)["leaf_value"])


def test_dataset_init_score_goes_on_top(frame, ref_model):
    X, y = frame
    _, path = ref_model
    off = np.linspace(-1.0, 1.0, len(y))
    rb = R.Booster(BASE, R.Dataset(X, label=y, init_score=off))
    rb.ingest_init_model(R.Booster(model_file=path))
    pb = P.Booster(BASE, _pds(X, y, init_score=off))
    pb.ingest_init_model(P.Booster(model_file=path, device="cpu"))
    np.testing.assert_array_equal(pb._pred_train.numpy(),
                                  np.asarray(rb._pred_train))
    # the same through a loaded model's update(ds)
    lb = P.Booster(model_file=path, device="cpu")
    lb.update(_pds(X, y, init_score=off))
    rl = R.Booster(model_file=path)
    rl.update(R.Dataset(X, label=y, init_score=off))
    _assert_parity(rl, lb)


@pytest.mark.parametrize("source", ["booster", "reference_file"])
def test_continuation_matches_the_reference(frame, ref_model, source):
    X, y = frame
    r, path = ref_model
    rc = R.train(BASE, R.Dataset(X, label=y), 3, init_model=path)
    init = (P.Booster(model_file=path, device="cpu") if source == "booster"
            else path)
    pc = P.train(BASE, _pds(X, y), 3, init_model=init)
    assert pc.num_trees() == 6 and pc.current_iteration() == 6
    _assert_parity(rc, pc)
    np.testing.assert_allclose(pc.predict(X), rc.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_loaded_booster_update_matches_the_reference(frame, ref_model):
    X, y = frame
    _, path = ref_model
    rb, pb = R.Booster(model_file=path), P.Booster(model_file=path,
                                                   device="cpu")
    rds, pds = R.Dataset(X, label=y), _pds(X, y)
    for _ in range(2):
        rb.update(rds)
        pb.update(pds)
    assert pb.current_iteration() == 5
    _assert_parity(rb, pb)


# -------------------------------------------------- (c) bit for bit, port
CASES = {
    "gbdt": (BASE, {}),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "verbosity": -1,
                    "bagging_fraction": 0.8, "bagging_freq": 1}, {}),
    "linear": ({"objective": "regression", "num_leaves": 7, "verbosity": -1,
                "linear_tree": True}, {"params": {"enable_bundle": False}}),
    "lambdarank": ({"objective": "lambdarank", "num_leaves": 7,
                    "verbosity": -1, "min_data_in_leaf": 5,
                    "eval_at": [5]}, {"group": [20] * 100}),
}


def _case_data(case, frame):
    X, y = frame
    if case == "multiclass":
        y = np.digitize(y, np.quantile(y, [1 / 3, 2 / 3])).astype(float)
    elif case == "lambdarank":
        X = X[:2000]
        y = np.digitize(y[:2000], np.quantile(y, [0.5, 0.8, 0.95]))
    return X, y.astype(float)


@pytest.mark.parametrize("case", sorted(CASES))
def test_continuation_equals_uninterrupted_bit_for_bit(case, frame,
                                                       tmp_path):
    params, dkw = CASES[case]
    X, y = _case_data(case, frame)
    ds = _pds(X, y, **dkw)
    full = P.train(params, ds, 6)
    first = P.train(params, ds, 3)
    runs = {"booster": P.train(params, ds, 3, init_model=first)}
    path = str(tmp_path / "m.txt")
    first.save_model(path)
    runs["file"] = P.train(params, ds, 3, init_model=path)
    loaded = P.Booster(model_file=path, device="cpu")
    for _ in range(3):
        loaded.update(ds)
    runs["update"] = loaded
    for how, b in runs.items():
        _same_trees(full, b)
        assert torch.equal(b._pred_train, full._pred_train), how


def test_train_resumable_init_model_continues(frame, tmp_path):
    """3 rounds saved as a model file, continued to 5 by
    ``train_resumable(init_model=)``: trees equal to 5 uninterrupted rounds,
    ``resumed_from`` the model file; a checkpoint of this generation takes
    precedence over the model on the next call."""
    X, y = frame
    ds = _pds(X, y)
    path = str(tmp_path / "gen1.txt")
    P.train(BASE, ds, 3).save_model(path)
    res = train_resumable(BASE, ds, 5, checkpoint_dir=str(tmp_path / "ck"),
                          checkpoint_rounds=2, init_model=path)
    assert res.completed and res.rounds_done == 5
    assert res.resumed_from == path
    full = P.train(BASE, ds, 5)
    _same_trees(full, res.booster)
    again = train_resumable(BASE, ds, 5, checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_rounds=2, init_model=path)
    assert again.resumed_from != path and again.rounds_done == 5
    _same_trees(full, again.booster)


@pytest.mark.parametrize("case", ["multiclass", "linear", "lambdarank"])
def test_continuation_matches_the_reference_by_kind(case, frame, tmp_path):
    params, dkw = CASES[case]
    X, y = _case_data(case, frame)
    rfirst = R.train(params, R.Dataset(X, label=y, **dkw), 2)
    path = str(tmp_path / "ref.txt")
    rfirst.save_model(path)
    rc = R.train(params, R.Dataset(X, label=y, **dkw), 2, init_model=path)
    pc = P.train(params, _pds(X, y, **dkw), 2, init_model=path)
    # the regime; C.5's leaf atol 1e-5 for lambdarank; C.7's bounds for
    # linear leaves (intercepts rtol 1e-3 / atol 1e-4, predictions 1e-5)
    leaf_tol, pred_atol = {"multiclass": ((RTOL, ATOL), ATOL),
                           "lambdarank": ((RTOL, 1e-5), 1e-5),
                           "linear": ((1e-3, 1e-4), 1e-5)}[case]
    _assert_parity(rc, pc, rtol=leaf_tol[0], atol=leaf_tol[1])
    if case == "linear":
        for tr, tp in zip(rc.trees, pc.trees):
            np.testing.assert_array_equal(p_arrays(tp)["linear_feat"],
                                          r_arrays(tr)["linear_feat"])
    np.testing.assert_allclose(pc.predict(X), rc.predict(X), rtol=RTOL,
                               atol=pred_atol)


# ------------------------------------------------------ (d) mixed capacity
MIXED = dict(BASE, num_leaves=7, learning_rate=0.05)


@pytest.fixture(scope="module")
def mixed(frame, ref_model):
    """The reference's and the port's 15-leaf model continued 3 rounds at
    7 leaves and half the learning rate."""
    X, y = frame
    _, path = ref_model
    rc = R.train(MIXED, R.Dataset(X, label=y), 3, init_model=path)
    pc = P.train(MIXED, _pds(X, y), 3, init_model=path)
    return rc, pc


def test_mixed_capacity_predict_and_introspection(frame, ref_model, mixed):
    X, _ = frame
    r3 = P.Booster(model_file=ref_model[1], device="cpu")
    rc, pc = mixed
    caps = {t.capacity for t in pc.trees}
    assert caps == {29, 13}
    _assert_parity(rc, pc)
    np.testing.assert_allclose(pc.predict(X), rc.predict(X), rtol=RTOL,
                               atol=ATOL)
    # the first three trees alone give the 15-leaf model (lr ratio 2 is
    # exact in f32; the sums over a longer stack may round otherwise)
    np.testing.assert_allclose(pc.predict(X, num_iteration=3),
                               r3.predict(X), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(pc.predict(X, pred_leaf=True),
                                  rc.predict(X, pred_leaf=True))
    contrib = pc.predict(X[:300], pred_contrib=True)
    np.testing.assert_allclose(contrib, rc.predict(X[:300],
                                                   pred_contrib=True),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(contrib.sum(1),
                               pc.predict(X[:300], raw_score=True),
                               rtol=0, atol=1e-5)
    dp, dr = pc.dump_model(), rc.dump_model()
    assert [t["num_leaves"] for t in dp["tree_info"]] == \
        [t["num_leaves"] for t in dr["tree_info"]]
    for a, b in zip(dp["tree_info"], dr["tree_info"]):
        assert _shape(a["tree_structure"]) == _shape(b["tree_structure"])
    for kind in ("split", "gain"):
        np.testing.assert_allclose(pc.feature_importance(kind),
                                   rc.feature_importance(kind), rtol=RTOL)
    df = pc.trees_to_dataframe()
    assert len(df) == sum(2 * int(t.num_leaves) - 1 for t in pc.trees)


def _shape(node):
    """A dumped tree's structure: the split features and child shapes."""
    if "leaf_index" in node:
        return "leaf"
    return (node["split_feature"], _shape(node["left_child"]),
            _shape(node["right_child"]))


def test_mixed_capacity_served_and_padded(frame, mixed):
    X, _ = frame
    _, pc = mixed
    pf = pack_booster(pc)
    assert pf.capacity == 29 and pf.num_trees == 6
    codes = pc._bin_mapper_for_predict().transform(X)
    np.testing.assert_allclose(pf.predict_numpy(codes, raw_score=True),
                               pc.predict(X, raw_score=True), rtol=0,
                               atol=1e-6)
    rt = P.PredictorRuntime(pf, device="cpu")
    np.testing.assert_allclose(rt.predict(X), pc.predict(X), rtol=RTOL,
                               atol=ATOL)
    # the padded slots carry the grower's unused-slot sentinels
    t = pad_tree(pc.trees[-1], 29)
    assert not bool(t.is_leaf[13:].any())
    assert bool((t.left[13:] == -1).all() and (t.right[13:] == -1).all())
    assert bool((t.leaf_value[13:] == 0).all())
    with pytest.raises(ValueError, match="cannot shrink"):
        pad_tree(pc.trees[0], 13)


def test_mixed_capacity_dart_continuation(frame, ref_model):
    """DART on top of a 15-leaf model at 7 leaves: its dropped trees stack
    across both capacities."""
    X, y = frame
    _, path = ref_model
    params = dict(MIXED, boosting="dart", drop_rate=0.5, skip_drop=0.0,
                  bagging_fraction=1.0, bagging_freq=0)
    rc = R.train(params, R.Dataset(X, label=y), 3, init_model=path)
    pc = P.train(params, _pds(X, y), 3, init_model=path)
    assert {t.capacity for t in pc.trees} == {29, 13}
    _assert_parity(rc, pc)
    np.testing.assert_allclose(pc.predict(X), rc.predict(X), rtol=RTOL,
                               atol=ATOL)


def test_mixed_capacity_checkpoint_resumes_bit_for_bit(frame, ref_model,
                                                       tmp_path):
    """A continued mixed forest checkpointed, killed and resumed grows the
    uninterrupted continuation's trees bit for bit; each tree keeps its own
    capacity in the checkpoint."""
    from lightgbm_tpu_torch.training import resume_booster, save_checkpoint

    X, y = frame
    _, path = ref_model
    ds = _pds(X, y)
    full = P.train(MIXED, ds, 4, init_model=path)
    part = P.train(MIXED, ds, 2, init_model=path)
    ck = save_checkpoint(part, str(tmp_path / "ck"))
    back = resume_booster(ck, ds, params=MIXED)
    assert [t.capacity for t in back.trees] == [29] * 3 + [13] * 2
    while back.current_iteration() < 7:
        back.update()
    _same_trees(full, back)
    assert torch.equal(back._pred_train, full._pred_train)


# --------------------------------------------------------------- (e) refusals
def _refusal(pkg, kind, X, y, path):
    """One refusal of each package: (exception type, message)."""
    ds = pkg.Dataset(X, label=y, **({"device": "cpu"} if pkg is P else {}))
    kw = {"device": "cpu"} if pkg is P else {}
    try:
        if kind == "rf":
            pkg.train(dict(BASE, boosting="rf"), ds, 1, init_model=path)
        elif kind == "classes":
            pkg.train({"objective": "multiclass", "num_class": 3,
                       "verbosity": -1},
                      pkg.Dataset(X, label=np.arange(len(y)) % 3,
                                  **({"device": "cpu"} if pkg is P else {})),
                      1, init_model=path)
        elif kind == "binning":
            pkg.train(BASE, pkg.Dataset(X * 2.0, label=y, **kw), 1,
                      init_model=path)
        elif kind == "linear":
            pkg.train(dict(BASE, linear_tree=True),
                      pkg.Dataset(X, label=y, params={"enable_bundle": False},
                                  **kw), 1, init_model=path)
        elif kind == "attach_binning":
            pkg.Booster(model_file=path, **kw).update(
                pkg.Dataset(X * 2.0, label=y, **kw))
    except Exception as e:            # noqa: BLE001 — compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("kind", ["rf", "classes", "binning", "linear",
                                  "attach_binning"])
def test_refusals_are_the_references(frame, ref_model, kind):
    X, y = frame
    _, path = ref_model
    got = _refusal(P, kind, X, y, path)
    want = _refusal(R, kind, X, y, path)
    assert want is not None and got == want
