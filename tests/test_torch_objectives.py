"""Port parity: the objectives of ``objectives.py`` and the leaf renewal of
``models/tree.py``, on the CPU, against the JAX package.

* Each objective's ``grad_hess`` (under ``jax.jit``, as the reference's round
  step runs it, where XLA's CPU backend contracts multiply-adds),
  ``init_score`` and ``transform`` on seeded f32 inputs: bit for bit.
* ``renew_leaf_values`` on seeded trees and rows: bit for bit with 0/1
  weights (every partial sum an integer), with MAPE's ``1/max(1, |y|)``
  scale and with sample weights (the port sums the weights in XLA's CPU scan
  order, so the target lands on the reference's row).
* A custom objective written only with arithmetic operators, so it runs on
  both packages' arrays: ``train`` agrees (structure equal, leaf values
  within rtol 1e-5 / atol 1e-6, the general-data regime); its model file
  cannot be loaded or served by either package (``objective='none'`` needs
  the callable), and ``Booster.update(fobj=)`` is accepted and unused.
* ``objective="fair"`` defaults to a metric named "fair" that neither
  package has: ``train`` without a valid set works, with one it raises the
  reference's ``ValueError``, and so does ``cv``.
* Model files of an exp-link objective (poisson) interchange both ways, as
  text and as ``.npz``, predictions within rtol 1e-6.
* The sklearn estimator, the CLI's parameters and ``Booster.update`` carry
  the objectives' parameters (alpha, tweedie_variance_power).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu_torch as P
from lightgbm_tpu import objectives as RO
from lightgbm_tpu.config import parse_params as r_parse
from lightgbm_tpu.models import tree as RT
from lightgbm_tpu.models.tree import tree_to_arrays as r_arrays
from lightgbm_tpu_torch import objectives as PO
from lightgbm_tpu_torch.config import parse_params as p_parse
from lightgbm_tpu_torch.models import tree as PT
from lightgbm_tpu_torch.models.tree import tree_to_arrays as p_arrays

OBJECTIVES = ("regression_l1", "huber", "fair", "poisson", "quantile",
              "mape", "gamma", "tweedie", "cross_entropy")
# every objective parameter away from its default
OBJ_PARAMS = {"alpha": 0.7, "tweedie_variance_power": 1.3, "fair_c": 0.8,
              "poisson_max_delta_step": 0.5}
STRUCTURE = ("split_feature", "split_bin", "left", "right", "is_leaf",
             "num_leaves")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the growers run thousands of small ops, which
    several test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, n=6000, seed=1):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 2, n).astype(np.float32)
    y = np.abs(rng.normal(1, 2, n)).astype(np.float32)
    y[:40] = 0.0
    if name == "cross_entropy":
        y = (y / y.max()).astype(np.float32)
    w = rng.uniform(0.5, 2, n).astype(np.float32)
    return pred, y, w


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", OBJECTIVES)
def test_grad_hess_init_transform_bit_equal(name):
    pred, y, w = _inputs(name)
    ro = RO.create_objective(r_parse(dict(OBJ_PARAMS, objective=name)))
    po = PO.create_objective(p_parse(dict(OBJ_PARAMS, objective=name)))
    gr, hr = jax.jit(ro.grad_hess)(pred, y, w)
    gp, hp = po.grad_hess(*map(torch.from_numpy, (pred, y, w)))
    assert np.array_equal(_bits(gr), _bits(gp.numpy()))
    assert np.array_equal(_bits(hr), _bits(hp.numpy()))
    tr = jax.jit(ro.transform)(pred)
    tp = po.transform(torch.from_numpy(pred))
    assert np.array_equal(_bits(tr), _bits(tp.numpy()))
    y64, w64 = y.astype(np.float64), w.astype(np.float64)
    assert po.init_score(y64, w64) == ro.init_score(y64, w64)
    assert getattr(po, "renew_alpha", None) == getattr(ro, "renew_alpha",
                                                       None)


def _tree_pair(rng, cap, leaf_value):
    nl = (cap + 1) // 2
    is_leaf = np.zeros(cap, bool)
    leaves = rng.choice(cap, nl, replace=False)
    is_leaf[leaves] = True
    z = np.zeros(cap, np.int32)
    rt = RT.Tree(*(jnp.asarray(z) for _ in range(4)),
                 leaf_value=jnp.asarray(leaf_value),
                 is_leaf=jnp.asarray(is_leaf), count=jnp.zeros(cap),
                 split_gain=jnp.zeros(cap), num_leaves=jnp.int32(nl))
    tz = torch.from_numpy(z)
    pt = PT.Tree(tz, tz, tz, tz, torch.from_numpy(leaf_value),
                 torch.from_numpy(is_leaf), torch.zeros(cap),
                 torch.zeros(cap), torch.tensor(nl))
    return rt, pt, leaves


@pytest.mark.parametrize("alpha", [0.5, 0.9])
@pytest.mark.parametrize("weights", ["bag", "mape", "sample"])
def test_renew_leaf_values_matches_reference(weights, alpha):
    rng = np.random.default_rng({"bag": 0, "mape": 1, "sample": 2}[weights])
    n, cap = 7000, 61
    lv = rng.normal(size=cap).astype(np.float32)
    rt, pt, leaves = _tree_pair(rng, cap, lv)
    # the last leaf gets no rows: it keeps its Newton value
    row_leaf = rng.choice(leaves[:-1], n).astype(np.int32)
    res = rng.normal(0, 1, n).astype(np.float32)
    bag = (rng.random(n) < 0.8).astype(np.float32)
    if weights == "bag":
        w = bag
    elif weights == "mape":
        y = rng.normal(0, 50, n).astype(np.float32)
        w = bag * (1.0 / np.maximum(np.abs(y), 1.0)).astype(np.float32)
    else:
        w = bag * rng.uniform(0.1, 3, n).astype(np.float32)
    want = jax.jit(lambda t, rl, r, ww: RT.renew_leaf_values(
        t, rl, r, ww, alpha))(rt, row_leaf, res, w).leaf_value
    got = PT.renew_leaf_values(pt, torch.from_numpy(row_leaf),
                               torch.from_numpy(res), torch.from_numpy(w),
                               alpha).leaf_value.numpy()
    assert np.array_equal(_bits(want), _bits(got))
    assert got[leaves[-1]] == lv[leaves[-1]]
    assert np.isin(got[leaves[:-1]], res).all()


def _regression(n=3000, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, 6))
    mu = np.exp(0.5 * X[:, 0] + 0.3 * np.sin(2 * X[:, 1])
                + 0.2 * X[:, 2] * X[:, 3])
    return X, rng.gamma(2.0, mu / 2.0)


def squared_error(pred, y):
    """A custom l2 objective with arithmetic operators only: it runs on the
    reference's traced JAX arrays and on the port's torch tensors."""
    return pred - y, pred * 0.0 + 1.0


def test_custom_objective_trains_like_the_reference(tmp_path):
    X, y = _regression()
    params = dict(objective=squared_error, num_leaves=15, learning_rate=0.3,
                  verbose=-1)
    br = R.train(params, R.Dataset(X, label=y), 4)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), 4)
    assert bp.params.objective == "none" and bp.obj.name == "custom"
    for i in range(4):
        a, b = r_arrays(br.trees[i]), p_arrays(bp.trees[i])
        for k in STRUCTURE:
            assert np.array_equal(a[k], b[k]), (i, k)
        np.testing.assert_allclose(b["leaf_value"], a["leaf_value"],
                                   rtol=RTOL, atol=ATOL)
    # raw scores, untransformed, from an init score of 0
    np.testing.assert_allclose(bp.predict(X), br.predict(X), rtol=RTOL,
                               atol=ATOL)
    assert bp.init_score_ == br.init_score_ == 0.0
    # the fobj receives the port's tensors on the Booster's device
    seen = []

    def spy(pred, yy):
        seen.append((type(pred), pred.device, yy.device))
        return squared_error(pred, yy)

    P.train(dict(params, objective=spy), P.Dataset(X, label=y,
                                                   device="cpu"), 1)
    assert seen == [(torch.Tensor, torch.device("cpu"),
                     torch.device("cpu"))]
    # neither package can reload or serve the model without the callable
    for lib, kw in ((R, {}), (P, {"device": "cpu"})):
        b = br if lib is R else bp
        for ext in ("txt", "npz"):
            path = str(tmp_path / f"{lib.__name__}.{ext}")
            b.save_model(path)
            with pytest.raises(ValueError, match="requires a custom fobj"):
                lib.Booster(model_file=path, **kw)
    from lightgbm_tpu_torch.serving import PredictorRuntime, pack_booster

    with pytest.raises(ValueError, match="requires a custom fobj"):
        PredictorRuntime(pack_booster(bp), device="cpu")


def test_update_fobj_is_accepted_and_unused():
    X, y = _regression(1000)
    params = dict(objective="regression", num_leaves=7, verbose=-1)
    out = []
    for lib, kw in ((R, {}), (P, {"device": "cpu"})):
        b = lib.train(params, lib.Dataset(X, label=y, **kw), 1)
        b.update(fobj=squared_error)
        out.append(b.predict(X))
        assert b.num_trees() == 2
    plain = P.train(params, P.Dataset(X, label=y, device="cpu"), 2)
    assert np.array_equal(out[1], plain.predict(X))
    np.testing.assert_allclose(out[1], out[0], rtol=RTOL, atol=ATOL)


def test_fair_default_metric_is_the_references():
    """The reference's default metric for fair is "fair", which it does not
    have: a valid set or cv raises its ValueError in both packages."""
    X, y = _regression(800)
    params = dict(objective="fair", num_leaves=7, verbose=-1)
    for lib, kw in ((R, {}), (P, {"device": "cpu"})):
        ds = lib.Dataset(X, label=y, **kw)
        assert lib.train(params, ds, 2).num_trees() == 2
        with pytest.raises(ValueError, match="Unknown metric: fair"):
            lib.train(params, ds, 2,
                      valid_sets=[lib.Dataset(X, label=y, **kw)])
        with pytest.raises(ValueError, match="Unknown metric: fair"):
            lib.cv(params, lib.Dataset(X, label=y, **kw), 2, nfold=2)


def test_poisson_model_files_interchange(tmp_path):
    X, y = _regression(4500, seed=4)
    params = dict(objective="poisson", num_leaves=31, learning_rate=0.2,
                  poisson_max_delta_step=0.3, verbose=-1)
    br = R.train(params, R.Dataset(X, label=y), 5)
    bp = P.train(params, P.Dataset(X, label=y, device="cpu"), 5)
    for ext in ("txt", "npz"):
        rp, pp = str(tmp_path / f"r.{ext}"), str(tmp_path / f"p.{ext}")
        br.save_model(rp)
        bp.save_model(pp)
        into_port = P.Booster(model_file=rp, device="cpu")
        into_ref = R.Booster(model_file=pp)
        np.testing.assert_allclose(into_port.predict(X), br.predict(X),
                                   rtol=1e-6)
        np.testing.assert_allclose(into_ref.predict(X), bp.predict(X),
                                   rtol=1e-6)
        assert into_port.params.poisson_max_delta_step == 0.3
    assert (bp.predict(X) > 0).all()
    np.testing.assert_allclose(np.log(bp.predict(X)),
                               bp.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-6)


def test_parameters_flow_through_the_entry_points(tmp_path):
    """LGBMRegressor(objective="quantile", alpha=...) and the CLI's
    ``objective=tweedie tweedie_variance_power=...`` reach the objective
    and train what ``train`` does."""
    from lightgbm_tpu_torch.__main__ import main as cli_main
    from lightgbm_tpu_torch.sklearn import LGBMRegressor

    X, y = _regression(1500)
    est = LGBMRegressor(objective="quantile", alpha=0.9, n_estimators=3,
                        num_leaves=7, device="cpu").fit(X, y)
    assert est.booster_.obj.renew_alpha == pytest.approx(0.9)
    direct = P.train(dict(objective="quantile", alpha=0.9, num_leaves=7,
                          learning_rate=0.1, verbosity=0),
                     P.Dataset(X, label=y, device="cpu"), 3)
    np.testing.assert_allclose(est.predict(X), direct.predict(X), rtol=1e-6)
    cover = np.mean(y <= est.predict(X))
    assert cover > 0.5
    csv = tmp_path / "train.csv"
    np.savetxt(csv, np.column_stack([y, X]), delimiter=",")
    model = tmp_path / "m.txt"
    rc = cli_main(["task=train", f"data={csv}", "objective=tweedie",
                   "tweedie_variance_power=1.3", "num_trees=3",
                   "num_leaves=7", "device=cpu", f"output_model={model}"])
    assert rc in (0, None)
    b = P.Booster(model_file=str(model), device="cpu")
    assert b.obj.name == "tweedie" and b.obj.rho == pytest.approx(1.3)
    assert (b.predict(X) > 0).all()
