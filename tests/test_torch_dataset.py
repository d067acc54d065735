"""Port parity: ``lightgbm_tpu_torch.dataset`` edge binning against
``lightgbm_tpu.dataset``.

Bin codes route every prediction, so they must be byte-identical: the same
numpy-seeded rows (NaN, categorical and EFB-bundled columns included) go
through both packages' ``BinMapper.fit``/``transform`` and must give equal
bounds and equal uint8 codes, and a mapper serialized by either package
must load and bin identically in the other.
"""

import numpy as np
import pytest

from lightgbm_tpu import dataset as jd
from lightgbm_tpu_torch import dataset as td


def _mixed(seed, n=1500):
    rng = np.random.default_rng(seed)
    X = np.column_stack([
        rng.normal(size=n),                              # quantile bins
        rng.integers(0, 5, n).astype(float),             # few distinct
        np.where(rng.random(n) < 0.1, np.nan, rng.exponential(size=n)),
        rng.integers(0, 40, n).astype(float),            # categorical
        np.where(rng.random(n) < 0.05, np.nan,
                 rng.integers(0, 7, n).astype(float)),   # categorical + NaN
        np.full(n, np.nan),                              # all missing
    ])
    return X, [3, 4]


def _sparse(seed, n=1200, groups=4, width=5):
    """One-hot blocks: mutually exclusive sparse columns EFB bundles."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(groups):
        hot = rng.integers(0, width, n)
        cols.append((hot[:, None] == np.arange(width)[None, :]) * 1.0)
    dense = rng.normal(size=(n, 2))
    return np.column_stack(cols + [dense])


def _same_mapper(a, b):
    assert a.num_features == b.num_features
    for ua, ub in zip(a.upper_bounds, b.upper_bounds):
        np.testing.assert_array_equal(ua, ub)
    np.testing.assert_array_equal(a.nan_bin, b.nan_bin)
    np.testing.assert_array_equal(a.n_bins, b.n_bins)
    np.testing.assert_array_equal(a.is_categorical, b.is_categorical)
    assert a.max_num_bins == b.max_num_bins


@pytest.mark.parametrize("max_bin,min_data", [(255, 3), (16, 1), (63, 20)])
def test_binmapper_fit_transform_byte_identical(max_bin, min_data):
    X, cat = _mixed(seed=max_bin)
    j = jd.BinMapper.fit(X, max_bin=max_bin, min_data_in_bin=min_data,
                         categorical=cat)
    t = td.BinMapper.fit(X, max_bin=max_bin, min_data_in_bin=min_data,
                         categorical=cat)
    _same_mapper(j, t)
    rng = np.random.default_rng(1)
    Xq = np.concatenate([X[:300], rng.normal(size=(50, X.shape[1])) * 50,
                         np.full((3, X.shape[1]), np.nan)])
    cj, ct = j.transform(Xq), t.transform(Xq)
    assert ct.dtype == np.uint8 and cj.dtype == np.uint8
    np.testing.assert_array_equal(cj, ct)


def test_binmapper_subsampled_fit_identical():
    # more rows than sample_cnt: both draw the same seeded row sample
    X = np.random.default_rng(5).normal(size=(3000, 3))
    j = jd.BinMapper.fit(X, max_bin=32, sample_cnt=1000, seed=7)
    t = td.BinMapper.fit(X, max_bin=32, sample_cnt=1000, seed=7)
    _same_mapper(j, t)
    np.testing.assert_array_equal(j.transform(X), t.transform(X))


def test_nan_routes_to_zero_bin_when_unseen_at_fit():
    X = np.random.default_rng(2).normal(size=(400, 2))
    j = jd.BinMapper.fit(X, max_bin=32)
    t = td.BinMapper.fit(X, max_bin=32)
    probe = np.array([[np.nan, 0.0], [0.0, np.nan]])
    np.testing.assert_array_equal(j.transform(probe), t.transform(probe))
    assert t.transform(probe)[0, 0] == t.transform(probe)[1, 0]


def test_efb_bundled_codes_identical():
    X = _sparse(seed=3)
    j = jd.BinMapper.fit(X, max_bin=255)
    t = td.BinMapper.fit(X, max_bin=255)
    rj, rt = j._transform_unbundled(X), t._transform_unbundled(X)
    np.testing.assert_array_equal(rj, rt)
    j.bundler = jd.FeatureBundler.fit(rj, j.n_bins, max_conflict_rate=0.0,
                                      exclude=j.is_categorical)
    t.bundler = td.FeatureBundler.fit(rt, t.n_bins, max_conflict_rate=0.0,
                                      exclude=t.is_categorical)
    assert t.bundler is not None
    assert t.bundler.groups == j.bundler.groups
    np.testing.assert_array_equal(t.bundler.default_bins,
                                  j.bundler.default_bins)
    assert t.bundler.num_columns == j.bundler.num_columns < X.shape[1]
    assert t.max_num_bins == j.max_num_bins
    np.testing.assert_array_equal(j.transform(X), t.transform(X))


def test_mapper_dict_round_trips_across_packages():
    X = _sparse(seed=9)
    X[::13, -1] = np.nan
    j = jd.BinMapper.fit(X, max_bin=64, categorical=[0])
    j.bundler = jd.FeatureBundler.fit(j._transform_unbundled(X), j.n_bins,
                                      exclude=j.is_categorical)
    t_from_j = td.BinMapper.from_dict(j.to_dict())
    assert t_from_j.to_dict() == j.to_dict()
    j_from_t = jd.BinMapper.from_dict(t_from_j.to_dict())
    for a, b in [(j, t_from_j), (j, j_from_t)]:
        np.testing.assert_array_equal(a.transform(X), b.transform(X))


def test_quantile_helpers_identical():
    rng = np.random.default_rng(4)
    vals = np.round(rng.normal(size=5000), 2)
    distinct, counts = np.unique(vals, return_counts=True)
    qs = np.linspace(0, 1, 33)[1:-1]
    np.testing.assert_array_equal(
        jd._weighted_quantile(distinct, counts, qs),
        td._weighted_quantile(distinct, counts, qs))
    for budget, md in [(32, 3), (500, 1), (8, 50)]:
        np.testing.assert_array_equal(
            jd.numeric_bin_bounds(budget, md, vals=vals),
            td.numeric_bin_bounds(budget, md, vals=vals))
        np.testing.assert_array_equal(
            jd.numeric_bin_bounds(budget, md, distinct=distinct,
                                  counts=counts),
            td.numeric_bin_bounds(budget, md, distinct=distinct,
                                  counts=counts))
    for data in ([[1, 2], [3, 4]], np.arange(5.0), [[1, None]]):
        np.testing.assert_array_equal(jd._to_2d_float_array(data),
                                      td._to_2d_float_array(data))
    with pytest.raises(ValueError):
        td._to_2d_float_array(np.zeros((2, 2, 2)))


# -- binary dataset files (save_binary / Dataset(path)) ---------------------
def _binary_set(kind, seed=11):
    """(X, Dataset kwargs) of a binary-file case: dense with weights and
    ``init_score``, EFB-bundled sparse columns, or query groups."""
    rng = np.random.default_rng(seed)
    if kind == "efb":
        X = _sparse(seed)
    else:
        X = rng.normal(size=(1200, 4))
    n = len(X)
    kw = {"label": X[:, -1] + 0.1 * rng.normal(size=n)}
    if kind == "dense":
        kw.update(weight=rng.uniform(0.5, 2.0, n),
                  init_score=rng.normal(size=n))
    elif kind == "groups":
        kw["group"] = [100] * 12
    return X, kw


def _same_binary(a, b):
    """Two constructed Datasets (either package) hold the same file
    contents: codes, mapper, names, fields."""
    n = a.num_data_
    assert b.num_data_ == n and a.num_feature() == b.num_feature()
    np.testing.assert_array_equal(np.asarray(a.X_binned)[:n],
                                  np.asarray(b.X_binned)[:n])
    _same_mapper(a.bin_mapper, b.bin_mapper)
    assert (a.bin_mapper.bundler is None) == (b.bin_mapper.bundler is None)
    if a.bin_mapper.bundler is not None:
        assert a.bin_mapper.bundler.groups == b.bin_mapper.bundler.groups
    assert list(a.feature_names) == list(b.feature_names)
    for f in ("label", "weight", "group", "init_score"):
        va, vb = a.get_field(f), b.get_field(f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_allclose(np.asarray(vb, np.float64),
                                       np.asarray(va, np.float64),
                                       rtol=1e-7, err_msg=f)


@pytest.mark.parametrize("kind", ["dense", "efb", "groups"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_binary_interchanges_both_ways(tmp_path, kind, writer):
    """A ``.bin`` name gets the ``.npz`` suffix on save and is found again
    on load; the file one package writes loads in the other (and in its
    own) with equal codes, mapper, EFB map and fields."""
    import lightgbm_tpu as R
    import lightgbm_tpu_torch as P

    X, kw = _binary_set(kind)
    src = (P.Dataset(X, device="cpu", **kw) if writer == "port"
           else R.Dataset(X, **kw))
    src.construct()
    path = str(tmp_path / "train.bin")
    src.save_binary(path)
    assert not (tmp_path / "train.bin").exists()
    assert (tmp_path / "train.bin.npz").exists()
    port = P.Dataset(path, device="cpu")
    port.construct()
    ref = R.Dataset(path)
    ref.construct()
    _same_binary(src, port)
    _same_binary(src, ref)
    if kind == "efb":
        assert port.bin_mapper.bundler is not None
        assert port.num_feature_ < port.num_feature()
    if kind == "groups":
        assert port.group_id is not None


def test_binary_dataset_trains_as_the_original(tmp_path):
    """Training on the reloaded file grows the original's trees bit for
    bit; a label given to the constructor replaces the stored one; the
    loaded Dataset takes the device it is given."""
    import lightgbm_tpu_torch as P
    from lightgbm_tpu_torch.models.tree import tree_to_arrays

    X, kw = _binary_set("dense")
    ds = P.Dataset(X, device="cpu", **kw)
    path = str(tmp_path / "t")
    ds.save_binary(path)
    back = P.Dataset(path + ".npz", device="cpu")
    params = {"objective": "regression", "num_leaves": 7, "verbosity": -1}
    a, b = P.train(params, ds, 3), P.train(params, back, 3)
    for ta, tb in zip(a.trees, b.trees):
        fa, fb = tree_to_arrays(ta), tree_to_arrays(tb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k
    relabeled = P.Dataset(path, label=np.zeros(len(X)), device="cpu")
    relabeled.construct()
    assert not relabeled.get_label().any()
    assert back.device.type == "cpu"
