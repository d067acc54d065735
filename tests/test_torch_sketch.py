"""Port parity: the streaming quantile sketch (``data/sketch.py``) and
``Dataset.from_blocks``'s construction, on the CPU, against the reference's
``lightgbm_tpu/data/sketch.py`` and ``Dataset.from_blocks``.

The contract is bit equality, not a tolerance: checkpoints and model files
carry the binning schema's digest, so the port's
``StreamingBinMapperBuilder`` must give the reference's bounds bit for bit
in every regime — the exact buffer below capacity (also equal to the
in-memory ``BinMapper.fit``), the distinct tally of a bounded vocabulary
past capacity, and the Greenwald-Khanna summary of continuous columns past
capacity — and ``schema_digest`` must be equal.  ``from_blocks`` bins the
blocks to the in-memory codes, and its validation errors are the
reference's.
"""

import copy

import numpy as np
import pytest

import lightgbm_tpu as R
from lightgbm_tpu.data import sketch as RS
import lightgbm_tpu_torch as P
from lightgbm_tpu_torch.data import sketch as PS
from lightgbm_tpu_torch.dataset import BinMapper


def _mapper_equal(a, b) -> bool:
    return (np.array_equal(a.n_bins, b.n_bins)
            and np.array_equal(a.nan_bin, b.nan_bin)
            and len(a.upper_bounds) == len(b.upper_bounds)
            and all(np.array_equal(ua, ub)
                    for ua, ub in zip(a.upper_bounds, b.upper_bounds)))


def _mixed_matrix(n, seed=0):
    """Continuous, low-cardinality, constant and NaN-bearing columns."""
    rng = np.random.default_rng(seed)
    cont = rng.normal(0, 1, n)
    lowcard = rng.integers(0, 7, n).astype(np.float64)
    const = np.full(n, 3.25)
    withnan = rng.normal(2, 5, n)
    withnan[rng.random(n) < 0.1] = np.nan
    heavy = rng.lognormal(0, 1.5, n)
    return np.column_stack([cont, lowcard, const, withnan, heavy])


def _fit_both(X, block, **kw):
    fin = {k: kw.pop(k) for k in ("max_bin", "min_data_in_bin") if k in kw}
    ours = PS.StreamingBinMapperBuilder(X.shape[1], **kw)
    ref = RS.StreamingBinMapperBuilder(X.shape[1], **kw)
    for lo in range(0, len(X), block):
        ours.update(X[lo:lo + block])
        ref.update(X[lo:lo + block])
    return ours.finalize(**fin), ref.finalize(**fin), ours, ref


@pytest.mark.parametrize("max_bin", [15, 63, 255])
def test_exact_regime_equals_reference_and_in_memory(max_bin):
    X = _mixed_matrix(3000, seed=1)
    a, b, ours, _ = _fit_both(X, 700, max_bin=max_bin)
    assert all(sk.mode == "exact" for sk in ours._sketches)
    assert _mapper_equal(a, b)
    assert _mapper_equal(a, BinMapper.fit(X, max_bin=max_bin,
                                          min_data_in_bin=3))
    assert PS.schema_digest(a) == RS.schema_digest(b)


@pytest.mark.parametrize("eps", [1e-3, 1e-2])
def test_past_capacity_equals_reference(eps):
    """Past capacity: the low-cardinality and constant columns tally
    distinct values, the continuous ones degrade to the GK summary; the
    bounds and digest are the reference's bit for bit."""
    X = _mixed_matrix(40_000, seed=2)
    a, b, ours, ref = _fit_both(X, 4096, capacity=5000, eps=eps,
                                max_distinct=64, max_bin=63)
    modes = [sk.mode for sk in ours._sketches]
    assert modes == [sk.mode for sk in ref._sketches]
    assert modes == ["gk", "distinct", "distinct", "gk", "gk"]
    assert _mapper_equal(a, b)
    assert PS.schema_digest(a) == RS.schema_digest(b)
    for sa, sb in zip(ours._sketches, ref._sketches):
        if sa.mode == "gk":
            for f in ("v", "g", "d"):
                assert np.array_equal(getattr(sa.gk, f), getattr(sb.gk, f))


def test_gk_summary_insert_merge_query_equal_reference():
    rng = np.random.default_rng(6)
    qs = np.linspace(0.0, 1.0, 51)[1:-1]
    pair = [(PS.GKSummary(1e-2), RS.GKSummary(1e-2)) for _ in range(2)]
    for (ours, ref), loc in zip(pair, (0.0, 2.0)):
        vals = rng.normal(loc, 1, 20_000)
        for lo in range(0, len(vals), 4096):
            dv, dc = np.unique(vals[lo:lo + 4096], return_counts=True)
            ours.insert_distinct(dv, dc.astype(np.int64))
            ref.insert_distinct(dv, dc.astype(np.int64))
    pair[0][0].merge(pair[1][0])
    pair[0][1].merge(pair[1][1])
    ours, ref = pair[0]
    assert ours.n == ref.n == 40_000
    assert np.array_equal(ours.query(qs), ref.query(qs))
    for f in ("v", "g", "d"):
        assert np.array_equal(getattr(ours, f), getattr(ref, f))


def test_builder_validation_as_reference():
    for mod in (PS, RS):
        with pytest.raises(ValueError, match="num_features"):
            mod.StreamingBinMapperBuilder(0)
        with pytest.raises(ValueError, match="eps"):
            mod.StreamingBinMapperBuilder(3, eps=0.9)
        b = mod.StreamingBinMapperBuilder(3)
        with pytest.raises(ValueError, match="ragged"):
            b.update(np.zeros((10, 4)))
        with pytest.raises(ValueError, match="2-D"):
            b.update(np.zeros((2, 3, 4)))
        with pytest.raises(ValueError, match="no rows"):
            mod.StreamingBinMapperBuilder(3).finalize()


def _blocks(n=1024, f=5, nb=4, seed=0, with_y=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(0, 1, (n, f)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    step = n // nb
    return [(X[lo:lo + step], y[lo:lo + step]) if with_y
            else X[lo:lo + step] for lo in range(0, n, step)]


def test_from_blocks_validation():
    params = {"stream_block_rows": 256}
    blocks = _blocks(with_y=False)
    blocks[2] = blocks[2][:, :3]
    with pytest.raises(ValueError, match="feature"):
        P.Dataset.from_blocks(blocks, params=params, device="cpu")
    blocks = _blocks(with_y=False)
    blocks[1] = blocks[1].astype(np.float64)
    with pytest.raises(ValueError, match="dtype"):
        P.Dataset.from_blocks(blocks, params=params, device="cpu")
    b = _blocks()
    with pytest.raises(ValueError, match=r"\(X, y\)"):
        P.Dataset.from_blocks(b[:1] + [(b[1][0], b[1][1], None, None)],
                              params=params, device="cpu")
    with pytest.raises(ValueError, match="label"):
        P.Dataset.from_blocks(_blocks(), label=np.zeros(1024, np.float32),
                              params=params, device="cpu")
    with pytest.raises(ValueError, match="inconsistent"):
        P.Dataset.from_blocks([b[0], b[1][0]], params=params, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        P.Dataset.from_blocks([], params=params, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        P.Dataset.from_blocks(_blocks(), params={"stream_block_rows": 100},
                              device="cpu")


def test_from_blocks_codes_and_digest_equal_reference():
    """Below capacity the sketch is the in-memory fit (the codes equal the
    in-memory Dataset's); past it, the reference's from_blocks digest."""
    rng = np.random.default_rng(11)
    X = rng.normal(0, 1, (1500, 6)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    params = {"max_bin": 63, "stream_block_rows": 512}
    blocks = [(X[lo:lo + 512], y[lo:lo + 512]) for lo in range(0, 1500, 512)]
    mem = P.Dataset(X, label=y, params=dict(params), device="cpu")
    mem.construct()
    ds = P.Dataset.from_blocks(blocks, params=dict(params), device="cpu")
    assert ds.is_streamed and ds.X_binned is None
    codes = ds.block_store.gather_rows(np.arange(1500))
    assert np.array_equal(codes, mem.X_binned[:1500].numpy())
    assert np.array_equal(ds.get_label(), y)
    assert ds.y.shape[0] == ds.block_store.padded_rows == 1536
    big = dict(params, stream_sketch_capacity=600, stream_sketch_eps=5e-3)
    ours = P.Dataset.from_blocks(blocks, params=dict(big), device="cpu")
    ref = R.Dataset.from_blocks(blocks, params=dict(big))
    assert PS.schema_digest(ours.bin_mapper) == \
        RS.schema_digest(ref.bin_mapper)
    assert np.array_equal(ours.block_store.gather_rows(np.arange(1500)),
                          ref.block_store.gather_rows(np.arange(1500)))
    # reference= pins the schema: no sketch pass, the mapper reused
    pinned = P.Dataset.from_blocks(blocks, params=dict(params),
                                   reference=ours)
    assert pinned.bin_mapper is ours.bin_mapper
    assert pinned.device == ours.device
    # a bundled (EFB) schema cannot be streamed
    bundled = copy.copy(mem.bin_mapper)
    bundled.bundler = object()
    with pytest.raises(ValueError, match="EFB"):
        P.Dataset.from_blocks(blocks, reference=bundled, device="cpu")
