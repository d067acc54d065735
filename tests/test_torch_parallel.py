"""Port parity: the mesh, its collectives, the histogram merges and the
split exchange against the reference's ``shard_map`` versions on the
8-device virtual CPU mesh.

The same numpy inputs, one ``[D, ...]`` stack with shard ``d``'s tensor at
index ``d``, go through the reference's collectives / ``histogram_merge`` /
``wire_transfer`` / ``reduce_best_split`` / ``_make_dist_scorer`` under
``shard_map`` and the port's list versions (``parallel.mesh``,
``ops.histogram``, ``ops.quantize``, ``parallel.feature_parallel``,
``models.tree.make_dist_scorer``):

* on exact inputs (dyadic values, every partial sum exact) every merge
  at f32 and bf16 wire is bit-equal, and one hop of every wire format;
* on general data the ring modes (a fixed hop order in both packages) are
  bit-equal at f32 and bf16 wire too; ``psum``/``reduce_scatter`` agree to
  f32 rounding (``1e-6 * sum |x|``, the reference's all-reduce order is
  XLA's); int8 wire rings stay within the reference's stated 3% of the
  largest cell, of the reference's and of the exact merge (XLA fuses the
  dequantize-and-add, so a hop can round an ulp apart and the next
  quantizer take the other step);
* the exchange picks the reference's winner (feature, bin, statistics)
  exactly, ties to the lowest shard; the voting ballot picks the
  reference's candidates (stable vote order) and winner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh as JMesh, PartitionSpec as PS

from lightgbm_tpu.ops import histogram as jh
from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.parallel import feature_parallel as jfp
from lightgbm_tpu.utils.compat import shard_map
from lightgbm_tpu_torch.models.tree import make_dist_scorer
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops import split as ts
from lightgbm_tpu_torch.parallel import feature_parallel as tfp
from lightgbm_tpu_torch.parallel import mesh as tm

D = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the mesh growers run thousands of small ops,
    which several test workers' thread pools, each as wide as the machine,
    would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= D, "conftest must provide 8 CPU devices"
    return JMesh(np.array(jax.devices()[:D]), ("data",))


def _ref(jmesh, fn, *stacks):
    """``fn`` on each shard's slice of the ``[D, ...]`` stacks under
    ``shard_map``; returns the ``[D, ...]`` stack of its outputs."""
    def body(*xs):
        out = fn(*[x[0] for x in xs])
        return jax.tree.map(lambda o: o[None], out)

    f = shard_map(body, mesh=jmesh, in_specs=(PS("data"),) * len(stacks),
                  out_specs=PS("data"), check_vma=False)
    out = jax.jit(f)(*[jnp.asarray(s) for s in stacks])
    return jax.tree.map(np.asarray, out)


def _port(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _stack(ts_):
    return np.stack([t.numpy() for t in ts_])


def _exact(rng, shape):
    return (rng.integers(-16, 17, shape) / 4.0).astype(np.float32)


def _general(rng, shape):
    counts = rng.poisson(16, shape[:-1] + (1,)).astype(np.float32)
    return (counts * rng.normal(0, 1, shape)).astype(np.float32)


# ------------------------------------------------------------ collectives

@pytest.mark.parametrize("name", ["psum", "psum_scatter", "ppermute",
                                  "ppermute_partial", "all_gather",
                                  "axis_index"])
def test_collective_matches_shard_map(jmesh, name):
    rng = np.random.default_rng(1)
    x = _exact(rng, (D, 16, 4))
    xs = _port(x)
    ring = [(i, (i + 1) % D) for i in range(D)]
    if name == "psum":
        want = _ref(jmesh, lambda a: lax.psum(a, "data"), x)
        got = _stack(tm.psum(xs))
    elif name == "psum_scatter":
        want = _ref(jmesh, lambda a: lax.psum_scatter(
            a, "data", scatter_dimension=0, tiled=True), x)
        got = _stack(tm.psum_scatter(xs, 0))
    elif name == "ppermute":
        want = _ref(jmesh, lambda a: lax.ppermute(a, "data", ring), x)
        got = _stack(tm.ppermute(xs, ring))
    elif name == "ppermute_partial":
        perm = [(0, 3), (5, 1), (2, 2)]
        want = _ref(jmesh, lambda a: lax.ppermute(a, "data", perm), x)
        got = _stack(tm.ppermute(xs, perm))
    elif name == "all_gather":
        want = _ref(jmesh, lambda a: lax.all_gather(a, "data"), x)
        got = _stack(tm.all_gather(xs))
    else:
        want = _ref(jmesh, lambda a: lax.axis_index("data") + 0 * a[0, 0]
                    .astype(jnp.int32), x)
        got = np.array([tm.axis_index(d) for d in range(D)])
    np.testing.assert_array_equal(got, want)


def test_psum_general_data_within_rounding(jmesh):
    rng = np.random.default_rng(2)
    x = _general(rng, (D, 13, 8, 3))
    want = _ref(jmesh, lambda a: lax.psum(a, "data"), x)
    got = _stack(tm.psum(_port(x)))
    scale = np.abs(x).sum(axis=0)
    assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)


def test_mesh_shapes_and_row_sharding():
    tm.set_virtual_devices(8)
    try:
        m = tm.make_mesh(8, base=torch.device("cpu"))
        assert m.shape == (8,) and m.lead.type == "cpu"
        m2 = tm.make_mesh_2d(4, 2, base=torch.device("cpu"))
        assert m2.axis_size("data") == 4 and m2.axis_size("feature") == 2
        x = torch.arange(64.0).reshape(16, 4)
        parts = tm.shard_rows(m.devices, x)
        assert [p.shape[0] for p in parts] == [2] * 8
        assert parts[3].data_ptr() == x[6:8].data_ptr()     # a view
        assert torch.equal(tm.gather_rows(parts, m.lead), x)
        with pytest.raises(ValueError, match="need 9 devices"):
            tm.make_mesh(9, base=torch.device("cpu"))
        with pytest.raises(ValueError, match="divide"):
            tm.row_bounds(10, 4)
    finally:
        tm.set_virtual_devices(0)
    assert tm.visible_devices(torch.device("cpu")) == [torch.device("cpu")]


# ------------------------------------------------------------ wire format

@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("data", ["exact", "general"])
def test_wire_transfer_matches_reference(jmesh, wire, data):
    rng = np.random.default_rng(3)
    x = (_exact if data == "exact" else _general)(rng, (D, 2, 5, 8, 3))
    ring = [(i, (i + 1) % D) for i in range(D)]
    want = _ref(jmesh, lambda a: jq.wire_transfer(a, "data", ring, wire,
                                                  f_axis=1), x)
    got = _stack(tq.wire_transfer(_port(x), ring, wire, f_axis=1))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="wire dtype"):
        tq.wire_transfer(_port(x), ring, "fp8")


# ------------------------------------------------------ histogram merges

MERGES = [("psum", "f32"), ("reduce_scatter", "f32"),
          ("reduce_scatter_ring", "f32"), ("reduce_scatter_ring", "bf16"),
          ("reduce_scatter_ring", "int8"),
          ("reduce_scatter_pipelined", "f32"),
          ("reduce_scatter_pipelined", "bf16"),
          ("reduce_scatter_pipelined", "int8")]


@pytest.mark.parametrize("mode,wire", MERGES)
def test_histogram_merge_matches_reference(jmesh, mode, wire):
    """F = 13 over 8 shards: a ragged tail and two all-padding shards (the
    pipelined mode pads to 8 * 2 = 16 columns as well)."""
    s, f, b = 2, 13, 8
    for data, seed in (("exact", 4), ("general", 5)):
        rng = np.random.default_rng(seed)
        x = (_exact if data == "exact" else _general)(rng, (D, s, f, b, 3))
        want = _ref(jmesh, lambda a: jh.histogram_merge(
            a, "data", mode=mode, n_shards=D, wire_dtype=wire, n_chunks=2),
            x)
        got = _stack(th.histogram_merge(_port(x), mode, D, wire, 2))
        assert got.shape == want.shape
        if wire == "int8":
            # the reference's stated ring-hop tolerance: a hop's rounding
            # differs by an ulp where XLA fuses the dequantize-and-add, and
            # the next hop's quantizer may then take the other step
            exact = _stack(th.histogram_merge(_port(x), mode, D, "f32", 2))
            for ref in (want, exact):
                rel = np.abs(got - ref).max() / np.abs(exact).max()
                assert rel < 0.03, (data, rel)
        elif data == "exact" or mode not in ("psum", "reduce_scatter"):
            np.testing.assert_array_equal(got, want, err_msg=data)
        else:
            scale = np.abs(x).sum(axis=0).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


def test_histogram_merge_guards_and_slices():
    xs = _port(_general(np.random.default_rng(6), (D, 2, 13, 8, 3)))
    with pytest.raises(ValueError, match="ring merge mode"):
        th.histogram_merge(xs, "psum", D, "int8")
    with pytest.raises(ValueError, match="ring merge mode"):
        th.histogram_merge(xs, "reduce_scatter", D, "bf16")
    with pytest.raises(ValueError, match="wire dtype"):
        th.histogram_merge(xs, "reduce_scatter_ring", D, "fp8")
    with pytest.raises(ValueError, match="merge mode"):
        th.histogram_merge(xs, "allgatherify", D)
    full = torch.stack(xs).sum(0)
    for mode in ("reduce_scatter", "reduce_scatter_ring",
                 "reduce_scatter_pipelined"):
        cat = torch.cat(th.histogram_merge(xs, mode, D, n_chunks=2), dim=1)
        torch.testing.assert_close(cat[:, :13], full, rtol=1e-5, atol=1e-5)
        assert not cat[:, 13:].any()
    assert torch.equal(th.histogram_psum(xs)[0], th.histogram_merge(xs)[0])


@pytest.mark.parametrize("f,d,mode,chunks", [
    (13, 8, "reduce_scatter", 1), (13, 8, "reduce_scatter_pipelined", 4),
    (28, 4, "reduce_scatter_pipelined", 4), (28, 4, "reduce_scatter", 4),
    (5, 8, "reduce_scatter_ring", 1), (136, 8, "reduce_scatter_pipelined", 3),
    (64, 2, "psum", 1)])
def test_merge_slice_width_and_pad(f, d, mode, chunks):
    assert th.merge_slice_width(f, d, mode, chunks) == \
        jh.merge_slice_width(f, d, mode, chunks)
    h = np.random.default_rng(f).normal(size=(2, f, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        th.pad_feature_axis(torch.from_numpy(h), d, 1).numpy(),
        np.asarray(jh.pad_feature_axis(jnp.asarray(h), d, 1)))


# -------------------------------------------------------- split exchange

def _ctx(l2=1.0):
    base = dict(lambda_l1=0.0, lambda_l2=l2, min_data_in_leaf=20.0,
                min_sum_hessian=1e-3, min_gain_to_split=0.0,
                max_delta_step=0.0, path_smooth=0.0)
    jctx = js.SplitContext(**{k: jnp.float32(v) for k, v in base.items()})
    return jctx, ts.SplitContext(**base)


def _hists(rng, shards, s, f, b, rows=600):
    """``[shards, s, f, b, 3]`` histograms of real rows per shard."""
    out = np.zeros((shards, s, f, b, 3), np.float32)
    for d in range(shards):
        for e in range(s):
            codes = rng.integers(0, b, (rows, f))
            g = rng.normal(0.3 * (e + 1), 1.0, rows)
            h = rng.uniform(0.05, 0.25, rows)
            for j in range(f):
                for k, v in enumerate((g, h, np.ones(rows))):
                    out[d, e, j, :, k] = np.bincount(codes[:, j], weights=v,
                                                     minlength=b)
    return out


FIELDS = ("feature", "bin", "left_g", "left_h", "left_c", "right_g",
          "right_h", "right_c", "left_out", "right_out")


def _assert_best(got, want, rtol=1e-6):
    for name in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)).astype(np.float64),
            np.asarray(getattr(want, name)).astype(np.float64), err_msg=name)
    np.testing.assert_allclose(np.asarray(got.gain), np.asarray(want.gain),
                               rtol=rtol)


@pytest.mark.parametrize("case", ["distinct", "ties", "no_split"])
def test_reduce_best_split_matches_reference(jmesh, case):
    """Each shard scans its own 4-column slice; the exchange's winner is
    the reference's (ties: every shard holds the same histogram, so the
    lowest shard, i.e. the lowest global feature, wins)."""
    rng = np.random.default_rng(7)
    f_loc, b = 4, 16
    h = _hists(rng, D, 1, f_loc, b)[:, 0]                    # [D, f, b, 3]
    if case == "ties":
        h[:] = h[3]
    mask = np.ones((D, f_loc), np.float32)
    if case == "no_split":
        mask[:] = 0.0
    jctx, tctx = _ctx()

    def ref(hd, md):
        bs = js.find_best_split(hd, jctx, md, jnp.bool_(True))
        return jfp.reduce_best_split(bs, "data", f_loc)

    want = _ref(jmesh, ref, h, mask)
    want0 = js.BestSplit(*[None if v is None else v[0] for v in want])
    bss = [ts.find_best_split(torch.from_numpy(h[d]), tctx,
                              torch.from_numpy(mask[d]),
                              torch.tensor(True)) for d in range(D)]
    got = tfp.reduce_best_split(bss, f_loc)
    _assert_best(got, want0)
    for d in range(1, D):                         # replicated on every shard
        assert np.asarray(want.feature[d]) == np.asarray(want.feature[0])


def test_broadcast_feature_column():
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 255, (64, 13)).astype(np.uint8)
    padded = tfp.pad_features(codes, 4)
    assert padded.shape == (64, 16) and not padded[:, 13:].any()
    np.testing.assert_array_equal(padded, jfp.pad_features(codes, 4))
    blocks = [torch.from_numpy(padded[:, 4 * j:4 * j + 4].copy())
              for j in range(4)]
    feat = torch.tensor([0, 12, 5, 7])
    got = tfp.broadcast_feature_column(blocks, feat, 4)
    np.testing.assert_array_equal(got.numpy(), codes[:, [0, 12, 5, 7]])


@pytest.mark.parametrize("mode,f,chunks", [
    ("reduce_scatter", 13, 1), ("reduce_scatter_ring", 13, 1),
    ("reduce_scatter_pipelined", 13, 2), ("reduce_scatter", 5, 1),
    ("voting", 13, 2), ("voting", 13, 3), ("voting", 24, 3),
    ("voting", 6, 0)])
def test_dist_scorer_matches_reference(jmesh, mode, f, chunks):
    """The mesh scorer on a batch of two nodes against the reference's
    ``_make_dist_scorer`` under shard_map: the slices of the merged
    histograms (reduce-scatter modes; F = 5 leaves three all-padding
    shards) or the local partials (voting: ``top_k = chunks``, an
    approximate ballot at 2k < F, the exact union at 2k >= F and the
    default k = 20 >= F)."""
    from lightgbm_tpu.models.tree import _make_dist_scorer

    rng = np.random.default_rng(9 + f)
    s, b = 2, 16
    local = _hists(rng, D, s, f, b)                        # [D, S, F, B, 3]
    masks = np.ones((s, f), np.float32)
    masks[1, 2] = 0.0
    po = np.array([0.1, -0.2], np.float32)
    jctx, tctx = _ctx()
    voting_k = chunks if mode == "voting" else 0

    def ref(hd):
        merged = (hd if mode == "voting" else jh.histogram_merge(
            hd, "data", mode=mode, n_shards=D, n_chunks=max(chunks, 1)))
        score = _make_dist_scorer("data", mode, D, f, jctx, None, None,
                                  voting_k, max(chunks, 1))
        return score(merged, jnp.asarray(masks), jnp.ones((s,), bool),
                     jnp.full((s,), -jnp.inf, jnp.float32),
                     jnp.full((s,), jnp.inf, jnp.float32), jnp.asarray(po))

    want = _ref(jmesh, ref, local)
    want0 = js.BestSplit(*[None if v is None else v[0] for v in want])
    xs = _port(local)
    if mode == "voting":
        hist = torch.stack(xs, dim=1)                      # [S, D, F, B, 3]
    else:
        hist = torch.cat(th.histogram_merge(xs, mode, D, "f32",
                                            max(chunks, 1)), dim=1)
    score = make_dist_scorer(mode, D, f, voting_k, max(chunks, 1))
    got = score(hist, tctx, torch.from_numpy(masks),
                torch.ones(s, dtype=torch.bool), torch.from_numpy(po))
    _assert_best(got, want0)
    # the reduce-scatter slices scan to the serial scan's winner
    if mode != "voting":
        full = ts.find_best_split(torch.stack(xs).sum(0), tctx,
                                  torch.from_numpy(masks),
                                  torch.ones(s, dtype=torch.bool),
                                  torch.from_numpy(po))
        assert torch.equal(got.feature, full.feature)
        assert torch.equal(got.bin, full.bin)


@pytest.mark.parametrize("mode,chunks", [("reduce_scatter", 1),
                                         ("reduce_scatter_pipelined", 2)])
def test_dist_scorer_categorical_matches_reference(jmesh, mode, chunks):
    """Categorical columns through the slice scorer (the subset scan's
    flags sliced per piece, ``cat_mask`` carried with the winner): the
    reference's scorer's winner, and the serial scan's on the sum."""
    from lightgbm_tpu.models.tree import _make_dist_scorer

    rng = np.random.default_rng(31)
    s, f, b = 2, 13, 16
    local = _hists(rng, D, s, f, b)
    is_cat = np.zeros(f, bool)
    is_cat[[1, 6, 12]] = True
    # the categorical columns' odd categories pull the gradient up: a
    # subset split (no threshold) separates them
    odd = np.arange(1, b, 2)
    for j in (1, 6, 12):
        local[:, :, j, odd, 0] += (1.5 + 0.1 * j) * local[:, :, j, odd, 2]
    masks = np.ones((s, f), np.float32)
    po = np.array([0.05, -0.1], np.float32)
    jctx, tctx = _ctx()
    jcat = js.CatInfo(jnp.asarray(is_cat), jnp.float32(10.0),
                      jnp.float32(10.0), 32)
    tcat = ts.CatInfo(torch.from_numpy(is_cat), 10.0, 10.0, 32)

    def ref(hd):
        merged = jh.histogram_merge(hd, "data", mode=mode, n_shards=D,
                                    n_chunks=chunks)
        score = _make_dist_scorer("data", mode, D, f, jctx, jcat, None, 0,
                                  chunks)
        return score(merged, jnp.asarray(masks), jnp.ones((s,), bool),
                     jnp.full((s,), -jnp.inf, jnp.float32),
                     jnp.full((s,), jnp.inf, jnp.float32), jnp.asarray(po))

    want = _ref(jmesh, ref, local)
    want0 = js.BestSplit(*[None if v is None else v[0] for v in want])
    xs = _port(local)
    hist = torch.cat(th.histogram_merge(xs, mode, D, "f32", chunks), dim=1)
    score = make_dist_scorer(mode, D, f, 0, chunks)
    got = score(hist, tctx, torch.from_numpy(masks),
                torch.ones(s, dtype=torch.bool), torch.from_numpy(po),
                cat_info=tcat)
    _assert_best(got, want0)
    assert bool(got.cat.any())               # a subset split won somewhere
    np.testing.assert_array_equal(got.cat.numpy(), np.asarray(want0.cat))
    np.testing.assert_array_equal(got.cat_mask.numpy(),
                                  np.asarray(want0.cat_mask))
    full = ts.find_best_split(torch.stack(xs).sum(0), tctx,
                              torch.from_numpy(masks),
                              torch.ones(s, dtype=torch.bool),
                              torch.from_numpy(po), cat_info=tcat)
    assert torch.equal(got.feature, full.feature)
    assert torch.equal(got.cat_mask, full.cat_mask)


def test_voting_ballot_ties_go_to_the_lower_feature():
    """Every shard holds the same histogram with features 0..5 all alike:
    every feature ties in gain and votes, and the stable vote order keeps
    the lowest ids (the winner is feature 0, as the serial scan's)."""
    rng = np.random.default_rng(10)
    one = _hists(rng, 1, 1, 1, 16)[0, 0, 0]                 # [B, 3]
    h = np.broadcast_to(one, (1, D, 6, 16, 3)).copy()
    _, tctx = _ctx()
    score = make_dist_scorer("voting", D, 6, voting_k=1)
    got = score(torch.from_numpy(h), tctx, torch.ones(1, 6),
                torch.ones(1, dtype=torch.bool))
    assert int(got.feature[0]) == 0
