"""Port parity: one strict split iteration (``split_iter_plain``, the plain
version of kernel B3) against the reference's ``split_iter_pallas`` run in
interpret mode on the CPU, as ``tests/test_split_iter_fused.py`` runs it.

The same seeded numpy histograms, node table, mask, pick and scalars go
into both; the new table and the next pick must be equal bit for bit
(compared as int32 words, so signed zeros count): a one-ulp difference in a
gain could swap a near-tied winner.  Cases: every regularizer on and off,
the reference ``vmap``ped over three elements with per-element min_data /
l2 / max_depth, exact ties across features, an inactive element, and a leaf
whose every candidate is invalid (-inf gains: index 0, as ``argmax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.models.tree import _PK as R_PK
from lightgbm_tpu.models.tree import _packed_root_table
from lightgbm_tpu.ops.histogram_pallas import split_iter_pallas
from lightgbm_tpu.ops.split import (SplitContext, constrained_leaf_output,
                                    find_best_split)
from lightgbm_tpu_torch.models.tree import _PK, split_iter, split_iter_plain


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the fused and strict growers run thousands of
    small ops, which several test workers' thread pools, each as wide as
    the machine, would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


F, B, NUM_LEAVES = 7, 32, 15
CAP = 2 * NUM_LEAVES - 1


def _ctx(l1=0.1, l2=1.0, min_data=3.0, min_hess=1e-3, min_gain=0.0, mds=0.5,
         ps=1.5):
    return SplitContext(*(jnp.float32(v) for v in
                          (l1, l2, min_data, min_hess, min_gain, mds, ps)))


def _hists(rng, lead, ties=False):
    h = (rng.standard_normal(tuple(lead) + (F, B, 3)) ** 2).astype(np.float32)
    h[..., 2] = np.round(h[..., 2] * 4)          # integer counts
    if ties:
        h[..., :, :, :] = h[..., :1, :, :]       # every feature = feature 0
    return h


def _root(rng, ctx, fmask, ties=False):
    """A packed table with the root scanned, and the pick it gives."""
    root_hist = jnp.asarray(_hists(rng, (), ties) * 3)
    tot = jnp.sum(root_hist[0], axis=0)
    out = constrained_leaf_output(
        tot[0], tot[1], tot[2], ctx._replace(path_smooth=jnp.float32(0.0)),
        jnp.float32(-jnp.inf), jnp.float32(jnp.inf), jnp.float32(0.0))
    best = find_best_split(root_hist, ctx, jnp.asarray(fmask),
                           jnp.bool_(True), None, parent_out=out)
    tab = _packed_root_table(CAP, out, tot, best, None)
    aux = jnp.stack([jnp.float32(0), best.feature.astype(jnp.float32),
                     best.bin.astype(jnp.float32),
                     jnp.isfinite(best.gain).astype(jnp.float32)]
                    + [jnp.float32(0)] * 4)
    return np.asarray(tab), np.asarray(aux)


def _scal(ctx, max_depth, n_nodes):
    vals = [float(v) for v in ctx] + [float(max_depth), float(n_nodes)]
    return np.asarray(vals + [0.0] * 7, np.float32)


def _one(h, t, m, a, s):
    return split_iter_pallas(h.transpose(0, 1, 3, 2), t, m[None], a[None],
                             s[None], pk=R_PK)


# ``jax.vmap`` of the reference kernel over the leading element axis
# (interpret mode on the CPU), compiled once per shape
_REF = jax.jit(jax.vmap(_one))


def _reference(hist, tab, fmask, aux, scal):
    t2, a2 = _REF(*(jnp.asarray(x) for x in (hist, tab, fmask, aux, scal)))
    return np.asarray(t2), np.asarray(a2)[:, 0]


def _port(hist, tab, fmask, aux, scal):
    t2, a2 = split_iter_plain(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in (hist, tab, fmask, aux, scal)))
    return t2.numpy(), a2.numpy()


def _assert_bits(got, want, gain_rtol=0.0):
    """Bit for bit; with ``gain_rtol`` the candidate gains (and the path
    minimum that copies them) only to that relative tolerance."""
    gcols = [_PK.CAND_GAIN, _PK.PM]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if gain_rtol and g.ndim == 3:
            np.testing.assert_allclose(g[..., gcols], w[..., gcols],
                                       rtol=gain_rtol)
            g, w = g.copy(), w.copy()
            g[..., gcols] = w[..., gcols] = 0.0
        assert np.array_equal(g.view(np.int32), w.view(np.int32)), \
            np.argwhere(g.view(np.int32) != w.view(np.int32))[:5]


def test_table_layout_matches_reference():
    assert _PK.NC == R_PK.NC == 24
    for name in ("SPLIT_FEAT", "LEAF_VALUE", "CAND_GAIN", "CAND_WR", "PM"):
        assert getattr(_PK, name) == getattr(R_PK, name)


REGULARIZERS = {
    "all": {},
    "no_smoothing": {"ps": 0.0},
    "no_delta_cap": {"mds": 0.0},
    "plain_l2": {"l1": 0.0, "ps": 0.0, "mds": 0.0},
    "min_gain": {"min_gain": 0.5, "l1": 0.5},
}


@pytest.mark.parametrize("reg", sorted(REGULARIZERS))
def test_chained_iterations_bit_equal(reg):
    """Five chained iterations of one element: every table and pick equal
    bit for bit, the candidate gains too (with path smoothing on, the gain
    takes the outputs smoothed as XLA contracts them there)."""
    rng = np.random.default_rng(3)
    ctx = _ctx(**REGULARIZERS[reg])
    fmask = np.ones(F, np.float32)
    tab, aux = _root(rng, ctx, fmask)
    n_nodes = 1
    gain_rtol = 0.0
    for it in range(5):
        hist = _hists(rng, (1, 2))
        args = (hist, tab[None], fmask[None], aux[None],
                _scal(ctx, 0, n_nodes)[None])
        want = _reference(*args)
        got = _port(*args)
        _assert_bits(got, want, gain_rtol)
        n_nodes += 2 * int(aux[3] > 0)
        tab, aux = want[0][0], want[1][0]
    assert n_nodes > 1


def test_vmapped_per_element_regularizers():
    """Three elements with their own min_data / l2 / max_depth: the port's
    per-element scan equals the reference's vmapped kernel."""
    rng = np.random.default_rng(5)
    ctxs = [_ctx(min_data=3.0, l2=1.0, ps=0.0),
            _ctx(min_data=40.0, l2=0.0, ps=0.0),
            _ctx(min_data=1.0, l2=4.0, ps=0.0, mds=0.0)]
    depths = [0, 1, 3]
    fmask = (rng.random((3, F)) < 0.7).astype(np.float32)
    fmask[:, 0] = 1.0
    roots = [_root(rng, c, m) for c, m in zip(ctxs, fmask)]
    tab = np.stack([r[0] for r in roots])
    aux = np.stack([r[1] for r in roots])
    scal = np.stack([_scal(c, d, 1) for c, d in zip(ctxs, depths)])
    for _ in range(3):
        hist = _hists(rng, (3, 2))
        want = _reference(hist, tab, fmask, aux, scal)
        _assert_bits(_port(hist, tab, fmask, aux, scal), want)
        scal[:, 8] += 2 * (aux[:, 3] > 0)
        tab, aux = want
    # the depth cap of 1 stops the second element after its root split
    assert aux[1, 3] == 0.0


def test_ties_inactive_and_all_invalid():
    rng = np.random.default_rng(9)
    ctx = _ctx(ps=0.0)
    fmask = np.ones((3, F), np.float32)
    roots = [_root(rng, ctx, fmask[0], ties=True) for _ in range(3)]
    tab = np.stack([r[0] for r in roots])
    aux = np.stack([r[1] for r in roots])
    aux[1, 3] = 0.0                       # element 1 inactive
    scal = np.stack([_scal(ctx, 0, 1)] * 3)
    scal[2, 2] = 1e9                      # element 2: no split is valid
    hist = _hists(rng, (3, 2), ties=True)
    want = _reference(hist, tab, fmask, aux, scal)
    _assert_bits(_port(hist, tab, fmask, aux, scal), want)
    t2, a2 = want
    # ties across identical features pick feature 0 (first occurrence)
    assert t2[0, 1, _PK.CAND_FEAT] == 0.0
    # the inactive element's table is untouched
    assert np.array_equal(t2[1].view(np.int32), tab[1].view(np.int32))
    # all candidates -inf: index 0, gain -inf
    assert t2[2, 1, _PK.CAND_GAIN] == -np.inf
    assert t2[2, 1, _PK.CAND_FEAT] == 0.0 and t2[2, 1, _PK.CAND_BIN] == 0.0


def test_dispatch_takes_plain_version_on_cpu():
    rng = np.random.default_rng(2)
    ctx = _ctx()
    tab, aux = _root(rng, ctx, np.ones(F, np.float32))
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (
        _hists(rng, (1, 2)), tab[None], np.ones((1, F), np.float32),
        aux[None], _scal(ctx, 0, 1)[None])]
    for impl in ("auto", "plain"):
        t1, a1 = split_iter(*args, impl=impl)
        t2, a2 = split_iter_plain(*args)
        assert torch.equal(t1, t2) and torch.equal(a1, a2)


@pytest.mark.parametrize("e,f,b", [(1, 28, 256), (5, 6, 256), (20, 6, 256),
                                   (40, 6, 256), (1, 6, 16), (200, 6, 63),
                                   (3, 150, 256), (1, 1, 2), (7, 500, 256)])
def test_split_iter_launch_plan(e, f, b):
    """B3's plan (pure arithmetic, no card): a cluster of at most eight
    blocks that divides the 2F (child, feature) pairs, larger while the
    batch alone leaves SMs idle; each block's chunk of pairs within the
    opt-in shared memory; the chunks cover the block's share."""
    from lightgbm_tpu_torch.kernels import split_iter as ks

    cluster, chunk = ks.plan_split_iter(e, f, b, 132)
    pairs = 2 * f
    assert 1 <= cluster <= ks.MAX_CLUSTER and pairs % cluster == 0
    # the largest such divisor not above ceil(SMs / E)
    target = min(ks.MAX_CLUSTER, -(-132 // e))
    assert cluster <= max(1, target)
    assert not [c for c in range(cluster + 1, target + 1) if pairs % c == 0]
    if e >= 132:
        assert cluster == 1
    per = pairs // cluster
    assert 1 <= chunk <= per
    assert ks.smem_bytes(b, chunk) <= ks.CHUNK_SMEM <= ks.SMEM_LIMIT
