"""Port parity: the ranking module (``lightgbm_tpu_torch/ranking.py``)
against the reference's ``lightgbm_tpu/ranking.py`` on the CPU.

(a) the host-side packing (``_pack_groups``), the label-gain table and the
    per-query inverse max-DCG equal the reference's;
(b) ``LambdaRank.grad_hess`` on CPU tensors is bit-equal to the
    reference's under ``jax.jit`` (as its Booster runs it), on both routes
    (uniform reshape+pad, ragged gather/scatter), over G = 8 to 264
    (sums over G in 8-lane vectors, 32-wide windows, several query
    chunks), truncation below and at G, ``lambdarank_norm`` on and off,
    a custom ``label_gain``, ``sigmoid`` != 1 and the all-zero scores of
    round 1; XLA's CPU ``log`` is copied bit for bit (``xla_log_f32``);
(c) ``ndcg_at_k``, ``map_at_k`` and ``eval_ranking`` within 1e-6 of the
    reference's jitted metrics;
(d) ``Dataset(group=)``: the group fields, ``group_id`` (-1 on padding),
    the sizes-sum check, ``create_valid(group=)`` and ``subset`` clearing
    the group; lambdarank without groups raises ``ValueError`` naming
    "group", as the reference does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as R
import lightgbm_tpu.ranking as RR
from lightgbm_tpu.config import parse_params as r_params
import lightgbm_tpu_torch as P
import lightgbm_tpu_torch.ranking as PR
from lightgbm_tpu_torch.config import parse_params as p_params
from lightgbm_tpu_torch.objectives import link_log2, xla_log_f32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sizes(kind: str, seed: int = 0) -> np.ndarray:
    """Query sizes: ``uniN`` (every query N documents) or ``ragLO_HI``."""
    rng = np.random.default_rng(seed)
    if kind.startswith("uni"):
        n, q = int(kind[3:]), 40
        return np.full(q if n < 200 else 260, n)
    lo, hi = (int(v) for v in kind[3:].split("_"))
    return rng.integers(lo, hi + 1, 300 if hi > 200 else 60)


# ------------------------------------------------------------ (a) packing
@pytest.mark.parametrize("kind", ["uni7", "uni24", "rag1_9", "rag8_40"])
def test_packing_gains_and_inverse_max_dcg_equal(kind):
    sizes = _sizes(kind, 3)
    rng = np.random.default_rng(4)
    y = rng.integers(0, 5, int(sizes.sum())).astype(np.float64)
    for a, b in zip(PR._pack_groups(sizes), RR._pack_groups(sizes)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for gain in (None, [0.0, 1.0, 3.0, 7.0, 15.0, 40.0]):
        t = PR._label_gain_table(gain, 4)
        assert np.array_equal(t, RR._label_gain_table(gain, 4))
        doc_idx, valid = RR._pack_groups(sizes)
        gains = np.where(valid, t[y[doc_idx].astype(np.int64)], 0.0)
        for trunc in (1, 5, 30):
            assert np.array_equal(PR._inverse_max_dcg(gains, valid, trunc),
                                  RR._inverse_max_dcg(gains, valid, trunc))
    with pytest.raises(ValueError, match="label_gain"):
        PR._label_gain_table([0.0, 1.0], 4)


# --------------------------------------------------------- (b) grad_hess
# (sizes, truncation, params): G = 8 (rows as vector lanes), 16/24/32 (8-lane
# sums, two interleaved accumulators at 32), 40-264 (32-wide windows), the
# last two over several query chunks
GRAD_CASES = {
    "uni24_t20": ("uni24", 20, {}),
    "uni24_t30_at_G": ("uni24", 30, {}),
    "uni7_g8": ("uni7", 3, {}),
    "uni32": ("uni32", 20, {}),
    "uni100_mslr": ("uni100", 100, {}),
    "rag1_9_g8": ("rag1_9", 30, {}),
    "rag8_24": ("rag8_24", 20, {}),
    "rag9_16_no_norm": ("rag9_16", 5, {"lambdarank_norm": False}),
    "rag8_40": ("rag8_40", 20, {}),
    "rag8_40_no_norm": ("rag8_40", 20, {"lambdarank_norm": False}),
    "rag8_40_label_gain": ("rag8_40", 20,
                           {"label_gain": [0.0, 1.0, 3.0, 7.0, 15.0, 40.0]}),
    "rag8_40_sigmoid2": ("rag8_40", 20, {"sigmoid": 2.0}),
    "rag60_100": ("rag60_100", 30, {}),
    "rag200_260_chunks": ("rag200_260", 30, {}),
    "uni257_chunks": ("uni257", 300, {}),
}


def _grad_pair(kind, trunc, extra, zero=False, seed=0):
    sizes = _sizes(kind, seed)
    rng = np.random.default_rng(seed + 1)
    n = int(sizes.sum())
    n_pad = n + 7
    y = np.zeros(n_pad)
    y[:n] = rng.integers(0, 5, n)
    params = dict(objective="lambdarank", lambdarank_truncation_level=trunc,
                  **extra)
    ref = RR.LambdaRank(r_params(params))
    ref.set_group(sizes, y, n_pad)
    port = PR.LambdaRank(p_params(params))
    port.set_group(sizes, y, n_pad, device="cpu")
    pred = (np.zeros(n_pad, np.float32) if zero
            else rng.normal(size=n_pad).astype(np.float32))
    w = rng.uniform(0.5, 1.5, n_pad).astype(np.float32)
    yf = y.astype(np.float32)
    rg, rh = jax.jit(ref.grad_hess)(jnp.asarray(pred), jnp.asarray(yf),
                                    jnp.asarray(w))
    pg, ph = port.grad_hess(torch.from_numpy(pred), torch.from_numpy(yf),
                            torch.from_numpy(w))
    return (np.asarray(rg), np.asarray(rh)), (pg.numpy(), ph.numpy()), port


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grad_hess_bit_equal(case):
    kind, trunc, extra = GRAD_CASES[case]
    (rg, rh), (pg, ph), port = _grad_pair(kind, trunc, extra)
    assert (port._packed["uniform"] is not None) == kind.startswith("uni")
    assert np.array_equal(_bits(pg), _bits(rg))
    assert np.array_equal(_bits(ph), _bits(rh))
    assert np.count_nonzero(pg) > len(pg) // 2


@pytest.mark.parametrize("kind", ["uni24", "rag8_40"])
def test_grad_hess_round_one_scores_bit_equal(kind):
    """Round 1: every score 0, so every rank is the document order."""
    (rg, rh), (pg, ph), _ = _grad_pair(kind, 20, {}, zero=True)
    assert np.array_equal(_bits(pg), _bits(rg))
    assert np.array_equal(_bits(ph), _bits(rh))


def test_truncation_changes_gradients():
    (_, _), (g5, _), _ = _grad_pair("rag8_24", 5, {})
    (_, _), (g30, _), _ = _grad_pair("rag8_24", 30, {})
    assert not np.array_equal(g5, g30)


def test_xla_log_bit_equal():
    rng = np.random.default_rng(9)
    x = np.concatenate([rng.uniform(0.6, 1.5, 100_000),
                        np.exp(rng.uniform(-87, 88, 100_000)),
                        np.arange(0, 3000),
                        [1e-40, 1e-45, -1.0, np.inf, np.nan]]
                       ).astype(np.float32)
    for ref, port in ((jnp.log, xla_log_f32), (jnp.log2, link_log2)):
        want = np.asarray(jax.jit(ref)(x))
        got = port(torch.from_numpy(x)).numpy()
        same = (want == got) | (np.isnan(want) & np.isnan(got))
        assert same.all(), x[~same][:5]


# ----------------------------------------------------------- (c) metrics
@pytest.mark.parametrize("k", [1, 3, 10, 50])
def test_ndcg_and_map_at_k_match_reference(k):
    sizes = _sizes("rag1_30", 5)
    rng = np.random.default_rng(6)
    n = int(sizes.sum())
    y = rng.integers(0, 5, n).astype(np.float64)
    y[:sizes[0]] = 0                       # a query with no relevant doc
    scores = rng.normal(size=n).astype(np.float32)
    scores[sizes[0]:sizes[0] + 4] = 0.5    # ties keep document order
    rctx = RR.RankEvalContext(sizes, y, None)
    pctx = PR.RankEvalContext(sizes, y, None, device="cpu")
    st = torch.from_numpy(scores)
    np.testing.assert_allclose(pctx.ndcg(st, k), rctx.ndcg(scores, k),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(pctx.map(st, k), rctx.map(scores, k),
                               rtol=0, atol=1e-6)
    doc_idx, valid = RR._pack_groups(sizes)
    gains = np.where(valid, 2.0 ** y[doc_idx] - 1, 0.0).astype(np.float32)
    s2 = np.where(valid, scores[doc_idx], 0).astype(np.float32)
    per_q = np.asarray(RR.ndcg_at_k(jnp.asarray(s2), jnp.asarray(gains),
                                    jnp.asarray(valid), k))
    got = PR.ndcg_at_k(torch.from_numpy(s2), torch.from_numpy(gains),
                       torch.from_numpy(valid), k).numpy()
    np.testing.assert_allclose(got, per_q, rtol=0, atol=1e-6)
    rel = valid & (y[doc_idx] > 0)
    np.testing.assert_allclose(
        PR.map_at_k(torch.from_numpy(s2), torch.from_numpy(rel),
                    torch.from_numpy(valid), k).numpy(),
        np.asarray(RR.map_at_k(jnp.asarray(s2), jnp.asarray(rel),
                               jnp.asarray(valid), k)), rtol=0, atol=1e-6)


def test_eval_ranking_names_values_and_cache():
    sizes = _sizes("rag3_20", 7)
    rng = np.random.default_rng(8)
    n = int(sizes.sum())
    X = rng.normal(size=(n, 3))
    y = rng.integers(0, 4, n).astype(np.float64)
    raw = rng.normal(size=n).astype(np.float32)
    rds = R.Dataset(X, label=y, group=sizes)
    pds = P.Dataset(X, label=y, group=sizes, device="cpu")
    for ds in (rds, pds):
        ds.construct()
    n_pad = int(pds.row_mask.shape[0])
    praw = torch.zeros(n_pad)
    praw[:n] = torch.from_numpy(raw)
    rraw = jnp.zeros(int(rds.row_mask.shape[0]), jnp.float32).at[:n].set(raw)
    gain = [0.0, 2.0, 5.0, 9.0]
    want = RR.eval_ranking(rraw, rds, [1, 5, 10], gain, ("ndcg", "map"))
    got = PR.eval_ranking(praw, pds, [1, 5, 10], gain, ("ndcg", "map"))
    assert [(a, c) for a, _, c in got] == [(a, c) for a, _, c in want] == [
        ("ndcg@1", True), ("ndcg@5", True), ("ndcg@10", True),
        ("map@1", True), ("map@5", True), ("map@10", True)]
    np.testing.assert_allclose([v for _, v, _ in got],
                               [v for _, v, _ in want], rtol=0, atol=1e-6)
    ctx = pds._rank_eval_ctx
    assert ctx is not None
    PR.eval_ranking(praw, pds, [3], gain)
    assert pds._rank_eval_ctx is ctx
    pds.set_group(sizes)                 # new groups drop the cached layout
    assert pds._rank_eval_ctx is None
    for name in ("ndcg", "map"):
        m = P.metrics.get_metric(name)
        assert m.name == name and m.higher_better
        with pytest.raises(ValueError, match="group"):
            m.fn(None, None, None)


# ----------------------------------------------------------- (d) dataset
def test_dataset_group_fields():
    sizes = np.array([3, 5, 2, 7])
    rng = np.random.default_rng(10)
    X = rng.normal(size=(17, 2))
    y = rng.integers(0, 3, 17).astype(np.float64)
    ds = P.Dataset(X, label=y, group=list(sizes), device="cpu")
    assert ds.get_group().dtype == np.int64
    assert np.array_equal(ds.get_group(), sizes)
    assert np.array_equal(ds.get_field("group"), sizes)
    ds.construct()
    gid = ds.group_id.numpy()
    assert gid.dtype == np.int32 and len(gid) == int(ds.row_mask.shape[0])
    assert np.array_equal(gid[:17], np.repeat(np.arange(4), sizes))
    assert (gid[17:] == -1).all()
    ds.set_group([10, 7])
    assert np.array_equal(ds.group_id.numpy()[:17], np.repeat([0, 1], [10, 7]))
    ds.set_field("group", sizes)
    assert np.array_equal(ds.get_group(), sizes)
    with pytest.raises(ValueError, match="sum to num_data"):
        ds.set_group([3, 3])
    ds.set_group(sizes)
    valid = ds.create_valid(X[:5], label=y[:5], group=[2, 3])
    valid.construct()
    assert np.array_equal(valid.get_group(), [2, 3])
    assert np.array_equal(valid.group_id.numpy()[:5], [0, 0, 1, 1, 1])
    sub = ds.subset(np.arange(8))
    assert sub.get_group() is None and sub.group_id is None
    ds.set_group(None)
    assert ds.get_group() is None and ds.group_id is None
    rds = R.Dataset(X, label=y, group=sizes)
    rds.construct()
    pds = P.Dataset(X, label=y, group=sizes, device="cpu")
    pds.construct()
    assert np.array_equal(pds.group_id.numpy(), np.asarray(rds.group_id))


def test_lambdarank_requires_group():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(120, 3))
    y = rng.integers(0, 3, 120).astype(np.float64)
    with pytest.raises(ValueError, match="group"):
        R.train(dict(objective="lambdarank", verbose=-1),
                R.Dataset(X, label=y), 2)
    with pytest.raises(ValueError, match="group"):
        P.train(dict(objective="lambdarank", verbose=-1),
                P.Dataset(X, label=y, device="cpu"), 2)
    obj = PR.LambdaRank(p_params(dict(objective="lambdarank")))
    with pytest.raises(ValueError, match="group"):
        obj.grad_hess(torch.zeros(4), torch.zeros(4), torch.ones(4))
    # the objective's aliases resolve to the port's LambdaRank
    for alias in ("lambdarank", "rank_xendcg", "xendcg"):
        made = P.objectives.create_objective(p_params(dict(objective=alias)))
        assert isinstance(made, PR.LambdaRank)
