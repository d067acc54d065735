"""LambdaRank and the NDCG/MAP metrics — the port of
``lightgbm_tpu/ranking.py`` (upstream ``rank_objective.hpp`` LambdarankNDCG
and ``rank_metric.hpp``).

Queries are packed on the host into a ``[Q, G]`` index layout once per
training (G the largest query rounded up to a multiple of 8).  Each round
the scores go into ``[Q, G]`` (a reshape and pad when every query has the
same size, else a gather), per-query ranks come from one stable descending
sort, and the pairwise lambdas ``[qc, G, G]`` are evaluated for a chunk of
``qc = 2**24 // G**2`` queries at a time: ΔNDCG pair weights with the
inverse max-DCG, sigmoid-scaled logistic lambdas,
``lambdarank_truncation_level`` (a pair counts when its better-scored
document ranks inside the window) and ``lambdarank_norm``.  Gradients go
back to the row axis by the inverse reshape or one scatter per round, and
hessians are floored at 2e-3.

On a CPU tensor every step rounds as the reference's jitted XLA program
does: ``exp`` and ``log2`` are XLA's (``objectives.link_exp``,
``objectives.link_log2``) and the sums over G follow the order of its
compiled loops (:func:`pair_axis_sum`, :func:`pair_total`), so gradients
and hessians are bit-equal to the reference's.  On the card the same
formulas run as plain torch ops and nothing is read back to the host.
The grouped metrics run on the ``[Q, G]`` layout on the device, one host
read per metric.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import Params
from .device import resolve_device
from .metrics import Metric
from .objectives import Objective, link_exp, link_log2

_F32 = torch.float32
_LANE = 8  # pad G to a multiple of the sublane for friendlier layouts


def _f32c(v: float) -> float:
    return float(np.float32(v))


def _pack_groups(group_sizes: np.ndarray,
                 max_docs: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: group sizes -> (doc_idx [Q, G] int32, valid [Q, G] bool).

    Rows are group-contiguous (group sizes partition the row axis in
    order).  Padding slots point at row 0 and are masked by ``valid``.
    """
    sizes = np.asarray(group_sizes, np.int64)
    q = len(sizes)
    g = int(sizes.max()) if max_docs is None else int(max_docs)
    g = max(_LANE, -(-g // _LANE) * _LANE)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    doc_idx = np.zeros((q, g), np.int32)
    valid = np.zeros((q, g), bool)
    for i, (st, sz) in enumerate(zip(starts, sizes)):
        doc_idx[i, :sz] = np.arange(st, st + sz, dtype=np.int32)
        valid[i, :sz] = True
    return doc_idx, valid


def _label_gain_table(label_gain: Optional[List[float]],
                      max_label: int) -> np.ndarray:
    if label_gain is not None:
        t = np.asarray(label_gain, np.float64)
        if len(t) <= max_label:
            raise ValueError(
                f"label_gain has {len(t)} entries but labels reach {max_label}")
        return t
    return (2.0 ** np.arange(max_label + 1)) - 1.0  # LightGBM default


def _inverse_max_dcg(gains: np.ndarray, valid: np.ndarray,
                     truncation: int) -> np.ndarray:
    """Host-side per-query 1/maxDCG@truncation (0 when maxDCG == 0)."""
    q, g = gains.shape
    neg = np.where(valid, gains, -np.inf)
    top = -np.sort(-neg, axis=1)[:, :truncation]           # desc
    disc = 1.0 / np.log2(2.0 + np.arange(top.shape[1]))
    dcg = np.sum(np.where(np.isfinite(top), top, 0.0) * disc, axis=1)
    inv = np.zeros(q)
    nz = dcg > 0
    inv[nz] = 1.0 / dcg[nz]
    return inv


def _packed_gains(group_sizes, y_host, label_gain):
    """``(doc_idx, valid, labels, gains)`` of the packed layout: labels and
    gains are float64 ``[Q, G]``, 0 on padding."""
    doc_idx, valid = _pack_groups(group_sizes)
    labels = np.zeros(doc_idx.shape)
    labels[valid] = np.asarray(y_host)[doc_idx[valid]]
    max_label = int(labels.max()) if labels.size else 0
    table = _label_gain_table(label_gain, max_label)
    gains = np.where(valid, table[labels.astype(np.int64)], 0.0)
    return doc_idx, valid, labels, gains


# The reference's pair program on the CPU: XLA marks a reduction's adds
# reassociable, and LLVM vectorizes the sums over G <= 32 with 8 f32 lanes
# (lane l adds the elements l, l + 8, ... in order, 4 chunks of a contiguous
# axis in two interleaved accumulators) and folds the lanes by halves; past
# 32 XLA's TreeReductionRewriter sums windows of 32 (the axis padded with
# p // 2 zeros before and the rest after) in order, then the window sums.
_XLA_VF = 8
_XLA_WINDOW = 32


def _fold_halves(acc: torch.Tensor) -> torch.Tensor:
    """LLVM's reassociated vector reduce: lanes added by halves."""
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _lane_sum(x: torch.Tensor, start: torch.Tensor,
              contiguous: bool) -> torch.Tensor:
    """``start + sum(x)`` over the last axis (G in 8, 16, 24, 32) in the
    vectorized loop's order; ``start`` rides in lane 0."""
    ch = x.reshape(*x.shape[:-1], -1, _XLA_VF)
    first = torch.cat([(start + ch[..., 0, 0])[..., None], ch[..., 0, 1:]],
                      dim=-1)
    if ch.shape[-2] == 4 and contiguous:
        acc = (ch[..., 1, :] + ch[..., 3, :]) + (first + ch[..., 2, :])
    else:
        acc = first
        for c in range(1, ch.shape[-2]):
            acc = acc + ch[..., c, :]
    return _fold_halves(acc)


def _windows(x: torch.Tensor, dims: int) -> torch.Tensor:
    """The last ``dims`` axes padded as XLA's rewriter pads them and cut
    into windows: ``[..., nw, 32]`` or ``[..., nw, 32, nw, 32]``."""
    k = x.shape[-1]
    pad = _XLA_WINDOW * -(-k // _XLA_WINDOW) - k
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2) * dims)
    nw = xp.shape[-1] // _XLA_WINDOW
    return xp.reshape(*x.shape[:-dims], *((nw, _XLA_WINDOW) * dims))


def _in_order(parts) -> torch.Tensor:
    acc = torch.zeros_like(parts[0])
    for part in parts:
        acc = acc + part
    return acc


def pair_axis_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of a ``[qc, G, G]`` pair block over axis 1 or 2: the reference
    program's order on a CPU tensor, ``torch.sum`` on the card."""
    if x.device.type != "cpu":
        return x.sum(dim=dim)
    g = x.shape[dim]
    x = x.movedim(dim, -1)
    if g == _XLA_VF:            # vectorized over the kept axis instead
        return _in_order([x[..., j] for j in range(g)])
    if g <= _XLA_WINDOW:
        return _lane_sum(x, torch.zeros(x.shape[:-1]), contiguous=dim == 2)
    xw = _windows(x, 1)
    win = _in_order([xw[..., c] for c in range(_XLA_WINDOW)])
    return _in_order([win[..., c] for c in range(win.shape[-1])])


def pair_total(x: torch.Tensor) -> torch.Tensor:
    """Sum of a ``[qc, G, G]`` pair block over both pair axes: the
    reference program's order on a CPU tensor, ``torch.sum`` on the card.
    At 8 a side the rows are the lanes (each row in order, the rows folded
    by halves); up to 32 row by row, each row as :func:`_lane_sum`; past
    it the 32 x 32 windows in row-major order, then the ``[nw, nw]``
    window sums: a power-of-two ``nw`` up to 8 vectorizes over the rows as
    at 8 a side, any other ``nw`` adds in row-major order."""
    if x.device.type != "cpu":
        return x.sum(dim=(-2, -1))
    g = x.shape[-1]
    if g == _XLA_VF:            # vectorized over the rows instead
        return _fold_halves(_in_order([x[..., j] for j in range(g)]))
    if g <= _XLA_WINDOW:
        acc = torch.zeros(x.shape[:-2])
        for i in range(g):
            acc = _lane_sum(x[..., i, :], acc, contiguous=True)
        return acc
    xw = _windows(x, 2)                          # [qc, nw, 32, nw, 32]
    win = _in_order([xw[..., :, i, :, j] for i in range(_XLA_WINDOW)
                     for j in range(_XLA_WINDOW)])          # [qc, nw, nw]
    nw = win.shape[-1]
    if nw <= _XLA_VF and nw & (nw - 1) == 0:
        return _fold_halves(_in_order([win[..., b] for b in range(nw)]))
    return _in_order([win[..., a, b] for a in range(nw) for b in range(nw)])


def _ranks_desc(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-query 0-based rank of each doc under descending score order
    (the inverse permutation of the per-query stable argsort)."""
    masked = torch.where(valid, scores, float("-inf"))
    order = torch.argsort(-masked, dim=-1, stable=True)
    iota = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.zeros_like(order).scatter_(-1, order, iota)


class LambdaRank(Objective):
    """Pairwise LambdaRank with ΔNDCG weighting (lambdarank objective)."""

    name = "lambdarank"
    needs_group = True

    def __init__(self, params: Params):
        super().__init__(params)
        self.sigma = _f32c(params.sigmoid)
        self.truncation = int(params.lambdarank_truncation_level)
        self.norm = bool(params.lambdarank_norm)
        self._packed = None

    # -- group setup (Booster._setup_training) ---------------------------
    def set_group(self, group_sizes: np.ndarray, y_host: np.ndarray,
                  n_padded: int, device=None) -> None:
        """Pack the queries for training on ``device`` (None: ``cuda``)."""
        dev = resolve_device(device)
        doc_idx, valid, _, gains = _packed_gains(
            group_sizes, y_host, self.params.label_gain)
        inv_max = _inverse_max_dcg(gains, valid, self.truncation)
        sizes = np.asarray(group_sizes, np.int64)
        safe = np.where(valid, doc_idx, n_padded).astype(np.int64)
        self._packed = dict(
            doc_idx=torch.from_numpy(doc_idx.astype(np.int64)).to(dev),
            valid=torch.from_numpy(valid).to(dev),
            scatter_idx=torch.from_numpy(safe.reshape(-1)).to(dev),
            gains=torch.from_numpy(gains.astype(np.float32)).to(dev),
            inv_max=torch.from_numpy(inv_max.astype(np.float32)).to(dev),
            # every query of one size U: the [Q, G] layout maps to the rows
            # by a reshape and pad, no gather or scatter
            uniform=(int(sizes[0]) if len(sizes) and
                     (sizes == sizes[0]).all() else None),
        )

    @property
    def query_chunk(self) -> int:
        """Queries per pairwise block (the reference's ``qc``)."""
        q, g = self._packed["doc_idx"].shape
        return max(1, min(q, (16 << 20) // max(g * g, 1)))

    # -- pairwise lambdas -------------------------------------------------
    def _pairs(self, s, v, gn, d, rk, im):
        """``(g_row, h_row)`` ``[qc, G]`` of one chunk of queries, in the
        reference's op order (i is the better doc of a pair)."""
        sigma = self.sigma
        better = ((gn[:, :, None] > gn[:, None, :])
                  & v[:, :, None] & v[:, None, :])
        in_win = torch.minimum(rk[:, :, None], rk[:, None, :]) \
            < self.truncation
        pair = better & in_win
        delta = (torch.abs(gn[:, :, None] - gn[:, None, :])
                 * torch.abs(d[:, :, None] - d[:, None, :])
                 * im[:, None, None])                   # ΔNDCG [qc, G, G]
        p = 1.0 / (1.0 + link_exp(sigma * (s[:, :, None] - s[:, None, :])))
        lam = torch.where(pair, sigma * p * delta, 0.0)
        hes = torch.where(pair, _f32c(sigma * sigma) * p * (1.0 - p) * delta,
                          0.0)
        g_row = pair_axis_sum(lam, 1) - pair_axis_sum(lam, 2)
        h_row = pair_axis_sum(hes, 2) + pair_axis_sum(hes, 1)
        if self.norm:
            all_lam = pair_total(lam)
            norm = torch.where(
                all_lam > 0.0,
                link_log2(all_lam + 1.0) / torch.clamp(all_lam, min=1e-20),
                1.0)
            g_row = g_row * norm[:, None]
            h_row = h_row * norm[:, None]
        return g_row, h_row

    def grad_hess(self, pred, y, w):
        if self._packed is None:
            raise ValueError(
                "lambdarank requires group information: pass group= to the "
                "training Dataset (lgb.Dataset(X, label=y, group=sizes))")
        pk = self._packed
        valid = pk["valid"]
        q, g = valid.shape
        uni = pk["uniform"]
        n_pad = pred.shape[0]
        if uni is not None:    # reshape+pad instead of a row gather
            scores = torch.nn.functional.pad(pred[:q * uni].reshape(q, uni),
                                             (0, g - uni))
        else:
            scores = pred[pk["doc_idx"]]                      # [Q, G]
        ranks = _ranks_desc(scores, valid)
        disc = 1.0 / link_log2(ranks.to(_F32) + 2.0)          # [Q, G]
        qc = self.query_chunk
        parts = [self._pairs(scores[a:a + qc], valid[a:a + qc],
                             pk["gains"][a:a + qc], disc[a:a + qc],
                             ranks[a:a + qc], pk["inv_max"][a:a + qc])
                 for a in range(0, q, qc)]
        g_q = torch.cat([gp for gp, _ in parts]) * valid
        h_q = torch.cat([hp for _, hp in parts]) * valid
        if uni is not None:    # inverse of the reshape+pad above
            grad = torch.nn.functional.pad(g_q[:, :uni].reshape(-1),
                                           (0, n_pad - q * uni))
            hess = torch.nn.functional.pad(h_q[:, :uni].reshape(-1),
                                           (0, n_pad - q * uni))
        else:                  # padding slots land past the rows, dropped
            idx = pk["scatter_idx"]
            grad = torch.zeros(n_pad + 1, dtype=_F32, device=pred.device
                               ).index_add_(0, idx, g_q.reshape(-1))[:n_pad]
            hess = torch.zeros(n_pad + 1, dtype=_F32, device=pred.device
                               ).index_add_(0, idx, h_q.reshape(-1))[:n_pad]
        hess = torch.clamp(hess, min=_f32c(2e-3))  # LightGBM's rank floor
        return grad * w, hess * w


# ---------------------------------------------------------------------------
# NDCG@k / MAP@k evaluation
# ---------------------------------------------------------------------------

def ndcg_at_k(scores: torch.Tensor, gains: torch.Tensor, valid: torch.Tensor,
              k: int) -> torch.Tensor:
    """Per-query NDCG@k on the ``[Q, G]`` layout (queries with maxDCG@k ==
    0 count as 1, LightGBM's NDCGMetric convention)."""
    masked = torch.where(valid, scores, float("-inf"))
    order = torch.argsort(-masked, dim=-1, stable=True)[:, :k]
    top = gains.gather(-1, order)
    topv = valid.gather(-1, order).to(_F32)
    kk = order.shape[-1]
    disc = 1.0 / link_log2(torch.arange(kk, dtype=_F32,
                                        device=scores.device) + 2.0)
    dcg = torch.sum(top * topv * disc[None, :], dim=-1)
    ideal_order = torch.argsort(-torch.where(valid, gains, float("-inf")),
                                dim=-1, stable=True)[:, :k]
    idcg = torch.sum(gains.gather(-1, ideal_order) * disc[None, :], dim=-1)
    return torch.where(idcg > 0, dcg / torch.clamp(idcg, min=1e-20), 1.0)


def map_at_k(scores: torch.Tensor, rel: torch.Tensor, valid: torch.Tensor,
             k: int) -> torch.Tensor:
    """Per-query MAP@k (upstream MapMetric): binary relevance (label > 0),
    AP@k = the sum over relevant hits in the top k of hits so far over the
    position, normalized by min(relevant, k); queries with no relevant
    document count as 1.  ``[Q, G]`` layout."""
    masked = torch.where(valid, scores, float("-inf"))
    order = torch.argsort(-masked, dim=-1, stable=True)
    rel_sorted = (rel & valid).gather(-1, order)
    kk = min(k, rel.shape[-1])
    hits = torch.cumsum(rel_sorted.to(_F32), dim=-1)[:, :kk]
    pos = 1.0 + torch.arange(kk, dtype=_F32, device=scores.device)
    acc = torch.sum(torch.where(rel_sorted[:, :kk], hits / pos, 0.0), dim=-1)
    npos = torch.sum((rel & valid).to(_F32), dim=-1)
    denom = torch.clamp(npos, max=float(kk))
    return torch.where(npos > 0, acc / torch.clamp(denom, min=1.0), 1.0)


class RankEvalContext:
    """Per-dataset packed layout for the ranking metrics, built once, on
    ``device``."""

    def __init__(self, group_sizes: np.ndarray, y_host: np.ndarray,
                 label_gain: Optional[List[float]], device=None):
        dev = resolve_device(device)
        doc_idx, valid, labels, gains = _packed_gains(group_sizes, y_host,
                                                      label_gain)
        self.doc_idx = torch.from_numpy(doc_idx.astype(np.int64)).to(dev)
        self.valid = torch.from_numpy(valid).to(dev)
        self.gains = torch.from_numpy(gains.astype(np.float32)).to(dev)
        # binary relevance for MAP: label > 0 (upstream MapMetric threshold)
        self.rel = torch.from_numpy(valid & (labels > 0)).to(dev)
        self.qweight = torch.ones(doc_idx.shape[0], dtype=_F32, device=dev)

    def _mean(self, per_q: torch.Tensor) -> float:
        return float(torch.sum(per_q * self.qweight)
                     / torch.clamp(torch.sum(self.qweight), min=1e-12))

    def ndcg(self, pred_raw: torch.Tensor, k: int) -> float:
        return self._mean(ndcg_at_k(pred_raw[self.doc_idx], self.gains,
                                    self.valid, int(k)))

    def map(self, pred_raw: torch.Tensor, k: int) -> float:
        return self._mean(map_at_k(pred_raw[self.doc_idx], self.rel,
                                   self.valid, int(k)))


def eval_ranking(pred_raw, ds, eval_at: List[int],
                 label_gain: Optional[List[float]] = None,
                 metrics: Tuple[str, ...] = ("ndcg",)):
    """``[(name, value, higher_better)]`` for ndcg@k / map@k over a grouped
    Dataset (upstream NDCGMetric / MapMetric), on the scores' device."""
    ctx = getattr(ds, "_rank_eval_ctx", None)
    if ctx is None:
        gs = ds.get_group()
        if gs is None:
            raise ValueError(
                "ranking metrics require the Dataset to have group")
        ctx = RankEvalContext(gs, ds.get_label(), label_gain,
                              device=pred_raw.device)
        ds._rank_eval_ctx = ctx
    out = []
    for m in metrics:
        if m == "ndcg":
            out.extend((f"ndcg@{k}", ctx.ndcg(pred_raw, k), True)
                       for k in eval_at)
        elif m == "map":
            out.extend((f"map@{k}", ctx.map(pred_raw, k), True)
                       for k in eval_at)
    return out


def get_ranking_metric(name: str, params=None) -> Metric:
    """The registry entry of ndcg/map: its name and ``higher_better``; the
    values come from :func:`eval_ranking` (``Booster._eval_on``), since the
    plain ``(pred, y, w)`` signature carries no groups."""
    if name not in ("ndcg", "map"):
        raise ValueError(f"Unknown ranking metric: {name}")

    def _needs_group(*_a, **_k):
        raise ValueError(
            f"{name} must be evaluated with group information "
            "(use Booster.eval_valid / lgb.cv with a grouped Dataset)")

    return Metric(name, True, _needs_group)
