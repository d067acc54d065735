"""Fused cross-validation: a batch of ``cv`` trainings as one device loop —
the port of ``lightgbm_tpu/models/fused.py``.

The reference's workload is ``lgb.cv`` inside a serial 108-config grid.
This module trains every (config, fold) pair of a bucket together:

* folds and configs share one leading batch axis of ``E = configs x folds``
  elements; every regularizer is a per-element tensor
  (:class:`~.gbdt.HyperScalarsBatch`), so configs that differ only in them
  run in one loop;
* all rows, train and held-out, live in one binned matrix.  Held-out rows
  carry zero gradient, hessian and bag weight but are partitioned all the
  same, so each fold's held-out predictions come from the same
  ``leaf_value[row_leaf]`` gather that updates its training scores;
* trees grow all ``E`` at once (:func:`~.tree.grow_trees_batched`, with
  the width of :func:`_fused_wave_width`): strictly best-first below 2^19
  rows (one histogram pass per split iteration for the whole batch, kernel
  B6, and one split-iteration launch, kernel B3), in waves from 2^19 rows
  or with an explicit ``grow_policy``/``wave_width`` (one histogram pass per
  wave for the whole batch, kernel B5);
* multiclass: each element grows its K class trees in the same batch, so
  the grower's batch is configs x folds x classes and the scores are
  ``[E, n, K]``;
* early stopping runs on the device: each config's patience counters live
  in the carry.  The host reads one flag per round (whether every config
  has stopped), the loop's only host read.

Bagging, ``feature_fraction`` and ``feature_fraction_bynode`` draw from the
reference's key streams: round ``r``'s key is ``fold_in(PRNGKey(seed), r)``,
split over the batch elements (``utils/random.py``), so the same call gives
the same trees as the reference's fused program.  With per-node sampling on
(any config of the batch) the strict trees take the unfused body, as the
reference's; categorical columns take k-vs-rest subset splits, through the
unfused strict body and the batched waves' plain partition, with the
first config's ``cat_smooth``, ``cat_l2`` and ``max_cat_threshold`` (the
reference's static ``cat_key``); ``boosting="rf"`` takes the per-fold
route.  CV keeps no trees: the carry is the predictions, the bags and the
metric history.

"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import Params, default_metric_for_objective
from ..metrics import get_metric
from ..objectives import create_objective
from ..ops.histogram import sr_round_bf16
from ..ops.sampling import sample_bag_rows, sample_feature_mask_rows
from ..ops.split import fma
from ..utils.random import (fold_in, fold_in_keys, fold_in_tensor, prng_key,
                            split_keys, split_on)
from .gbdt import (HyperScalarsBatch, build_cat_info, resolve_hist_dtype,
                   resolve_wave_width)
from .tree import _PK, grow_trees_batched

_F32 = torch.float32


class FusedCVCarry(NamedTuple):
    r: int                      # current round (host)
    pred: torch.Tensor          # f32 [E, n] (or [E, n, K]) raw scores
    bag: torch.Tensor           # f32 [E, n] current bagging mask
    history: torch.Tensor       # f32 [T_max, E] per-round valid metric
    best_score: torch.Tensor    # f32 [C] sign-normalized best mean metric
    best_iter: torch.Tensor     # i32 [C] 0-based round of the best score
    done: torch.Tensor          # bool [C]


class FusedCVResult(NamedTuple):
    history: torch.Tensor       # f32 [T_max, C, K] per-round per-fold metric
    best_iter: torch.Tensor     # i32 [C] 1-based best iteration
    best_score: torch.Tensor    # f32 [C] raw mean metric at the best round
    rounds_run: int


def _fused_wave_width(p: Params, n_pad: int, hist_dtype: str) -> int:
    """Wave width of the batched regime: strict growth below 2^19 rows (and
    for exact-f32 or int8 histograms), unless ``grow_policy`` or
    ``wave_width`` is given explicitly — cv grows trees the way the final
    training will."""
    explicit = (p.grow_policy != "auto"
                or int(p.extra.get("wave_width", 0)) != 0)
    if not explicit and (n_pad < (1 << 19)
                         or hist_dtype in ("f32x", "int8")):
        return 1
    return resolve_wave_width(p, n_pad)


def fused_cv_eligible(p: Params, feval, callbacks, train_set=None) -> bool:
    """Whether ``cv`` takes the fused route (the reference's test): anything
    that needs per-round host hooks takes the per-fold route."""
    if feval is not None or callbacks:
        return False
    if p.extra.get("fobj") is not None:
        return False
    if p.objective in ("lambdarank", "none"):
        return False
    metrics = [m for m in p.metric if m != "none"]
    if len(metrics) > 1:
        return False
    if p.boosting not in ("gbdt",):
        return False
    if p.monotone_constraints is not None or p.extra_trees \
            or p.linear_tree or p.interaction_constraints:
        return False
    if train_set is not None and getattr(train_set, "is_streamed", False):
        return False
    return True


class FusedCVProgram:
    """One fused-CV batch as explicit init / step / finalize calls, with a
    carry <-> numpy round trip (:meth:`carry_arrays`, :meth:`restore_carry`)
    so a sweep can stop between segments and resume bit-identically: every
    carry field is f32, i32 or bool, and each round's random draws are keyed
    by its index."""

    CARRY_DTYPES = {"r": np.int32, "pred": np.float32, "bag": np.float32,
                    "history": np.float32, "best_score": np.float32,
                    "best_iter": np.int32, "done": np.bool_}

    def __init__(self, train_set, param_list: Sequence[Params],
                 fold_masks: np.ndarray, num_boost_round: int,
                 early_stopping_rounds: int, seed: int):
        p0 = param_list[0]
        metrics = [m for m in p0.metric if m != "none"] or \
            [default_metric_for_objective(p0.objective)]
        self.metric_name = metrics[0]
        self.metric = get_metric(self.metric_name, p0)
        self.sign = 1.0 if self.metric.higher_better else -1.0
        self.num_boost_round = int(num_boost_round)

        train_set.construct()
        self._train_set = train_set
        dev = self.device = train_set.device
        n_pad = int(train_set.row_mask.shape[0])
        n = train_set.num_data()
        n_folds = fold_masks.shape[0]
        n_configs = len(param_list)
        self.n_configs, self.n_folds, self.n_pad = n_configs, n_folds, n_pad
        self.batch = n_configs * n_folds

        hd = resolve_hist_dtype(p0, n_pad)
        self.wave_width = _fused_wave_width(p0, n_pad, hd)
        self.hist_dtype = hd
        self.hist_impl = p0.extra.get("hist_impl", "auto")
        self.num_leaves = int(p0.num_leaves)
        self.num_bins = train_set.num_bins
        # categorical columns: the first config's cat_smooth, cat_l2 and
        # max_cat_threshold for the batch, as the reference's static cat_key
        self.cat_info = build_cat_info(train_set, p0, dev)

        # [E, n_pad] masks; padding rows excluded everywhere
        tm = np.zeros((self.batch, n_pad), np.float32)
        vm = np.zeros((self.batch, n_pad), np.float32)
        for ci in range(n_configs):
            for ki in range(n_folds):
                b = ci * n_folds + ki
                tm[b, :n] = fold_masks[ki]
                vm[b, :n] = ~fold_masks[ki]
        self._tm = torch.from_numpy(tm).to(dev)
        self._vm = torch.from_numpy(vm).to(dev)
        self._n_in_fold = torch.from_numpy(tm.sum(axis=1).astype(
            np.float32)).to(dev)

        def rep(vals, device=dev):
            return torch.from_numpy(np.repeat(np.asarray(vals, np.float32),
                                              n_folds)).to(device)

        self.hyper = HyperScalarsBatch.from_params(param_list, n_folds, dev)
        self._bag_frac = rep([p.bagging_fraction for p in param_list])
        ff = [p.feature_fraction for p in param_list]
        self._ff_host = rep(ff, "cpu")
        self._use_ff = any(np.float32(f) < 1.0 for f in ff)
        # per-node sampling: on for the batch when any config samples
        self._bynode = any(p.feature_fraction_bynode < 1.0
                           for p in param_list)
        # configs of a bucket share bagging_freq (the sweep's bucket key)
        self.bagging_freq = p0.bagging_freq if any(
            p.bagging_fraction < 1.0 for p in param_list) else 0

        obj = create_objective(p0)
        y_host = train_set.get_label()
        w_host = (train_set.get_weight()
                  if train_set.get_weight() is not None else np.ones(n))
        if hasattr(obj, "prepare"):
            obj.prepare(y_host, w_host)
        self.obj = obj
        self.num_class = (int(p0.num_class) if p0.objective in (
            "multiclass", "multiclassova") else 1)
        init = obj.init_score(y_host, w_host)     # [K] priors multiclass
        self._init_score = (torch.from_numpy(np.asarray(init, np.float32)).to(
            dev) if self.num_class > 1 else float(init))
        self._es_rounds = int(early_stopping_rounds)
        self._min_delta = torch.tensor(
            [p.early_stopping_min_delta for p in param_list], dtype=_F32,
            device=dev)
        self._base_key = prng_key(seed)
        self.segment_rounds = int(p0.extra.get("cv_segment_rounds", 100))

    # ------------------------------------------------------------------
    def init(self) -> FusedCVCarry:
        """Fresh round-0 carry (the bags seeded to the train masks)."""
        dev = self.device
        if self.num_class > 1:
            pred = self._init_score.expand(self.batch, self.n_pad,
                                           self.num_class).clone()
        else:
            pred = torch.full((self.batch, self.n_pad), self._init_score,
                              dtype=_F32, device=dev)
        return FusedCVCarry(
            r=0,
            pred=pred,
            bag=self._tm.clone(),
            history=torch.full((self.num_boost_round, self.batch),
                               float("nan"), dtype=_F32, device=dev),
            best_score=torch.full((self.n_configs,), float("-inf"),
                                  dtype=_F32, device=dev),
            best_iter=torch.zeros(self.n_configs, dtype=torch.int32,
                                  device=dev),
            done=torch.zeros(self.n_configs, dtype=torch.bool, device=dev))

    def _round(self, c: FusedCVCarry) -> FusedCVCarry:
        ts = self._train_set
        dev = self.device
        r = c.r
        rkey = fold_in(self._base_key, r)
        if self.bagging_freq > 0 and r % self.bagging_freq == 0:
            bkeys = split_keys(fold_in(rkey, 0), self.batch).to(dev)
            bag = sample_bag_rows(bkeys, self._tm, self._bag_frac,
                                  self._n_in_fold)
        else:
            bag = c.bag
        num_features = ts.X_binned.shape[1]
        if self._use_ff:
            fmask = sample_feature_mask_rows(
                fold_in_keys(split_keys(fold_in(rkey, 1), self.batch), 1),
                self._ff_host, num_features).to(dev)
        else:
            fmask = torch.ones((self.batch, num_features), dtype=_F32,
                               device=dev)
        g, h = self.obj.grad_hess(c.pred, ts.y, ts.w)
        k = self.num_class
        hyper = self.hyper
        bynode = {}
        if self._bynode:
            # element b's grower key fold_in(split(fold_in(round key, 1),
            # E)[b], 2), split over its classes for multiclass, as the
            # reference's element round keys it (on the device: no copy)
            gkeys = fold_in_keys(split_on(fold_in(rkey, 1), self.batch,
                                          dev), 2)
            if k > 1:
                gkeys = fold_in_tensor(gkeys, torch.arange(
                    k, device=dev)).reshape(-1, 2)
            bynode = dict(keys=gkeys)
        if k > 1:
            # element b's class c is grower element b * K + c (the
            # reference's vmap over classes inside the vmap over the batch)
            bag_k = bag[:, :, None].expand_as(g)
            stats_t = torch.stack([(g * bag_k).permute(1, 0, 2),
                                   (h * bag_k).permute(1, 0, 2),
                                   bag_k.permute(1, 0, 2)], dim=-1).reshape(
                                       self.n_pad, self.batch * k, 3)
            if self.hist_dtype == "bf16sr":
                # the reference's class vmap inside the batch vmap hashes
                # each element's statistics in its own [K, n, 3] layout;
                # the grower's rounding after this one changes nothing
                stats_t = sr_round_bf16(stats_t.view(
                    self.n_pad, self.batch, k, 3).permute(1, 2, 0, 3),
                    batch_dims=1).permute(2, 0, 1, 3).reshape(
                        self.n_pad, self.batch * k, 3)
            fmask = fmask.repeat_interleave(k, dim=0)
            hyper = HyperScalarsBatch(*(v.repeat_interleave(k)
                                        for v in hyper))
        else:
            g, h = g * bag, (h * bag).expand_as(g)
            stats_t = torch.stack([g.t(), h.t(), bag.t()], dim=-1)  # [n, E, 3]
        if bynode:
            bynode["ff_bynode"] = hyper.feature_fraction_bynode
        P, _, row_leaf, _ = grow_trees_batched(
            ts.X_binned, stats_t, fmask, hyper.ctx(), hyper.max_depth,
            self.num_leaves, self.num_bins, self.wave_width,
            hist_impl=self.hist_impl, hist_dtype=self.hist_dtype,
            cat_info=self.cat_info, **bynode)
        vals = P[:, :, _PK.LEAF_VALUE].gather(1, row_leaf.t().to(torch.int64))
        if k > 1:
            vals = vals.view(self.batch, k, self.n_pad).transpose(1, 2)
            pred = fma(self.hyper.learning_rate[:, None, None], vals, c.pred)
        else:
            pred = fma(self.hyper.learning_rate[:, None], vals, c.pred)

        mvals = self.metric.fn(self.obj.transform(pred), ts.y,
                               ts.w * self._vm)                    # [E]
        history = c.history.clone()
        history[r] = mvals
        score = self.sign * mvals.view(self.n_configs, self.n_folds).mean(1)
        # early_stopping_min_delta per config: an improvement counts only
        # when it beats the incumbent by more than the tolerance
        improved = (score > c.best_score + self._min_delta) & ~c.done
        best_score = torch.where(improved, score, c.best_score)
        best_iter = torch.where(improved, torch.tensor(
            r, dtype=torch.int32, device=dev), c.best_iter)
        stalled = ((r - best_iter >= self._es_rounds)
                   & (self._es_rounds > 0))
        return FusedCVCarry(r + 1, pred, bag, history, best_score,
                            best_iter, c.done | stalled)

    def step(self, carry: FusedCVCarry, seg_end: int) -> FusedCVCarry:
        """Rounds ``[carry.r, seg_end)``, stopping early once every config
        has stopped; the flag is read back once per round."""
        while carry.r < min(int(seg_end), self.num_boost_round) \
                and not bool(carry.done.all()):
            carry = self._round(carry)
        return carry

    def done(self, carry: FusedCVCarry) -> bool:
        return bool(carry.done.all()) or carry.r >= self.num_boost_round

    def finalize(self, carry: FusedCVCarry) -> FusedCVResult:
        return FusedCVResult(
            history=carry.history.view(self.num_boost_round, self.n_configs,
                                       self.n_folds),
            best_iter=carry.best_iter + 1,
            best_score=self.sign * carry.best_score,
            rounds_run=int(carry.r))

    def carry_arrays(self, carry: FusedCVCarry) -> dict:
        """Carry -> host numpy dict (a checkpoint's payload)."""
        out = {}
        for f in FusedCVCarry._fields:
            v = getattr(carry, f)
            out[f] = (np.asarray(v, self.CARRY_DTYPES[f]) if f == "r"
                      else v.cpu().numpy())
        return out

    def restore_carry(self, arrays: dict) -> FusedCVCarry:
        """Exact inverse of :meth:`carry_arrays`."""
        kw = {}
        for f in FusedCVCarry._fields:
            a = np.asarray(arrays[f], self.CARRY_DTYPES[f])
            kw[f] = int(a) if f == "r" else torch.from_numpy(
                a.copy()).to(self.device)
        return FusedCVCarry(**kw)


def run_fused_cv_batch(train_set, param_list: Sequence[Params],
                       fold_masks: np.ndarray, num_boost_round: int,
                       early_stopping_rounds: int, seed: int):
    """Run a batch of cv trainings (configs sharing num_leaves, max_bin and
    the objective) to completion.

    Returns ``(history [T, C, K] numpy with a NaN tail, best_iter [C],
    best_score_raw [C], rounds_run, metric_name)``.
    """
    prog = FusedCVProgram(train_set, param_list, fold_masks,
                          num_boost_round, early_stopping_rounds, seed)
    carry = prog.step(prog.init(), num_boost_round)
    res = prog.finalize(carry)
    return (res.history.cpu().numpy(), res.best_iter.cpu().numpy(),
            res.best_score.cpu().numpy(), res.rounds_run, prog.metric_name)
