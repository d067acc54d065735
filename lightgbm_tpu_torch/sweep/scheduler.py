"""Sweep scheduler: config grid -> hyper-batches -> device groups — the
port's copy of ``lightgbm_tpu/sweep/scheduler.py``.

The fused-CV program (models/fused.py) runs one BUCKET of configs —
everything that shapes the program: num_leaves, bagging_freq, the
objective and, for early stopping's sake, the learning rate — as one
device loop with a configs x folds batch axis.  The scheduler turns a whole
grid into an executable plan over a configs x devices mesh:

* axis 1 (configs): pending configs bucket by :func:`fused_bucket_key`
  and pack into hyper-batches of at most ``hyper_batch`` configs (the
  36-config x 5-fold shape of the reference's default);
* axis 2 (devices): the ``n_devices`` mesh splits into
  ``n_devices // group_size`` device groups; each hyper-batch is
  assigned whole to one group (configs never straddle groups — a
  bucket's early stopping is collective), greedily balancing total
  configs per group.

The groups are a plan, as in the reference: the service runs its units one
after another and records each unit's group in its ledger rows.  Unit
identity (``uid``) is content-derived, so a resumed sweep re-plans the same
remaining units.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple


def fused_bucket_key(p, train_set) -> tuple:
    """Everything the fused program treats as compile-time static,
    INCLUDING objective scalars (a grid axis over e.g. quantile alpha
    must not share one objective instance).  learning_rate also buckets
    — not for compilation (it is traced) but because a bucket runs until
    its SLOWEST config early-stops, and stopping round is dominated by
    lr (mixing lr=0.1 with lr=0.01 makes the fast configs idle-run ~5x
    their needed rounds)."""
    return (p.num_leaves, p.bagging_freq if p.bagging_fraction < 1 else 0,
            p.objective, p.num_class, train_set.num_bins, p.alpha,
            p.sigmoid, p.scale_pos_weight, p.is_unbalance, p.fair_c,
            p.poisson_max_delta_step, p.learning_rate)


class SweepUnit(NamedTuple):
    """One schedulable hyper-batch: a bucket slice bound to a device
    group.  ``uid`` is content-derived (bucket key + config indices), so
    the same remaining work always maps to the same checkpoint
    directory across a kill/resume boundary."""

    uid: str
    bucket_key: tuple
    config_indices: Tuple[int, ...]
    group: int


class SweepPlan(NamedTuple):
    """The full mesh assignment for one sweep execution."""

    units: Tuple[SweepUnit, ...]
    n_devices: int
    group_size: int
    n_groups: int

    def units_for_group(self, group: int) -> List[SweepUnit]:
        return [u for u in self.units if u.group == group]

    def n_configs(self) -> int:
        return sum(len(u.config_indices) for u in self.units)


def _unit_uid(bucket_key: tuple, config_indices: Sequence[int]) -> str:
    doc = repr((tuple(bucket_key), tuple(int(i) for i in config_indices)))
    return hashlib.sha256(doc.encode()).hexdigest()[:16]


class SweepScheduler:
    """Pack pending configs into hyper-batches and spread them over the
    device mesh.

    Parameters
    ----------
    hyper_batch : int
        Max configs per fused hyper-batch (x nfold batch elements on
        device).  36 is the reference's default.
    """

    def __init__(self, hyper_batch: int = 36):
        if hyper_batch < 1:
            raise ValueError(
                f"hyper_batch must be >= 1, got {hyper_batch}")
        self.hyper_batch = int(hyper_batch)

    def plan(self, parsed: Sequence, train_set, *,
             done: Optional[Sequence[int]] = None,
             n_devices: int = 1, group_size: int = 1) -> SweepPlan:
        """Build the mesh plan for the configs not yet in the ledger.

        ``parsed`` is the full grid as Params (index-aligned with the
        ledger rows); ``done`` lists row indices to skip.  Deterministic:
        the same pending set always yields the same units, the same
        uids, and the same group assignment.
        """
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if group_size < 1 or n_devices % group_size:
            raise ValueError(
                f"group_size must be >= 1 and divide n_devices "
                f"(got group_size={group_size}, n_devices={n_devices})")
        n_groups = n_devices // group_size
        skip = set(done or ())

        buckets: Dict[tuple, List[int]] = {}
        for i, p in enumerate(parsed):
            if i in skip:
                continue
            buckets.setdefault(fused_bucket_key(p, train_set), []).append(i)

        chunks: List[Tuple[tuple, Tuple[int, ...]]] = []
        for key, idxs in sorted(buckets.items()):
            for lo in range(0, len(idxs), self.hyper_batch):
                chunks.append((key, tuple(idxs[lo:lo + self.hyper_batch])))

        # largest chunks first onto the least-loaded group (greedy LPT;
        # ties break on group index so the plan stays deterministic)
        order = sorted(range(len(chunks)),
                       key=lambda c: (-len(chunks[c][1]), c))
        load = [0] * n_groups
        group_of = {}
        for c in order:
            g = min(range(n_groups), key=lambda gi: (load[gi], gi))
            group_of[c] = g
            load[g] += len(chunks[c][1])

        units = tuple(
            SweepUnit(uid=_unit_uid(key, idxs), bucket_key=key,
                      config_indices=idxs, group=group_of[c])
            for c, (key, idxs) in enumerate(chunks))
        return SweepPlan(units=units, n_devices=int(n_devices),
                         group_size=int(group_size), n_groups=n_groups)
