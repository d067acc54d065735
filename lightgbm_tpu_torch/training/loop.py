"""Preemption-safe resumable training loop — the port of
``lightgbm_tpu/training/loop.py``.

``train_resumable`` wraps the per-round ``Booster.update()`` walk with the
recovery protocol a preemptible fleet assumes:

* **auto-checkpoint** every ``checkpoint_rounds`` rounds (atomic
  tmp+rename artifacts, see :mod:`.checkpoint`) plus one final
  checkpoint at completion;
* **SIGTERM drain** — a preemption notice never interrupts a round:
  the in-flight round finishes, a checkpoint is written, the previous
  handler is restored, and the loop returns cleanly with
  ``preempted=True``;
* **resume** — ``resume=True`` picks the newest VALID checkpoint in
  ``checkpoint_dir`` (falling back past torn files), and continuation
  is BIT-IDENTICAL to the uninterrupted run: every per-round random draw
  is keyed by round index, the checkpoint carries the exact
  prediction/bag state the next round consumes, and every kernel on the
  path sums in a fixed order;
* **fault hooks** — an armed :class:`~lightgbm_tpu_torch.faults.FaultInjector`
  drives the ``gradient`` site (poisons the round's input predictions so
  the finiteness screen trips) and the ``checkpoint_write`` site (a
  failed write warns and keeps training on the prior checkpoint cadence —
  checkpointing is an overhead budget, never a liveness dependency).

Training runs on the Dataset's device (the card unless the caller built the
Dataset with ``device="cpu"``); a checkpoint write copies the round state to
the host.
"""

from __future__ import annotations

import signal
import warnings
from typing import Callable, List, NamedTuple, Optional

from ..faults import FaultError
from .checkpoint import load_latest, resume_booster, save_checkpoint


class TrainResult(NamedTuple):
    """What came out of a resumable training session."""

    booster: object
    completed: bool            # reached num_boost_round
    preempted: bool            # SIGTERM drained mid-run
    rounds_done: int           # booster iteration at exit
    resumed_from: Optional[str]      # checkpoint or init_model path
    last_checkpoint: Optional[str]   # newest checkpoint written/seen
    checkpoint_failures: int   # writes lost to injected/real faults


class PreemptionGuard:
    """Scoped SIGTERM latch: the handler only records the request; the
    training loop (and the sweep) polls ``requested`` at round and segment
    boundaries, so the round in flight always completes.  Restores the
    previous handler on exit.

    Reentrant: a sweep holds ONE guard across a whole grid while each
    training re-enters it through ``train_resumable(guard=...)`` — the
    handler installs at depth 0 and restores at depth 0, and one latched
    SIGTERM drains every nesting level."""

    def __init__(self, signum: int = signal.SIGTERM):
        self.signum = signum
        self.requested = False
        self._prev = None
        self._depth = 0

    def __enter__(self) -> "PreemptionGuard":
        if self._depth == 0:
            def _on_term(signo, frame):
                self.requested = True

            self._prev = signal.signal(self.signum, _on_term)
        self._depth += 1
        return self

    def __exit__(self, *exc) -> None:
        self._depth -= 1
        if self._depth == 0:
            signal.signal(self.signum, self._prev)
            self._prev = None
        return None


def train_resumable(
    params,
    train_set,
    num_boost_round: int,
    *,
    checkpoint_dir: str,
    checkpoint_rounds: int = 10,
    keep_last: int = 2,
    resume: bool = True,
    injector=None,
    round_callbacks: Optional[List[Callable]] = None,
    finite_screen: bool = True,
    init_model: Optional[str] = None,
    guard: Optional[PreemptionGuard] = None,
) -> TrainResult:
    """Train with checkpoint/resume + preemption drain; see module doc.

    ``round_callbacks`` run after every completed round as
    ``cb(booster, round_index)`` — the chaos tests use one to deliver a
    real SIGTERM at an exact round.  ``resume`` may also be a checkpoint
    path to pin the exact artifact to resume from.

    ``guard`` shares an outer :class:`PreemptionGuard` (it is reentrant):
    a SIGTERM latched anywhere in an enclosing sweep drains this training
    too, and one already latched BEFORE this call makes the run drain at
    its first round boundary instead of being missed.

    ``init_model`` seeds the run by CONTINUING a saved model file (the
    JSON text model or a packed ``.npz``) when no checkpoint exists yet:
    a generation trains on from the model of the one before, while a
    preemption mid-generation still resumes from this generation's own
    checkpoints, which take precedence (they carry the exact round
    state).  The params come from the model file; the offered Dataset
    must be binned as the model was.
    """
    from ..config import parse_params
    from ..models.gbdt import Booster

    if checkpoint_rounds <= 0:
        raise ValueError(
            f"checkpoint_rounds must be positive, got {checkpoint_rounds}")

    booster = None
    resumed_from = None
    last_checkpoint = None
    if resume:
        if isinstance(resume, str):
            booster = resume_booster(resume, train_set, params=params)
            resumed_from = last_checkpoint = resume
        else:
            path, found = load_latest(checkpoint_dir)
            for rej_path, why in found["rejected"]:
                warnings.warn(
                    f"skipping corrupt checkpoint {rej_path}: {why}")
            if path is not None:
                booster = resume_booster(
                    (found["arrays"], found["meta"]), train_set,
                    params=params)
                resumed_from = last_checkpoint = path
    if booster is None and init_model is not None:
        booster = Booster(model_file=init_model, device=train_set.device)
        booster._attach_continuation(train_set)
        resumed_from = init_model
    if booster is None:
        p = params if not isinstance(params, dict) else parse_params(params)
        booster = Booster(p, train_set)

    ckpt_failures = 0

    def _try_checkpoint() -> None:
        nonlocal last_checkpoint, ckpt_failures
        try:
            last_checkpoint = save_checkpoint(
                booster, checkpoint_dir, injector=injector,
                keep_last=keep_last)
        except (FaultError, OSError) as e:
            # the tmp+rename protocol already guaranteed the prior
            # checkpoint is intact; losing one write costs at most
            # checkpoint_rounds rounds of redo, never the run
            ckpt_failures += 1
            warnings.warn(f"checkpoint write failed (prior checkpoint "
                          f"kept): {e}")

    preempted = False
    guard = guard if guard is not None else PreemptionGuard()
    with guard:
        while booster._iter < num_boost_round:
            i = booster._iter
            if injector is not None:
                try:
                    injector.check("gradient")
                except FaultError:
                    # model an upstream corruption of the round inputs:
                    # poison the predictions and let the screen (not the
                    # grower) be what stops the run
                    booster._pred_train = booster._pred_train * float("nan")
            if finite_screen:
                booster._screen_finite(i)
            booster.update()
            for cb in round_callbacks or ():
                cb(booster, i)
            if booster._iter % checkpoint_rounds == 0 \
                    and booster._iter < num_boost_round:
                _try_checkpoint()
            if guard.requested:
                preempted = True
                break

    _try_checkpoint()
    completed = booster._iter >= num_boost_round
    return TrainResult(
        booster=booster, completed=completed, preempted=preempted,
        rounds_done=int(booster._iter), resumed_from=resumed_from,
        last_checkpoint=last_checkpoint,
        checkpoint_failures=ckpt_failures)
