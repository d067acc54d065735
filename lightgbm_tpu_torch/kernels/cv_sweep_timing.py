"""End-to-end times of the sweep and ``cv()`` paths on the card, to hold two
versions of the package against each other in turns.

    python3 lightgbm_tpu_torch/kernels/cv_sweep_timing.py [--package DIR]

After one untimed run of each path (the warm-up), each path runs twice in
this process:

- ``sweep``: ``chip_smoke.py`` phase 8c, ``run_grid_search`` over the 36
  learning_rate=0.1 rows of ``examples/gridsearch_cv.py``'s grid on the
  diamonds training split (bf16 histograms, 5 folds, early stopping 5):
  seconds and configs per hour;
- ``ns_cv``: phase 10, ``cv()`` at the north star (``make_higgs_like``
  1,000,000 x 28, 127 leaves, 255 bins, 5 folds, 20 rounds): seconds per
  round;
- ``carry``: phase 13c's uninterrupted sweep (the 12 configs of the
  num_leaves 31, learning_rate 0.1 bucket of ``paramGrid.json``'s axes,
  segments of 25 rounds) without carry checkpoints and with them
  (``checkpoint_dir``), in turns: the checkpoints' cost.  A version that
  refuses ``checkpoint_dir`` times the first alone.

``--package DIR`` times the ``lightgbm_tpu_torch`` under ``DIR`` (a parent
unpacked with ``git archive``); run versions in turns (old, new, new, old)
in one call to the card.  One JSON line per timed run, ``RESULT {...}``
last.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SWEEP_SEED, CV_ROUNDS, CV_FOLDS, CV_ES = 3928272, 1000, 5, 5
NS_SEED, NS_ROWS, NS_FEATURES, NS_ROUNDS = 20261016, 1_000_000, 28, 20
NS_PARAMS = {"objective": "binary", "num_leaves": 127, "learning_rate": 0.1,
             "min_data_in_leaf": 20, "max_bin": 255, "verbosity": -1}
CARRY_SEGMENT_ROUNDS = 25
REPS = 2


def diamonds():
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.utils.datasets import (
        make_synthetic_diamonds, train_test_split_bernoulli)

    X, y, _ = make_synthetic_diamonds()
    tr, _ = train_test_split_bernoulli(len(y), p_train=0.85, seed=SWEEP_SEED)
    ds = lgb.Dataset(X[tr], label=y[tr])
    ds.construct()
    return ds


def sweep_grid():
    from lightgbm_tpu_torch.utils.sweep import expand_grid

    grid = expand_grid(learning_rate=[0.1, 0.05, 0.01],
                       num_leaves=[31, 63, 127], min_data_in_leaf=[20, 40],
                       feature_fraction=[0.8, 1.0],
                       bagging_fraction=[0.6, 0.8, 1.0], bagging_freq=[4],
                       nthread=[4])
    return [g for g in grid if g["learning_rate"] == 0.1]


def carry_grid():
    from lightgbm_tpu_torch.utils.sweep import expand_grid

    with open(os.path.join(ROOT, "paramGrid.json")) as f:
        rows = json.load(f)["rows"]
    axes = {k: sorted({r[k] for r in rows}) for k in rows[0]
            if k not in ("iteration", "score")}
    return [g for g in expand_grid(**axes)
            if g["num_leaves"] == 31 and g["learning_rate"] == 0.1]


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_sweep(ds, work):
    from lightgbm_tpu_torch.utils.sweep import run_grid_search

    grid = sweep_grid()
    path = os.path.join(work, "paramGrid_lr0.1.json")
    if os.path.exists(path):
        os.unlink(path)
    ledger, s = timed(lambda: run_grid_search(
        grid, ds, base_params={"objective": "regression", "verbosity": -1,
                               "hist_dtype": "bf16"},
        num_boost_round=CV_ROUNDS, nfold=CV_FOLDS,
        early_stopping_rounds=CV_ES, ledger_path=path, seed=SWEEP_SEED,
        verbose=False))
    if ledger.pending():
        raise SystemExit(f"sweep left rows {ledger.pending()}")
    return {"s": s, "configs_per_hour": len(grid) / s * 3600.0,
            "best_score": ledger.leaderboard()[0]["score"]}


def run_ns_cv(ds):
    import lightgbm_tpu_torch as lgb

    fit, s = timed(lambda: lgb.cv(dict(NS_PARAMS), ds,
                                  num_boost_round=NS_ROUNDS, nfold=5,
                                  early_stopping_rounds=5, seed=NS_SEED))
    rounds = min(fit.best_iter + 5, NS_ROUNDS)
    return {"s": s, "rounds": rounds, "s_per_round": s / rounds,
            "best_iter": fit.best_iter, "best_score": fit.best_score}


def run_carry(ds, work, checkpointed):
    from lightgbm_tpu_torch.sweep import SweepService

    ledger = os.path.join(work, "carry.json")
    if os.path.exists(ledger):
        os.unlink(ledger)
    kw = {"checkpoint_dir": os.path.join(work, "ck")} if checkpointed \
        else {}
    res, s = timed(lambda: SweepService(
        carry_grid(), ds,
        base_params={"objective": "regression", "verbosity": -1,
                     "cv_segment_rounds": CARRY_SEGMENT_ROUNDS},
        num_boost_round=CV_ROUNDS, nfold=CV_FOLDS,
        early_stopping_rounds=CV_ES, seed=SWEEP_SEED, ledger_path=ledger,
        clock=lambda: 0.0, **kw).run())
    if not res.completed:
        raise SystemExit(f"carry sweep did not complete: {res.error}")
    return {"s": s, "checkpointed": checkpointed}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cv_sweep_timing: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.package)
    sys.path.insert(0, root)
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.utils.datasets import make_higgs_like

    if not lgb.__file__.startswith(root):
        raise SystemExit(f"imported {lgb.__file__}, not the package under "
                         f"{root}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="cv_sweep_timing-",
                            dir=os.path.join(ROOT, "build"))
    out = {"package": root}
    try:
        dsd = diamonds()
        X, y = make_higgs_like(NS_ROWS, NS_FEATURES, seed=0)
        dsn = lgb.Dataset(X, label=y, params={"max_bin": 255})
        dsn.construct()
        runs = {"sweep": lambda: run_sweep(dsd, work),
                "ns_cv": lambda: run_ns_cv(dsn),
                "carry": lambda: run_carry(dsd, work, False),
                "carry_ck": lambda: run_carry(dsd, work, True)}
        order = ["sweep", "ns_cv", "carry"]
        try:
            runs["carry_ck"]()               # its warm-up, and the probe
            order.append("carry_ck")
        except NotImplementedError as e:
            out["carry_ck_refused"] = str(e)
        for p in order:
            if p != "carry_ck":
                runs[p]()                    # warm-up
        for rep in range(REPS):
            # carry: without, with (even reps) / with, without (odd reps)
            seq = order if rep % 2 == 0 else \
                [p for p in order if not p.startswith("carry")] + \
                [p for p in reversed(order) if p.startswith("carry")]
            for p in seq:
                row = runs[p]()
                row.update(path=p, rep=rep)
                out.setdefault(p, []).append(row)
                print(json.dumps(row), flush=True)
        for p in runs:
            if p in out:
                key = "s_per_round" if p == "ns_cv" else "s"
                vals = [r[key] for r in out[p]]
                out[f"{p}_median_{key}"] = float(np.median(vals))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print("RESULT", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
