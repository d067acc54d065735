"""Config-file CLI of the port: ``task=train``, ``task=predict``,
``task=serve``, ``task=refresh`` and ``task=sweep`` — the port of
``lightgbm_tpu/__main__.py`` (LightGBM's original ``key=value`` interface):

    python -m lightgbm_tpu_torch task=train data=train.csv valid=valid.csv \
        objective=regression num_trees=100 output_model=model.txt
    python -m lightgbm_tpu_torch task=predict data=test.csv \
        input_model=model.txt output_result=preds.txt
    python -m lightgbm_tpu_torch task=serve input_model=model.npz \
        max_batch=256 max_delay_ms=2 < requests.csv > preds.txt
    python -m lightgbm_tpu_torch task=sweep data=train.csv \
        sweep_grid=grid.json ledger=paramGrid.RData
    python -m lightgbm_tpu_torch task=refresh watch_dir=blocks/ \
        state_dir=state/ objective=binary refresh_rounds=5
    python -m lightgbm_tpu_torch lint [paths...] [--budgets]

Config format: one ``key = value`` per line, ``#`` comments; command-line
``key=value`` pairs override a ``config=`` file.

``task=train`` and ``task=predict`` read CSV/TSV files (the delimiter
sniffed from the first line; ``NA``/``NaN``/empty cells are NaN) with
``header=true|false`` (default false), ``label_column=<int>`` (default 0)
or ``label_column=name:<col>``; ``valid=`` takes a comma-separated list of
files.  ``train`` writes ``output_model`` (default ``LightGBM_model.txt``;
a ``.npz`` suffix writes the packed model), ``predict`` writes
``output_result`` (default ``LightGBM_predict_result.txt``), dropping the
label column of a labelled file.  The remaining keys are the LightGBM
params (``hist_dtype=int8`` trains on quantized histograms).  Model files
interchange with the reference's CLI both ways.  ``device=cuda|cpu``
(default cuda; with no card, cuda fails at startup) picks the device of
every task.

Fault-tolerant training (``task=train``): ``checkpoint_dir=`` turns on the
resumable loop (``training.train_resumable``) — atomic checkpoints every
``checkpoint_rounds`` rounds (default 10), ``checkpoint_keep`` generations
kept (default 2), and ``resume=true|false`` (default true) picks up the
newest valid checkpoint.  A SIGTERM finishes the round in flight, writes a
checkpoint, prints "preempted" and exits 0, so a scheduler simply reruns the
same command line; the rerun's model file equals an uninterrupted run's.

``task=sweep`` runs (or resumes) a hyperparameter sweep over a CSV/TSV
training file through ``SweepService``: ``sweep_grid=<grid.json>``
(``{"axes": {...}}`` expands R's ``expand.grid`` order, ``{"rows": [...]}``
or a bare list is the explicit row set), ``ledger=`` (``.RData`` or JSON,
resumable), ``sweep_checkpoint_dir=`` (per-hyper-batch carry checkpoints),
``nfold`` (5), ``early_stopping_rounds`` (5), ``hyper_batch`` (36),
``seed`` (0), ``top`` (10), ``engine=auto|fused|host``; the remaining keys
are the params every config shares (unknown keys exit by name).  The
leaderboard goes to stdout as JSON lines, a summary to stderr; a preempted
sweep exits 0 and resumes on rerun.  ``sweep_devices``/``sweep_group_size``
(the mesh shape; the group size must divide the devices) plan the
hyper-batches over device groups, recorded in each ledger row's ``group``;
the units run one after another, as the reference's do.

``task=refresh`` drives the refresh daemon (``pipeline.RefreshDaemon``) over
a watch directory of ``.npz`` blocks (``X``, ``y``; ``.tmp`` names are
skipped until renamed): ``watch_dir=`` and ``state_dir=`` are required;
``refresh_rounds`` (5), ``initial_rounds``, ``checkpoint_rounds`` (5),
``canary_rows`` (8), ``max_ticks`` (64), ``model_name``,
``staleness_slo_ms``, and the retune keys ``sweep_grid=``, ``sweep_every``
(0), ``sweep_rounds`` (50), ``sweep_nfold`` (3), ``sweep_early_stopping``
(5), ``sweep_devices`` (1); the remaining keys are the training params
(unknown keys exit by name).  One invocation drains the directory and
exits, one JSON event a line on stdout and a summary on stderr; rerunning
the same command line re-anchors on the newest artifact in ``state_dir``.

``lint`` runs graftlint's backend-neutral rules over the port
(``analysis.cli``; ``--budgets`` adds the launch budgets).

``task=serve`` (alias ``predict-server``) loads a packed ``.npz`` model or a
JSON text model, packed on load (written by either package), builds the
ModelBank-backed PredictorRuntime + micro-batching queue and serves
newline-delimited requests from stdin to
stdout — one CSV row (or JSON array) of features in, one prediction out, no
network dependency.  Keys are the reference's (``output_format``,
``raw_score``, ``num_iteration``, ``request_timeout_ms``, ``show_stats``,
``max_bucket``, ``max_cache_entries``, ``warm_buckets``,
``max_queue_depth``, ``shed_policy``, ``canary_rows``,
``compile_cache_dir`` (a no-op here), ``mesh_devices`` (a power of two:
the serving mesh over the visible CUDA devices, or over
``LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES`` virtual shards of one),
``shard_policy``, ``forest_precision``).  ``!swap <model>`` (either kind) /
``!rollback`` / ``!stats`` request lines are control commands (acks on
stderr); SIGTERM drains gracefully; a kernel that fails to build or launch
stops the server with a non-zero exit.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np


def parse_config_text(text: str) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"config line without '=': {line!r}")
        k, v = line.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def parse_argv(argv: List[str]) -> Dict[str, str]:
    """``key=value`` pairs; a ``config=`` file loads first, CLI overrides."""
    pairs: Dict[str, str] = {}
    for a in argv:
        if "=" not in a:
            raise ValueError(f"expected key=value, got {a!r}")
        k, v = a.split("=", 1)
        pairs[k.strip()] = v.strip()
    cfg: Dict[str, str] = {}
    if "config" in pairs:
        with open(pairs.pop("config")) as f:
            cfg = parse_config_text(f.read())
    cfg.update(pairs)
    return cfg


def _load_table(path: str, header: bool) -> Tuple[np.ndarray, List[str]]:
    import csv

    with open(path) as f:
        sample = f.read(4096)
        f.seek(0)
        delim = "\t" if "\t" in sample.split("\n", 1)[0] else ","
        rows = list(csv.reader(f, delimiter=delim))
    names: List[str] = []
    if header:
        names = rows[0]
        rows = rows[1:]
    data = np.asarray(
        [[np.nan if c in ("", "NA", "na", "NaN") else float(c) for c in r]
         for r in rows if r], dtype=np.float64)
    return data, names


def _split_label(data: np.ndarray, names: List[str],
                 label_spec: str) -> Tuple[np.ndarray, np.ndarray]:
    if label_spec.startswith("name:"):
        col = names.index(label_spec[5:])
    else:
        col = int(label_spec)
    return np.delete(data, col, axis=1), data[:, col]


def main(argv: Optional[List[str]] = None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    if raw and raw[0] == "lint":
        # graftlint front end: flag-style argv, not key=value config
        from .analysis.cli import main as lint_main

        return lint_main(raw[1:])
    try:
        cfg = parse_argv(raw)
    except (ValueError, OSError) as e:
        raise SystemExit(
            f"lightgbm_tpu_torch: {e}\nusage: python -m lightgbm_tpu_torch "
            "task=train|predict|serve|refresh|sweep key=value ... "
            "(or config=<file>; see module docs)") from None
    task = cfg.pop("task", "train")
    input_model = cfg.pop("input_model", None)
    if task in ("serve", "predict-server"):
        if input_model is None:
            raise SystemExit("task=serve requires input_model=<model.npz "
                             "or model.txt>")
        return _serve(input_model, cfg)
    if task not in ("train", "predict", "refresh", "sweep"):
        raise SystemExit(
            f"unknown task {task!r} (train|predict|serve|refresh|sweep)")
    header = cfg.pop("header", "false").lower() in ("true", "1", "yes")
    label_spec = cfg.pop("label_column", "0")
    data_path = cfg.pop("data", None)
    valid_path = cfg.pop("valid", cfg.pop("valid_data", None))
    output_model = cfg.pop("output_model", "LightGBM_model.txt")
    output_result = cfg.pop("output_result", "LightGBM_predict_result.txt")
    if task == "refresh":
        return _refresh(cfg)
    device = cfg.pop("device", "cuda")
    if device not in ("cuda", "cpu"):
        raise SystemExit(f"task={task}: device must be cuda|cpu, got "
                         f"{device!r}")
    if task == "sweep":
        return _sweep(cfg, data_path, header, label_spec, device)
    if task == "train":
        if data_path is None:
            raise SystemExit("task=train requires data=<file>")
        return _train(cfg, data_path, valid_path, header, label_spec,
                      output_model, device)
    if data_path is None or input_model is None:
        raise SystemExit(
            "task=predict requires data=<file> input_model=<model>")
    return _predict(data_path, input_model, header, label_spec,
                    output_result, device)


def _train(params: Dict[str, str], data_path: str, valid_path, header: bool,
           label_spec: str, output_model: str, device: str) -> int:
    """Train on a CSV/TSV file; the remaining keys are the params (``train``
    resolves every num-rounds alias from them).  With ``checkpoint_dir=``
    the run goes through the resumable loop."""
    import lightgbm_tpu_torch as lgb

    from .device import NoDeviceError

    ckpt_dir = params.pop("checkpoint_dir", None)
    data, names = _load_table(data_path, header)
    X, y = _split_label(data, names, label_spec)
    try:
        dtrain = lgb.Dataset(X, label=y, device=device)
    except NoDeviceError as e:
        raise SystemExit(f"task=train: {e}") from None
    if ckpt_dir:
        return _train_resumable(dict(params), dtrain, ckpt_dir, output_model)
    valid_sets = None
    if valid_path:
        valid_sets = []
        for vp in valid_path.split(","):            # upstream: comma list
            vdata, vnames = _load_table(vp.strip(), header)
            Xv, yv = _split_label(vdata, vnames, label_spec)
            valid_sets.append(lgb.Dataset(Xv, label=yv, reference=dtrain))
    booster = lgb.train(dict(params), dtrain, valid_sets=valid_sets)
    booster.save_model(output_model)
    print(f"[lightgbm_tpu_torch] finished training; model -> {output_model}")
    return 0


def _int_key(cfg: Dict[str, str], name: str, default: str, minimum: int,
             task: str) -> int:
    """Pop the integer key ``name`` from ``cfg``: a typed one-line exit
    when it is not an integer or is below ``minimum``."""
    raw_v = cfg.pop(name, default)
    try:
        v = int(raw_v)
    except ValueError:
        raise SystemExit(f"task={task}: {name} must be an integer, got "
                         f"{raw_v!r}") from None
    if v < minimum:
        raise SystemExit(f"task={task}: {name} must be >= {minimum}, "
                         f"got {v}")
    return v


def _train_resumable(params: Dict[str, str], dtrain, ckpt_dir: str,
                     output_model: str) -> int:
    """``task=train checkpoint_dir=``: auto-checkpoint + SIGTERM drain +
    resume; a preempted run exits 0 with the checkpoint noted so a
    scheduler can simply rerun the same command line."""
    from .engine import _resolve_num_rounds
    from .training import train_resumable

    ckpt_rounds = _int_key(params, "checkpoint_rounds", "10", 1, "train")
    keep_last = _int_key(params, "checkpoint_keep", "2", 0, "train")
    resume = str(params.pop("resume", "true")).lower() in ("true", "1",
                                                            "yes")
    rounds = _resolve_num_rounds(params, 100)
    result = train_resumable(params, dtrain, rounds, checkpoint_dir=ckpt_dir,
                             checkpoint_rounds=ckpt_rounds,
                             keep_last=keep_last, resume=resume)
    if result.resumed_from:
        print(f"[lightgbm_tpu_torch] resumed from {result.resumed_from}",
              flush=True)
    if result.preempted:
        print(f"[lightgbm_tpu_torch] preempted at round {result.rounds_done}"
              f"/{rounds}; state -> {result.last_checkpoint} (rerun to "
              "resume)", flush=True)
        return 0
    result.booster.save_model(output_model)
    print(f"[lightgbm_tpu_torch] finished training; model -> {output_model}")
    return 0


def _refresh(cfg: Dict[str, str], stdout=None, stderr=None) -> int:
    """``task=refresh``: drive the refresh daemon over a watch directory.
    Every refresh key is validated up front and unknown keys are rejected
    (the ``serve`` contract): a typo'd operating point fails at startup,
    not mid-refresh; the keys left over after the refresh set must belong
    to the parameter vocabulary.  One invocation drains the watch
    directory (bounded by ``max_ticks``) and exits; schedulers keep the
    loop alive by rerunning the same command line — the daemon re-anchors
    on the newest completed artifact in ``state_dir``.  ``device=`` picks
    the device as in the other tasks (default cuda)."""
    import json

    from .config import _ALIASES, _FRAMEWORK_KEYS
    from .device import NoDeviceError
    from .pipeline import DirectoryFeed, RefreshDaemon

    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr

    def die(msg: str) -> "SystemExit":
        return SystemExit(f"task=refresh: {msg}")

    def intkey(key: str, default: str, minimum: int):
        raw_v = cfg.pop(key, default)
        if raw_v is None:
            return None
        try:
            v = int(raw_v)
        except ValueError:
            raise die(f"{key} must be an integer, got {raw_v!r}") \
                from None
        if v < minimum:
            raise die(f"{key} must be >= {minimum}, got {v}")
        return v

    watch_dir = cfg.pop("watch_dir", None)
    if not watch_dir:
        raise die("requires watch_dir=<directory of X/y .npz blocks>")
    state_dir = cfg.pop("state_dir", None)
    if not state_dir:
        raise die("requires state_dir=<directory for models/checkpoints>")
    refresh_rounds = intkey("refresh_rounds", "5", 1)
    initial_rounds = intkey("initial_rounds", None, 1)
    checkpoint_rounds = intkey("checkpoint_rounds", "5", 1)
    canary_rows = intkey("canary_rows", "8", 0)
    max_ticks = intkey("max_ticks", "64", 1)
    model_name = cfg.pop("model_name", "model")
    # the closed tune->serve loop: every sweep_every'th data-bearing
    # generation sweeps the grid and promotes the winner
    grid_path = cfg.pop("sweep_grid", None)
    sweep_grid = None
    if grid_path is not None:
        sweep_grid = _load_grid(grid_path, die)
    sweep_every = intkey("sweep_every", "0", 0)
    if sweep_every > 0 and sweep_grid is None:
        raise die("sweep_every > 0 requires sweep_grid=<grid.json>")
    sweep_rounds = intkey("sweep_rounds", "50", 1)
    sweep_nfold = intkey("sweep_nfold", "3", 2)
    sweep_early_stopping = intkey("sweep_early_stopping", "5", 0)
    sweep_devices = intkey("sweep_devices", "1", 1)
    slo_s = cfg.pop("staleness_slo_ms", None)
    staleness_slo_ms = None
    if slo_s is not None:
        try:
            staleness_slo_ms = float(slo_s)
        except ValueError:
            raise die(f"staleness_slo_ms must be a number, got "
                      f"{slo_s!r}") from None
        if staleness_slo_ms <= 0:
            raise die(f"staleness_slo_ms must be > 0, got "
                      f"{staleness_slo_ms}")
    device = cfg.pop("device", "cuda")
    if device not in ("cuda", "cpu"):
        raise die(f"device must be cuda|cpu, got {device!r}")
    unknown = sorted(k for k in cfg
                     if k.lower() not in _ALIASES
                     and k.lower() not in _FRAMEWORK_KEYS)
    if unknown:
        raise die(f"unknown key(s): {', '.join(unknown)}")

    try:
        daemon = RefreshDaemon(
            dict(cfg), state_dir, feed=DirectoryFeed(watch_dir),
            model_name=model_name, refresh_rounds=refresh_rounds,
            initial_rounds=initial_rounds,
            checkpoint_rounds=checkpoint_rounds,
            staleness_slo_ms=staleness_slo_ms, canary_rows=canary_rows,
            sweep_grid=sweep_grid, sweep_every=sweep_every,
            sweep_rounds=sweep_rounds, sweep_nfold=sweep_nfold,
            sweep_early_stopping=sweep_early_stopping,
            sweep_devices=sweep_devices, device=device)
    except NoDeviceError as e:
        raise die(str(e)) from None
    events = daemon.run_until_idle(max_ticks=max_ticks)
    for ev in events:
        doc = {k: v for k, v in ev.items() if k != "report"}
        stdout.write(json.dumps(doc) + "\n")
    snap = daemon.tracker.snapshot()
    stderr.write(json.dumps({
        "generation": daemon.snapshot()["generation"],
        "served": snap["served"],
        "worst_staleness_ms": snap["worst_staleness_ms"],
        "breaches": snap["breaches"],
    }) + "\n")
    stdout.flush()
    stderr.flush()
    return 0


def _load_grid(path: str, die) -> list:
    """Load a sweep grid from a JSON file: ``{"axes": {...}}`` expands
    the cartesian product (R ``expand.grid`` order), ``{"rows": [...]}``
    or a bare list of objects is the explicit row set.  Every misuse is
    a typed one-line error through ``die``."""
    import json

    from .sweep import expand_grid

    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise die(f"sweep_grid file unreadable: {e}") from None
    except json.JSONDecodeError as e:
        raise die(f"sweep_grid is not valid JSON: {e}") from None
    if isinstance(doc, dict) and "axes" in doc:
        axes = doc["axes"]
        if not isinstance(axes, dict) or not axes or \
                not all(isinstance(v, list) and v for v in axes.values()):
            raise die('sweep_grid "axes" must map param names to '
                      "non-empty lists of values")
        return expand_grid(**axes)
    rows = doc.get("rows") if isinstance(doc, dict) else doc
    if not isinstance(rows, list) or not rows or \
            not all(isinstance(r, dict) for r in rows):
        raise die('sweep_grid must be {"axes": {...}}, {"rows": [...]}, '
                  "or a JSON list of config objects")
    return [dict(r) for r in rows]


def _sweep(cfg: Dict[str, str], data_path: Optional[str], header: bool,
           label_spec: str, device: str = "cuda", stdout=None,
           stderr=None) -> int:
    """``task=sweep``: run (or resume) a standalone hyperparameter sweep
    over a CSV/TSV training file through ``SweepService`` — hyper-batches
    on the fused-CV program, per-hyper-batch carry checkpoints, a
    crash-safe resumable ledger and a leaderboard on stdout.  Every sweep
    key is checked up front with a typed one-line error, unknown keys are
    rejected against the parameter vocabulary, and a preemption exits 0
    with the resume instruction."""
    import json

    from .config import _ALIASES, _FRAMEWORK_KEYS
    from .engine import _resolve_num_rounds

    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr

    def die(msg: str) -> "SystemExit":
        return SystemExit(f"task=sweep: {msg}")

    if data_path is None:
        raise die("requires data=<train file>")
    grid_path = cfg.pop("sweep_grid", None)
    if not grid_path:
        raise die('requires sweep_grid=<grid.json> ({"axes": {...}}, '
                  '{"rows": [...]}, or a list of config objects)')
    grid = _load_grid(grid_path, die)
    sweep_devices = _int_key(cfg, "sweep_devices", "1", 1, "sweep")
    sweep_group_size = _int_key(cfg, "sweep_group_size", "1", 1, "sweep")
    if sweep_devices % sweep_group_size:
        raise die(f"sweep_group_size must divide sweep_devices (got "
                  f"group_size={sweep_group_size}, "
                  f"devices={sweep_devices})")
    ckpt_dir = cfg.pop("sweep_checkpoint_dir", None)
    if ckpt_dir is not None and not str(ckpt_dir).strip():
        raise die("sweep_checkpoint_dir must be a directory path")
    ledger_path = cfg.pop("ledger", None)
    nfold = _int_key(cfg, "nfold", "5", 2, "sweep")
    early_stopping = _int_key(cfg, "early_stopping_rounds", "5", 0, "sweep")
    hyper_batch = _int_key(cfg, "hyper_batch", "36", 1, "sweep")
    seed = _int_key(cfg, "seed", "0", 0, "sweep")
    top = _int_key(cfg, "top", "10", 1, "sweep")
    engine = cfg.pop("engine", "auto")
    if engine not in ("auto", "fused", "host"):
        raise die(f"engine must be auto|fused|host, got {engine!r}")
    unknown = sorted(k for k in cfg
                     if k.lower() not in _ALIASES
                     and k.lower() not in _FRAMEWORK_KEYS)
    if unknown:
        raise die(f"unknown key(s): {', '.join(unknown)}")
    params = dict(cfg)
    rounds = _resolve_num_rounds(params, 100)

    import lightgbm_tpu_torch as lgb

    from .device import NoDeviceError
    from .sweep import SweepService

    data, names = _load_table(data_path, header)
    X, y = _split_label(data, names, label_spec)
    try:
        dtrain = lgb.Dataset(X, label=y, device=device)
    except NoDeviceError as e:
        raise die(str(e)) from None
    service = SweepService(
        grid, dtrain, base_params=params,
        num_boost_round=rounds, nfold=nfold,
        early_stopping_rounds=early_stopping, seed=seed, engine=engine,
        ledger_path=ledger_path, checkpoint_dir=ckpt_dir,
        n_devices=sweep_devices, group_size=sweep_group_size,
        hyper_batch=hyper_batch, verbose=True)
    result = service.run()
    if result.preempted:
        pend = len(result.ledger.pending())
        stderr.write(f"[lightgbm_tpu_torch] sweep preempted "
                     f"({result.error}); {pend}/{len(grid)} configs pending "
                     "— rerun the same command line to resume\n")
        stderr.flush()
        return 0
    for row in result.ledger.leaderboard()[:top]:
        stdout.write(json.dumps(row) + "\n")
    stderr.write(json.dumps({
        "engine": result.engine, "units": result.units_total,
        "resumed_units": result.resumed_units,
        "configs": len(grid),
        "rounds_total": result.stats.get("rounds_total", 0),
    }) + "\n")
    stdout.flush()
    stderr.flush()
    return 0


def _predict(data_path: str, input_model: str, header: bool,
             label_spec: str, output_result: str, device: str) -> int:
    import lightgbm_tpu_torch as lgb

    from .device import NoDeviceError

    data, names = _load_table(data_path, header)
    try:
        booster = lgb.Booster(model_file=input_model, device=device)
    except NoDeviceError as e:
        raise SystemExit(f"task=predict: {e}") from None
    if data.shape[1] == booster.num_feature() + 1:
        # labelled file: drop the label column like upstream predict
        X, _ = _split_label(data, names, label_spec)
    else:
        X = data
    np.savetxt(output_result, booster.predict(X), fmt="%.10g")
    print(f"[lightgbm_tpu_torch] predictions -> {output_result}")
    return 0


def _parse_request_line(line: str) -> Optional[np.ndarray]:
    """One request: CSV floats or a JSON array; blank/comment -> None."""
    line = line.strip()
    if not line or line.startswith("#"):
        return None
    if line.startswith("["):
        import json

        return np.asarray(json.loads(line), dtype=np.float64)
    return np.asarray(
        [np.nan if c.strip() in ("", "NA", "na", "NaN") else float(c)
         for c in line.split(",")], dtype=np.float64)


_SERVE_MODEL = "default"        # single-tenant CLI name in the ModelBank


def _serve(input_model: str, cfg: Dict[str, str],
           stdin=None, stdout=None, stderr=None) -> int:
    """Micro-batched stdin/stdout serving loop (no network dependency).

    Reads one request per line, coalesces through MicroBatcher, answers
    in submission order.  Separated from main() with injectable streams
    so the loop is Tier-1-testable in-process.

    The model lives in a ModelBank, so lines starting with ``!`` are
    control commands (acks on stderr, so the prediction stream stays
    clean): ``!swap <model>`` hot-swaps to a new artifact (``.npz``, or
    a text model packed on load)
    (validate -> warm -> canary -> atomic flip; a rejected swap leaves
    the current version serving), ``!rollback`` flips back to the
    previous resident version, ``!stats`` prints a stats snapshot.

    SIGTERM drains gracefully: stop admitting, flush in-flight requests,
    emit a final stats snapshot on stderr.
    """
    import json
    import signal

    from .device import NoDeviceError
    from .kernels import KernelError
    from .serving import (FOREST_PRECISIONS, SHARD_POLICIES, SHED_POLICIES,
                          ModelBank, SwapRejected)

    stdin = sys.stdin if stdin is None else stdin
    stdout = sys.stdout if stdout is None else stdout
    stderr = sys.stderr if stderr is None else stderr

    def flag(key: str, default: bool = False) -> bool:
        return cfg.pop(key, str(default)).lower() in ("true", "1", "yes")

    def die(msg: str) -> "SystemExit":
        return SystemExit(f"task=serve: {msg}")

    max_batch = int(cfg.pop("max_batch", "128"))
    max_delay_ms = float(cfg.pop("max_delay_ms", "2"))
    max_bucket = int(cfg.pop("max_bucket", "16384"))
    max_cache = int(cfg.pop("max_cache_entries", "12"))
    out_format = cfg.pop("output_format", "csv")
    raw_score = flag("raw_score")
    show_stats = flag("show_stats")
    warm_buckets = flag("warm_buckets")
    tmo = cfg.pop("request_timeout_ms", None)
    timeout_ms = None if tmo is None else float(tmo)
    num_it = cfg.pop("num_iteration", None)
    num_iteration = None if num_it is None else int(num_it)
    # -- resilience knobs, validated up front: a typo'd operating
    # -- point fails the process at startup, not under load
    depth_s = cfg.pop("max_queue_depth", "none").lower()
    try:
        max_queue_depth = None if depth_s in ("none", "") else int(depth_s)
    except ValueError:
        raise die(f"max_queue_depth must be an integer or 'none', "
                  f"got {depth_s!r}") from None
    if max_queue_depth is not None and max_queue_depth < 1:
        raise die(f"max_queue_depth must be >= 1, got {max_queue_depth}")
    shed_policy = cfg.pop("shed_policy", "deadline")
    if shed_policy not in SHED_POLICIES:
        raise die(f"shed_policy must be one of {'|'.join(SHED_POLICIES)},"
                  f" got {shed_policy!r}")
    try:
        canary_rows = int(cfg.pop("canary_rows", "8"))
    except ValueError:
        raise die("canary_rows must be an integer") from None
    if canary_rows < 0:
        raise die(f"canary_rows must be >= 0, got {canary_rows}")
    cache_dir = cfg.pop("compile_cache_dir", None)
    device = cfg.pop("device", "cuda")
    if device not in ("cuda", "cpu"):
        raise die(f"device must be cuda|cpu, got {device!r}")
    try:
        mesh_devices = int(cfg.pop("mesh_devices", "1"))
    except ValueError:
        raise die("mesh_devices must be an integer") from None
    if mesh_devices < 1 or (mesh_devices & (mesh_devices - 1)):
        raise die(f"mesh_devices must be a power of two >= 1, "
                  f"got {mesh_devices}")
    shard_policy = cfg.pop("shard_policy", "auto")
    if shard_policy not in SHARD_POLICIES:
        raise die(f"shard_policy must be one of "
                  f"{'|'.join(SHARD_POLICIES)}, got {shard_policy!r}")
    forest_precision = cfg.pop("forest_precision", "f32")
    if forest_precision not in FOREST_PRECISIONS:
        raise die(f"forest_precision must be one of "
                  f"{'|'.join(FOREST_PRECISIONS)}, got "
                  f"{forest_precision!r}")
    if cfg:
        raise die(f"unknown key(s): {', '.join(sorted(cfg))}")

    try:
        bank = ModelBank(max_bucket=max_bucket, max_cache_entries=max_cache,
                         warm_on_deploy=warm_buckets,
                         canary_rows=canary_rows, cache_dir=cache_dir,
                         mesh_devices=mesh_devices, shard_policy=shard_policy,
                         forest_precision=forest_precision, device=device)
    except NoDeviceError as e:
        raise die(str(e)) from None
    if mesh_devices > 1:
        from .parallel.mesh import visible_devices

        have = len(visible_devices(bank.device))
        if have < mesh_devices:
            raise die(f"mesh_devices={mesh_devices} needs {mesh_devices} "
                      f"devices, {have} visible; set "
                      f"LIGHTGBM_TPU_TORCH_VIRTUAL_DEVICES={mesh_devices} "
                      "for virtual shards on one device")

    def deploy(path: str) -> dict:
        if path.endswith(".npz"):
            return bank.deploy(_SERVE_MODEL, path, raw_score=raw_score)
        # a JSON text model is packed on load, as the reference does
        from .models.gbdt import Booster
        from .serving import pack_booster

        try:
            packed = pack_booster(Booster(model_file=path, device="cpu"))
        except (OSError, ValueError, KeyError) as e:
            raise SwapRejected("ingest", f"{path}: {e}") from None
        return bank.deploy(_SERVE_MODEL, packed, raw_score=raw_score)

    try:
        rep = deploy(input_model)
    except SwapRejected as e:
        raise die(f"input_model rejected: {e}") from None
    except KernelError as e:
        raise die(f"kernel failure, serving not started: {e}") from e
    if warm_buckets:
        # the ladder ran inside deploy(), before the first request
        stderr.write(f"[lightgbm_tpu] warmed {rep['warmed']} bucket "
                     f"programs\n")
        stderr.flush()
    batcher = bank.batcher(_SERVE_MODEL, max_batch=max_batch,
                           max_delay_ms=max_delay_ms,
                           timeout_ms=timeout_ms, raw_score=raw_score,
                           max_queue_depth=max_queue_depth,
                           shed_policy=shed_policy)
    stats = batcher.stats

    def emit(pending) -> None:
        try:
            v = pending.result()
        except Exception as e:                    # noqa: BLE001
            stdout.write(f"ERROR: {type(e).__name__}: {e}\n")
            return
        v = np.atleast_1d(np.asarray(v, np.float64))
        if out_format == "json":
            stdout.write(json.dumps(
                v.tolist() if v.size > 1 else float(v[0])) + "\n")
        else:
            stdout.write(",".join(f"{x:.10g}" for x in v) + "\n")

    def control(line: str) -> None:
        parts = line[1:].split()
        cmd = parts[0] if parts else ""
        try:
            if cmd == "swap" and len(parts) == 2:
                r = deploy(parts[1])
                stderr.write(f"[lightgbm_tpu] swapped {_SERVE_MODEL} -> "
                             f"{r['version']}\n")
            elif cmd == "rollback":
                r = bank.rollback(_SERVE_MODEL)
                stderr.write(f"[lightgbm_tpu] rolled back {_SERVE_MODEL} "
                             f"-> {r['version']}\n")
            elif cmd == "stats":
                stderr.write(json.dumps(stats.snapshot()) + "\n")
            else:
                stderr.write(f"[lightgbm_tpu] unknown control "
                             f"{line.strip()!r} (!swap <path> | "
                             f"!rollback | !stats)\n")
        except SwapRejected as e:
            # the old version never stopped serving
            stderr.write(f"[lightgbm_tpu] {e}\n")
        stderr.flush()

    draining = False

    def _on_term(signum, frame):                   # noqa: ARG001
        nonlocal draining
        draining = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
    except ValueError:                             # not the main thread
        prev_handler = None

    pendings = []
    try:
        for line in stdin:
            if draining:
                break                              # stop admitting
            if line.lstrip().startswith("!"):
                control(line)
                continue
            try:
                row = _parse_request_line(line)
            except (ValueError, json.JSONDecodeError) as e:
                pendings.append(_failed_pending(e))
                continue
            if row is None:
                continue
            pendings.append(batcher.submit(row,
                                           num_iteration=num_iteration))
            batcher.pump()
            # stream out everything already resolved, in order
            while pendings and pendings[0].done:
                emit(pendings.pop(0))
        # graceful drain (SIGTERM or EOF): flush in-flight, answer all
        batcher.flush()
        for p in pendings:
            emit(p)
        stdout.flush()
    except KernelError as e:
        # a kernel that fails to build or launch stops the server instead
        # of having its answers computed on the host
        while pendings and pendings[0].done:
            emit(pendings.pop(0))
        stdout.flush()
        raise die(f"kernel failure, serving stopped: {e}") from e
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    if draining:
        stderr.write(f"[lightgbm_tpu] drained on SIGTERM "
                     f"({len(pendings)} in-flight flushed)\n")
    if show_stats or draining:
        stderr.write(json.dumps(stats.snapshot()) + "\n")
        stderr.flush()
    return 0


def _failed_pending(e: Exception):
    from .serving import PendingPrediction

    p = PendingPrediction()
    p._set(error=e)
    return p


if __name__ == "__main__":
    sys.exit(main())
