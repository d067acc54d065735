"""Port parity: the ported CLI (``task=serve``, ``task=train``,
``task=predict``, ``task=sweep``, ``task=refresh``) against the reference's.

The same request lines (CSV rows, JSON arrays, blank and bad lines,
``!swap``/``!rollback``/``!stats`` control lines) go through the reference's
``lightgbm_tpu.__main__._serve`` and the port's
``lightgbm_tpu_torch.__main__._serve`` (``device=cpu``) on in-memory streams.
Predictions agree at rtol 1e-5 / atol 1e-6; errors and acks agree in kind.
``task=train`` then ``task=predict`` on small CSV files (a header,
``label_column=name:y``, ``valid=``, int8 histograms) write what
``Booster(model_file=...).predict`` gives, and the model files of either
package's CLI load in the other with predictions within 1e-6.
``task=train checkpoint_dir=`` preempted by a SIGTERM exits 0 and its rerun
writes the model file of an uninterrupted run, byte for byte;
``task=sweep``'s leaderboard equals the reference CLI's (configs and
iterations equal, scores within rtol 1e-5) and its typed errors read the
same.  ``task=refresh``'s misuses give the reference's messages, and two
invocations over a growing watch directory give the reference's events
(the second re-anchors and continues).
"""

import dataclasses
import io
import json
import os
import signal

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as P
from lightgbm_tpu.__main__ import _refresh as ref_refresh
from lightgbm_tpu.__main__ import _serve as ref_serve
from lightgbm_tpu.__main__ import _sweep as ref_sweep
from lightgbm_tpu.__main__ import main as ref_main
from lightgbm_tpu.serving.packed import pack_booster
import lightgbm_tpu_torch.training as port_training
from lightgbm_tpu_torch.__main__ import _refresh as port_refresh
from lightgbm_tpu_torch.__main__ import _serve as port_serve
from lightgbm_tpu_torch.__main__ import _sweep as port_sweep
from lightgbm_tpu_torch.__main__ import main as port_main
from lightgbm_tpu_torch.kernels import KernelLaunchError
from lightgbm_tpu_torch.ops import predict as port_predict

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(400, 4))
    y = 2.0 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.normal(size=400)
    b = lgb.train({"objective": "regression", "num_leaves": 7,
                   "verbosity": -1}, lgb.Dataset(X, label=y),
                  num_boost_round=5)
    pf = pack_booster(b)
    d = tmp_path_factory.mktemp("cli")
    v1, v2 = str(d / "v1.npz"), str(d / "v2.npz")
    pf.save(v1)
    dataclasses.replace(pf, leaf_value=pf.leaf_value * 2.0).save(v2)
    return X, v1, v2


def _run(serve, path, cfg, lines):
    out, err = io.StringIO(), io.StringIO()
    rc = serve(path, dict(cfg), stdin=iter(lines), stdout=out, stderr=err)
    return rc, out.getvalue().splitlines(), err.getvalue()


def _rows(X, n):
    return [",".join(f"{v:.8g}" for v in X[i]) + "\n" for i in range(n)]


def _numbers(lines):
    return np.array([[float(v) for v in ln.split(",")] for ln in lines
                     if not ln.startswith("ERROR")], np.float64)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_serve_predictions_match_reference(models, precision):
    X, v1, v2 = models
    lines = (_rows(X, 5) + ["\n", "# comment\n",
                            json.dumps(X[5].tolist()) + "\n",
                            "1.0,oops,2,3\n"] + _rows(X[6:], 20))
    cfg = {"max_batch": "8", "forest_precision": precision,
           "num_iteration": "4"}
    rc_r, out_r, _ = _run(ref_serve, v1, cfg, lines)
    rc_p, out_p, _ = _run(port_serve, v1, dict(cfg, device="cpu"), lines)
    assert rc_r == rc_p == 0
    assert len(out_p) == len(out_r) == 27
    assert [ln.startswith("ERROR") for ln in out_p] == \
        [ln.startswith("ERROR") for ln in out_r]
    np.testing.assert_allclose(_numbers(out_p), _numbers(out_r), rtol=RTOL,
                               atol=ATOL)


def test_serve_control_lines_match_reference(models):
    X, v1, v2 = models
    row = _rows(X, 1)[0]
    lines = [row, "!stats\n", f"!swap {v2}\n", row, "!rollback\n", row,
             "!frobnicate\n"]
    cfg = {"max_batch": "1", "canary_rows": "4", "output_format": "json"}
    rc_r, out_r, err_r = _run(ref_serve, v1, cfg, lines)
    rc_p, out_p, err_p = _run(port_serve, v1, dict(cfg, device="cpu"),
                              lines)
    assert rc_r == rc_p == 0
    got = np.array([json.loads(x) for x in out_p])
    want = np.array([json.loads(x) for x in out_r])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got[0] != got[1] and got[0] == got[2]
    for ack in ("swapped default -> v2", "rolled back default -> v1",
                "unknown control"):
        assert ack in err_r and ack in err_p
    stats = json.loads([ln for ln in err_p.splitlines()
                        if ln.startswith("{")][0])
    assert stats["fused_path"]["dispatches"] >= 1


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_serve_text_model_equals_its_npz(tmp_path, boosting):
    """A JSON text model is packed on load: served, it answers what its
    ``.npz`` does (and the reference's CLI serving the text), and
    ``!swap`` takes either kind."""
    rng = np.random.default_rng(22)
    X = rng.normal(size=(400, 4))
    y = 2.0 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.normal(size=400)
    params = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
              "boosting": boosting, "feature_fraction_bynode": 0.5}
    b = P.train(params, P.Dataset(X, label=y, device="cpu"), 5)
    txt, npz = str(tmp_path / "m.txt"), str(tmp_path / "m.npz")
    b.save_model(txt)
    b.save_model(npz)
    lines = _rows(X, 12)
    cfg = {"max_batch": "4", "device": "cpu"}
    rc_t, out_t, _ = _run(port_serve, txt, cfg, lines)
    rc_n, out_n, _ = _run(port_serve, npz, cfg, lines)
    rc_r, out_r, _ = _run(ref_serve, txt, {"max_batch": "4"}, lines)
    assert rc_t == rc_n == rc_r == 0 and len(out_t) == 12
    np.testing.assert_allclose(_numbers(out_t), _numbers(out_n), rtol=1e-6)
    np.testing.assert_allclose(_numbers(out_t), _numbers(out_r), rtol=RTOL,
                               atol=ATOL)
    sent = _numbers(lines)                  # the rows as the server read them
    np.testing.assert_allclose(_numbers(out_t)[:, 0], b.predict(sent),
                               rtol=RTOL, atol=ATOL)
    row = lines[0]
    rc, out, err = _run(port_serve, npz, cfg,
                        [f"!swap {txt}\n", row, f"!swap {npz}\n", row,
                         f"!swap {tmp_path / 'missing.txt'}\n", row])
    assert rc == 0 and err.count("swapped default") == 2
    assert "missing.txt" in err
    assert len(set(out)) == 1 and len(out) == 3


def test_serve_rejects_bad_keys_and_missing_card(models):
    _, v1, _ = models
    for cfg, msg in (({"bogus": "1"}, "unknown key"),
                     ({"device": "tpu"}, "device"),
                     ({"mesh_devices": "3"}, "power of two"),
                     ({"mesh_devices": "2"}, "2 devices, 1 visible"),
                     ({"shed_policy": "yolo"}, "shed_policy"),
                     ({"forest_precision": "fp8"}, "forest_precision")):
        with pytest.raises(SystemExit, match=msg):
            port_serve(v1, dict(cfg, device=cfg.get("device", "cpu")),
                       stdin=iter(()), stdout=io.StringIO(),
                       stderr=io.StringIO())
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            port_serve(v1, {}, stdin=iter(()), stdout=io.StringIO(),
                       stderr=io.StringIO())
    with pytest.raises(SystemExit, match="requires state_dir"):
        port_main(["task=refresh", "watch_dir=x"])
    with pytest.raises(SystemExit, match="requires input_model"):
        port_main(["task=serve"])


@pytest.mark.parametrize("canary_rows", ["0", "4"])
def test_serve_stops_on_kernel_failure(models, monkeypatch, canary_rows):
    # a kernel that cannot launch stops the server (at the deploy's canary,
    # or at the first batch when the canary is off) instead of having the
    # batcher answer on the host
    X, v1, _ = models

    def broken(*args, **kwargs):
        raise KernelLaunchError("predict_forest_f32 launch failed: refused")

    monkeypatch.setattr(port_predict, "predict_forest", broken)
    out = io.StringIO()
    with pytest.raises(SystemExit, match="kernel failure") as e:
        port_serve(v1, {"device": "cpu", "max_batch": "1",
                        "canary_rows": canary_rows},
                   stdin=iter(_rows(X, 3)), stdout=out,
                   stderr=io.StringIO())
    assert isinstance(e.value.__cause__, KernelLaunchError)
    assert all(ln.startswith("ERROR: KernelLaunchError")
               for ln in out.getvalue().splitlines())


# ------------------------------------------------------ task=train|predict
@pytest.fixture(scope="module")
def csv_files(tmp_path_factory):
    rng = np.random.default_rng(31)
    X = rng.normal(size=(700, 4))
    y = 2.0 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.normal(size=700)
    d = tmp_path_factory.mktemp("cli_train")
    paths = {}
    for name, rows in (("train", slice(0, 500)), ("valid", slice(500, 600)),
                       ("valid2", slice(600, 700))):
        paths[name] = str(d / f"{name}.csv")
        with open(paths[name], "w") as f:
            f.write("a,b,y,c,d\n")
            for xr, yv in zip(X[rows], y[rows]):
                v = [xr[0], xr[1], yv, xr[2], xr[3]]
                f.write(",".join(f"{t:.9g}" for t in v) + "\n")
    return d, paths, X


TRAIN_KEYS = ["header=true", "label_column=name:y", "objective=regression",
              "num_trees=4", "num_leaves=7", "min_data_in_leaf=5",
              "verbose=-1"]


def test_train_then_predict_cli_on_cpu(csv_files):
    d, paths, X = csv_files
    model, preds = str(d / "port.txt"), str(d / "port_preds.txt")
    assert port_main(["task=train", f"data={paths['train']}",
                      f"valid={paths['valid']},{paths['valid2']}",
                      "hist_dtype=int8", "device=cpu",
                      f"output_model={model}"] + TRAIN_KEYS) == 0
    assert port_main(["task=predict", f"data={paths['valid']}",
                      "header=true", "label_column=name:y", "device=cpu",
                      f"input_model={model}",
                      f"output_result={preds}"]) == 0
    booster = P.Booster(model_file=model, device="cpu")
    assert booster.num_trees() == 4
    got = np.loadtxt(preds)
    np.testing.assert_allclose(got, booster.predict(X[500:600]), rtol=1e-9,
                               atol=1e-9)


def test_cli_models_interchange_with_reference(csv_files):
    d, paths, X = csv_files
    port_model, ref_model = str(d / "p.txt"), str(d / "r.txt")
    assert port_main(["task=train", f"data={paths['train']}", "device=cpu",
                      f"output_model={port_model}"] + TRAIN_KEYS) == 0
    assert ref_main(["task=train", f"data={paths['train']}",
                     f"output_model={ref_model}"] + TRAIN_KEYS) == 0
    for path in (port_model, ref_model):
        want = P.Booster(model_file=path, device="cpu").predict(X)
        got = lgb.Booster(model_file=path).predict(X)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the same data and params: the two CLIs' models agree too
    np.testing.assert_allclose(
        P.Booster(model_file=port_model, device="cpu").predict(X),
        lgb.Booster(model_file=ref_model).predict(X), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("argv,name", [
    (["task=refresh"], "requires watch_dir"),
    (["task=refresh", "watch_dir=x"], "requires state_dir"),
    (["task=sweep", "data=x.csv", "sweep_grid={grid}", "sweep_devices=3",
      "sweep_group_size=2"], "sweep_group_size must divide"),
    (["task=train", "data=x.csv", "device=tpu"], "device")])
def test_cli_unported_keys_exit_by_name(argv, name, tmp_path):
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({"axes": {"num_leaves": [7, 15]}}))
    with pytest.raises(SystemExit, match=name) as e:
        port_main([a.format(grid=grid) for a in argv])
    assert e.value.code not in (0, None)


def test_train_checkpoint_dir_preempted_then_resumed(csv_files, tmp_path,
                                                     monkeypatch, capsys):
    """A SIGTERM after round index 2 of ``task=train checkpoint_dir=``: the
    run exits 0 naming the checkpoint, the rerun resumes and writes the
    model file an uninterrupted run writes."""
    _, paths, _ = csv_files
    keys = ["task=train", f"data={paths['train']}", "device=cpu",
            "checkpoint_rounds=2", "num_trees=6"] + \
        [k for k in TRAIN_KEYS if not k.startswith("num_trees")]
    clean = str(tmp_path / "clean.txt")
    assert port_main(keys + [f"checkpoint_dir={tmp_path / 'ck0'}",
                             f"output_model={clean}"]) == 0
    real = port_training.train_resumable

    def preempted(*a, **kw):
        def kill(booster, i):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, round_callbacks=[kill], **kw)

    model, ck = str(tmp_path / "m.txt"), str(tmp_path / "ck")
    monkeypatch.setattr(port_training, "train_resumable", preempted)
    capsys.readouterr()
    assert port_main(keys + [f"checkpoint_dir={ck}",
                             f"output_model={model}"]) == 0
    assert "preempted at round 3/6" in capsys.readouterr().out
    assert not os.path.exists(model)
    monkeypatch.setattr(port_training, "train_resumable", real)
    assert port_main(keys + [f"checkpoint_dir={ck}",
                             f"output_model={model}"]) == 0
    assert "resumed from" in capsys.readouterr().out
    with open(model, "rb") as f, open(clean, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("bad,msg", [
    ("checkpoint_rounds=0", "checkpoint_rounds must be >= 1, got 0"),
    ("checkpoint_rounds=x", "checkpoint_rounds must be an integer"),
    ("checkpoint_keep=-1", "checkpoint_keep must be >= 0, got -1")])
def test_train_checkpoint_keys_typed_errors(csv_files, tmp_path, bad, msg):
    _, paths, _ = csv_files
    keys = ["task=train", f"data={paths['train']}", "device=cpu",
            f"checkpoint_dir={tmp_path / 'ck'}", bad] + TRAIN_KEYS
    with pytest.raises(SystemExit, match=f"^task=train: {msg}") as e:
        port_main(keys)
    assert e.value.code not in (0, None)
    assert not os.path.exists(tmp_path / "ck")


SWEEP_KEYS = {"objective": "regression", "num_trees": "15",
              "min_data_in_leaf": "5", "verbose": "-1", "nfold": "3",
              "early_stopping_rounds": "5", "label_column": "name:y"}


def test_sweep_cli_leaderboard_matches_reference(csv_files, tmp_path):
    _, paths, _ = csv_files
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({"axes": {"learning_rate": [0.3, 0.1],
                                         "num_leaves": [7]}}))
    boards = {}
    for tag, fn, extra in (("port", port_sweep, {"device": "cpu"}),
                           ("ref", ref_sweep, {})):
        cfg = dict(SWEEP_KEYS, sweep_grid=str(grid),
                   ledger=str(tmp_path / f"{tag}.RData"),
                   sweep_checkpoint_dir=str(tmp_path / f"ck_{tag}"))
        label = cfg.pop("label_column")
        out, err = io.StringIO(), io.StringIO()
        assert fn(cfg, paths["train"], True, label, stdout=out, stderr=err,
                  **extra) == 0
        boards[tag] = [json.loads(ln) for ln in out.getvalue().splitlines()]
        summary = json.loads(err.getvalue().strip().splitlines()[-1])
        assert summary["configs"] == 2 and summary["resumed_units"] == 0
        assert not os.path.exists(tmp_path / f"ck_{tag}")
    got, want = boards["port"], boards["ref"]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert {k: v for k, v in a.items() if k != "score"} \
            == {k: v for k, v in b.items() if k != "score"}
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-5)


def test_sweep_cli_multi_device_ledger(csv_files, tmp_path):
    """``sweep_devices=4 sweep_group_size=2`` plans the two hyper-batches
    over two device groups and runs them one after another, as the
    reference's CLI does (the plan itself is held against the reference's
    scheduler in ``test_torch_sweep.py``): the ledger file and the
    leaderboard are the single-device run's byte for byte.  One intra-op
    thread: the fused program runs thousands of small ops."""
    _, paths, _ = csv_files
    grid = tmp_path / "grid.json"
    grid.write_text(json.dumps({"axes": {"learning_rate": [0.3, 0.1],
                                         "num_leaves": [7]}}))
    boards, ledgers = {}, {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for tag, devices in (("one", {}), ("four", {
                "sweep_devices": "4", "sweep_group_size": "2"})):
            ledgers[tag] = tmp_path / f"{tag}.RData"
            cfg = dict(SWEEP_KEYS, sweep_grid=str(grid),
                       ledger=str(ledgers[tag]), **devices)
            label = cfg.pop("label_column")
            out, err = io.StringIO(), io.StringIO()
            assert port_sweep(cfg, paths["train"], True, label, stdout=out,
                              stderr=err, device="cpu") == 0
            boards[tag] = out.getvalue()
            # one hyper-batch a bucket: a bucket per learning rate
            assert json.loads(err.getvalue().strip().splitlines()[-1])[
                "units"] == 2
    finally:
        torch.set_num_threads(threads)
    assert ledgers["one"].read_bytes() == ledgers["four"].read_bytes()
    assert boards["one"] == boards["four"]
    assert len(boards["four"].splitlines()) == 2


@pytest.mark.parametrize("cfg", [
    {},
    {"sweep_grid": "{missing}"},
    {"sweep_grid": "{bad_json}"},
    {"sweep_grid": "{bad_axes}"},
    {"sweep_grid": "{grid}", "nfold": "1"},
    {"sweep_grid": "{grid}", "top": "x"},
    {"sweep_grid": "{grid}", "engine": "gpu"},
    {"sweep_grid": "{grid}", "sweep_devices": "3", "sweep_group_size": "2"},
    {"sweep_grid": "{grid}", "sweep_checkpoint_dir": " "},
    {"sweep_grid": "{grid}", "bogus_key": "1"},
], ids=["no-grid", "missing", "bad-json", "bad-axes", "nfold", "top",
        "engine", "group-size", "ckpt-dir", "unknown-key"])
def test_sweep_cli_typed_errors_match_reference(cfg, tmp_path):
    files = {"missing": tmp_path / "nope.json",
             "bad_json": tmp_path / "bad.json",
             "bad_axes": tmp_path / "axes.json", "grid": tmp_path / "g.json"}
    files["bad_json"].write_text("{not json")
    files["bad_axes"].write_text(json.dumps({"axes": {"num_leaves": []}}))
    files["grid"].write_text(json.dumps({"rows": [{"num_leaves": 7}]}))
    msgs = []
    for fn, extra in ((port_sweep, {"device": "cpu"}), (ref_sweep, {})):
        c = {k: v.format(**files) for k, v in cfg.items()}
        with pytest.raises(SystemExit) as e:
            fn(c, "train.csv", True, "0", stdout=io.StringIO(),
               stderr=io.StringIO(), **extra)
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and msgs[0].startswith("task=sweep: ")


# -- task=refresh ----------------------------------------------------------

REFRESH_KEYS = {"objective": "binary", "num_leaves": "7",
                "learning_rate": "0.2", "max_bin": "31",
                "min_data_in_leaf": "5", "verbose": "-1", "seed": "7",
                "stream_block_rows": "256", "refresh_rounds": "2"}


def _refresh_cfg(tmp_path, **over):
    cfg = dict(REFRESH_KEYS, watch_dir=str(tmp_path / "watch"),
               state_dir=str(tmp_path / "state"))
    cfg.update(over)
    return cfg


@pytest.mark.parametrize("cfg,full", [
    ({}, False), ({"watch_dir": "{w}"}, False), ({"bogus_knob": "1"}, True),
    ({"refresh_rounds": "five"}, True), ({"max_ticks": "0"}, True),
    ({"staleness_slo_ms": "-3"}, True), ({"staleness_slo_ms": "soon"}, True),
    ({"sweep_every": "2"}, True), ({"sweep_nfold": "1"}, True),
    ({"sweep_grid": "{w}/none.json"}, True),
], ids=["no-watch", "no-state", "unknown-key", "not-int", "ticks",
        "slo-negative", "slo-word", "every-no-grid", "nfold", "grid-file"])
def test_refresh_cli_misuse_matches_reference(cfg, full, tmp_path):
    msgs = []
    for fn, extra in ((port_refresh, {"device": "cpu"}), (ref_refresh, {})):
        c = {k: v.format(w=tmp_path) for k, v in cfg.items()}
        if full:
            c = _refresh_cfg(tmp_path, **c, **extra)
        with pytest.raises(SystemExit) as e:
            fn(c, stdout=io.StringIO(), stderr=io.StringIO())
        msgs.append(str(e.value.code))
    assert msgs[0] == msgs[1] and msgs[0].startswith("task=refresh: ")


def test_refresh_cli_device_and_usage():
    with pytest.raises(SystemExit, match="device must be cuda|cpu"):
        port_refresh({"watch_dir": "w", "state_dir": "s", "device": "tpu"})
    with pytest.raises(SystemExit, match="usage"):
        port_main(["task=refresh", "--help"])
    with pytest.raises(SystemExit, match="refresh"):
        port_main(["task=refres"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            port_refresh({"watch_dir": "w", "state_dir": "s"})


def test_refresh_cli_two_invocations_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(0, 1, (512, 5)).astype(np.float32)
    w = rng.normal(0, 1, 5)
    y = (rng.random(512) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    out = {}
    for name, fn, extra in (("port", port_refresh, {"device": "cpu"}),
                            ("reference", ref_refresh, {})):
        root = tmp_path / name
        watch = root / "watch"
        watch.mkdir(parents=True)
        np.savez(str(watch / "block0.npz"), X=X[:256], y=y[:256])
        np.savez(str(watch / "block1.npz"), X=X[256:], y=y[256:])
        runs = []
        for extra_block in (False, True):
            if extra_block:
                np.savez(str(watch / "block2.npz"), X=X[:256],
                         y=1.0 - y[:256])
            so, se = io.StringIO(), io.StringIO()
            assert fn(_refresh_cfg(root, **extra), stdout=so,
                      stderr=se) == 0
            events = [json.loads(ln) for ln in so.getvalue().splitlines()]
            runs.append(([{k: v for k, v in e.items()
                           if k not in ("resumed_from", "staleness_ms")}
                          for e in events], json.loads(se.getvalue())))
        out[name] = runs
    assert [[e["event"] for e in r[0]] for r in out["port"]] == \
        [["flipped"], ["flipped"]]
    assert out["port"][0][0][0]["version"] == "g0001"
    assert out["port"][1][0][-1]["version"] == "g0002"
    assert out["port"][1][0][-1]["rounds"] == 4
    for (ev_p, sum_p), (ev_r, sum_r) in zip(out["port"], out["reference"]):
        assert ev_p == ev_r
        assert {k: v for k, v in sum_p.items() if k != "worst_staleness_ms"} \
            == {k: v for k, v in sum_r.items() if k != "worst_staleness_ms"}
