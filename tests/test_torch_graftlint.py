"""Port parity: graftlint's backend-neutral part (``analysis/``) against the
reference's analyzer, and the port's own gates.

* the reference's GL008, GL009 and GL011 fixtures and their clean twins
  give the same ``(rule, line, col)`` through both analyzers, inline
  waivers included; its GL010 fixtures give the same drift findings;
* the baseline's parse, count exhaustion and format errors match the
  reference's texts;
* the CLI's exit codes (0 clean, 1 findings, 2 usage, 3 internal),
  ``--format github`` and ``--explain``;
* ``lint`` exits 0 on the port's tree with its baseline, no entry stale,
  and GL010 finds no drift between ``faults.SITES``, the port's
  consultation sites and its tests;
* the ``*_cpu`` launch budgets hold.
"""

import os

import pytest
import torch

import test_graftlint as R
from lightgbm_tpu.analysis import baseline as rbase
from lightgbm_tpu.analysis import program as rprog
from lightgbm_tpu.analysis.rules import analyze_source as r_analyze
from lightgbm_tpu_torch import faults
from lightgbm_tpu_torch.analysis import baseline as pbase
from lightgbm_tpu_torch.analysis import program as pprog
from lightgbm_tpu_torch.analysis.budgets import (LAUNCH_BUDGETS,
                                                 budget_by_name,
                                                 check_launch_budgets)
from lightgbm_tpu_torch.analysis.cli import main as lint_main
from lightgbm_tpu_torch.analysis.engine import (PACKAGE_ROOT, _port_tests,
                                                _read_sources, run_lint)
from lightgbm_tpu_torch.analysis.rules import RULE_IDS, analyze_source


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the growers run many small ops, which several
    test workers' thread pools would otherwise contend for."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

PORTED = ("GL008", "GL009", "GL011")
WAIVED_GL008 = R.GL008_BAD.replace(
    "time.sleep(0.1)", "time.sleep(0.1)  # graftlint: GL008 — backoff")
WAIVED_GL011 = R.GL011_BAD.replace(
    "    except ValueError:",
    "    except ValueError:  # graftlint: GL011 — best-effort push")
LOCKLESS_GL009 = R.GL009_BAD.replace(
    "        self._lock = threading.Lock()\n", "").replace(
    "        with self._lock:\n            self.hits += 1\n"
    "            self.events.append(\"hit\")",
    "        self.hits += 1\n        self.events.append(\"hit\")")
FROM_IMPORT_GL008 = ("from time import perf_counter\n\n"
                     "def t():\n    return perf_counter()\n")
FIXTURES = {
    "GL008_BAD": R.GL008_BAD, "GL008_GOOD": R.GL008_GOOD,
    "GL008_from_import": FROM_IMPORT_GL008, "GL008_waived": WAIVED_GL008,
    "GL009_BAD": R.GL009_BAD, "GL009_GOOD": R.GL009_GOOD,
    "GL009_lockless": LOCKLESS_GL009,
    "GL011_BAD": R.GL011_BAD, "GL011_GOOD": R.GL011_GOOD,
    "GL011_waived": WAIVED_GL011,
}


def _keys(findings, rules=PORTED):
    return [(f.rule, f.line, f.col) for f in findings if f.rule in rules]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_findings_equal_the_reference(name):
    src = FIXTURES[name]
    want = _keys(r_analyze("fix.py", src))
    got = _keys(analyze_source("fix.py", src))
    assert got == want
    # the bad fixtures fire, their twins and the waived lines stay silent
    assert bool(got) == (name.endswith("BAD") or name.endswith("import")
                         or name.endswith("waived"))


def test_parse_failure_is_gl000_in_both():
    src = "def f(:  # graftlint: GL000 — nope\n"
    assert _keys(analyze_source("b.py", src), ("GL000",)) == \
        _keys(r_analyze("b.py", src), ("GL000",)) == [("GL000", 1, 0)]


def _gl010(mod, modules, tests):
    fs = mod.fault_site_findings(mod.Program(modules), tests)
    return sorted((f.rule, f.path, f.line, f.col, f.message.split("'")[1])
                  for f in fs)


@pytest.mark.parametrize("use,tests", [
    (R._GL010_USE, [("tests/test_x.py", "SITE = 'predict'\n")]),
    (R._GL010_USE.replace('self.faults.check("mistyped")',
                          'self.faults.check("flip")'),
     [("tests/test_x.py", "COVERED = ('predict', 'flip')\n")]),
    ("from pkg.faults import FaultSpec\n\ndef chaos(inj):\n"
     "    inj.arm('predict')\n    return FaultSpec(site='flip')\n", ()),
    ("def f(validator):\n    validator.check('predict')\n", ()),
], ids=["three_directions", "drift_free", "arm_and_spec", "not_injector"])
def test_gl010_fixtures_equal_the_reference(use, tests):
    modules = [("pkg/faults.py", R._GL010_FAULTS), ("pkg/use.py", use)]
    assert _gl010(pprog, modules, tests) == _gl010(rprog, modules, tests)


# -- the baseline ---------------------------------------------------------

BASELINE_ERRORS = [
    "[[other]]\nrule = \"GL008\"\n",
    "[suppress]\n",
    "rule = \"GL008\"\n",
    "[[suppress]]\nrule = \"GL008\"\npath = \"p\"\nreason = \"\"\n",
    "[[suppress]]\nrule = \"GL008\"\npath = \"p\"\ncount = 0\n"
    "reason = \"r\"\n",
    "[[suppress]]\npath = \"p\"\nreason = \"r\"\n",
    "[[suppress]]\nrule = \"GL008\"\npath = \"p\"\nreason = 1.5\n",
    "[[suppress]]\nnot a pair\n",
    '[[suppress]]\nrule = "GL9999"\npath = "p"\nreason = "r"\n',
    '[[suppress]]\nrule = "GL000"\npath = "p"\nreason = "r"\n',
]


@pytest.mark.parametrize("bad", BASELINE_ERRORS)
def test_baseline_format_errors_as_the_reference(bad):
    with pytest.raises(rbase.BaselineError) as want:
        rbase.parse_baseline(bad)
    with pytest.raises(pbase.BaselineError) as got:
        pbase.parse_baseline(bad)
    assert str(got.value) == str(want.value)


def test_baseline_unknown_rule_id_names_the_ported_ones():
    bad = '[[suppress]]\nrule = "GL003"\npath = "p"\nreason = "r"\n'
    with pytest.raises(pbase.BaselineError,
                       match=r"unknown rule id 'GL003' \(known: GL000, "
                             r"GL008, GL009, GL010, GL011\)"):
        pbase.parse_baseline(bad)
    assert RULE_IDS == ("GL000", "GL008", "GL009", "GL010", "GL011")


def test_baseline_parse_suppress_and_exhaustion_as_the_reference():
    text = ('# ledger\n[[suppress]]\nrule = "GL008"\npath = "p.py"\n'
            'count = 2\nreason = "timing"  # why\n')
    out = {}
    for name, base, analyze in (("reference", rbase, r_analyze),
                                ("port", pbase, analyze_source)):
        fs = [f for f in analyze("p.py", R.GL008_BAD) if f.rule == "GL008"]
        sup = base.parse_baseline(text)
        one = base.apply_baseline(fs[:1], sup)
        sup = base.parse_baseline(text)
        all_ = base.apply_baseline(fs + fs, sup)
        out[name] = ([(s.rule, s.path, s.count, s.reason) for s in sup],
                     len(one.suppressed), [(s.used, s.count)
                                           for s in one.stale],
                     len(all_.suppressed), _keys(all_.unsuppressed),
                     all_.stale)
    assert out["port"] == out["reference"]
    assert out["port"][1] == 1 and out["port"][3] == 2


# -- the CLI --------------------------------------------------------------


def test_cli_exit_codes_and_formats(tmp_path, capsys):
    bad = tmp_path / "seeded.py"
    bad.write_text(R.GL008_BAD)
    assert lint_main([str(bad), "-q"]) == 1
    assert "GL008" in capsys.readouterr().out
    assert lint_main([str(bad), "--format", "github"]) == 1
    first = capsys.readouterr().out.splitlines()[0]
    assert first.startswith(f"::error file={bad},line=7,col=10,")
    assert "title=graftlint GL008::" in first
    good = tmp_path / "clean.py"
    good.write_text(R.GL008_GOOD)
    assert lint_main([str(good), "-q"]) == 0
    assert lint_main([str(good), "--format", "json"]) == 0
    assert '"ok": true' in capsys.readouterr().out
    b = tmp_path / "bad.toml"
    b.write_text("[suppress]\n")
    assert lint_main([str(good), "--baseline", str(b), "-q"]) == 2
    assert "graftlint: usage-error:" in capsys.readouterr().err
    assert lint_main([str(good), "--bogus"]) == 2
    assert "unknown option" in capsys.readouterr().err
    d = tmp_path / "bldir"
    d.mkdir()
    assert lint_main([str(good), "--baseline", str(d), "-q"]) == 3
    err = capsys.readouterr().err
    assert err.startswith("graftlint: internal-error: IsADirectoryError")
    assert "Traceback" not in err


@pytest.mark.parametrize("rule", ["GL008", "GL009", "GL010", "GL011"])
def test_cli_explain_prints_the_rule_section(rule, capsys):
    assert lint_main(["--explain", rule.lower()]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"## {rule}")
    assert not any(r in out for r in RULE_IDS if r != rule)


def test_cli_explain_unported_rule_is_usage_error(capsys):
    assert lint_main(["--explain", "GL003"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("graftlint: usage-error:") and "GL010" in err
    assert lint_main(["--explain"]) == 2


def test_python_m_lint_entry(capsys):
    from lightgbm_tpu_torch.__main__ import main

    assert main(["lint", "--explain", "GL009"]) == 0
    assert "lock discipline" in capsys.readouterr().out


# -- the gates on the port's own tree -------------------------------------


def test_port_tree_lints_clean_with_its_baseline(capsys):
    report = run_lint()
    assert report.ok, "\n".join(f.format() for f in report.unsuppressed)
    assert not report.stale, [s.reason for s in report.stale]
    assert report.files_checked > 60
    assert lint_main(["-q"]) == 0


def test_gl010_every_site_consulted_and_armed_by_a_port_test():
    prog = pprog.Program(_read_sources([PACKAGE_ROOT]))
    assert pprog.fault_site_findings(prog, _port_tests()) == []
    # not vacuous: without the tests every site is uncovered
    uncovered = pprog.fault_site_findings(prog, [("t.py", "x = 1\n")])
    assert {f.message.split("'")[1] for f in uncovered} == set(faults.SITES)
    assert len(faults.SITES) == 15


def test_cpu_launch_budgets_hold():
    res = check_launch_budgets([b.name for b in LAUNCH_BUDGETS
                                if b.where == "cpu"])
    assert len(res) == 3
    assert all(r["ok"] for r in res), res
    with pytest.raises(KeyError):
        budget_by_name("nope")
    assert {b.where for b in LAUNCH_BUDGETS} == {"cpu", "card"}
    assert os.path.basename(PACKAGE_ROOT) == "lightgbm_tpu_torch"


def test_launch_budget_floor_fails_a_lost_measurement(monkeypatch):
    # a profiler that lost the window's records reads 0 launches: below the
    # floor (the kernels the entry point must launch), so the check fails
    from lightgbm_tpu_torch.analysis.budgets import LaunchBudget

    spec = budget_by_name("strict_card")
    assert spec.floor == 2 and budget_by_name("cv_card").floor == 2
    for measured, ok in ((0, False), (1, False), (2, True),
                         (spec.budget, True), (spec.budget + 1, False)):
        monkeypatch.setattr(LaunchBudget, "measure",
                            lambda self, m=measured: m)
        assert spec.check()["ok"] is ok, measured
