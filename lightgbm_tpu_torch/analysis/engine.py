"""graftlint's engine: walk the port, run the rules, apply the baseline — the
port of ``lightgbm_tpu/analysis/engine.py``.

The engine imports neither torch nor the package under analysis: the rules
are pure ``ast``, so ``lint`` stays fast and runs on a machine with no card.
The budget models and anchors (:mod:`.budgets`) are pure arithmetic and
``ast`` too; the launch budgets, which load torch, run only when asked
(``--budgets``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

from .baseline import (BaselineResult, Suppression, apply_baseline,
                       parse_baseline)
from .program import (Program, fault_site_findings,
                      parity_anchor_findings)
from .rules import Finding, analyze_source

# Directories never linted: fixtures are deliberately-broken snippets,
# __pycache__ is noise.
_SKIP_DIRS = {"__pycache__", "fixtures", ".git"}

_HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_BASELINE = os.path.join(_HERE, "baseline.toml")
PACKAGE_ROOT = os.path.dirname(_HERE)          # lightgbm_tpu_torch/
REPO_ROOT = os.path.dirname(PACKAGE_ROOT)
# the port's chaos/resilience test tree (GL010's third direction)
TEST_GLOB_PREFIX = "test_torch_"


def iter_py_files(roots: Iterable[str]) -> List[str]:
    out: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return out


def rel_path(path: str) -> str:
    """Repo-relative posix path — the canonical anchor form findings and
    baseline entries use, so the baseline is machine-independent."""
    ap = os.path.abspath(path)
    if ap.startswith(REPO_ROOT + os.sep):
        ap = ap[len(REPO_ROOT) + 1:]
    return ap.replace(os.sep, "/")


@dataclass
class LintReport:
    files_checked: int = 0
    findings: List[Finding] = field(default_factory=list)
    unsuppressed: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale: List[Suppression] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.unsuppressed


def _read_sources(paths: Iterable[str]) -> List[tuple]:
    out = []
    for path in iter_py_files(paths):
        with open(path, encoding="utf-8") as f:
            out.append((rel_path(path), f.read()))
    return out


def _port_tests() -> List[tuple]:
    tests_dir = os.path.join(REPO_ROOT, "tests")
    if not os.path.isdir(tests_dir):
        return []
    return _read_sources(
        os.path.join(tests_dir, fn) for fn in sorted(os.listdir(tests_dir))
        if fn.startswith(TEST_GLOB_PREFIX) and fn.endswith(".py"))


def run_lint(paths: Optional[Iterable[str]] = None,
             baseline_path: Optional[str] = DEFAULT_BASELINE) -> LintReport:
    """Lint ``paths`` and fold in the baseline.

    With no explicit ``paths`` (the default pass) the whole port package is
    analyzed as one :class:`~.program.Program`, and GL010 checks the
    fault-site registry against every consultation site and the port's
    tests (``tests/test_torch_*.py``), and GL014 pins the port's PARITY.md
    contracts to live symbols.  Explicit paths are linted file by file
    (fixtures, CLI-on-a-file); GL010 and GL014 need the whole program and
    are skipped there.

    ``baseline_path=None`` disables suppression.  GL000 parse failures
    are never baselined and never waived: a tree that does not parse
    fails the gate, full stop.
    """
    report = LintReport()
    if paths is None:
        modules = _read_sources([PACKAGE_ROOT])
        program = Program(modules)
        report.findings.extend(program.run_rules())
        report.findings.extend(fault_site_findings(program, _port_tests()))
        # GL014: the port's PARITY.md contracts pinned to live symbols
        report.findings.extend(parity_anchor_findings(REPO_ROOT))
        report.files_checked = len(modules)
    else:
        for rel, src in _read_sources(paths):
            report.findings.extend(analyze_source(rel, src))
            report.files_checked += 1
    report.findings.sort(key=lambda f: (f.path, f.line, f.rule))

    suppressions: List[Suppression] = []
    if baseline_path and os.path.exists(baseline_path):
        with open(baseline_path, encoding="utf-8") as f:
            suppressions = parse_baseline(f.read())
    parse_failures = [f for f in report.findings if f.rule == "GL000"]
    rest = [f for f in report.findings if f.rule != "GL000"]
    res: BaselineResult = apply_baseline(rest, suppressions)
    report.unsuppressed = parse_failures + res.unsuppressed
    report.suppressed = res.suppressed
    report.stale = res.stale
    return report
