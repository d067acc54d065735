"""``python -m lightgbm_tpu_torch lint`` — the graftlint front end, the port
of ``lightgbm_tpu/analysis/cli.py``.

Default run: the AST rules (GL008, GL009, GL011 per file; GL010 and GL014
over the whole program in the no-paths case) plus the baseline, the nine
analytic budget model families on the card's constants and the budget
anchors — fast, pure arithmetic and ``ast``, no torch.  ``--budgets`` adds
the launch budgets (:mod:`.budgets`): the ``*_cpu`` pins everywhere, the
``*_card`` counts where a CUDA device is visible.

Exit codes (machine-readable by construction):

* 0 — clean (a model spec in ``budgets.CARD_MISSES`` may miss its bar: it
  is printed ``[MISS]`` with its ROADMAP entry);
* 1 — findings above the baseline / budget violations / a new or stale
  card miss;
* 2 — usage or baseline-format error (``graftlint: usage-error: ...``);
* 3 — internal analyzer error (``graftlint: internal-error: ...``) —
  the analyzer itself broke, which must never masquerade as "the tree
  has findings" in CI.
"""

from __future__ import annotations

import json
import sys
from typing import List, Optional

from .baseline import BaselineError
from .engine import DEFAULT_BASELINE, run_lint

_USAGE = """\
usage: python -m lightgbm_tpu_torch lint [paths...] [options]

options:
  --budgets         also run the launch budgets (*_card needs a CUDA device)
  --no-baseline     report accepted debt too (ratchet view)
  --baseline PATH   alternate baseline file
  --explain GLxxx   print the RULES.md section for a rule id and exit
  --format json     machine-readable report on stdout
  --format github   GitHub workflow-annotation lines (::error file=...)
  -q, --quiet       findings only, no summary
"""


def _explain(rule_id: str) -> int:
    """Print the RULES.md section for one rule id.  Unknown ids exit 2
    with the usage-error one-liner (machine-readable, like every other
    CLI misuse)."""
    import os
    import re

    rid = rule_id.upper()
    rules_md = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "RULES.md")
    with open(rules_md, encoding="utf-8") as f:
        text = f.read()
    match = re.search(rf"^## {re.escape(rid)}\b.*?(?=^## |\Z)",
                      text, re.M | re.S)
    if match is None:
        known = re.findall(r"^## (GL\d{3})\b", text, re.M)
        print(f"graftlint: usage-error: unknown rule id {rule_id!r} "
              f"(known: {', '.join(known)})", file=sys.stderr)
        return 2
    print(match.group(0).rstrip())
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """Parse args and run; every internal failure becomes exit 3 with a
    typed one-liner (the CLI convention: no tracebacks)."""
    try:
        return _run(argv)
    except SystemExit:
        raise
    except BaselineError as e:
        print(f"graftlint: usage-error: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # noqa: BLE001 — the exit-3 contract boundary
        print(f"graftlint: internal-error: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 3


def _run(argv: Optional[List[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    budgets = False
    use_baseline = True
    fmt = "text"
    quiet = False
    baseline_path = DEFAULT_BASELINE
    paths: List[str] = []
    i = 0
    while i < len(args):
        a = args[i]
        if a in ("-h", "--help"):
            print(_USAGE)
            return 0
        if a == "--budgets":
            budgets = True
        elif a == "--no-baseline":
            use_baseline = False
        elif a == "--baseline":
            i += 1
            if i >= len(args):
                print("--baseline needs a path", file=sys.stderr)
                return 2
            baseline_path = args[i]
        elif a == "--explain":
            i += 1
            if i >= len(args):
                print("graftlint: usage-error: --explain needs a rule id "
                      "(e.g. GL010)", file=sys.stderr)
                return 2
            return _explain(args[i])
        elif a == "--format":
            i += 1
            if i >= len(args) or args[i] not in ("text", "json",
                                                 "github"):
                print("--format takes text|json|github",
                      file=sys.stderr)
                return 2
            fmt = args[i]
        elif a in ("-q", "--quiet"):
            quiet = True
        elif a.startswith("-"):
            print(f"unknown option {a!r}\n{_USAGE}", file=sys.stderr)
            return 2
        else:
            paths.append(a)
        i += 1

    report = run_lint(paths or None,
                      baseline_path if use_baseline else None)

    sections = {"layer1": {
        "files_checked": report.files_checked,
        "unsuppressed": [f.format() for f in report.unsuppressed],
        "suppressed": [f.format() for f in report.suppressed],
        "stale_suppressions": [
            f"{s.rule} {s.path} (count {s.count}, used {s.used}): "
            f"{s.reason}" for s in report.stale],
    }}
    failed = bool(report.unsuppressed)

    # pure arithmetic on the card's constants — always on
    from .budgets import check_budget_anchors, model_sections, section_failed

    for key, res in model_sections().items():
        sections[key] = res
        failed |= section_failed(res)

    # stale-entry reporting: budget specs must anchor to live symbols —
    # pure ast, so it rides in the default pass
    res = check_budget_anchors()
    sections["budget_anchors"] = res
    failed |= any(not r["ok"] for r in res)

    if budgets:
        from .budgets import check_launch_budgets

        res = check_launch_budgets()
        sections["launch_budgets"] = res
        failed |= any(not r["ok"] for r in res)

    if fmt == "json":
        sections["ok"] = not failed
        print(json.dumps(sections, indent=1))
        return 1 if failed else 0

    if fmt == "github":
        # workflow-annotation lines: findings anchor file+line, budget /
        # anchor failures annotate without a location, known card misses
        # warn
        for f in report.unsuppressed:
            print(f"::error file={f.path},line={f.line},"
                  f"col={f.col + 1},title=graftlint {f.rule}::"
                  f"{f.message}")
        for line in sections["layer1"]["stale_suppressions"]:
            print(f"::warning title=graftlint stale baseline::{line}")
        for key, rs in sections.items():
            if key == "layer1":
                continue
            for r in rs:
                known = r.get("known_miss")
                if r["ok"] and not known:
                    continue
                if known and not r["ok"]:
                    print(f"::warning title=graftlint {key}::"
                          f"{r['name']}: known card miss ({known})")
                    continue
                why = r.get("why") or (
                    f"listed in CARD_MISSES ({known}) but passes"
                    if known else json.dumps(
                        {k: v for k, v in r.items() if k != "name"}))
                print(f"::error title=graftlint {key}::{r['name']}: {why}")
        return 1 if failed else 0

    l1 = sections["layer1"]
    for line in l1["unsuppressed"]:
        print(line)
    if not quiet:
        for line in l1["stale_suppressions"]:
            print(f"stale baseline entry: {line}")
        for key in ("comm_budgets", "comm_time", "stream_time",
                    "stream_dp", "serve_slo", "ckpt", "freshness",
                    "sweep", "screen", "budget_anchors",
                    "launch_budgets"):
            for r in sections.get(key, ()):
                known = r.get("known_miss")
                mark = ("ok" if r["ok"] and not known else
                        "MISS" if known and not r["ok"] else "FAIL")
                detail = (f"{r['measured']} B ({r['drop_x']}x vs psum, "
                          f"floor {r['min_drop_x']}x)"
                          if key == "comm_budgets" else
                          f"{r['measured']*100:.0f}% hidden "
                          f"({r['exposed_ms']:.3f} ms exposed of "
                          f"{r['comm_ms']:.3f} ms, floor "
                          f"{r['budget']*100:.0f}%)"
                          if key in ("comm_time", "stream_time") else
                          f"{r['path']}" + (f" ({r['why']})"
                                            if r["why"] else "")
                          if key == "budget_anchors" else
                          f"{r['measured']}/{r['budget']}")
                if known:
                    detail += (f" (known card miss, {known})" if not r["ok"]
                               else f" (listed as a card miss, {known}, "
                                    f"but passes: stale)")
                print(f"[{mark}] {key}:{r['name']} {detail}")
        n_unsup = len(l1["unsuppressed"])
        layers = ["budget models"] + (["launch budgets"] if budgets
                                      else [])
        print(f"graftlint: {l1['files_checked']} files, {n_unsup} "
              f"finding(s), {len(l1['suppressed'])} baselined"
              + f"; {' + '.join(layers)} "
              + ("FAILED" if failed and not n_unsup else "ok"))
    return 1 if failed else 0
