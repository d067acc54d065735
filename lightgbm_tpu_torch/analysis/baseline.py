"""Baseline (accepted-debt) handling for graftlint — the port of
``lightgbm_tpu/analysis/baseline.py``.

``analysis/baseline.toml`` holds ``[[suppress]]`` tables:

    [[suppress]]
    rule = "GL008"
    path = "lightgbm_tpu_torch/kernels/_timing.py"
    count = 1
    reason = "a timing script's product is wall time"

Matching is count-based per (rule, path): the first ``count`` findings of
that rule in that file are suppressed, anything beyond is reported.  The
gate therefore starts green and only ratchets down — deleting debt shows
up as a *stale* suppression (count in the file exceeds reality), which the
CLI reports so the baseline can shrink but never silently grow.

The reference parses the baseline by hand (its Python had no
``tomllib``), and the port keeps that parser so both give the same error
texts: exactly the TOML subset the baseline uses: ``[[table]]``
headers, ``key = "string" | integer | true/false`` pairs, ``#`` comments.
Anything fancier is a hard error — the baseline is a ledger, not a config
language.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .rules import RULE_IDS, Finding

_RULE_ID_RE = re.compile(r"GL\d{3}\Z")


@dataclass
class Suppression:
    rule: str
    path: str
    count: int
    reason: str
    used: int = 0


class BaselineError(ValueError):
    pass


def _parse_value(raw: str, lineno: int):
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
        return raw[1:-1]
    if raw in ("true", "false"):
        return raw == "true"
    try:
        return int(raw)
    except ValueError:
        raise BaselineError(
            f"baseline line {lineno}: unsupported value {raw!r} "
            f"(strings, ints, booleans only)") from None


def parse_baseline(text: str) -> List[Suppression]:
    """Parse the ``[[suppress]]`` TOML subset (see module docstring)."""
    tables: List[Dict[str, object]] = []
    current: Dict[str, object] = {}
    in_suppress = False
    for lineno, line in enumerate(text.splitlines(), 1):
        # strip comments, but not inside quoted strings
        if '"' in line:
            q = False
            for i, ch in enumerate(line):
                if ch == '"':
                    q = not q
                elif ch == "#" and not q:
                    line = line[:i]
                    break
        else:
            line = line.split("#", 1)[0]
        line = line.strip()
        if not line:
            continue
        if line.startswith("[["):
            if line != "[[suppress]]":
                raise BaselineError(
                    f"baseline line {lineno}: only [[suppress]] tables "
                    f"are allowed, got {line!r}")
            if in_suppress:
                tables.append(current)
            current = {}
            in_suppress = True
            continue
        if line.startswith("["):
            raise BaselineError(
                f"baseline line {lineno}: plain [table] headers are not "
                f"part of the baseline format")
        if "=" not in line:
            raise BaselineError(
                f"baseline line {lineno}: expected key = value, got "
                f"{line!r}")
        if not in_suppress:
            raise BaselineError(
                f"baseline line {lineno}: key outside a [[suppress]] "
                f"table")
        k, v = line.split("=", 1)
        current[k.strip()] = _parse_value(v, lineno)
    if in_suppress:
        tables.append(current)

    out: List[Suppression] = []
    for i, t in enumerate(tables, 1):
        missing = {"rule", "path", "reason"} - set(t)
        if missing:
            raise BaselineError(
                f"baseline [[suppress]] #{i}: missing keys "
                f"{sorted(missing)}")
        count = t.get("count", 1)
        if not isinstance(count, int) or count < 1:
            raise BaselineError(
                f"baseline [[suppress]] #{i}: count must be a positive "
                f"integer")
        if not str(t["reason"]).strip():
            raise BaselineError(
                f"baseline [[suppress]] #{i}: reason must be non-empty — "
                f"accepted debt needs a justification")
        rule = str(t["rule"])
        # a malformed or unknown rule id would suppress NOTHING and
        # sit in the ledger forever looking like accepted debt — reject
        # it at parse time, same as any other format error
        if not _RULE_ID_RE.match(rule):
            raise BaselineError(
                f"baseline [[suppress]] #{i}: malformed rule id {rule!r} "
                f"(expected GLxxx)")
        if rule not in RULE_IDS and rule != "GL000":
            raise BaselineError(
                f"baseline [[suppress]] #{i}: unknown rule id {rule!r} "
                f"(known: {', '.join(RULE_IDS)})")
        if rule == "GL000":
            raise BaselineError(
                f"baseline [[suppress]] #{i}: GL000 (parse failure) is "
                f"never baselineable — a tree that does not parse fails "
                f"the gate, full stop")
        out.append(Suppression(rule=rule, path=str(t["path"]),
                               count=count, reason=str(t["reason"])))
    return out


@dataclass
class BaselineResult:
    unsuppressed: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    stale: List[Suppression] = field(default_factory=list)


def apply_baseline(findings: List[Finding],
                   suppressions: List[Suppression]) -> BaselineResult:
    """Split findings into unsuppressed/suppressed; report stale entries."""
    budget: Dict[Tuple[str, str], List[Suppression]] = {}
    for s in suppressions:
        budget.setdefault((s.rule, s.path), []).append(s)
    res = BaselineResult()
    for f in findings:
        for s in budget.get((f.rule, f.path), []):
            if s.used < s.count:
                s.used += 1
                res.suppressed.append(f)
                break
        else:
            res.unsuppressed.append(f)
    res.stale = [s for s in suppressions if s.used < s.count]
    return res
