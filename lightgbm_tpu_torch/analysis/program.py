"""graftlint's whole-program rule, GL010 — the port of the fault-site part
of ``lightgbm_tpu/analysis/program.py``.

GL010 (fault-site registry drift) is whole-program by nature: the registry
in :mod:`lightgbm_tpu_torch.faults`, the consultation sites spread across
serving, training, the block store, the sweep and the pipeline, and the
chaos tests that must exercise each site are three different sets of files
that have to agree.  :func:`fault_site_findings` checks all three
directions:

1. every site string passed to an injection point exists in
   :data:`~lightgbm_tpu_torch.faults.SITES`;
2. every registered site is consulted somewhere in the package;
3. every registered site is referenced from at least one test module
   (the chaos matrix must not silently stop covering a site).

:class:`Program` parses every module of the package once and runs the
per-file rules over each.  The reference's traced and mesh closures
(GL001-GL007, GL012, GL013) and its parity anchors (GL014) are not ported.
Pure ``ast``: nothing here imports torch or the package under analysis.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .rules import Finding, _ModuleAnalysis, apply_waivers

# the shared fault-site registry: module (dotted suffix) and the tuple
# assignments that define it
FAULTS_MODULE_SUFFIX = "faults"
SITE_REGISTRY_NAMES = ("SERVING_SITES", "TRAINING_SITES", "PIPELINE_SITES",
                       "SWEEP_SITES")

# receivers that make a ``.check("site")`` call a fault consultation —
# precision guard: budget specs also have .check() methods (no string
# argument), and unrelated APIs may take string-first .check calls
_INJECTORISH = ("fault", "inject")


def module_name_of(rel_path: str) -> str:
    """Dotted module name for a repo-relative posix path.

    ``lightgbm_tpu_torch/serving/queue.py`` ->
    ``lightgbm_tpu_torch.serving.queue``; ``lightgbm_tpu_torch/__init__.py``
    -> ``lightgbm_tpu_torch``.
    """
    p = rel_path[:-3] if rel_path.endswith(".py") else rel_path
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


@dataclass
class ModuleEntry:
    """One parsed module."""

    rel: str                                 # repo-relative posix path
    modname: str                             # dotted module name
    src: str
    analysis: Optional[_ModuleAnalysis]      # None when GL000 fired
    parse_finding: Optional[Finding] = None


class Program:
    """Every module of the package, parsed once."""

    def __init__(self, modules: Sequence[Tuple[str, str]]) -> None:
        """``modules`` is a list of (repo-relative posix path, source)."""
        self.entries: List[ModuleEntry] = []
        for rel, src in modules:
            modname = module_name_of(rel)
            try:
                tree = ast.parse(src)
            except SyntaxError as e:
                entry = ModuleEntry(
                    rel, modname, src, None,
                    Finding("GL000", rel, e.lineno or 1, 0,
                            f"syntax error: {e.msg}"))
            else:
                entry = ModuleEntry(rel, modname, src,
                                    _ModuleAnalysis(rel, tree))
            self.entries.append(entry)

    def run_rules(self) -> List[Finding]:
        out: List[Finding] = []
        for e in self.entries:
            if e.analysis is None:
                out.append(e.parse_finding)
                continue
            out.extend(apply_waivers(e.analysis.run(), e.src))
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        return out


# ---------------------------------------------------------------------------
# GL010 — fault-site registry drift
# ---------------------------------------------------------------------------
def _registry_sites(entry: ModuleEntry) -> Dict[str, int]:
    """site -> registry line, from the ``*_SITES`` tuple assignments."""
    sites: Dict[str, int] = {}
    if entry.analysis is None:
        return sites
    for node in ast.walk(entry.analysis.tree):
        if not isinstance(node, ast.Assign):
            continue
        names = {t.id for t in node.targets if isinstance(t, ast.Name)}
        if not (names & set(SITE_REGISTRY_NAMES)):
            continue
        if isinstance(node.value, (ast.Tuple, ast.List)):
            for el in node.value.elts:
                if isinstance(el, ast.Constant) and \
                        isinstance(el.value, str):
                    sites[el.value] = node.lineno
    return sites


def _is_injectorish(recv: ast.AST) -> bool:
    names: List[str] = []
    while isinstance(recv, ast.Attribute):
        names.append(recv.attr)
        recv = recv.value
    if isinstance(recv, ast.Name):
        names.append(recv.id)
    return any(m in n.lower() for n in names for m in _INJECTORISH)


def _consultation_sites(entry: ModuleEntry) -> List[Tuple[str, ast.AST]]:
    """(site string, node) for every fault-injection consultation:
    ``<injectorish>.check("site")``, ``.arm("site"|site=...)``, and
    ``FaultSpec("site"|site=...)``."""
    out: List[Tuple[str, ast.AST]] = []
    if entry.analysis is None:
        return out

    def const_site(call: ast.Call) -> Optional[str]:
        if call.args and isinstance(call.args[0], ast.Constant) and \
                isinstance(call.args[0].value, str):
            return call.args[0].value
        for kw in call.keywords:
            if kw.arg == "site" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
        return None

    for node in ast.walk(entry.analysis.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth == "check" and _is_injectorish(node.func.value):
                site = const_site(node)
                if site is not None:
                    out.append((site, node))
            elif meth == "arm":
                site = const_site(node)
                if site is not None:
                    out.append((site, node))
        elif isinstance(node.func, ast.Name) and \
                node.func.id == "FaultSpec":
            site = const_site(node)
            if site is not None:
                out.append((site, node))
    return out


def _string_constants(tree: ast.Module) -> Set[str]:
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def fault_site_findings(
        program: Program,
        test_sources: Sequence[Tuple[str, str]] = ()) -> List[Finding]:
    """GL010: registry <-> usage <-> test coverage, all three directions.

    ``test_sources`` is (path, source) for the chaos/resilience test
    modules (the port's ``tests/test_torch_*.py``); when empty the
    test-coverage direction is skipped (per-file CLI invocations don't see
    the test tree).
    """
    registry_entry = None
    for e in program.entries:
        if e.modname.endswith("." + FAULTS_MODULE_SUFFIX) or \
                e.modname == FAULTS_MODULE_SUFFIX:
            if _registry_sites(e):
                registry_entry = e
                break
    if registry_entry is None:
        return []                    # nothing to drift against
    registered = _registry_sites(registry_entry)

    findings: List[Finding] = []
    used: Set[str] = set()
    for e in program.entries:
        for site, node in _consultation_sites(e):
            used.add(site)
            if site not in registered:
                findings.append(Finding(
                    "GL010", e.rel, node.lineno, node.col_offset,
                    f"fault site {site!r} is not in the shared SITES "
                    f"registry ({registry_entry.rel}) — FaultSpec "
                    f"construction will raise at runtime; register it "
                    f"or fix the typo"))
    # the registry module itself consults sites through subscripts
    # (hits['clock']) rather than .check() — count its string constants
    # as usage, excluding the registry assignments themselves
    if registry_entry.analysis is not None:
        reg_lines = set(_registry_sites(registry_entry).values())
        for node in ast.walk(registry_entry.analysis.tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str) and \
                    node.value in registered and \
                    node.lineno not in reg_lines:
                used.add(node.value)

    for site, line in sorted(registered.items()):
        if site not in used:
            findings.append(Finding(
                "GL010", registry_entry.rel, line, 0,
                f"registered fault site {site!r} is never consulted "
                f"(.check/.arm/FaultSpec) anywhere in the package — "
                f"dead registry entries hide coverage gaps; wire it in "
                f"or remove it"))

    if test_sources:
        covered: Set[str] = set()
        for _, src in test_sources:
            try:
                tree = ast.parse(src)
            except SyntaxError:
                continue
            covered |= _string_constants(tree) & set(registered)
        for site, line in sorted(registered.items()):
            if site not in covered:
                findings.append(Finding(
                    "GL010", registry_entry.rel, line, 0,
                    f"registered fault site {site!r} is not referenced "
                    f"by any chaos/resilience test — the chaos matrix "
                    f"silently stopped covering it"))
    return findings
