"""graftlint's whole-program rules, GL010 and GL014 — the port of the
fault-site and parity-anchor parts of ``lightgbm_tpu/analysis/program.py``.

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

:func:`parity_anchor_findings` (GL014) pins every claim of the port's
parity contracts (``lightgbm_tpu_torch/PARITY.md``) to the live port
symbols and ``tests/test_torch_*.py`` tests that carry it, both ways.

:class:`Program` parses every module of the package once and runs the
per-file rules over each.  The reference's traced and mesh closures
(GL001-GL007, GL012, GL013) are not ported.  Pure ``ast``: nothing here
imports torch or the package under analysis.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
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


# ---------------------------------------------------------------------------
# GL014 — parity-contract anchors
# ---------------------------------------------------------------------------
# Every section of the port's PARITY.md that makes a bit-identical /
# tolerance claim is pinned to the live code and tests that carry it — the
# BUDGET_ANCHORS discipline applied to parity contracts.  Keys are the
# ``## `` heading texts, values (repo-relative file, top-level symbol)
# pairs; renaming or deleting a pinned symbol fails the lint NAMING the
# stale contract.
PARITY_DOC = "lightgbm_tpu_torch/PARITY.md"
_PARITY_CLAIM_RE = re.compile(r"bit-?identical|bitwise|tolerance", re.I)

PARITY_ANCHORS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "The dyadic tier: bit-identical trees and predictions": (
        ("lightgbm_tpu_torch/models/tree.py", "grow_tree"),
        ("lightgbm_tpu_torch/ops/split.py", "find_best_split"),
        ("lightgbm_tpu_torch/ops/histogram.py", "compute_histograms"),
        ("tests/test_torch_train.py", "test_dyadic_round1_bit_identical"),
        ("tests/test_torch_train.py",
         "test_dyadic_half_tail_with_every_regularizer"),
        ("tests/test_torch_int8.py", "test_wave_tree_dyadic_bit_identical"),
    ),
    "General data: split structure equal, values within tolerance": (
        ("lightgbm_tpu_torch/ops/split.py", "find_best_split"),
        ("lightgbm_tpu_torch/models/gbdt.py", "Booster"),
        ("tests/test_torch_train.py",
         "test_general_l2_structure_and_values"),
        ("tests/test_torch_train.py",
         "test_general_binary_structure_and_values"),
        ("tests/test_torch_near_ties.py",
         "test_near_tied_thresholds_swap_only_where_no_in_bag_row_lies"),
    ),
    "Kernels against their plain versions": (
        ("lightgbm_tpu_torch/ops/histogram.py", "compute_histograms"),
        ("lightgbm_tpu_torch/ops/predict.py", "predict_forest"),
        ("lightgbm_tpu_torch/ops/predict.py", "predict_forest_plain"),
        ("lightgbm_tpu_torch/kernels/histogram.py", "int8_passes_plain"),
        ("tests/test_torch_b1_b2_passes.py",
         "test_passes_match_the_plain_version"),
        ("tests/test_torch_predict.py",
         "test_wrapper_takes_plain_version_only_for_cpu_tensors"),
        ("tests/test_torch_kernels_on_card.py",
         "test_b1_kernel_matches_plain_on_card"),
        ("tests/test_torch_kernels_on_card.py",
         "test_b3_kernel_matches_plain_bit_for_bit_on_card"),
        ("tests/test_torch_kernels_on_card.py",
         "test_kernel_matches_plain_version_on_card"),
    ),
    "int8 histograms quantize on the CPU too": (
        ("lightgbm_tpu_torch/ops/histogram.py", "quantize_int8"),
        ("tests/test_torch_int8.py",
         "test_plain_int8_histogram_bit_equal_to_pallas"),
        ("tests/test_torch_int8.py", "test_quantize_int8_bit_equal_to_pallas"),
        ("tests/test_torch_int8.py", "test_train_l2_int8_matches_reference"),
    ),
    "Streamed training equals in-memory training": (
        ("lightgbm_tpu_torch/data/block_store.py", "BlockStore"),
        ("lightgbm_tpu_torch/data/stream_grow.py", "stream_grow_tree"),
        ("tests/test_torch_streaming.py",
         "test_dyadic_streamed_bit_equal_reference_and_in_memory"),
        ("tests/test_torch_streaming.py",
         "test_general_streamed_within_regime"),
        ("tests/test_torch_stream_dp.py", "test_dyadic_bit_identical"),
    ),
    "The mesh equals serial on exact sums; the lossy wires": (
        ("lightgbm_tpu_torch/ops/histogram.py", "histogram_merge"),
        ("lightgbm_tpu_torch/ops/quantize.py", "wire_transfer"),
        ("lightgbm_tpu_torch/parallel/mesh.py", "psum"),
        ("tests/test_torch_parallel_train.py",
         "test_dyadic_round_one_bit_identical"),
        ("tests/test_torch_parallel_train.py", "test_learner_matches_serial"),
        ("tests/test_torch_parallel.py",
         "test_wire_transfer_matches_reference"),
        ("tests/test_torch_parallel.py",
         "test_histogram_merge_matches_reference"),
    ),
    "Kill and resume: bit-identical": (
        ("lightgbm_tpu_torch/training/checkpoint.py", "save_checkpoint"),
        ("lightgbm_tpu_torch/training/loop.py", "train_resumable"),
        ("tests/test_torch_checkpoint.py",
         "test_kill_at_every_round_resumes_bit_identical"),
        ("tests/test_torch_checkpoint.py",
         "test_sigterm_drains_checkpoints_and_resumes"),
        ("tests/test_torch_kernels_on_card.py",
         "test_kill_and_resume_bit_identical_on_card"),
    ),
    "Model files interchange both ways": (
        ("lightgbm_tpu_torch/utils/serialize.py", "booster_to_string"),
        ("lightgbm_tpu_torch/serving/packed.py", "PackedForest"),
        ("tests/test_torch_model_io.py",
         "test_port_text_model_loads_in_reference"),
        ("tests/test_torch_model_io.py",
         "test_reference_text_model_loads_in_port"),
        ("tests/test_torch_model_io.py", "test_port_packed_npz_interchanges"),
        ("tests/test_torch_checkpoint.py",
         "test_port_checkpoint_resumes_in_reference"),
    ),
}


def _top_level_symbols(path: Path) -> Optional[Set[str]]:
    """Top-level def/class/assignment names of a module; None when the
    file is missing or does not parse (the caller reports that as the
    stale-anchor finding, not a crash)."""
    try:
        tree = ast.parse(path.read_text(encoding="utf-8"))
    except (OSError, SyntaxError):
        return None
    out: Set[str] = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _parity_sections(text: str) -> Dict[str, Tuple[int, str]]:
    """``## `` heading -> (1-based heading line, section body)."""
    sections: Dict[str, Tuple[int, str]] = {}
    title: Optional[str] = None
    start = 0
    body: List[str] = []
    for i, line in enumerate(text.splitlines(), start=1):
        if line.startswith("## "):
            if title is not None:
                sections[title] = (start, "\n".join(body))
            title = line[3:].strip()
            start = i
            body = []
        elif title is not None:
            body.append(line)
    if title is not None:
        sections[title] = (start, "\n".join(body))
    return sections


def parity_anchor_findings(
        repo_root: Path,
        anchors: Optional[Dict[str, Tuple[Tuple[str, str], ...]]] = None,
        parity_md: Optional[str] = None) -> List[Finding]:
    """GL014: the port's PARITY.md contracts <-> live code, both ways.

    1. every claim-bearing section (matches ``bit-identical``/
       ``bitwise``/``tolerance`` in its heading or prose; table rows are
       inventories, not claims) has a PARITY_ANCHORS entry;
    2. every PARITY_ANCHORS key names a section that still exists;
    3. every pinned (file, symbol) resolves to a live top-level symbol.

    ``anchors``/``parity_md`` are injectable for tests; the default pass
    reads ``PARITY_ANCHORS`` and ``<repo_root>/lightgbm_tpu_torch/PARITY.md``.
    """
    if anchors is None:
        anchors = PARITY_ANCHORS
    if parity_md is None:
        doc = Path(repo_root) / PARITY_DOC
        if not doc.is_file():
            if anchors:
                return [Finding(
                    "GL014", PARITY_DOC, 1, 0,
                    f"{len(anchors)} parity contract(s) are anchored but "
                    f"{PARITY_DOC} is missing — the contract document "
                    f"moved or was deleted without retiring its anchors")]
            return []
        parity_md = doc.read_text(encoding="utf-8")

    findings: List[Finding] = []
    sections = _parity_sections(parity_md)

    for title, (line, body) in sorted(sections.items(),
                                      key=lambda kv: kv[1][0]):
        prose = "\n".join(ln for ln in body.splitlines()
                          if not ln.lstrip().startswith("|"))
        if _PARITY_CLAIM_RE.search(title) or _PARITY_CLAIM_RE.search(prose):
            if title not in anchors:
                findings.append(Finding(
                    "GL014", PARITY_DOC, line, 0,
                    f"section {title!r} makes a bit-identical/tolerance "
                    f"claim but has no PARITY_ANCHORS entry — pin the "
                    f"claim to its (file, symbol) pairs in "
                    f"analysis/program.py so renames fail the lint"))

    symcache: Dict[str, Optional[Set[str]]] = {}
    for title in sorted(anchors):
        if title not in sections:
            findings.append(Finding(
                "GL014", PARITY_DOC, 1, 0,
                f"PARITY_ANCHORS pins section {title!r} but {PARITY_DOC} "
                f"has no such heading — the contract was renamed or "
                f"removed; update the anchor key (analysis/program.py) "
                f"in the same change"))
            continue
        line = sections[title][0]
        for rel, sym in anchors[title]:
            if rel not in symcache:
                symcache[rel] = _top_level_symbols(Path(repo_root) / rel)
            syms = symcache[rel]
            if syms is None:
                findings.append(Finding(
                    "GL014", PARITY_DOC, line, 0,
                    f"contract {title!r} is anchored to {rel} which is "
                    f"missing or unparseable — the parity-bearing module "
                    f"moved; re-pin the contract"))
            elif sym not in syms:
                findings.append(Finding(
                    "GL014", PARITY_DOC, line, 0,
                    f"contract {title!r} is anchored to {rel}:{sym} "
                    f"which no longer exists at top level — the "
                    f"parity-bearing symbol was renamed or deleted; "
                    f"update the contract and its anchor together"))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings
