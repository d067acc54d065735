"""graftlint's backend-neutral AST rules — the port of the production-loop
families of ``lightgbm_tpu/analysis/rules.py``.

The reference's Layer 1 finds JAX footguns (traced-value branching, host
syncs in traced code, static arguments, Pallas refs, ``shard_map`` axes,
quantized casts: GL001-GL007, GL012, GL013); the port traces nothing, so
those rules have no meaning here (ROADMAP, "Deliberately not ported"), and
on the card host syncs are held by ``chip_smoke.py``'s sync debug mode
"error" instead.  What carries over are the four production-loop families,
whose rule logic is copied so that the reference's fixtures give the same
findings at the same line and column through either analyzer:

* GL008 determinism — wall-clock reads and unseeded or process-global RNG
  draws outside the injectable-clock contract;
* GL009 lock discipline — attributes mutated both inside and outside
  ``with self._lock`` in a class that owns a threading lock;
* GL010 fault-site registry drift — whole-program, in :mod:`.program`;
* GL011 typed-error discipline — bare ``except:``, ``raise Exception``,
  swallowed handlers.

The detectors are high-precision heuristics: a finding is either a real
bug or a deliberate decision worth a waiver or a baseline entry.  Pure
``ast``: nothing here imports torch or the package under analysis.  See
analysis/RULES.md for one bad/good example per rule.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

# -- GL008: determinism --------------------------------------------------
# ``time`` module calls that read (or stall on) the wall clock.  A bare
# REFERENCE (``clock=time.monotonic`` as a default) is the sanctioned
# injection idiom and never matches — only calls do.
WALL_CLOCK_CALLS = {
    "time", "sleep", "monotonic", "perf_counter", "process_time",
    "time_ns", "monotonic_ns", "perf_counter_ns", "process_time_ns",
}
DATETIME_NOW_CALLS = {"now", "utcnow", "today"}
# ``random`` module functions that consume the process-global RNG
PY_RANDOM_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "betavariate",
    "expovariate", "getrandbits", "seed",
}
# np.random constructors that are deterministic WHEN SEEDED
NP_RNG_CONSTRUCTORS = {"default_rng", "RandomState", "Generator",
                       "SeedSequence", "PCG64", "Philox"}

# -- GL009: lock discipline ----------------------------------------------
LOCK_FACTORIES = {"Lock", "RLock"}
# container methods that mutate their receiver in place
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "update", "setdefault", "pop", "popleft", "popitem", "remove",
    "discard", "clear",
}
HEAPQ_MUTATORS = {"heappush", "heappop", "heappushpop", "heapreplace"}


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    @property
    def anchor(self) -> str:
        return f"{self.path}:{self.line}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}")


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------
def _attr_chain(node: ast.AST) -> List[str]:
    """['jax', 'numpy', 'asarray'] for jax.numpy.asarray; [] if not a
    plain dotted name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


def _call_target(call: ast.Call) -> Tuple[Optional[str], List[str]]:
    """(final attr name, full dotted chain) of a call's callee."""
    chain = _attr_chain(call.func)
    if chain:
        return chain[-1], chain
    if isinstance(call.func, ast.Name):
        return call.func.id, [call.func.id]
    return None, []


class _ModuleAnalysis:
    """Import tables + rule dispatch for one module."""

    def __init__(self, path: str, tree: ast.Module) -> None:
        self.path = path
        self.tree = tree
        self.findings: List[Finding] = []
        # local binding -> imported module ('np' -> 'numpy'); and
        # local binding -> (module, symbol) for from-imports
        self.import_aliases: Dict[str, str] = {}
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.import_aliases[a.asname] = a.name
                    else:
                        top = a.name.split(".")[0]
                        self.import_aliases[top] = top
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.from_imports[a.asname or a.name] = (node.module,
                                                             a.name)

    def _module_of(self, root: str) -> str:
        """Resolve a name root through import aliases (np -> numpy)."""
        return self.import_aliases.get(root, root)

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(rule, self.path, node.lineno,
                                     node.col_offset, message))

    def run(self) -> List[Finding]:
        self._rule_determinism()
        self._rule_lock_discipline()
        self._rule_typed_errors()
        return self.findings

    # -- GL008: determinism (injectable-clock / seeded-RNG contract) ---------
    def _rule_determinism(self) -> None:
        """Direct wall-clock reads and global-RNG draws.  Only *calls*
        match: ``clock=time.monotonic`` as a default argument is the
        sanctioned injection idiom and is a bare reference, never a
        call.  The one legitimate boundary (pipeline/staleness.py's
        ``wall_clock``) carries an inline waiver."""
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            tgt, chain = _call_target(node)
            if not chain or tgt is None:
                continue
            mod = self._module_of(chain[0])
            if len(chain) == 2 and mod == "time" and \
                    tgt in WALL_CLOCK_CALLS:
                self.emit(
                    "GL008", node,
                    f"direct `{chain[0]}.{tgt}()` — the long-running "
                    f"subsystems promise an injectable clock; accept "
                    f"`clock=time.monotonic` as a parameter and call "
                    f"`clock()` so SimClock tests stay deterministic")
            elif mod == "datetime" and tgt in DATETIME_NOW_CALLS and \
                    2 <= len(chain) <= 3:
                self.emit(
                    "GL008", node,
                    f"`{'.'.join(chain)}()` reads the wall clock — "
                    f"thread a clock parameter (or a timestamp argument) "
                    f"instead of sampling ambient time")
            elif len(chain) == 2 and mod == "random" and \
                    tgt in PY_RANDOM_FNS:
                self.emit(
                    "GL008", node,
                    f"`{chain[0]}.{tgt}()` draws from the process-global "
                    f"RNG — construct `random.Random(seed)` (or accept "
                    f"an rng parameter) so runs replay bit-identically")
            elif mod == "numpy" and len(chain) == 3 and \
                    chain[1] == "random":
                if tgt in NP_RNG_CONSTRUCTORS:
                    if not node.args and not node.keywords:
                        self.emit(
                            "GL008", node,
                            f"`{'.'.join(chain)}()` without a seed pulls "
                            f"OS entropy — pass an explicit seed (the "
                            f"workbench's runs must replay "
                            f"bit-identically)")
                else:
                    self.emit(
                        "GL008", node,
                        f"`{'.'.join(chain)}()` uses numpy's legacy "
                        f"global RNG — use a seeded "
                        f"np.random.default_rng(seed) generator")
            elif len(chain) == 1:
                fi = self.from_imports.get(tgt)
                if fi is None:
                    continue
                fmod, fsym = fi
                if fmod == "time" and fsym in WALL_CLOCK_CALLS:
                    self.emit(
                        "GL008", node,
                        f"direct `{tgt}()` (time.{fsym}) — accept an "
                        f"injectable clock parameter instead")
                elif fmod == "random" and fsym in PY_RANDOM_FNS:
                    self.emit(
                        "GL008", node,
                        f"`{tgt}()` (random.{fsym}) draws from the "
                        f"process-global RNG — use a seeded instance")

    # -- GL009: lock discipline ---------------------------------------------
    def _rule_lock_discipline(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                self._lock_check_class(node)

    @staticmethod
    def _self_attr(node: ast.AST, selfname: str) -> Optional[str]:
        """First attribute on a self.<attr>[...]... chain, else None."""
        attrs: List[str] = []
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            if isinstance(node, ast.Attribute):
                attrs.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name) and node.id == selfname and attrs:
            return attrs[-1]
        return None

    def _lock_check_class(self, cls: ast.ClassDef) -> None:
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

        def self_name(m) -> str:
            return m.args.args[0].arg if m.args.args else "self"

        # 1. which attrs hold threading locks?
        locks: Set[str] = set()
        for m in methods:
            sn = self_name(m)
            for node in ast.walk(m):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                tgt, chain = _call_target(node.value)
                if tgt not in LOCK_FACTORIES:
                    continue
                from_threading = (
                    (len(chain) >= 2
                     and self._module_of(chain[0]) == "threading")
                    or (len(chain) == 1 and self.from_imports.get(
                        tgt, ("", ""))[0] == "threading"))
                if not from_threading:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == sn:
                        locks.add(t.attr)
        if not locks:
            return

        # 2. classify every self-attr mutation site as locked/unlocked
        locked: Dict[str, List[ast.AST]] = {}
        unlocked: Dict[str, List[ast.AST]] = {}

        def is_lock_expr(expr: ast.AST, sn: str) -> bool:
            a = self._self_attr(expr, sn)
            return a in locks

        def record(stmt: ast.AST, sn: str, in_lock: bool) -> None:
            sites = locked if in_lock else unlocked
            for node in ast.walk(stmt):
                attr = None
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        a = self._self_attr(t, sn)
                        if a:
                            sites.setdefault(a, []).append(node)
                    continue
                if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    attr = self._self_attr(node.target, sn)
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        a = self._self_attr(t, sn)
                        if a:
                            sites.setdefault(a, []).append(node)
                    continue
                elif isinstance(node, ast.Call):
                    tgt, chain = _call_target(node)
                    if tgt in MUTATOR_METHODS and isinstance(
                            node.func, ast.Attribute):
                        attr = self._self_attr(node.func.value, sn)
                    elif tgt in HEAPQ_MUTATORS and node.args:
                        attr = self._self_attr(node.args[0], sn)
                if attr:
                    sites.setdefault(attr, []).append(node)

        def scan(body: List[ast.stmt], sn: str, in_lock: bool) -> None:
            for stmt in body:
                if isinstance(stmt, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    continue
                if isinstance(stmt, ast.With):
                    inner = in_lock or any(
                        is_lock_expr(i.context_expr, sn)
                        for i in stmt.items)
                    scan(stmt.body, sn, inner)
                elif isinstance(stmt, (ast.If, ast.For, ast.While)):
                    head = (stmt.iter if isinstance(stmt, ast.For)
                            else stmt.test)
                    record(head, sn, in_lock)
                    scan(stmt.body, sn, in_lock)
                    scan(stmt.orelse, sn, in_lock)
                elif isinstance(stmt, ast.Try):
                    scan(stmt.body, sn, in_lock)
                    for h in stmt.handlers:
                        scan(h.body, sn, in_lock)
                    scan(stmt.orelse, sn, in_lock)
                    scan(stmt.finalbody, sn, in_lock)
                else:
                    record(stmt, sn, in_lock)

        for m in methods:
            if m.name in ("__init__", "__new__"):
                continue            # construction precedes sharing
            scan(list(m.body), self_name(m), in_lock=False)

        for attr in sorted(set(locked) & set(unlocked)):
            if attr in locks:
                continue
            for node in unlocked[attr]:
                self.emit(
                    "GL009", node,
                    f"`self.{attr}` is mutated under the lock elsewhere "
                    f"in `{cls.name}` but not here — every write to a "
                    f"lock-guarded attribute must sit inside `with "
                    f"self._lock:` (use RLock if helpers re-enter)")

    # -- GL011: typed-error discipline ---------------------------------------
    def _rule_typed_errors(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ExceptHandler):
                if node.type is None:
                    self.emit(
                        "GL011", node,
                        "bare `except:` catches SystemExit/Keyboard"
                        "Interrupt too — name the typed fault "
                        "(SwapRejected, OOCBlockError, FaultError, ...) "
                        "or `except Exception` at an outermost boundary")
                elif len(node.body) == 1 and isinstance(node.body[0],
                                                        ast.Pass):
                    self.emit(
                        "GL011", node,
                        "swallowed exception (`except ...: pass`) — "
                        "record, re-raise, or degrade explicitly; silent "
                        "drops hide chaos-matrix regressions")
            elif isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                name = None
                if isinstance(exc, ast.Call) and isinstance(exc.func,
                                                            ast.Name):
                    name = exc.func.id
                elif isinstance(exc, ast.Name):
                    name = exc.id
                if name in ("Exception", "BaseException"):
                    self.emit(
                        "GL011", node,
                        f"`raise {name}(...)` defeats the typed-error "
                        f"contract — raise one of the workbench's typed "
                        f"faults so callers can catch precisely")


# GL000 (a file that does not parse) and the ported rule ids
RULE_IDS = ("GL000", "GL008", "GL009", "GL010", "GL011")


def apply_waivers(findings: List[Finding], src: str) -> List[Finding]:
    """Drop findings waived inline: `# graftlint: GLxxx — reason` on the
    finding's line.  GL000 (parse failure) is never waivable — a file
    that does not parse cannot carry a trustworthy comment."""
    lines = src.splitlines()
    kept = []
    for f in findings:
        if f.rule != "GL000":
            line = lines[f.line - 1] if f.line - 1 < len(lines) else ""
            if "graftlint:" in line:
                waiver = line.split("graftlint:", 1)[1]
                if f.rule in waiver or "off" in waiver:
                    continue
        kept.append(f)
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule))


def analyze_source(path: str, src: str) -> List[Finding]:
    """Run every per-file rule over one module's source (GL010 needs the
    whole program and lives in :mod:`.program`)."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("GL000", path, e.lineno or 1, 0,
                        f"syntax error: {e.msg}")]
    return apply_waivers(_ModuleAnalysis(path, tree).run(), src)
