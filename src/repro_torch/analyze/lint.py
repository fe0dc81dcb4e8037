"""Repo invariant linter of the PyTorch port: AST checks encoding the
ROADMAP's own rules.

The JAX package's linter, rule for rule, with its path allowlists pointed at
``repro_torch/...``.  Every invariant below is pinned by example-based
tests in ``tests/``; this linter makes them *structural*, so a new module
cannot violate one silently.  ``python -m repro_torch.analyze
src/repro_torch`` runs all rules and exits non-zero on any finding.

Rules (stable ids, one :class:`LintFinding` per violation):

``no-builtin-hash``
    Python's builtin ``hash()`` is salted per process (PYTHONHASHSEED), so
    hashing names/identities breaks cross-process determinism.  Use
    ``zlib.crc32(name.encode())`` — the repo's CRC-32 rule (FaultPlan lane
    hashing, param-tree rng folding).

``wall-clock``
    ``time.time()`` is banned everywhere (wall timing uses the monotonic
    ``time.perf_counter``), and *any* wall clock — ``time.time`` or
    ``time.perf_counter`` — is banned inside modeled-accounting modules
    (:data:`MODELED_ACCOUNTING`), where time must come from the machine
    model or an injected clock.  Referencing ``time.perf_counter`` without
    calling it (the serve layers' ``clock=time.perf_counter`` injection
    default) is always allowed: the rule flags *calls*.

``tracer-guard``
    Observability is zero-overhead when off: every ``<obj>.tracer.…`` /
    ``<obj>._tracer.…`` access on a hot path must be dominated by an
    ``… is not None`` guard on the same attribute (or live inside a
    ``_trace*`` helper that is only entered under such a guard).

``registry-kernels``
    Kernel objects are constructed only through the
    :func:`~repro_torch.core.program.kernel_family` registry (builders decorated
    with it), plus the closed allowlist :data:`KERNEL_CTOR_MODULES`
    (the runtime's transfer/marker sentinels, the program registry itself,
    and the ``batched_stages`` adapter that re-wraps an existing kernel).

``bench-history``
    ``BENCH_*.json`` trajectories are append-only and written through
    ``benchmarks/history.py`` only (the port's benches write no file at
    all); any module that names a ``BENCH_*.json``
    file and also opens/dumps files itself is flagged.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Iterable, List, Optional, Sequence, Tuple, Union

__all__ = ["LintFinding", "lint_source", "lint_file", "lint_paths",
           "MODELED_ACCOUNTING", "KERNEL_CTOR_MODULES"]


#: module path suffixes where ANY wall-clock call is banned: these modules
#: produce or transform *modeled* time/energy, which must never mix with
#: host wall time (the virtual-clock invariant; serve clocks are injected)
MODELED_ACCOUNTING: Tuple[str, ...] = (
    "repro_torch/core/machine.py",
    "repro_torch/core/power.py",
    "repro_torch/serve/faults.py",
    "repro_torch/obs/",
)

#: module path suffixes allowed to call ``Kernel(...)`` directly:
#: the runtime (defines Kernel + the marker/transfer sentinels), the
#: registry itself, and the micro-batching adapter that re-wraps an
#: existing kernel's executor while preserving its registry identity
KERNEL_CTOR_MODULES: Tuple[str, ...] = (
    "repro_torch/core/runtime.py",
    "repro_torch/core/program.py",
    "repro_torch/serve/batching.py",
)

_BENCH_RE = re.compile(r"BENCH_\w+\.json")
_BENCH_WRITER = "benchmarks/history.py"


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _posix(path: Union[str, pathlib.Path]) -> str:
    return pathlib.PurePath(path).as_posix()


def _dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _parents(tree: ast.AST) -> dict:
    par = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


def _has_not_none_guard(test: ast.AST, dotted: str) -> bool:
    """True when ``test`` contains ``<dotted> is not None`` (possibly inside
    an ``and`` chain or parenthesized boolean expression)."""
    for sub in ast.walk(test):
        if (isinstance(sub, ast.Compare) and len(sub.ops) == 1
                and isinstance(sub.ops[0], ast.IsNot)
                and isinstance(sub.comparators[0], ast.Constant)
                and sub.comparators[0].value is None
                and _dotted(sub.left) == dotted):
            return True
    return False


def _in_subtree(node: ast.AST, roots: Sequence[ast.AST], parents: dict) -> bool:
    cur: Optional[ast.AST] = node
    roots_id = {id(r) for r in roots}
    while cur is not None:
        if id(cur) in roots_id:
            return True
        cur = parents.get(cur)
    return False


def _rule_no_builtin_hash(tree, path, src, findings):
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "hash"):
            findings.append(LintFinding(
                path, node.lineno, "no-builtin-hash",
                "builtin hash() is salted per process (PYTHONHASHSEED); "
                "use zlib.crc32(name.encode()) for stable identities"))


def _rule_wall_clock(tree, path, src, findings):
    modeled = any(m in path for m in MODELED_ACCOUNTING)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _dotted(node.func)
        if fn == "time.time":
            findings.append(LintFinding(
                path, node.lineno, "wall-clock",
                "time.time() is banned: wall timing uses the monotonic "
                "time.perf_counter()"
                + (" (and modeled-accounting modules use no wall clock "
                   "at all)" if modeled else "")))
        elif fn == "time.perf_counter" and modeled:
            findings.append(LintFinding(
                path, node.lineno, "wall-clock",
                "modeled-accounting module calls time.perf_counter(); "
                "modeled time comes from the machine model / an injected "
                "clock, never the host wall clock"))


def _rule_tracer_guard(tree, path, src, findings):
    parents = _parents(tree)
    for node in ast.walk(tree):
        # match `<expr>.tracer.<attr>` / `<expr>._tracer.<attr>`: the value
        # chain must itself be an attribute named tracer (bare locals named
        # `tracer` are non-None by construction and exempt)
        if not (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Attribute)
                and node.value.attr in ("tracer", "_tracer")):
            continue
        receiver = _dotted(node.value)
        if receiver is None:
            continue
        guarded = False
        cur: Optional[ast.AST] = node
        while cur is not None and not guarded:
            parent = parents.get(cur)
            if (isinstance(parent, ast.If)
                    and _in_subtree(node, parent.body, parents)
                    and _has_not_none_guard(parent.test, receiver)):
                guarded = True
            elif (isinstance(parent, ast.IfExp)
                    and _in_subtree(node, [parent.body], parents)
                    and _has_not_none_guard(parent.test, receiver)):
                guarded = True
            elif (isinstance(parent, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and parent.name.startswith("_trace")):
                # a `_trace*` helper is the guard's hoisted body: its call
                # sites sit under the `is not None` check
                guarded = True
            cur = parent
        if not guarded:
            findings.append(LintFinding(
                path, node.lineno, "tracer-guard",
                f"unguarded {receiver}.{node.attr} on a hot path; dominate "
                f"it with `if {receiver} is not None:` (zero-overhead-"
                "when-off observability)"))


def _rule_registry_kernels(tree, path, src, findings):
    if any(path.endswith(m) or m in path for m in KERNEL_CTOR_MODULES):
        return
    parents = _parents(tree)

    def in_family_builder(node: ast.AST) -> bool:
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in cur.decorator_list:
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    name = _dotted(target) or ""
                    if name.split(".")[-1] == "kernel_family":
                        return True
            cur = parents.get(cur)
        return False

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _dotted(node.func) or ""
        if fn.split(".")[-1] != "Kernel":
            continue
        if not in_family_builder(node):
            findings.append(LintFinding(
                path, node.lineno, "registry-kernels",
                "direct Kernel(...) construction outside a @kernel_family "
                "builder; register the kernel through repro_torch.core.program "
                "so serving identity/caching stay registry-keyed"))


def _rule_bench_history(tree, path, src, findings):
    if path.endswith(_BENCH_WRITER):
        return
    if not _BENCH_RE.search(src):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = _dotted(node.func) or ""
        flagged = False
        if fn == "open" or fn.endswith(".open"):
            mode = None
            if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
                mode = node.args[1].value
            for kw in node.keywords:
                if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                    mode = kw.value.value
            flagged = isinstance(mode, str) and any(
                c in mode for c in ("w", "a", "x"))
        elif fn == "json.dump" or fn.split(".")[-1] in ("write_text",
                                                        "write_bytes"):
            flagged = True
        if flagged:
            findings.append(LintFinding(
                path, node.lineno, "bench-history",
                "module names a BENCH_*.json trajectory but writes files "
                "directly; append through benchmarks/history.append_entry "
                "(append-only bench trajectories)"))


_RULES = (_rule_no_builtin_hash, _rule_wall_clock, _rule_tracer_guard,
          _rule_registry_kernels, _rule_bench_history)


def lint_source(source: str, path: Union[str, pathlib.Path]) -> List[LintFinding]:
    """Run every rule over one module's source.  ``path`` is used both for
    reporting and for path-keyed allowlists (match it repo-relative)."""
    spath = _posix(path)
    try:
        tree = ast.parse(source, filename=spath)
    except SyntaxError as e:
        return [LintFinding(spath, e.lineno or 0, "syntax-error", str(e.msg))]
    findings: List[LintFinding] = []
    for rule in _RULES:
        rule(tree, spath, source, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_file(path: Union[str, pathlib.Path]) -> List[LintFinding]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(), p)


def _iter_py(paths: Iterable[Union[str, pathlib.Path]]):
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        else:
            yield p


def lint_paths(paths: Iterable[Union[str, pathlib.Path]]) -> List[LintFinding]:
    """Lint every ``*.py`` under ``paths`` (files or directories)."""
    findings: List[LintFinding] = []
    for f in _iter_py(paths):
        findings.extend(lint_file(f))
    return findings
