"""Analyzer engine: file walking, per-module AST context, capture-region
resolution, baseline/suppression handling.

The port's copy of ``bcg_tpu/analysis/core.py``.  Where the JAX package
resolves *traced regions* (jitted functions, ``lax`` loop operands and
their callees), the port resolves **capture regions**: the code that a
CUDA graph of the decode step (or of the fused round) records, which
must read nothing on the host — a host read there either breaks the
capture or bakes one step's value into every replay.  The roots are
declared by qualified name in :data:`CAPTURE_ROOTS` (never marked in the
hot code itself); callees of a region, in its module and across modules
(``interproc.ProgramContext.propagate_capture_regions``), are regions
too.

Rules live in :mod:`bcg_tpu_torch.analysis.rules`; each is a callable
``rule(ctx: ModuleContext) -> Iterable[Finding]``.  The engine parses
each file once, builds the shared context (source lines, capture-region
set, inline-suppression map), runs every rule, then subtracts baseline
matches.

Baseline entries match on ``(rule, path, stripped source line)`` — NOT
line numbers — so unrelated edits don't invalidate them, while deleting
or fixing the flagged line retires the entry (the meta-test in
``tests/test_torch_analysis.py`` asserts every entry still matches a
real finding: the baseline is load-bearing, not a blanket mute).
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore\[([A-Z0-9,\-\s]+)\]")

_LOOPS = (ast.For, ast.AsyncFor, ast.While)
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


@dataclass(frozen=True)
class CaptureRoot:
    """One root of a capture region.

    ``path`` is the repo-relative module, ``qualname`` the dotted name
    of a function in it (``Class.method``, ``outer.inner`` for a nested
    function).  ``body="function"`` makes the whole function a region;
    ``body="loop"`` only the body of its outermost loop (the per-step
    body of an eager decode loop, whose set-up and readback run once per
    call, outside the graph)."""

    path: str
    qualname: str
    body: str = "function"


# What a CUDA graph of the decode step, and of the fused round, will
# record (ROADMAP A10a): the model's step, the per-step bodies of the
# plain and fast-forward loops, the speculative loop, the fused round's
# program up to its one readback, and the fused sampler.
CAPTURE_ROOTS: Tuple[CaptureRoot, ...] = (
    CaptureRoot("bcg_tpu_torch/models/transformer.py", "decode_step"),
    CaptureRoot("bcg_tpu_torch/engine/torch_engine.py",
                "TorchEngine._decode_loop", body="loop"),
    CaptureRoot("bcg_tpu_torch/engine/torch_engine.py",
                "TorchEngine._ff_decode_loop", body="loop"),
    CaptureRoot("bcg_tpu_torch/engine/speculative.py", "spec_decode_loop"),
    CaptureRoot("bcg_tpu_torch/engine/megaround.py",
                "build_round_program.program"),
    CaptureRoot("bcg_tpu_torch/ops/guided_sampler.py",
                "make_fused_sampler.masked_sample"),
)


def repo_root() -> str:
    """The repository root (two levels above this package)."""
    return os.path.abspath(
        os.path.join(os.path.dirname(__file__), os.pardir, os.pardir)
    )


def default_paths() -> List[str]:
    """The tree the port's repo-wide run covers: the port's package and
    its card script.  The JAX package's checker keeps its own scope
    (``bcg_tpu/``, ``scripts/``, ``bench.py``)."""
    root = repo_root()
    paths = [os.path.join(root, "bcg_tpu_torch")]
    cand = os.path.join(root, "chip_smoke.py")
    if os.path.exists(cand):
        paths.append(cand)
    return paths


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    content: str  # stripped source of the flagged line (baseline key)

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.content)

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


@dataclass
class BaselineEntry:
    rule: str
    path: str
    content: str
    reason: str
    # Max occurrences this entry suppresses.  Identical source lines
    # (several bare ``except Exception:`` in one file) share a key, and
    # an uncapped entry would silently park every FUTURE violation with
    # the same text too — the blanket mute the baseline must not be.
    count: int = 1
    # BCG-HOST-SYNC entries: the runtime seam of obs/hostsync.py that
    # counts this sync (``obs_hostsync.note(<seam>, ...)``) — the static
    # and runtime views stay cross-linked.
    seam: str = ""

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.content)


def _qualnames(tree: ast.Module) -> Dict[str, ast.AST]:
    """``{"Class.method" / "outer.inner": FunctionDef}`` for the module."""
    out: Dict[str, ast.AST] = {}

    def visit(body, scope: Tuple[str, ...]) -> None:
        for node in body:
            if isinstance(node, _FUNCS):
                qn = ".".join(scope + (node.name,))
                out.setdefault(qn, node)
                visit(node.body, scope + (node.name,))
            elif isinstance(node, ast.ClassDef):
                visit(node.body, scope + (node.name,))
            elif isinstance(node, (ast.If, ast.Try, ast.With)):
                for part in ast.iter_child_nodes(node):
                    if isinstance(part, ast.stmt):
                        visit([part], scope)

    visit(tree.body, ())
    return out


def _outermost_loop(fn: ast.AST) -> Optional[ast.AST]:
    """The first loop of ``fn``'s own scope in source order (nested
    function bodies excluded) — the outermost one."""
    best = None
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        cur = stack.pop()
        if isinstance(cur, _FUNCS + (ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(cur, _LOOPS):
            if best is None or cur.lineno < best.lineno:
                best = cur
        stack.extend(ast.iter_child_nodes(cur))
    return best


class ModuleContext:
    """Everything a rule needs about one parsed file."""

    def __init__(self, path: str, rel_path: str, source: str,
                 roots: Sequence[CaptureRoot] = ()):
        self.path = path
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        mine = [r for r in roots if r.path == rel_path]
        # root_functions: the declared root FunctionDefs (BCG-JIT-BRANCH's
        # scope); unresolved: roots naming nothing here.
        self.root_functions: Set[ast.AST] = set()
        self.unresolved_roots: List[CaptureRoot] = []
        self.capture_regions = self._resolve_capture_regions(mine)
        # Filled by the whole-program pass (interproc.py): functions in
        # THIS module that run inside a capture region because a region
        # in ANOTHER module calls them.  Per-module rules see both sets
        # via in_capture_region.
        self.extra_capture_regions: Set[ast.AST] = set()
        self._capture_nodes: Optional[List[ast.AST]] = None

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def line_content(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        """Inline ``# lint: ignore[RULE]`` on the flagged line (or the
        line above, for flagged multi-line statements)."""
        for ln in (lineno, lineno - 1):
            m = _IGNORE_RE.search(self.line_content(ln))
            if m:
                ids = {s.strip() for s in m.group(1).split(",")}
                if rule in ids or "*" in ids:
                    return True
        return False

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        lineno = getattr(node, "lineno", 1)
        return Finding(
            rule=rule,
            path=self.rel_path,
            line=lineno,
            message=message,
            content=self.line_content(lineno),
        )

    def in_capture_region(self, node: ast.AST) -> bool:
        """Is ``node`` lexically inside a capture region: a region
        function (or lambda), or the body of a region loop — directly or
        because a region calls its function?"""
        child, cur = node, self._parents.get(node)
        while cur is not None:
            if cur in self.capture_regions or cur in self.extra_capture_regions:
                if not isinstance(cur, _LOOPS) or child in cur.body:
                    return True
            child, cur = cur, self._parents.get(cur)
        return False

    def capture_nodes(self) -> List[ast.AST]:
        """Every node inside a capture region (walked once, after the
        whole-program lift has filled ``extra_capture_regions``)."""
        if self._capture_nodes is None:
            seen: Set[int] = set()
            out: List[ast.AST] = []
            for region in self.capture_regions | self.extra_capture_regions:
                parts = region.body if isinstance(region, _LOOPS) else [region]
                for part in parts:
                    for node in ast.walk(part):
                        if id(node) not in seen:
                            seen.add(id(node))
                            out.append(node)
            self._capture_nodes = out
        return self._capture_nodes

    def in_expected_sync(self, node: ast.AST) -> bool:
        """Is ``node`` lexically inside ``with obs_hostsync.expected():``
        — a seam whose sync the runtime audit counts at its ``note``?"""
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        name = _call_name(expr.func)
                        last = name.rsplit(".", 1)[-1]
                        if last == "expected" and (
                            "hostsync" in name or name == "expected"
                        ):
                            return True
            if isinstance(cur, _FUNCS + (ast.Lambda,)):
                return False
            cur = self._parents.get(cur)
        return False

    def _resolve_capture_regions(
        self, roots: Sequence[CaptureRoot]
    ) -> Set[ast.AST]:
        """The region nodes of this module: each declared root (a
        FunctionDef, or the outermost loop of one), then a fixpoint over
        intra-module calls — a function invoked by simple name from
        inside a region runs inside it too."""
        funcs_by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, _FUNCS):
                funcs_by_name.setdefault(node.name, []).append(node)
        by_qualname = _qualnames(self.tree)
        regions: Set[ast.AST] = set()
        for root in roots:
            fn = by_qualname.get(root.qualname)
            if fn is None:
                self.unresolved_roots.append(root)
                continue
            if root.body == "loop":
                loop = _outermost_loop(fn)
                if loop is None:
                    self.unresolved_roots.append(root)
                    continue
                regions.add(loop)
            else:
                regions.add(fn)
                self.root_functions.add(fn)

        def region_body(region: ast.AST) -> Iterable[ast.AST]:
            if isinstance(region, _LOOPS):
                for stmt in region.body:
                    yield from ast.walk(stmt)
            else:
                yield from ast.walk(region)

        changed = True
        while changed:
            changed = False
            for region in list(regions):
                for node in region_body(region):
                    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                        for fn in funcs_by_name.get(node.func.id, []):
                            if fn not in regions:
                                regions.add(fn)
                                changed = True
        return regions


def _call_name(func: ast.AST) -> str:
    """Dotted name of a call target, e.g. ``torch.cuda.synchronize`` ->
    'torch.cuda.synchronize'; non-name shapes -> ''."""
    parts: List[str] = []
    cur = func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return ""


# ------------------------------------------------------------- baseline
def baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def load_baseline(path: Optional[str] = None) -> List[BaselineEntry]:
    path = path or baseline_path()
    if not os.path.exists(path):
        return []
    with open(path) as f:
        data = json.load(f)
    entries = []
    for row in data.get("suppressions", []):
        entries.append(
            BaselineEntry(
                rule=row["rule"],
                path=row["path"],
                content=row["content"],
                reason=row.get("reason", ""),
                count=int(row.get("count", 1)),
                seam=row.get("seam", ""),
            )
        )
    return entries


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)  # unsuppressed
    baselined: List[Finding] = field(default_factory=list)
    unused_baseline: List[BaselineEntry] = field(default_factory=list)
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)
    # Declared capture roots whose module was scanned but which name no
    # function (or loop) there: a rename would otherwise silently shrink
    # every capture rule's scope to nothing.
    unresolved_roots: List[CaptureRoot] = field(default_factory=list)


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [
                    d for d in dirnames
                    if d not in ("__pycache__", ".git", "analysis_fixtures",
                                 "torch_analysis_fixtures")
                ]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def _parse_all(paths: Sequence[str], roots: Sequence[CaptureRoot],
               result: Optional[AnalysisResult]) -> List[ModuleContext]:
    root = repo_root()
    contexts: List[ModuleContext] = []
    for file_path in iter_python_files(paths):
        rel = os.path.relpath(os.path.abspath(file_path), root).replace(
            os.sep, "/"
        )
        try:
            with open(file_path, encoding="utf-8") as f:
                source = f.read()
            ctx = ModuleContext(file_path, rel, source, roots)
        except (SyntaxError, UnicodeDecodeError) as exc:
            if result is not None:
                result.parse_errors.append(f"{rel}: {exc}")
            continue
        contexts.append(ctx)
    return contexts


def analyze_paths(
    paths: Optional[Sequence[str]] = None,
    rules: Optional[Sequence] = None,
    baseline: Optional[Sequence[BaselineEntry]] = None,
    roots: Optional[Sequence[CaptureRoot]] = None,
) -> AnalysisResult:
    """Run ``rules`` over every python file under ``paths``.

    ``baseline=None`` means "no baseline" (all findings reported);
    callers wanting the checked-in baseline pass ``load_baseline()``.
    ``roots=None`` means the declared :data:`CAPTURE_ROOTS`.
    """
    from bcg_tpu_torch.analysis.rules import ALL_RULES

    paths = list(paths) if paths else default_paths()
    rules = list(rules) if rules is not None else list(ALL_RULES)
    baseline = list(baseline) if baseline else []
    roots = CAPTURE_ROOTS if roots is None else tuple(roots)

    result = AnalysisResult()
    raw: List[Finding] = []
    contexts = _parse_all(paths, roots, result)
    result.files_scanned = len(contexts)
    for ctx in contexts:
        result.unresolved_roots.extend(ctx.unresolved_roots)

    # Whole-program pass FIRST: the cross-module capture-region lift
    # feeds the per-module capture rules, and the program-level rules
    # (lock order, blocking-under-lock, shared mutation) consume the
    # same index.
    from bcg_tpu_torch.analysis.interproc import ProgramContext

    prog = ProgramContext(contexts)
    prog.propagate_capture_regions()

    module_rules = [
        r for r in rules if not getattr(r, "program_level", False)
    ]
    program_rules = [r for r in rules if getattr(r, "program_level", False)]
    for ctx in contexts:
        for rule in module_rules:
            for finding in rule(ctx):
                if not ctx.suppressed(finding.line, finding.rule):
                    raw.append(finding)
    for rule in program_rules:
        for finding in rule(prog):
            fctx = prog.modules.get(finding.path)
            if fctx is None or not fctx.suppressed(
                finding.line, finding.rule
            ):
                raw.append(finding)

    result.findings, result.baselined, result.unused_baseline = (
        apply_baseline(raw, baseline)
    )
    return result


def apply_baseline(
    raw: Sequence[Finding], baseline: Sequence[BaselineEntry]
) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
    """Split ``raw`` findings into (new, baselined, unused-entries).

    Pure function of its inputs — the load-bearing meta-test replays
    baseline variants against ONE analysis run instead of re-analyzing
    the tree per entry, so the matching semantics must live here, shared
    with ``analyze_paths``."""
    new: List[Finding] = []
    baselined: List[Finding] = []
    matched_keys: Set[Tuple[str, str, str]] = set()
    budget: Dict[Tuple[str, str, str], int] = {}
    for e in baseline:
        budget[e.key()] = budget.get(e.key(), 0) + max(1, e.count)
    for finding in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        if budget.get(finding.key(), 0) > 0:
            budget[finding.key()] -= 1
            matched_keys.add(finding.key())
            baselined.append(finding)
        else:
            # Over-budget duplicates of a baselined line are NEW debt —
            # they resurface instead of riding the existing entry.
            new.append(finding)
    unused = [e for e in baseline if e.key() not in matched_keys]
    return new, baselined, unused


def build_program(paths: Optional[Sequence[str]] = None):
    """Parse every python file under ``paths`` and return the
    whole-program index (``interproc.ProgramContext``) without running
    any rules — backs the ``--locks`` report.  Unparseable files are
    skipped; the lint entry point is where parse errors get teeth."""
    from bcg_tpu_torch.analysis.interproc import ProgramContext

    paths = list(paths) if paths else default_paths()
    return ProgramContext(_parse_all(paths, CAPTURE_ROOTS, None))
