"""Whole-program concurrency model: cross-module call graph, thread-root
inventory, lock-acquisition graph.

The port's copy of ``bcg_tpu/analysis/interproc.py``.  Built once per
:func:`bcg_tpu_torch.analysis.core.analyze_paths` run over every parsed
module, then consumed by the program-level rules (BCG-LOCK-ORDER,
BCG-LOCK-BLOCK, BCG-SHARED-MUT in :mod:`bcg_tpu_torch.analysis.rules`),
by the cross-module capture-region lift of the per-module rules, and by
the ``--locks`` report mode.

Resolution is deliberately heuristic — the same bar as the per-module
rules: precise enough to model THIS codebase's thread/lock idioms
(module-alias calls, ``self.``/typed-attribute methods,
``threading.Thread(target=...)``, ``with self._lock:``, local lock
aliases like ``lock = self._device_lock``), never a full type system.
Unresolvable calls simply contribute no edges; unresolvable lock
expressions that still *look* locky get a synthetic per-module identity
so held-region reasoning degrades instead of disappearing.

Identity conventions (stable — they appear in findings and baselines):

* function:      ``<rel_path>::<Qual.Name>``
* class:         ``<rel_path>::<ClassName>``
* instance lock: ``<rel_path>::<ClassName>.<attr>``
* module lock:   ``<rel_path>::<name>``
* per-key lock:  ``<rel_path>::<ClassName>.<attr>[]`` (dict-of-locks)
* local lock:    ``<function qname>:<var>`` (closure-shared)
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from bcg_tpu_torch.analysis.core import ModuleContext, _call_name

_LOCKY_RE = re.compile(r"lock|cond|mutex|barrier", re.I)
_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

# Attribute names too generic for the unique-name fallback: resolving
# `x.get()` to the single function named `get` somewhere in the package
# would be wrong far more often than right.  (Threading/file primitives
# here are modeled as *blocking ops*, not call edges.)
_GENERIC_ATTRS = {
    "get", "put", "join", "start", "close", "run", "items", "keys",
    "values", "append", "appendleft", "pop", "popleft", "add", "update",
    "clear", "copy", "extend", "remove", "index", "count", "setdefault",
    "acquire", "release", "wait", "notify", "notify_all", "set",
    "is_set", "is_alive", "write", "read", "flush", "strip", "split",
    "format", "encode", "decode", "sort", "group", "match", "search",
    "info", "warning", "error", "debug", "exception", "name", "result",
    "done", "cancel", "total_seconds", "mkdir", "exists",
}

# Constructor-family method names whose self-attribute writes describe
# object *birth* (pre-publication), not shared-state mutation.
_INIT_METHODS = {"__init__", "__new__", "__post_init__", "__set_name__"}

_ENGINE_DISPATCH_ATTRS = {
    "generate", "batch_generate", "generate_json", "batch_generate_json",
}
_DEVICE_ATTRS = {"device_put", "device_get", "block_until_ready"}
_FILE_CALLS = {
    "open", "os.fsync", "os.replace", "os.rename", "os.remove",
    "os.makedirs", "shutil.copy", "shutil.copytree", "shutil.move",
    "shutil.rmtree", "json.dump",
}
_SUBPROCESS_CALLS = {
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
}
_QUEUE_RECV_RE = re.compile(r"(^|_)q(ueue)?$", re.I)
_THREADY_RE = re.compile(r"thread|worker|proc(ess)?$", re.I)


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _call_name(node.func)
    short = name.rsplit(".", 1)[-1]
    return short in _LOCK_CTORS and (
        name == short or name.startswith("threading.")
    )


def _walk_same_scope(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does NOT descend into nested function/class
    bodies — statements there execute in a different activation (or
    never), so they don't belong to the enclosing function's behavior."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        cur = stack.pop()
        yield cur
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                  ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(cur))


@dataclass
class LockSite:
    """One lexical region that runs with ``lock_id`` held."""
    lock_id: str
    node: ast.AST  # ast.With, or the FunctionDef of a *_locked helper


@dataclass
class ThreadRoot:
    name: str      # thread name kwarg (static prefix) or the target qname
    kind: str      # "thread" | "atexit"
    target: str    # function qname
    path: str
    line: int
    multi: bool = False  # spawned in a loop / f-string-numbered pool

    def describe(self) -> str:
        star = " xN" if self.multi else ""
        return f"{self.kind}:{self.name}{star} ({self.path}:{self.line})"


@dataclass
class EdgeEvidence:
    """Why lock ``outer`` is held when ``inner`` gets acquired."""
    outer: str
    inner: str
    fn: str            # function whose body holds `outer` at the site
    node: ast.AST      # the inner acquisition / the call leading to it
    via: Optional[str]  # callee qname when the acquisition is transitive


class FunctionInfo:
    __slots__ = (
        "qname", "name", "node", "ctx", "cls_qname", "parent_fn",
        "calls", "lock_sites", "local_locks", "_scope_nodes",
    )

    def __init__(self, qname, name, node, ctx, cls_qname, parent_fn):
        self.qname = qname
        self.name = name
        self.node = node
        self.ctx = ctx
        self.cls_qname = cls_qname      # class whose DIRECT method this is
        self.parent_fn = parent_fn      # enclosing function qname (closures)
        self.calls: List[Tuple[ast.Call, str]] = []  # (site, callee qname)
        self.lock_sites: List[LockSite] = []
        self.local_locks: Dict[str, str] = {}  # local var -> lock id
        self._scope_nodes: Optional[List[ast.AST]] = None

    def scope_nodes(self) -> List[ast.AST]:
        """Own-scope AST nodes, walked once — half a dozen collectors
        (calls, locks, types, blocking ops, mutations) iterate the same
        body, and the repeated walks dominated analysis time."""
        if self._scope_nodes is None:
            self._scope_nodes = list(_walk_same_scope(self.node))
        return self._scope_nodes


class ClassInfo:
    __slots__ = (
        "qname", "name", "node", "ctx", "base_names", "bases",
        "methods", "lock_attrs", "attr_type_names", "attr_types",
    )

    def __init__(self, qname, name, node, ctx):
        self.qname = qname
        self.name = name
        self.node = node
        self.ctx = ctx
        self.base_names: List[str] = []   # raw dotted names
        self.bases: List[str] = []        # resolved class qnames
        self.methods: Dict[str, str] = {}
        self.lock_attrs: Dict[str, str] = {}       # attr -> lock id
        self.attr_type_names: Dict[str, str] = {}  # attr -> raw ctor name
        self.attr_types: Dict[str, str] = {}       # attr -> class qname


class ProgramContext:
    """Package-wide index over every module of one analysis run."""

    def __init__(self, contexts: Sequence[ModuleContext]):
        self.modules: Dict[str, ModuleContext] = {
            c.rel_path: c for c in contexts
        }
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.module_funcs: Dict[str, Dict[str, str]] = {}
        self.module_classes: Dict[str, Dict[str, str]] = {}
        self.module_locks: Dict[str, Dict[str, str]] = {}
        self.imports_mod: Dict[str, Dict[str, str]] = {}
        self.imports_sym: Dict[str, Dict[str, Tuple[str, str]]] = {}
        self.by_attr_name: Dict[str, List[str]] = {}

        for ctx in contexts:
            self._index_module(ctx)
        for ci in self.classes.values():
            self._index_class_attrs(ci)
        for ci in self.classes.values():
            self._resolve_class_links(ci)
        for fi in list(self.functions.values()):
            self._resolve_function(fi)

        self.call_graph: Dict[str, Set[str]] = {
            q: {callee for _, callee in fi.calls}
            for q, fi in self.functions.items()
        }
        self.thread_roots: List[ThreadRoot] = self._collect_roots()
        self._reach: Dict[str, Set[str]] = {
            r.target: self._reachable(r.target) for r in self.thread_roots
        }
        self._transitive_locks = self._fix_transitive_locks()
        self._blocking_direct: Dict[str, List[Tuple[ast.AST, str]]] = {}
        self._blocking_kinds = self._fix_blocking()

    # ------------------------------------------------------------ indexing
    def _index_module(self, ctx: ModuleContext) -> None:
        rel = ctx.rel_path
        self.module_funcs[rel] = {}
        self.module_classes[rel] = {}
        self.module_locks[rel] = {}
        self.imports_mod[rel] = {}
        self.imports_sym[rel] = {}
        self._index_imports(ctx)
        self._index_body(ctx, ctx.tree.body, (), None, None)
        for node in ctx.tree.body:
            self._maybe_module_lock(ctx, node)
        # module-level locks may also hide under `if TYPE_CHECKING:` etc.
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.If, ast.Try)):
                for stmt in ast.iter_child_nodes(node):
                    self._maybe_module_lock(ctx, stmt)

    def _maybe_module_lock(self, ctx: ModuleContext, node: ast.AST) -> None:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and _is_lock_ctor(node.value)
        ):
            name = node.targets[0].id
            self.module_locks[ctx.rel_path].setdefault(
                name, f"{ctx.rel_path}::{name}"
            )

    def _module_rel(self, dotted: str) -> Optional[str]:
        path = dotted.replace(".", "/")
        for cand in (path + ".py", path + "/__init__.py"):
            if cand in self.modules:
                return cand
        return None

    def _index_imports(self, ctx: ModuleContext) -> None:
        rel = ctx.rel_path
        pkg_dir = rel.rsplit("/", 1)[0] if "/" in rel else ""
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = self._module_rel(alias.name)
                    if target is None:
                        continue
                    if alias.asname:
                        self.imports_mod[rel][alias.asname] = target
                    elif "." not in alias.name:
                        self.imports_mod[rel][alias.name] = target
                    # `import a.b.c` bare: resolved via full dotted names
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    up = pkg_dir.split("/") if pkg_dir else []
                    up = up[: len(up) - (node.level - 1)]
                    prefix = ".".join(up)
                    base = f"{prefix}.{base}" if base else prefix
                for alias in node.names:
                    asname = alias.asname or alias.name
                    sub = self._module_rel(
                        f"{base}.{alias.name}" if base else alias.name
                    )
                    if sub is not None:
                        self.imports_mod[rel][asname] = sub
                        continue
                    target = self._module_rel(base) if base else None
                    if target is not None:
                        self.imports_sym[rel][asname] = (target, alias.name)

    def _index_body(self, ctx, body, scope, cls, parent_fn) -> None:
        rel = ctx.rel_path
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{rel}::{'.'.join(scope + (node.name,))}"
                fi = FunctionInfo(
                    qn, node.name, node, ctx,
                    cls.qname if cls is not None else None, parent_fn,
                )
                self.functions[qn] = fi
                self.by_attr_name.setdefault(node.name, []).append(qn)
                if cls is not None:
                    cls.methods.setdefault(node.name, qn)
                elif not scope:
                    self.module_funcs[rel].setdefault(node.name, qn)
                self._index_body(
                    ctx, node.body, scope + (node.name,), None, qn
                )
            elif isinstance(node, ast.ClassDef):
                cqn = f"{rel}::{'.'.join(scope + (node.name,))}"
                ci = ClassInfo(cqn, node.name, node, ctx)
                ci.base_names = [
                    _call_name(b) for b in node.bases if _call_name(b)
                ]
                self.classes[cqn] = ci
                if not scope:
                    self.module_classes[rel].setdefault(node.name, cqn)
                self._index_body(
                    ctx, node.body, scope + (node.name,), ci, parent_fn
                )

    def _index_class_attrs(self, ci: ClassInfo) -> None:
        for mqn in ci.methods.values():
            fn = self.functions[mqn].node
            for n in _walk_same_scope(fn):
                if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
                    continue
                t = n.targets[0]
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                if _is_lock_ctor(n.value):
                    ci.lock_attrs.setdefault(
                        t.attr, f"{ci.qname}.{t.attr}"
                    )
                elif isinstance(n.value, ast.Call):
                    ctor = _call_name(n.value.func)
                    if ctor:
                        ci.attr_type_names.setdefault(t.attr, ctor)

    def _resolve_class_links(self, ci: ClassInfo) -> None:
        rel = ci.ctx.rel_path
        for base in ci.base_names:
            cqn = self._resolve_class_name(rel, base)
            if cqn:
                ci.bases.append(cqn)
        for attr, ctor in ci.attr_type_names.items():
            cqn = self._resolve_class_name(rel, ctor)
            if cqn:
                ci.attr_types[attr] = cqn

    def _resolve_class_name(self, rel: str, dotted: str) -> Optional[str]:
        parts = dotted.split(".")
        if len(parts) == 1:
            name = parts[0]
            if name in self.module_classes.get(rel, {}):
                return self.module_classes[rel][name]
            sym = self.imports_sym.get(rel, {}).get(name)
            if sym:
                return self.module_classes.get(sym[0], {}).get(sym[1])
            return None
        mod = self.imports_mod.get(rel, {}).get(parts[0])
        if mod and len(parts) == 2:
            return self.module_classes.get(mod, {}).get(parts[1])
        target = self._module_rel(".".join(parts[:-1]))
        if target:
            return self.module_classes.get(target, {}).get(parts[-1])
        return None

    # ---------------------------------------------------- class utilities
    def _mro(self, cqn: str) -> Iterable[ClassInfo]:
        seen: Set[str] = set()
        stack = [cqn]
        while stack:
            cur = stack.pop(0)
            if cur in seen:
                continue
            seen.add(cur)
            ci = self.classes.get(cur)
            if ci is None:
                continue
            yield ci
            stack.extend(ci.bases)

    def lookup_method(self, cqn: str, name: str) -> Optional[str]:
        for ci in self._mro(cqn):
            if name in ci.methods:
                return ci.methods[name]
        return None

    def lookup_lock_attr(self, cqn: str, attr: str) -> Optional[str]:
        for ci in self._mro(cqn):
            if attr in ci.lock_attrs:
                return ci.lock_attrs[attr]
        return None

    def lookup_attr_type(self, cqn: str, attr: str) -> Optional[str]:
        for ci in self._mro(cqn):
            if attr in ci.attr_types:
                return ci.attr_types[attr]
            if attr in ci.attr_type_names:
                return None  # typed, but to an out-of-program class
        return None

    def class_of_method(self, fi: FunctionInfo) -> Optional[str]:
        return fi.cls_qname

    # ------------------------------------------------------ call resolution
    def _resolve_function(self, fi: FunctionInfo) -> None:
        rel = fi.ctx.rel_path
        self._collect_local_locks(fi)
        local_types = self._collect_local_types(fi)
        for node in fi.scope_nodes():
            if not isinstance(node, ast.Call):
                continue
            callee = self._resolve_call(fi, node, local_types)
            if callee:
                fi.calls.append((node, callee))
            self._maybe_lock_site(fi, node)
        for node in fi.scope_nodes():
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lock_id = self.resolve_lock_expr(fi, item.context_expr)
                    if lock_id:
                        fi.lock_sites.append(LockSite(lock_id, node))
                        break  # one region per with-statement
        if fi.name.endswith("_locked"):
            fi.lock_sites.append(
                LockSite(self._held_lock_for_locked_helper(fi), fi.node)
            )

    def _maybe_lock_site(self, fi, node) -> None:
        # placeholder for future acquire()-style tracking; with-blocks
        # and *_locked helpers are the repo's locking idioms.
        return

    def _held_lock_for_locked_helper(self, fi: FunctionInfo) -> str:
        """A ``*_locked`` helper runs with its owner's lock held; when
        the class has exactly one registered lock that IS the lock."""
        if fi.cls_qname:
            locks: Dict[str, str] = {}
            for ci in self._mro(fi.cls_qname):
                for attr, lid in ci.lock_attrs.items():
                    locks.setdefault(attr, lid)
            if len(locks) == 1:
                return next(iter(locks.values()))
            return f"{fi.cls_qname}.<held>"
        return f"{fi.ctx.rel_path}::<held>"

    def _collect_local_locks(self, fi: FunctionInfo) -> None:
        cls = fi.cls_qname
        for n in fi.scope_nodes():
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1):
                continue
            t = n.targets[0]
            if not isinstance(t, ast.Name):
                continue
            v = n.value
            if _is_lock_ctor(v):
                fi.local_locks[t.id] = f"{fi.qname}:{t.id}"
            elif isinstance(v, ast.Attribute) and isinstance(
                v.value, ast.Name
            ) and v.value.id == "self" and cls:
                lid = self.lookup_lock_attr(cls, v.attr)
                if lid is None and _LOCKY_RE.search(v.attr):
                    lid = f"{cls}.{v.attr}"
                if lid:
                    fi.local_locks[t.id] = lid
            elif isinstance(v, ast.Name):
                lid = self.module_locks.get(fi.ctx.rel_path, {}).get(v.id)
                if lid:
                    fi.local_locks[t.id] = lid
            elif isinstance(v, ast.Call) and any(
                _is_lock_ctor(c) for c in ast.walk(v)
            ):
                # `key_lock = self._group_locks.setdefault(k, Lock())`:
                # a per-key lock pulled out of a dict-of-locks attribute.
                owner = None
                for c in ast.walk(v):
                    if (
                        isinstance(c, ast.Attribute)
                        and isinstance(c.value, ast.Name)
                        and c.value.id == "self"
                        and _LOCKY_RE.search(c.attr)
                    ):
                        owner = c.attr
                        break
                if owner and cls:
                    fi.local_locks[t.id] = f"{cls}.{owner}[]"
                else:
                    fi.local_locks[t.id] = f"{fi.qname}:{t.id}"

    def _collect_local_types(self, fi: FunctionInfo) -> Dict[str, str]:
        types: Dict[str, str] = {}
        rel = fi.ctx.rel_path
        for n in fi.scope_nodes():
            if (
                isinstance(n, ast.Assign)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and isinstance(n.value, ast.Call)
            ):
                ctor = _call_name(n.value.func)
                if ctor:
                    cqn = self._resolve_class_name(rel, ctor)
                    if cqn:
                        types[n.targets[0].id] = cqn
        return types

    def _resolve_call(
        self, fi: FunctionInfo, call: ast.Call, local_types: Dict[str, str]
    ) -> Optional[str]:
        func = call.func
        rel = fi.ctx.rel_path
        if isinstance(func, ast.Name):
            return self._resolve_plain_name(fi, func.id)
        if not isinstance(func, ast.Attribute):
            return None
        dotted = _call_name(func)
        attr = func.attr
        if dotted:
            parts = dotted.split(".")
            if parts[0] in ("self", "cls") and fi.cls_qname:
                if len(parts) == 2:
                    return self.lookup_method(fi.cls_qname, parts[1])
                if len(parts) == 3:
                    t = self.lookup_attr_type(fi.cls_qname, parts[1])
                    if t:
                        return self.lookup_method(t, parts[2])
                    return None
            mod = self.imports_mod.get(rel, {}).get(parts[0])
            if mod is not None:
                if len(parts) == 2:
                    hit = self.module_funcs.get(mod, {}).get(parts[1])
                    if hit:
                        return hit
                    cqn = self.module_classes.get(mod, {}).get(parts[1])
                    if cqn:
                        return self.lookup_method(cqn, "__init__")
                if len(parts) == 3:
                    cqn = self.module_classes.get(mod, {}).get(parts[1])
                    if cqn:
                        return self.lookup_method(cqn, parts[2])
            if len(parts) >= 2:
                target = self._module_rel(".".join(parts[:-1]))
                if target:
                    hit = self.module_funcs.get(target, {}).get(parts[-1])
                    if hit:
                        return hit
            # Typed local receiver: `sink = EventSink(...); sink.emit()`
            if len(parts) == 2 and parts[0] in local_types:
                return self.lookup_method(local_types[parts[0]], parts[1])
            # Class symbol receiver: `Scheduler.submit` (rare) / classvar
            if len(parts) == 2:
                cqn = self._resolve_class_name(rel, parts[0])
                if cqn:
                    return self.lookup_method(cqn, parts[1])
        # Unique-name fallback for attribute calls on untyped receivers:
        # only when exactly one function in the program bears the name
        # and the name isn't generic enough to collide with builtins.
        if attr not in _GENERIC_ATTRS and not attr.startswith("__"):
            cands = self.by_attr_name.get(attr, [])
            if len(cands) == 1:
                return cands[0]
        return None

    def _resolve_plain_name(
        self, fi: FunctionInfo, name: str
    ) -> Optional[str]:
        rel = fi.ctx.rel_path
        # nested function in the lexical scope chain
        cur: Optional[FunctionInfo] = fi
        while cur is not None:
            cand = f"{cur.qname}.{name}"
            if cand in self.functions:
                return cand
            cur = (
                self.functions.get(cur.parent_fn)
                if cur.parent_fn else None
            )
        hit = self.module_funcs.get(rel, {}).get(name)
        if hit:
            return hit
        cqn = self.module_classes.get(rel, {}).get(name)
        if cqn:
            return self.lookup_method(cqn, "__init__")
        sym = self.imports_sym.get(rel, {}).get(name)
        if sym:
            target_rel, symname = sym
            hit = self.module_funcs.get(target_rel, {}).get(symname)
            if hit:
                return hit
            cqn = self.module_classes.get(target_rel, {}).get(symname)
            if cqn:
                return self.lookup_method(cqn, "__init__")
        return None

    # ----------------------------------------------------- lock expressions
    def resolve_lock_expr(
        self, fi: FunctionInfo, expr: ast.AST
    ) -> Optional[str]:
        """Lock identity of a with-item context expression, or None when
        the expression is not lock-like (tracer spans, open(), ...)."""
        if isinstance(expr, ast.Attribute):
            if (
                isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and fi.cls_qname
            ):
                lid = self.lookup_lock_attr(fi.cls_qname, expr.attr)
                if lid:
                    return lid
                if _LOCKY_RE.search(expr.attr):
                    return f"{fi.cls_qname}.{expr.attr}"
                return None
            base = _call_name(expr.value)
            mod = self.imports_mod.get(fi.ctx.rel_path, {}).get(base)
            if mod is not None:
                lid = self.module_locks.get(mod, {}).get(expr.attr)
                if lid:
                    return lid
                if _LOCKY_RE.search(expr.attr):
                    return f"{mod}::{expr.attr}"
            if _LOCKY_RE.search(expr.attr):
                return f"{fi.ctx.rel_path}::<{expr.attr}>"
            return None
        if isinstance(expr, ast.Name):
            # closure chain first: a local lock in an enclosing def IS
            # shared across the threads the enclosing function spawns
            cur: Optional[FunctionInfo] = fi
            while cur is not None:
                if expr.id in cur.local_locks:
                    return cur.local_locks[expr.id]
                cur = (
                    self.functions.get(cur.parent_fn)
                    if cur.parent_fn else None
                )
            lid = self.module_locks.get(fi.ctx.rel_path, {}).get(expr.id)
            if lid:
                return lid
            sym = self.imports_sym.get(fi.ctx.rel_path, {}).get(expr.id)
            if sym:
                lid = self.module_locks.get(sym[0], {}).get(sym[1])
                if lid:
                    return lid
            if _LOCKY_RE.search(expr.id):
                return f"{fi.ctx.rel_path}::{expr.id}"
            return None
        return None

    # -------------------------------------------------------- thread roots
    def _collect_roots(self) -> List[ThreadRoot]:
        roots: List[ThreadRoot] = []
        for qn, fi in self.functions.items():
            for node in fi.scope_nodes():
                if not isinstance(node, ast.Call):
                    continue
                cname = _call_name(node.func)
                short = cname.rsplit(".", 1)[-1]
                if short == "Thread" and cname in (
                    "Thread", "threading.Thread"
                ):
                    target = self._thread_target(fi, node)
                    if target:
                        roots.append(self._root_from_thread(fi, node, target))
                elif cname == "atexit.register" and node.args:
                    # only the dotted spelling counts; a bare register()
                    # is someone else's API
                    tq = self._callable_ref(fi, node.args[0])
                    if tq:
                        roots.append(ThreadRoot(
                            name=tq.rsplit("::", 1)[-1],
                            kind="atexit", target=tq,
                            path=fi.ctx.rel_path,
                            line=getattr(node, "lineno", 1),
                        ))
        # module-level Thread()/atexit.register() sites (rare; scripts)
        for rel, ctx in self.modules.items():
            pseudo = FunctionInfo(
                f"{rel}::<module>", "<module>", ctx.tree, ctx, None, None
            )
            for node in _walk_same_scope(ctx.tree):
                if not isinstance(node, ast.Call):
                    continue
                cname = _call_name(node.func)
                if cname in ("Thread", "threading.Thread"):
                    target = self._thread_target(pseudo, node)
                    if target:
                        roots.append(
                            self._root_from_thread(pseudo, node, target)
                        )
                elif cname == "atexit.register" and node.args:
                    tq = self._callable_ref(pseudo, node.args[0])
                    if tq:
                        roots.append(ThreadRoot(
                            name=tq.rsplit("::", 1)[-1], kind="atexit",
                            target=tq, path=rel,
                            line=getattr(node, "lineno", 1),
                        ))
        # dedupe by (kind, target, path, line)
        seen: Set[Tuple] = set()
        out = []
        for r in roots:
            key = (r.kind, r.target, r.path, r.line)
            if key not in seen:
                seen.add(key)
                out.append(r)
        out.sort(key=lambda r: (r.path, r.line))
        return out

    def _thread_target(
        self, fi: FunctionInfo, call: ast.Call
    ) -> Optional[str]:
        for kw in call.keywords:
            if kw.arg == "target":
                return self._callable_ref(fi, kw.value)
        if call.args:
            return self._callable_ref(fi, call.args[0])
        return None

    def _callable_ref(
        self, fi: FunctionInfo, expr: ast.AST
    ) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return self._resolve_plain_name(fi, expr.id)
        if isinstance(expr, ast.Attribute):
            dotted = _call_name(expr)
            parts = dotted.split(".") if dotted else []
            if (
                len(parts) == 2
                and parts[0] in ("self", "cls")
                and fi.cls_qname
            ):
                return self.lookup_method(fi.cls_qname, parts[1])
            if len(parts) == 2:
                mod = self.imports_mod.get(fi.ctx.rel_path, {}).get(parts[0])
                if mod:
                    return self.module_funcs.get(mod, {}).get(parts[1])
        return None

    def _root_from_thread(
        self, fi: FunctionInfo, call: ast.Call, target: str
    ) -> ThreadRoot:
        name = target.rsplit("::", 1)[-1]
        multi = False
        for kw in call.keywords:
            if kw.arg == "name":
                if isinstance(kw.value, ast.Constant) and isinstance(
                    kw.value.value, str
                ):
                    name = kw.value.value
                elif isinstance(kw.value, ast.JoinedStr):
                    multi = True  # f-string-numbered pool
                    lead = kw.value.values[0] if kw.value.values else None
                    if isinstance(lead, ast.Constant) and isinstance(
                        lead.value, str
                    ):
                        name = lead.value + "*"
        cur = fi.ctx.parent(call)
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)
        ):
            if isinstance(
                cur, (ast.For, ast.While, ast.ListComp, ast.GeneratorExp)
            ):
                multi = True
            cur = fi.ctx.parent(cur)
        return ThreadRoot(
            name=name, kind="thread", target=target,
            path=fi.ctx.rel_path, line=getattr(call, "lineno", 1),
            multi=multi,
        )

    # ------------------------------------------------------- reachability
    def _reachable(self, start: str) -> Set[str]:
        seen: Set[str] = set()
        stack = [start]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(self.call_graph.get(cur, ()))
        return seen

    def roots_reaching(self, qname: str) -> List[ThreadRoot]:
        return [
            r for r in self.thread_roots if qname in self._reach[r.target]
        ]

    # ------------------------------------------------------- lock fixpoints
    def _fix_transitive_locks(self) -> Dict[str, Set[str]]:
        acc: Dict[str, Set[str]] = {
            q: {s.lock_id for s in fi.lock_sites}
            for q, fi in self.functions.items()
        }
        changed = True
        while changed:
            changed = False
            for q, callees in self.call_graph.items():
                mine = acc[q]
                before = len(mine)
                for c in callees:
                    mine |= acc.get(c, set())
                if len(mine) != before:
                    changed = True
        return acc

    def transitive_locks(self, qname: str) -> Set[str]:
        return self._transitive_locks.get(qname, set())

    def direct_blocking(self, qname: str) -> List[Tuple[ast.AST, str]]:
        """Blocking ops lexically inside ``qname`` (node, kind)."""
        if qname in self._blocking_direct:
            return self._blocking_direct[qname]
        fi = self.functions.get(qname)
        out: List[Tuple[ast.AST, str]] = []
        if fi is not None:
            for node in fi.scope_nodes():
                if isinstance(node, ast.Call):
                    kind = self._blocking_kind(fi, node)
                    if kind:
                        out.append((node, kind))
        self._blocking_direct[qname] = out
        return out

    def _blocking_kind(
        self, fi: FunctionInfo, call: ast.Call
    ) -> Optional[str]:
        dotted = _call_name(call.func)
        kwnames = {kw.arg for kw in call.keywords if kw.arg}
        if dotted == "open" or dotted in _FILE_CALLS:
            return "file I/O"
        if dotted in _SUBPROCESS_CALLS:
            return "subprocess"
        if dotted == "time.sleep" or (
            dotted == "sleep" and self._imported_from_time(fi.ctx)
        ):
            return "sleep"
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        recv = call.func.value
        recv_name = _call_name(recv)
        if attr in _ENGINE_DISPATCH_ATTRS:
            return "engine dispatch"
        if attr in _DEVICE_ATTRS:
            return "device transfer"
        if attr == "serve_forever":
            return "blocking server loop"
        if attr == "join":
            if isinstance(recv, ast.Constant):
                return None  # "sep".join(...)
            if recv_name.startswith(("os.path", "posixpath", "ntpath")):
                return None
            last = recv_name.rsplit(".", 1)[-1] if recv_name else ""
            typed_thread = False
            if (
                recv_name.startswith("self.")
                and recv_name.count(".") == 1
                and fi.cls_qname
            ):
                ci_type = None
                for ci in self._mro(fi.cls_qname):
                    ci_type = ci.attr_type_names.get(last) or ci_type
                typed_thread = ci_type in ("threading.Thread", "Thread")
            if typed_thread or (last and _THREADY_RE.search(last)):
                return "thread join"
            return None
        if attr in ("get", "put"):
            last = recv_name.rsplit(".", 1)[-1] if recv_name else ""
            if not last or not _QUEUE_RECV_RE.search(last):
                return None
            if "timeout" in kwnames:
                return None
            if attr == "get" and (call.args or kwnames):
                return None  # dict.get(key[, default])
            return f"queue {attr} without timeout"
        return None

    def _imported_from_time(self, ctx: ModuleContext) -> bool:
        sym = self.imports_sym.get(ctx.rel_path, {}).get("sleep")
        if sym:
            return True
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.ImportFrom)
                and node.module == "time"
                and any(a.name == "sleep" for a in node.names)
            ):
                return True
        return False

    def _fix_blocking(self) -> Dict[str, Set[str]]:
        acc: Dict[str, Set[str]] = {
            q: {kind for _, kind in self.direct_blocking(q)}
            for q in self.functions
        }
        changed = True
        while changed:
            changed = False
            for q, callees in self.call_graph.items():
                mine = acc[q]
                before = len(mine)
                for c in callees:
                    mine |= acc.get(c, set())
                if len(mine) != before:
                    changed = True
        return acc

    def blocking_kinds(self, qname: str) -> Set[str]:
        return self._blocking_kinds.get(qname, set())

    def blocking_witness(self, qname: str, kind: str) -> List[str]:
        """Shortest call chain from ``qname`` to a function that performs
        ``kind`` directly (inclusive), for finding messages."""
        prev: Dict[str, Optional[str]] = {qname: None}
        queue = [qname]
        while queue:
            cur = queue.pop(0)
            if any(k == kind for _, k in self.direct_blocking(cur)):
                chain = []
                c: Optional[str] = cur
                while c is not None:
                    chain.append(c)
                    c = prev[c]
                return list(reversed(chain))
            for nxt in self.call_graph.get(cur, ()):
                if nxt not in prev and kind in self.blocking_kinds(nxt):
                    prev[nxt] = cur
                    queue.append(nxt)
        return [qname]

    # -------------------------------------------------- held-region walking
    def iter_held_regions(self):
        """Yield ``(fi, lock_site)`` for every lexical held region in the
        program (with-blocks on resolved/locky locks, *_locked helpers)."""
        for fi in self.functions.values():
            for site in fi.lock_sites:
                yield fi, site

    def region_statements(self, site: LockSite) -> List[ast.AST]:
        if isinstance(site.node, (ast.With, ast.AsyncWith)):
            return list(site.node.body)
        return list(site.node.body)

    def region_nodes(self, site: LockSite) -> Iterable[ast.AST]:
        """Nodes executing with the region's lock held: the with-body
        (or *_locked body), minus nested function/class bodies and minus
        the context expressions (they run before the acquire)."""
        for stmt in self.region_statements(site):
            yield stmt
            yield from _walk_same_scope(stmt)

    # --------------------------------------------------- lock-order edges
    def lock_order_edges(self) -> Dict[Tuple[str, str], List[EdgeEvidence]]:
        edges: Dict[Tuple[str, str], List[EdgeEvidence]] = {}

        def add(ev: EdgeEvidence) -> None:
            if ev.outer == ev.inner:
                return
            edges.setdefault((ev.outer, ev.inner), []).append(ev)

        for fi, site in self.iter_held_regions():
            inner_nodes = set()
            for node in self.region_nodes(site):
                inner_nodes.add(id(node))
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        lid = self.resolve_lock_expr(fi, item.context_expr)
                        if lid:
                            add(EdgeEvidence(
                                site.lock_id, lid, fi.qname, node, None
                            ))
            for call, callee in fi.calls:
                if id(call) not in inner_nodes:
                    continue
                for lid in self.transitive_locks(callee):
                    add(EdgeEvidence(
                        site.lock_id, lid, fi.qname, call, callee
                    ))
        return edges

    def find_lock_cycles(
        self, edges: Dict[Tuple[str, str], List[EdgeEvidence]]
    ) -> List[List[Tuple[str, str]]]:
        """Simple cycles (as edge lists) in the lock-order graph, bounded
        at length 4 — deadlocks beyond that exceed what evidence-quality
        heuristics can usefully report."""
        adj: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)
        cycles: List[List[Tuple[str, str]]] = []
        seen_sets: Set[frozenset] = set()

        def dfs(start: str, cur: str, path: List[str]) -> None:
            if len(path) > 4:
                return
            for nxt in sorted(adj.get(cur, ())):
                if nxt == start and len(path) >= 2:
                    key = frozenset(path)
                    if key not in seen_sets:
                        seen_sets.add(key)
                        cycle_nodes = path + [start]
                        cycles.append([
                            (cycle_nodes[i], cycle_nodes[i + 1])
                            for i in range(len(cycle_nodes) - 1)
                        ])
                elif nxt not in path and nxt > start:
                    # canonical start = smallest node name in the cycle
                    dfs(start, nxt, path + [nxt])

        for node in sorted(adj):
            dfs(node, node, [node])
        return cycles

    # ------------------------------------------------------ shared mutation
    def attribute_mutations(self):
        """``{(class_qname, attr): [(fi, node, guards)]}`` for every
        ``self.<attr> = ...`` outside constructor-family methods, and
        ``{(rel::name): ...}`` for rebinding of module globals declared
        with ``global``.  ``guards`` is the set of lock ids lexically
        held at the assignment."""
        muts: Dict[Tuple[str, str], List] = {}
        for fi in self.functions.values():
            if fi.name in _INIT_METHODS:
                continue
            held_map = self._held_at_map(fi)
            global_names: Set[str] = set()
            for n in fi.scope_nodes():
                if isinstance(n, ast.Global):
                    global_names.update(n.names)
            for n in fi.scope_nodes():
                target = None
                if isinstance(n, ast.Assign):
                    targets = n.targets
                elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                    targets = [n.target]
                else:
                    continue
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and fi.cls_qname
                        and not t.attr.startswith("__")
                    ):
                        target = (fi.cls_qname, t.attr)
                    elif (
                        isinstance(t, ast.Name) and t.id in global_names
                    ):
                        target = (
                            f"{fi.ctx.rel_path}::<global>", t.id
                        )
                    if target:
                        muts.setdefault(target, []).append(
                            (fi, n, held_map.get(id(n), frozenset()))
                        )
        return muts

    def _held_at_map(self, fi: FunctionInfo) -> Dict[int, frozenset]:
        """``id(node) -> frozenset(lock ids held)`` for the nodes of
        ``fi`` covered by at least one held region."""
        held: Dict[int, Set[str]] = {}
        for site in fi.lock_sites:
            for node in self.region_nodes(site):
                held.setdefault(id(node), set()).add(site.lock_id)
        return {k: frozenset(v) for k, v in held.items()}

    # ----------------------------------------------- capture-region lift
    def propagate_capture_regions(self) -> None:
        """Cross-module closure of the per-module capture-region
        fixpoint: a module-level function called from inside any capture
        region — through an import alias or symbol import — runs inside
        it too.  Marks land in each ModuleContext's
        ``extra_capture_regions``.  Methods, and calls resolved only by
        the unique-name fallback, are excluded: attribute resolution is
        too heuristic to brand a function as captured (``x.chunk(2)``
        on a tensor is not a call of some function named ``chunk``)."""
        changed = True
        while changed:
            changed = False
            for fi in self.functions.values():
                for call, callee in fi.calls:
                    cfi = self.functions.get(callee)
                    if cfi is None or cfi.cls_qname is not None:
                        continue  # methods: resolution too heuristic
                    if cfi.name == "__init__":
                        continue
                    if not self._named_call(fi, call):
                        continue
                    cctx = cfi.ctx
                    if (
                        cfi.node in cctx.capture_regions
                        or cfi.node in cctx.extra_capture_regions
                    ):
                        continue
                    if fi.ctx.in_capture_region(call):
                        cctx.extra_capture_regions.add(cfi.node)
                        changed = True

    def _named_call(self, fi: FunctionInfo, call: ast.Call) -> bool:
        """Is ``call`` a call by plain name (scope chain, module
        function, symbol import) or through a module alias / dotted
        module path — not an attribute call on an untyped receiver?"""
        if isinstance(call.func, ast.Name):
            return True
        dotted = _call_name(call.func)
        if not dotted or "." not in dotted:
            return False
        head, rest = dotted.split(".", 1)
        if head in self.imports_mod.get(fi.ctx.rel_path, {}):
            return "." not in rest
        return self._module_rel(dotted.rsplit(".", 1)[0]) is not None

    # ---------------------------------------------------------- reporting
    def locks_report(self) -> str:
        """The thread-root × lock table plus the lock-order edge list —
        the ``--locks`` CLI mode and the DESIGN.md walkthrough source."""
        out: List[str] = []
        out.append("thread roots:")
        if not self.thread_roots:
            out.append("  (none)")
        for r in self.thread_roots:
            locks = sorted(
                set().union(
                    *[
                        self.transitive_locks(q)
                        for q in self._reach[r.target]
                    ] or [set()]
                )
            )
            out.append(f"  {r.describe()}")
            out.append(f"    target: {r.target}")
            out.append(
                "    locks:  " + (", ".join(locks) if locks else "(none)")
            )
        edges = self.lock_order_edges()
        out.append("")
        out.append("lock-order edges (outer -> inner):")
        if not edges:
            out.append("  (none)")
        for (a, b), evs in sorted(edges.items()):
            ev = evs[0]
            where = (
                f"{self.functions[ev.fn].ctx.rel_path}:"
                f"{getattr(ev.node, 'lineno', '?')}"
            )
            via = f" via {ev.via}" if ev.via else ""
            out.append(f"  {a} -> {b}  [{where}{via}]")
        return "\n".join(out) + "\n"
