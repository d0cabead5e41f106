"""Rule implementations.

The port's copy of ``bcg_tpu/analysis/rules.py``.  Each rule is
``rule(ctx: ModuleContext) -> Iterable[Finding]`` with a stable
``.rule_id`` attribute.  Rules are deliberately heuristic — the goal is
catching this codebase's recurring hazard patterns cheaply, not
soundness; deliberate violations are parked in the port's baseline
(``bcg_tpu_torch/analysis/baseline.json``) with a justification, and
``# lint: ignore[ID]`` suppresses inline.

The three traced-region rules keep their IDs and apply to **capture
regions** (``core.CAPTURE_ROOTS`` and their callees): BCG-HOST-SYNC,
BCG-JIT-NP and BCG-JIT-BRANCH.  Three of the JAX package's four mesh
rules keep their IDs and are retargeted to the port's mesh code
(``parallel/``: a ``DeviceMesh`` of ranks, explicit collectives, plain
local tensors a rank):

* BCG-SHARD-AXIS: a string literal used as a mesh axis — the ``axis``
  of ``parallel/collectives``, the ``axis_name`` of ``parallel/
  game_step``, a ``DeviceMesh``'s ``get_group`` / ``get_local_rank``, a
  key of ``mesh_shape(...)`` — must be one of ``parallel/mesh.AXES``;
* BCG-SHARD-DIVISOR: a division by a raw device or rank count;
* BCG-JIT-OUTSHARD: in ``models/`` and ``parallel/``, a function that
  takes a ``mesh`` and stores a freshly made tensor (a ``torch``
  factory's draw or fill, or a name bound to one) into the tree it
  builds, with no ``shard_leaf`` / sharding transform between them: the
  full leaf on every rank (torch has no ``out_shardings``; the leaf is
  whole unless the code slices it).

BCG-JIT-DONATE has no torch construct and is not in :data:`ALL_RULES`:
torch updates tensors in place and has no buffer donation, so no call
holds a source and its result alive for want of one.  What the rule
guarded, the boot peak, is the port's design: each rank draws a full
leaf and then slices it, and ``models/loader.boot_peak_report`` counts
that transient (final tree + the largest full leaf), which
``tools/boot_smoke`` checks for every preset and the card script holds
against ``torch.cuda.max_memory_allocated``.  The rest are copies.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterable, List, Optional, Sequence, Set

from bcg_tpu_torch.analysis.core import (
    Finding,
    ModuleContext,
    _call_name,
    repo_root,
)

# Env-flag name shapes owned by this repo (see runtime/envflags.py).
_ENV_NAME_RE = re.compile(r"^(BCG_TPU_|BENCH_|MB_)\w*$|^VERBOSE$")
_ENV_ACCESSORS = {"get_bool", "get_int", "get_str", "is_set", "env_flag"}
_NP_BASES = {"np", "numpy", "onp"}
_HOST_MATERIALIZE = {"asarray", "array"}
_LOGGY_RE = re.compile(r"log|warn|print|debug|echo|exception|progress", re.I)


def _rule(rule_id: str):
    def wrap(fn):
        fn.rule_id = rule_id
        return fn
    return wrap


def _registered_env_names() -> Set[str]:
    from bcg_tpu_torch.runtime.envflags import REGISTRY

    return set(REGISTRY)


# --------------------------------------------------- tensor-valued exprs
# Tensor methods whose result is a tensor (a Python ``if``/``bool()`` of
# one reads it on the host).  Heuristic, like every rule here: an
# expression counts as a tensor when it is built from ``torch.*`` calls,
# these methods, a parameter annotated ``torch.Tensor``, or a local name
# assigned from such an expression.
_TENSOR_METHODS = {
    "all", "any", "sum", "max", "min", "mean", "prod", "argmax", "argmin",
    "amax", "amin", "eq", "ne", "gt", "ge", "lt", "le", "count_nonzero",
    "norm", "abs", "float", "long", "int", "bool", "half", "to", "clone",
    "clamp", "masked_fill", "logical_and", "logical_or", "logical_not",
    "isnan", "isinf", "isfinite", "cumsum", "std", "var", "contiguous",
    "view", "reshape", "expand", "squeeze", "unsqueeze", "gather",
    "index_select", "where", "sigmoid", "softmax", "exp", "log",
}
# torch.* calls that return host values or non-tensors.
_TORCH_HOST_RESULT = re.compile(
    r"^torch\.(cuda\.|backends\.|is_|get_|set_|Size$|device$|dtype$|"
    r"finfo$|iinfo$|no_grad$|inference_mode$|Generator$|manual_seed$|"
    r"compile$|profiler\.|autograd\.|distributed\.)"
)
# Attributes of a tensor that are host metadata, not tensors.
_TENSOR_META = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "is_leaf", "names"}
# Calls that return host scalars even on a tensor argument.
_HOST_SCALAR_METHODS = {"size", "numel", "dim", "item", "tolist",
                        "data_ptr", "element_size", "stride",
                        "is_contiguous", "get_device"}
# Calls whose RESULT is a host value read from the device: flagged by
# name wherever they stand in a capture region.
_SYNC_METHODS = {
    "item": ".item()", "tolist": ".tolist()", "cpu": ".cpu()",
    "numpy": ".numpy()", "synchronize": ".synchronize()",
    "nonzero": ".nonzero()",
}
_SYNC_CALLS = {
    "torch.cuda.synchronize", "torch.nonzero", "torch.argwhere",
    "torch.masked_select", "torch.equal", "torch.allclose",
    "torch.is_nonzero",
}


def _enclosing_function(ctx: ModuleContext, node: ast.AST) -> Optional[ast.AST]:
    cur = ctx.parent(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return cur
        cur = ctx.parent(cur)
    return None


def _local_tensor_names(fn: Optional[ast.AST]) -> Set[str]:
    """Names in ``fn`` bound to tensors: parameters annotated
    ``torch.Tensor`` / ``Tensor``, then a fixpoint over simple
    assignments from tensor-valued expressions."""
    if fn is None or isinstance(fn, ast.Lambda):
        return set()
    names: Set[str] = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.annotation is not None and _call_name(a.annotation) in (
            "torch.Tensor", "Tensor"
        ):
            names.add(a.arg)
    assigns = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            assigns.append((node.targets[0].id, node.value))
        elif isinstance(node, ast.AugAssign) and isinstance(node.target, ast.Name):
            assigns.append((node.target.id, node.value))
    changed = True
    while changed:
        changed = False
        for name, value in assigns:
            if name not in names and _tensorish(value, names):
                names.add(name)
                changed = True
    return names


def _tensorish(expr: ast.AST, names: Set[str]) -> bool:
    """Does ``expr`` evaluate to a tensor (heuristically)?"""
    if isinstance(expr, ast.Name):
        return expr.id in names
    if isinstance(expr, ast.Call):
        fname = _call_name(expr.func)
        if fname.startswith("torch."):
            return not _TORCH_HOST_RESULT.match(fname)
        if isinstance(expr.func, ast.Attribute):
            attr = expr.func.attr
            if attr in _HOST_SCALAR_METHODS:
                return False
            if attr in _TENSOR_METHODS:
                return True
        return False
    if isinstance(expr, ast.Attribute):
        if expr.attr in _TENSOR_META:
            return False
        return expr.attr in ("T", "mT", "real", "imag") and _tensorish(
            expr.value, names
        )
    if isinstance(expr, ast.Subscript):
        return _tensorish(expr.value, names)
    if isinstance(expr, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False  # identity, read on the host without the data
        return any(_tensorish(o, names) for o in [expr.left] + expr.comparators)
    if isinstance(expr, ast.BinOp):
        return _tensorish(expr.left, names) or _tensorish(expr.right, names)
    if isinstance(expr, ast.UnaryOp):
        return _tensorish(expr.operand, names)
    if isinstance(expr, ast.BoolOp):
        return any(_tensorish(v, names) for v in expr.values)
    if isinstance(expr, ast.IfExp):
        return _tensorish(expr.body, names) or _tensorish(expr.orelse, names)
    return False


def _boolish_mask(expr: ast.AST, names: Set[str]) -> bool:
    """A boolean tensor used as an index: a comparison or ``~``/``&``/
    ``|`` of tensors, ``.bool()``, or ``torch.isfinite``-style calls."""
    if isinstance(expr, ast.Compare):
        return _tensorish(expr, names)
    if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
        return _tensorish(expr.operand, names)
    if isinstance(expr, ast.BinOp) and isinstance(
        expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)
    ):
        return _boolish_mask(expr.left, names) or _boolish_mask(expr.right, names)
    if isinstance(expr, ast.Call):
        fname = _call_name(expr.func)
        short = fname.rsplit(".", 1)[-1]
        if isinstance(expr.func, ast.Attribute) and short == "bool":
            return True
        if fname.startswith("torch.") and short in (
            "isfinite", "isnan", "isinf", "logical_and", "logical_or",
            "logical_not", "logical_xor", "eq", "ne", "gt", "ge", "lt", "le",
        ):
            return True
    return False


def _capture_nodes(ctx: ModuleContext):
    """(node, tensor-name set of its function) for every AST node in a
    capture region, outside ``obs_hostsync.expected()`` seams."""
    memo = {}
    for node in ctx.capture_nodes():
        if ctx.in_expected_sync(node):
            continue
        fn = _enclosing_function(ctx, node)
        if fn not in memo:
            memo[fn] = _local_tensor_names(fn)
        yield node, memo[fn]


# ------------------------------------------------------------ rule: host sync
@_rule("BCG-HOST-SYNC")
def rule_host_sync(ctx: ModuleContext) -> Iterable[Finding]:
    """A host read inside a capture region: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize``; ``bool()``,
    ``int()`` or ``float()`` of a tensor, or a tensor as the test of a
    Python ``if``/``while``; ``torch.nonzero`` and boolean-mask indexing
    (their output sizes are read on the host); ``np.asarray``/
    ``np.array``.  In an eager step each is a stall per token; inside a
    CUDA graph capture it raises, or freezes one step's value into every
    replay.

    Calls lexically inside ``with obs_hostsync.expected():`` are the
    runtime audit's seams (``bcg_tpu_torch/obs/hostsync.py``) and exempt;
    every deliberate sync parked in the port's baseline names the seam
    that counts it — the static and runtime views are cross-linked, not
    parallel."""
    for node, names in _capture_nodes(ctx):
        what = None
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if isinstance(node.func, ast.Attribute):
                base = _call_name(node.func.value)
                attr = node.func.attr
                if attr in _SYNC_METHODS and not node.args:
                    what = _SYNC_METHODS[attr]
                elif (
                    base.split(".")[0] in _NP_BASES
                    and attr in _HOST_MATERIALIZE
                ):
                    what = f"{base}.{attr}()"
            if name in _SYNC_CALLS:
                what = name + "()"
            elif name in ("bool", "int", "float") and len(node.args) == 1 \
                    and _tensorish(node.args[0], names):
                what = f"{name}() of a tensor"
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if _tensorish(node.test, names):
                kind = {ast.If: "if", ast.While: "while", ast.IfExp: "if",
                        ast.Assert: "assert"}[type(node)]
                what = f"a tensor as a Python {kind} test"
        elif isinstance(node, ast.Subscript):
            if _boolish_mask(node.slice, names):
                what = "boolean-mask indexing"
        if what:
            yield ctx.finding(
                "BCG-HOST-SYNC",
                node,
                f"host read {what} inside a capture region",
            )


# --------------------------------------------------------- rule: np in capture
@_rule("BCG-JIT-NP")
def rule_jit_np(ctx: ModuleContext) -> Iterable[Finding]:
    """``np.*`` calls inside a capture region: numpy runs on the host,
    so inside a CUDA graph its result is baked in at capture time and
    every replay reuses it — compute it with ``torch`` on the device, or
    outside the region."""
    for node, _names in _capture_nodes(ctx):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute):
            base = _call_name(node.func.value)
            if (
                base.split(".")[0] in _NP_BASES
                and node.func.attr not in _HOST_MATERIALIZE
            ):
                yield ctx.finding(
                    "BCG-JIT-NP",
                    node,
                    f"numpy call {base}.{node.func.attr}() inside a "
                    "capture region (host-side, baked in at capture "
                    "time) — use torch on the device",
                )


# ------------------------------------------------------ rule: host branching
@_rule("BCG-JIT-BRANCH")
def rule_jit_branch(ctx: ModuleContext) -> Iterable[Finding]:
    """Python ``if``/``while`` on a (non-defaulted) parameter of a declared
    capture root: a CUDA graph records ONE side of the branch, so a call
    whose argument takes the other side replays the wrong work (or, on a
    tensor, the branch reads it on the host).  Branch on ``.shape`` or a
    defaulted (host-side) parameter, or use ``torch.where``."""
    for fn in ctx.root_functions:
        # Params WITH defaults are closure captures or optional host
        # values, not per-call arguments.
        pos = fn.args.posonlyargs + fn.args.args
        n_defaulted = len(fn.args.defaults)
        traced_pos = pos[: len(pos) - n_defaulted] if n_defaulted else pos
        params = {a.arg for a in traced_pos} - {"self", "cls"}
        if not params:
            continue
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if ctx.in_expected_sync(node):
                    continue
                bad = _traced_name_in_test(ctx, node.test, params)
                if bad:
                    yield ctx.finding(
                        "BCG-JIT-BRANCH",
                        node,
                        f"python branch on parameter {bad!r} of capture "
                        f"root {fn.name}() — use torch.where, or make it a "
                        "defaulted host-side parameter",
                    )


def _traced_name_in_test(
    ctx: ModuleContext, test: ast.AST, params: Set[str]
) -> Optional[str]:
    for node in ast.walk(test):
        if not (isinstance(node, ast.Name) and node.id in params):
            continue
        # x.shape / x.ndim / x.dtype ... — static metadata, fine.
        parent = ctx.parent(node)
        skip = False
        cur, child = parent, node
        while cur is not None:
            if isinstance(cur, ast.Attribute) and cur.value is child:
                skip = True
                break
            if isinstance(cur, ast.Call):
                fname = _call_name(cur.func)
                if fname in ("len", "isinstance", "hasattr", "getattr", "type"):
                    skip = True
                    break
            if cur is test:
                break
            child, cur = cur, ctx.parent(cur)
        if skip:
            continue
        # `x is None` / `x is not None`: optional-arg idiom, static.
        if isinstance(parent, ast.Compare):
            operands = [parent.left] + list(parent.comparators)
            if any(
                isinstance(o, ast.Constant) and o.value is None
                for o in operands
            ):
                continue
        return node.id
    return None


# ----------------------------------------------------------- rules: env flags
@_rule("BCG-ENV-RAW")
def rule_env_raw(ctx: ModuleContext) -> Iterable[Finding]:
    """Raw environment reads of registered flag names (BCG_TPU_*,
    BENCH_*, MB_*, VERBOSE) outside ``runtime/envflags.py`` bypass the
    registry's single parse + defaults — resolve through
    ``envflags.get_bool/get_int/get_str/is_set``."""
    if ctx.rel_path.endswith("runtime/envflags.py"):
        return

    def flag_name(node: ast.AST) -> Optional[str]:
        if (
            isinstance(node, ast.Constant)
            and isinstance(node.value, str)
            and _ENV_NAME_RE.match(node.value)
        ):
            return node.value
        return None

    for node in ast.walk(ctx.tree):
        name = None
        how = None
        if isinstance(node, ast.Call):
            cname = _call_name(node.func)
            if cname in ("os.environ.get", "environ.get") and node.args:
                name, how = flag_name(node.args[0]), cname
            elif cname in ("os.getenv", "getenv") and node.args:
                name, how = flag_name(node.args[0]), cname
            elif (
                cname in ("os.environ.setdefault", "environ.setdefault")
                and node.args
            ):
                # setdefault RETURNS the (possibly pre-existing) value —
                # a read with the registry's parse bypassed, plus a
                # write that later registry reads silently inherit.
                # Plain `os.environ[...] = ...` writes stay legal
                # (scenario harnesses configure flags they then read
                # through the registry).
                name, how = flag_name(node.args[0]), cname
        elif isinstance(node, ast.Subscript):
            base = _call_name(node.value)
            if base in ("os.environ", "environ") and isinstance(
                getattr(node, "ctx", None), ast.Load
            ):
                name, how = flag_name(node.slice), f"{base}[...]"
        elif isinstance(node, ast.Compare) and len(node.ops) == 1:
            if isinstance(node.ops[0], (ast.In, ast.NotIn)):
                comp = node.comparators[0]
                if _call_name(comp) in ("os.environ", "environ"):
                    name, how = flag_name(node.left), "in os.environ"
        if name:
            yield ctx.finding(
                "BCG-ENV-RAW",
                node,
                f"raw env read of {name!r} via {how} — use "
                "bcg_tpu_torch.runtime.envflags accessors",
            )


@_rule("BCG-ENV-UNREG")
def rule_env_unreg(ctx: ModuleContext) -> Iterable[Finding]:
    """envflags accessor called with a name the registry doesn't know —
    a typo'd knob reads as permanently-default instead of erroring."""
    registered = _registered_env_names()
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _call_name(node.func)
        short = name.rsplit(".", 1)[-1]
        if short not in _ENV_ACCESSORS:
            continue
        if "." in name and "envflags" not in name and short != "env_flag":
            continue
        if not node.args:
            continue
        arg = node.args[0]
        if (
            isinstance(arg, ast.Constant)
            and isinstance(arg.value, str)
            and arg.value not in registered
        ):
            yield ctx.finding(
                "BCG-ENV-UNREG",
                node,
                f"env flag {arg.value!r} is not registered in "
                "bcg_tpu_torch.runtime.envflags (typo, or add it to the "
                "registry)",
            )


# ------------------------------------------------------ rule: broad excepts
@_rule("BCG-EXCEPT-BROAD")
def rule_except_broad(ctx: ModuleContext) -> Iterable[Finding]:
    """``except Exception`` (or bare ``except:``) whose body neither
    re-raises, logs, nor inspects the exception swallows real failures —
    the misattributed-warning / silent-fallback class.  Narrow the type,
    or bind the exception and report it."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        names = []
        t = node.type
        if t is None:
            names = ["<bare>"]
        else:
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            names = [_call_name(e).rsplit(".", 1)[-1] for e in elts]
        if not any(n in ("Exception", "BaseException", "<bare>") for n in names):
            continue
        handled = False
        for child in ast.walk(node):
            if isinstance(child, (ast.Raise, ast.Assert)):
                handled = True
                break
            if (
                node.name
                and isinstance(child, ast.Name)
                and child.id == node.name
            ):
                handled = True
                break
            if isinstance(child, ast.Call) and _LOGGY_RE.search(
                _call_name(child.func).rsplit(".", 1)[-1]
            ):
                handled = True
                break
        if not handled:
            yield ctx.finding(
                "BCG-EXCEPT-BROAD",
                node,
                "broad except swallows the exception (no re-raise, no "
                "logging, exception unused) — narrow the type or report",
            )


# ----------------------------------------------- rule: engine call under lock
_LOCKY_RE = re.compile(r"lock|cond|mutex|barrier", re.I)
_ENGINE_CALL_ATTRS = {
    "generate", "batch_generate", "generate_json", "batch_generate_json",
}
_DEVICE_CALL_ATTRS = {"device_put", "device_get", "block_until_ready"}


def _lock_regions(ctx: ModuleContext) -> List[ast.AST]:
    """AST nodes whose lexical body runs with a scheduler/collective
    lock held: ``with <lock-ish>:`` blocks (context expression's last
    name segment matches lock/cond/mutex/barrier) and functions named
    ``*_locked`` (the repo convention for called-with-the-lock-held
    helpers, e.g. ``CollectiveEngine._dispatch_all_locked``)."""
    regions: List[ast.AST] = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    expr = expr.func
                name = _call_name(expr)
                if name and _LOCKY_RE.search(name.rsplit(".", 1)[-1]):
                    regions.append(node)
                    break
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.endswith("_locked"):
                regions.append(node)
    return regions


@_rule("BCG-LOCK-CALL")
def rule_lock_call(ctx: ModuleContext) -> Iterable[Finding]:
    """Engine/device calls made while holding a scheduler/collective
    lock: the inner call can block for a full device batch (seconds on a
    remote-attached TPU) while every other participant spins on the
    lock — and any completion path that needs the same lock deadlocks.
    Copy queue state under the lock, release it, then dispatch
    (bcg_tpu_torch/serve/scheduler.py is the reference shape)."""
    regions = _lock_regions(ctx)
    if not regions:
        return
    seen: Set[int] = set()  # nested regions (with-lock inside *_locked): report once
    for region in regions:
        # The lock-ACQUIRING expression itself (`with engine.lock():`)
        # runs before the lock is held — exclude the context expressions
        # from the region walk.
        excluded: Set[int] = set()
        if isinstance(region, (ast.With, ast.AsyncWith)):
            for item in region.items:
                excluded.update(id(n) for n in ast.walk(item.context_expr))
        for node in ast.walk(region):
            if node is region or not isinstance(node, ast.Call):
                continue
            if id(node) in seen or id(node) in excluded:
                continue  # nested regions: report once; context exprs: pre-lock
            if not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            base = _call_name(node.func.value)
            is_engine = attr in _ENGINE_CALL_ATTRS or (
                base and re.search(r"engine", base.rsplit(".", 1)[-1], re.I)
                and not attr.startswith("_")
            )
            is_device = attr in _DEVICE_CALL_ATTRS
            if not (is_engine or is_device):
                continue
            seen.add(id(node))
            kind = "device" if is_device and not is_engine else "engine"
            yield ctx.finding(
                "BCG-LOCK-CALL",
                node,
                f"{kind} call .{attr}() while holding a scheduler/"
                "collective lock — copy state under the lock, dispatch "
                "outside it",
            )


# ------------------------------------------------ rule: wall-clock durations
@_rule("BCG-TIME-WALL")
def rule_time_wall(ctx: ModuleContext) -> Iterable[Finding]:
    """``time.time()`` used in duration arithmetic — an operand of
    ``+``/``-`` (elapsed computation, deadline accumulation) or of an
    ordering comparison (deadline polling).  The wall clock steps under
    NTP corrections, so a "duration" spanning a step is wrong by the
    step; and around CUDA work with no ``torch.cuda.synchronize`` it
    times the launches, not the kernels (CUDA runs asynchronously) — use
    ``time.perf_counter()`` (or ``time.monotonic()``) after a
    synchronize, or CUDA events.  Bare
    timestamp uses — stored or emitted with no arithmetic at the call
    site — are legitimate and stay unflagged (park deliberate ones that
    do arithmetic in the baseline with a reason)."""
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and _call_name(node.func) == "time.time"
            and not node.args
            and not node.keywords
        ):
            continue
        how = None
        cur = ctx.parent(node)
        while cur is not None:
            if isinstance(cur, ast.BinOp) and isinstance(
                cur.op, (ast.Add, ast.Sub)
            ):
                how = "duration arithmetic (+/-)"
                break
            if isinstance(cur, ast.Compare) and any(
                isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE))
                for op in cur.ops
            ):
                how = "deadline comparison"
                break
            if isinstance(cur, ast.AugAssign) and isinstance(
                cur.op, (ast.Add, ast.Sub)
            ):
                how = "duration accumulation (+=/-=)"
                break
            if isinstance(cur, ast.stmt):
                break
            cur = ctx.parent(cur)
        if how:
            yield ctx.finding(
                "BCG-TIME-WALL",
                node,
                f"time.time() in {how} — the wall clock steps under "
                "NTP; use time.perf_counter()/time.monotonic() for "
                "durations",
            )


# ------------------------------------------------- rule: fixed-cadence retry
@_rule("BCG-RETRY-SLEEP")
def rule_retry_sleep(ctx: ModuleContext) -> Iterable[Finding]:
    """``time.sleep(<literal constant>)`` inside a ``while``/``for``
    loop body — a fixed-cadence retry/poll loop.  Constant-interval
    retries herd (every waiter comes back in the same window, re-losing
    the same race) and never adapt to how long the condition actually
    takes; derive the delay instead — exponential backoff with jitter
    (:func:`bcg_tpu_torch.runtime.resilience.backoff_s`), a server-supplied
    retry-after, or any computed expression.  A sleep whose argument is
    derived (a variable, arithmetic, a call) is legal, as is a constant
    sleep outside any loop; park deliberate fixed-cadence polls in the
    baseline with a reason."""
    imported_sleep = any(
        isinstance(node, ast.ImportFrom)
        and node.module == "time"
        and any(alias.name == "sleep" for alias in node.names)
        for node in ast.walk(ctx.tree)
    )

    def is_sleep_name(name: Optional[str]) -> bool:
        if not name:
            return False
        if name == "sleep":
            return imported_sleep
        base, _, attr = name.rpartition(".")
        # `time.sleep` plus aliased forms (`import time as _time`).
        return attr == "sleep" and base.lstrip("_").lower() == "time"

    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if not is_sleep_name(_call_name(node.func)):
            continue
        if not (
            len(node.args) == 1
            and not node.keywords
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, (int, float))
        ):
            continue
        cur = ctx.parent(node)
        in_loop = False
        while cur is not None:
            if isinstance(cur, (ast.While, ast.For, ast.AsyncFor)):
                in_loop = True
                break
            if isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                break  # the loop must enclose the sleep in THIS scope
            cur = ctx.parent(cur)
        if in_loop:
            yield ctx.finding(
                "BCG-RETRY-SLEEP",
                node,
                f"time.sleep({node.args[0].value!r}) inside a retry/poll "
                "loop — fixed-cadence retries herd and never adapt; "
                "derive the delay (backoff + jitter, e.g. "
                "runtime/resilience.backoff_s, or a carried retry-after)",
            )


# ------------------------------------------------ rule: metric name taxonomy
# <subsystem>.<noun>[.<detail>[.<detail>]] — lowercase dotted identifiers,
# 2-4 segments (DESIGN.md "Observability": the registry name is the
# documentation key, and the Prometheus exposition derives metric names
# from it mechanically).
_OBS_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+){1,3}$")
# f-string fragments: only chars a valid dotted name can contain (the
# dynamic parts fill in the rest); the LEADING fragment must already
# carry the `<subsystem>.` prefix.
_OBS_FRAGMENT_RE = re.compile(r"^[a-z0-9_.]*$")
_OBS_PREFIX_RE = re.compile(r"^[a-z][a-z0-9_]*\.")
# The legal subsystems (DESIGN.md "Observability" taxonomy).  A name
# under a subsystem not in this set is a namespace fork — dashboards,
# baselines, and the fleet shard merge all key on these prefixes, so a
# new subsystem is a deliberate registry decision, not a call-site
# spelling.  Extend HERE (and the DESIGN.md table) when one is added.
_OBS_SUBSYSTEMS = frozenset(
    {"engine", "serve", "game", "hbm", "kvpool", "fleet", "sweep", "chaos",
     "alert"}
)
_OBS_CALL_ATTRS = {
    "inc", "counter", "gauge", "set_gauge", "value", "histogram", "observe",
}
_OBS_BASE_RE = re.compile(r"(^|\.)(obs_)?_?counters$|(^|\.)REGISTRY$")
# Name-creating/mutating accessors for the bucket rule: a *read*
# (``value``) of a flat histogram entry legitimately names
# ``<hist>.bucket.le_*``; registering a counter/gauge under such a name
# is the hand-rolled-histogram anti-pattern.
_OBS_MUTATING_ATTRS = {"inc", "counter", "gauge", "set_gauge"}
# Bucket-encoding fragments in a counter/gauge name: ``<=`` spelled
# out, a ``le_<bound>`` label, or a literal ``bucket`` segment.
_OBS_BUCKET_RE = re.compile(r"<=|(^|[._])le_|(^|[._])bucket([._]|$)")


def _iter_obs_name_calls(ctx: ModuleContext, attrs):
    """(call node, name-argument node) for every registry-accessor call
    through ``bcg_tpu_torch.obs.counters`` whose accessor is in ``attrs`` —
    the shared detection base of BCG-OBS-NAME and BCG-OBS-BUCKET.
    Skips the registry implementation itself (obs/counters.py builds
    the flat ``.bucket.le_*`` names legitimately)."""
    if ctx.rel_path.endswith("obs/counters.py"):
        return
    imported_direct = any(
        isinstance(node, ast.ImportFrom)
        and node.module == "bcg_tpu_torch.obs.counters"
        for node in ast.walk(ctx.tree)
    )
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if isinstance(node.func, ast.Attribute):
            if node.func.attr not in attrs:
                continue
            base = _call_name(node.func.value)
            if not base or not _OBS_BASE_RE.search(base):
                continue
        elif isinstance(node.func, ast.Name):
            if not imported_direct or node.func.id not in attrs:
                continue
        else:
            continue
        yield node, node.args[0]


def _static_name_fragments(arg) -> Optional[List[str]]:
    """The statically-known string fragments of a name argument: a
    literal yields itself whole, an f-string its constant parts, a
    variable None (trusted)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value]
    if isinstance(arg, ast.JoinedStr):
        return [
            v.value for v in arg.values
            if isinstance(v, ast.Constant) and isinstance(v.value, str)
        ]
    return None


@_rule("BCG-OBS-NAME")
def rule_obs_name(ctx: ModuleContext) -> Iterable[Finding]:
    """Counter/gauge/histogram names registered through
    ``bcg_tpu_torch.obs.counters`` must be lowercase dotted identifiers
    matching the documented taxonomy
    (``<subsystem>.<noun>[.<detail>]``): the Prometheus exposition
    derives metric names from them mechanically, and a one-off spelling
    ("Serve.Requests", a bare "requests") fragments the namespace every
    dashboard and baseline keys on.  The leading segment must also be a
    REGISTERED subsystem (``_OBS_SUBSYSTEMS`` — engine/serve/game/hbm/
    kvpool/fleet/sweep/chaos/alert): an unknown subsystem is a namespace fork the
    fleet shard merge and every dashboard would silently split on.  Literal
    names are checked whole; f-string names have their static fragments
    checked (the leading fragment must carry the subsystem prefix);
    variable names are trusted."""
    for node, arg in _iter_obs_name_calls(ctx, _OBS_CALL_ATTRS):
        bad: Optional[str] = None
        unknown: Optional[str] = None
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if not _OBS_NAME_RE.match(arg.value):
                bad = repr(arg.value)
            elif arg.value.split(".", 1)[0] not in _OBS_SUBSYSTEMS:
                unknown = arg.value.split(".", 1)[0]
        elif isinstance(arg, ast.JoinedStr):
            consts = [
                v.value for v in arg.values
                if isinstance(v, ast.Constant) and isinstance(v.value, str)
            ]
            leading = (
                arg.values[0].value
                if arg.values
                and isinstance(arg.values[0], ast.Constant)
                and isinstance(arg.values[0].value, str)
                else None
            )
            if any(not _OBS_FRAGMENT_RE.match(c) for c in consts):
                bad = "f-string with non-taxonomy characters"
            elif leading is None or not _OBS_PREFIX_RE.match(leading):
                # Leading dynamic part (f"{x}.retrace"): the subsystem
                # itself is unknowable statically — require a literal
                # '<subsystem>.' prefix.
                bad = "f-string without a literal '<subsystem>.' prefix"
            elif leading.split(".", 1)[0] not in _OBS_SUBSYSTEMS:
                unknown = leading.split(".", 1)[0]
        if bad:
            yield ctx.finding(
                "BCG-OBS-NAME",
                node,
                f"metric name {bad} violates the counter/gauge taxonomy "
                "(<subsystem>.<noun>[.<detail>], lowercase dotted, 2-4 "
                "segments — DESIGN.md Observability)",
            )
        elif unknown is not None:
            yield ctx.finding(
                "BCG-OBS-NAME",
                node,
                f"metric subsystem {unknown!r} is not in the registered "
                f"taxonomy ({', '.join(sorted(_OBS_SUBSYSTEMS))}) — a new "
                "subsystem is a deliberate registry decision: add it to "
                "_OBS_SUBSYSTEMS and the DESIGN.md Observability table",
            )


# --------------------------------------------- rule: hand-rolled buckets
@_rule("BCG-OBS-BUCKET")
def rule_obs_bucket(ctx: ModuleContext) -> Iterable[Finding]:
    """A counter/gauge registered under a bucket-encoding name
    (``<=``, a ``le_<bound>`` label, or a ``bucket`` segment) is a
    hand-rolled histogram: N parallel counters whose bounds live in the
    name, invisible to the Prometheus histogram exposition and to every
    quantile consumer.  Use a first-class
    :class:`bcg_tpu_torch.obs.counters.Histogram` (``histogram(name, bounds)``
    + ``observe()``) — it flattens to the same registry entries AND
    exports as a conformant ``_bucket``/``_sum``/``_count`` family.
    Reads (``value``) of flat histogram entries are legitimate and stay
    unflagged."""
    for node, arg in _iter_obs_name_calls(ctx, _OBS_MUTATING_ATTRS):
        fragments = _static_name_fragments(arg)
        if fragments is None:
            continue  # variable name: trusted
        if any(_OBS_BUCKET_RE.search(frag) for frag in fragments):
            yield ctx.finding(
                "BCG-OBS-BUCKET",
                node,
                "bucket-encoding counter/gauge name (le_/<=/bucket) — "
                "a hand-rolled histogram; use obs.counters.histogram("
                "name, bounds).observe() so quantiles and the "
                "Prometheus _bucket/_sum/_count family derive "
                "mechanically",
            )


# ------------------------------------------------- rule: mutable defaults
@_rule("BCG-MUT-DEFAULT")
def rule_mut_default(ctx: ModuleContext) -> Iterable[Finding]:
    """Mutable default argument values are shared across every call."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        defaults = list(node.args.defaults) + [
            d for d in node.args.kw_defaults if d is not None
        ]
        for d in defaults:
            mutable = isinstance(
                d, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                    ast.SetComp)
            ) or (
                isinstance(d, ast.Call)
                and _call_name(d.func) in ("list", "dict", "set", "bytearray")
            )
            if mutable:
                yield ctx.finding(
                    "BCG-MUT-DEFAULT",
                    d,
                    f"mutable default argument in {node.name}() — shared "
                    "across calls; use None + in-body init",
                )


# ===================================================== program-level rules
# These receive a ProgramContext (interproc.py) instead of a
# ModuleContext: they reason over the package-wide call graph, the
# thread-root inventory, and the lock model.  The engine dispatches on
# the ``program_level`` attribute.


def _program_rule(rule_id: str):
    def wrap(fn):
        fn.rule_id = rule_id
        fn.program_level = True
        return fn
    return wrap


def _short(qname: str) -> str:
    """``bcg_tpu_torch/serve/scheduler.py::Scheduler._loop`` -> ``Scheduler._loop``."""
    return qname.rsplit("::", 1)[-1]


def _lock_short(lock_id: str) -> str:
    return lock_id.rsplit("::", 1)[-1]


@_program_rule("BCG-LOCK-ORDER")
def rule_lock_order(prog) -> Iterable[Finding]:
    """Cycle in the lock-acquisition graph reachable from two distinct
    thread roots (or two instances of one pooled root): thread A holds
    L1 wanting L2 while thread B holds L2 wanting L1 — the classic
    deadlock, and exactly the shape the PR-15 watchdog avoided by
    swapping the device lock instead of nesting it under the queue cond.
    The edge set comes from lexically nested ``with`` blocks AND from
    calls made under a lock into functions that (transitively) acquire
    another — module boundaries don't hide the ordering."""
    edges = prog.lock_order_edges()
    cycles = prog.find_lock_cycles(edges)
    for cycle in sorted(cycles, key=lambda c: tuple(sorted(c))):
        edge_roots = []
        for e in cycle:
            roots = []
            for ev in edges[e]:
                roots.extend(prog.roots_reaching(ev.fn))
            edge_roots.append({r.target: r for r in roots})
        held_by_two = False
        names = set()
        for i in range(len(cycle)):
            for j in range(len(cycle)):
                if i == j:
                    continue
                for r1 in edge_roots[i].values():
                    for r2 in edge_roots[j].values():
                        if r1.target != r2.target or r1.multi:
                            held_by_two = True
                            names.add(r1.name)
                            names.add(r2.name)
        if not held_by_two:
            continue
        ev = edges[cycle[0]][0]
        fi = prog.functions[ev.fn]
        order = " -> ".join(
            [_lock_short(a) for a, _ in cycle] + [_lock_short(cycle[0][0])]
        )
        sites = "; ".join(
            f"{_lock_short(a)}->{_lock_short(b)} at "
            f"{prog.functions[edges[(a, b)][0].fn].ctx.rel_path}:"
            f"{getattr(edges[(a, b)][0].node, 'lineno', '?')}"
            for a, b in cycle
        )
        yield fi.ctx.finding(
            "BCG-LOCK-ORDER",
            ev.node,
            f"lock-order cycle {order} across thread roots "
            f"({', '.join(sorted(names))}) — potential deadlock; "
            f"acquisitions: {sites}",
        )


@_program_rule("BCG-LOCK-BLOCK")
def rule_lock_block(prog) -> Iterable[Finding]:
    """A blocking operation — sleep, thread join, queue get/put without
    timeout, file I/O, engine dispatch, device transfer — executed while
    a lock is held, directly or through any resolvable call chain.  The
    interprocedural generalization of BCG-LOCK-CALL: every other thread
    needing that lock stalls for the full blocking duration, and a
    completion path that needs the same lock deadlocks.  Copy state
    under the lock, release it, then block (serve/scheduler.py is the
    reference shape)."""
    reported: Set[int] = set()
    findings = []
    for fi, site in prog.iter_held_regions():
        region_ids = {id(n) for n in prog.region_nodes(site)}
        for node, kind in prog.direct_blocking(fi.qname):
            if id(node) not in region_ids or id(node) in reported:
                continue
            reported.add(id(node))
            findings.append(fi.ctx.finding(
                "BCG-LOCK-BLOCK",
                node,
                f"blocking {kind} while holding "
                f"{_lock_short(site.lock_id)} — copy state under the "
                "lock, block outside it",
            ))
        for call, callee in fi.calls:
            if id(call) not in region_ids or id(call) in reported:
                continue
            kinds = prog.blocking_kinds(callee)
            if not kinds:
                continue
            reported.add(id(call))
            kind = sorted(kinds)[0]
            chain = " -> ".join(
                _short(q) for q in prog.blocking_witness(callee, kind)
            )
            findings.append(fi.ctx.finding(
                "BCG-LOCK-BLOCK",
                call,
                f"call into {_short(callee)}() performs {kind} while "
                f"{_lock_short(site.lock_id)} is held (chain: {chain})",
            ))
    return findings


@_program_rule("BCG-SHARED-MUT")
def rule_shared_mut(prog) -> Iterable[Finding]:
    """An attribute (or module global) mutated from two or more distinct
    thread roots — or, for module globals only, from two instances of one
    pooled root — with no common lock held across the mutation sites: a
    data race.  Pooled workers usually construct their own objects, so a
    single pooled root is not evidence that an *instance* attribute is
    shared; a module global IS shared across the pool by construction.
    Constructor-family writes are object birth and excluded; a single
    common guarding lock (or thread confinement to one root) silences
    the rule."""
    muts = prog.attribute_mutations()
    for (owner, attr), sites in sorted(muts.items()):
        is_global = owner.endswith("::<global>")
        root_map = {}
        multi = False
        rooted_sites = []
        for fi, node, guards in sites:
            roots = prog.roots_reaching(fi.qname)
            if roots:
                rooted_sites.append((fi, node, guards))
            for r in roots:
                root_map[r.target] = r
                multi = multi or r.multi
        if len(root_map) < 2 and not (
            len(root_map) == 1 and multi and is_global
        ):
            continue
        common = None
        for _, _, guards in rooted_sites:
            common = guards if common is None else (common & guards)
        if common:
            continue
        fi, node, _ = sorted(
            rooted_sites,
            key=lambda s: (s[0].ctx.rel_path, getattr(s[1], "lineno", 0)),
        )[0]
        names = sorted(r.name for r in root_map.values())
        what = (
            f"module global {attr!r}"
            if is_global
            else f"attribute {attr!r} of {_short(owner)}"
        )
        yield fi.ctx.finding(
            "BCG-SHARED-MUT",
            node,
            f"{what} mutated from {len(root_map)} thread root(s) "
            f"({', '.join(names)}) with no common guarding lock — "
            "guard every mutation site with one lock or confine the "
            "attribute to a single thread",
        )


# ------------------------------------------------------------ mesh rules
_MESH_AXES_MEMO: Optional[Set[str]] = None


def _mesh_axes() -> Set[str]:
    """The axis names ``parallel/mesh.py`` defines (its ``AXES``), parsed
    from source once per process."""
    global _MESH_AXES_MEMO
    if _MESH_AXES_MEMO is None:
        _MESH_AXES_MEMO = {"dp", "tp", "sp"}
        try:
            with open(os.path.join(repo_root(), "bcg_tpu_torch", "parallel", "mesh.py")) as fh:
                tree = ast.parse(fh.read())
        except (OSError, SyntaxError):
            tree = None
        for node in ast.walk(tree) if tree is not None else ():
            if (isinstance(node, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "AXES" for t in node.targets)
                    and isinstance(node.value, (ast.Tuple, ast.List))):
                names = {e.value for e in node.value.elts
                         if isinstance(e, ast.Constant) and isinstance(e.value, str)}
                if names:
                    _MESH_AXES_MEMO = names
    return _MESH_AXES_MEMO


# Functions taking a mesh axis name: the argument's position and keyword.
_AXIS_ARGS = {
    "all_reduce": (2, "axis"), "broadcast": (2, "axis"), "all_gather": (2, "axis"),
    "ring_shift": (2, "axis"), "axis_size": (1, "axis"), "axis_rank": (1, "axis"),
    "tally_votes": (2, "axis_name"), "shard_agents": (2, "axis_name"),
    "exchange_values": (3, "axis_name"), "exchange_proposals": (3, "axis_name"),
    # DeviceMesh methods
    "get_group": (0, "mesh_dim"), "get_local_rank": (0, "mesh_dim"),
}


def _axis_literals(node: ast.Call) -> Iterable[ast.Constant]:
    """The string literals a call passes where a mesh axis goes."""
    short = _call_name(node.func).rsplit(".", 1)[-1]
    if short in _AXIS_ARGS:
        pos, kw = _AXIS_ARGS[short]
        args = [node.args[pos]] if len(node.args) > pos else []
        args += [k.value for k in node.keywords if k.arg == kw]
        yield from (a for a in args if isinstance(a, ast.Constant) and isinstance(a.value, str))
    if (isinstance(node.func, ast.Attribute) and node.func.attr == "get"
            and isinstance(node.func.value, ast.Call)
            and _call_name(node.func.value.func).rsplit(".", 1)[-1] == "mesh_shape"
            and node.args and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        yield node.args[0]


@_rule("BCG-SHARD-AXIS")
def rule_shard_axis(ctx: ModuleContext) -> Iterable[Finding]:
    """A string literal used as a mesh axis must be an axis
    ``parallel/mesh.py`` defines: a typo'd axis is a size-1 axis to
    ``mesh_shape(...).get`` and the collectives, so the collective sums
    nothing and the tensor silently replicates."""
    if ctx.rel_path.endswith("parallel/mesh.py"):
        return  # the definition site itself
    axes = _mesh_axes()
    for node in ast.walk(ctx.tree):
        lits: List[ast.Constant] = []
        if isinstance(node, ast.Call):
            lits = list(_axis_literals(node))
        elif (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Call)
              and _call_name(node.value.func).rsplit(".", 1)[-1] == "mesh_shape"
              and isinstance(node.slice, ast.Constant) and isinstance(node.slice.value, str)):
            lits = [node.slice]
        for c in lits:
            if c.value not in axes:
                yield ctx.finding(
                    "BCG-SHARD-AXIS", c,
                    f"mesh axis {c.value!r} is not a mesh axis (defined: "
                    f"{sorted(axes)}) — silently replicates",
                )


# Calls whose result is a raw device or rank count.
_RAW_COUNT_CALLS = {"dist.get_world_size", "torch.distributed.get_world_size",
                    "distributed.world_size", "world_size", "torch.cuda.device_count",
                    "cuda.device_count"}


def _raw_count(node: ast.AST) -> Optional[str]:
    """The text of ``node`` when it is a raw device or rank count."""
    if not isinstance(node, ast.Call):
        return None
    name = _call_name(node.func)
    if name in _RAW_COUNT_CALLS:
        return name + "()"
    if name.endswith(".size") and re.search(r"mesh", name, re.I) and not node.args:
        return name + "()"
    if name == "len" and node.args:
        inner = node.args[0]
        target = _call_name(inner.func) if isinstance(inner, ast.Call) else _call_name(inner)
        if re.search(r"device", target, re.I):
            return f"len({target}{'()' if isinstance(inner, ast.Call) else ''})"
    return None


@_rule("BCG-SHARD-DIVISOR")
def rule_shard_divisor(ctx: ModuleContext) -> Iterable[Finding]:
    """Per-rank byte accounting must divide by the mesh axes that
    ENGAGE, not by a raw device or rank count: an axis that fails its
    divisibility guard replicates instead of sharding, and dividing by
    the world then undercounts a rank's bytes by that axis's factor.
    Route through ``parallel/sharding.kv_cache_bytes_per_device`` /
    ``tree_bytes_per_device`` (or the engine's ``cap_for``)."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.Div, ast.FloorDiv)):
            desc = _raw_count(node.right)
            if desc:
                yield ctx.finding(
                    "BCG-SHARD-DIVISOR", node,
                    f"division by a raw device count ({desc}) — divide by the "
                    "engaged mesh axes (parallel/sharding per-device helpers) or "
                    "replication overcommits device memory",
                )


def _in_param_scope(ctx: ModuleContext) -> bool:
    rel = ctx.rel_path
    return "/models/" in rel or "/parallel/" in rel or rel.startswith(("models/", "parallel/"))


# torch calls that make a tensor of the shape they are given (a full leaf).
_FACTORY_RE = re.compile(r"^torch\.(randn|rand|randint|empty|zeros|ones|full|normal|"
                         r"tensor|as_tensor|from_numpy)$")
# Calls that give a rank its part of a leaf.
_SHARDING_RE = re.compile(r"(^|\.)(shard_leaf|shard_params|_read_slice|\w*transform)$")


def _made_full(expr: ast.AST, bound) -> bool:
    """Whether ``expr`` is a freshly made full tensor: a factory call, a
    method chained on one (``.to``, ``.mul_``), a name ``bound`` to one,
    or a conditional either arm of which is one."""
    if isinstance(expr, ast.IfExp):
        return _made_full(expr.body, bound) or _made_full(expr.orelse, bound)
    if isinstance(expr, ast.Name):
        return bound.get(expr.id, False)
    if isinstance(expr, ast.Call):
        name = _call_name(expr.func)
        if _SHARDING_RE.search(name):
            return False
        if _FACTORY_RE.match(name):
            return True
        if isinstance(expr.func, ast.Attribute) and not name.startswith("torch."):
            return _made_full(expr.func.value, bound)
    return False


@_rule("BCG-JIT-OUTSHARD")
def rule_jit_outshard(ctx: ModuleContext) -> Iterable[Finding]:
    """In parameter-making modules (``models/``, ``parallel/``): a
    function that takes a ``mesh`` and stores a freshly made tensor into
    the tree it builds (``tree[name] = ...``) without a ``shard_leaf`` /
    sharding transform between the two keeps the FULL leaf on every rank
    — the unsharded materialization the JAX rule's ``out_shardings``
    guards (the boot OOM class).  Slice the leaf (or baseline a
    deliberately replicated one)."""
    if not _in_param_scope(ctx):
        return
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if "mesh" not in [a.arg for a in fn.args.args + fn.args.kwonlyargs]:
            continue
        # Names in source order: whether their latest binding is a full
        # leaf (a branch's rebinding through shard_leaf clears it).
        bound = {}
        stmts = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Assign)),
                       key=lambda n: (n.lineno, n.col_offset))
        for st in stmts:
            full = _made_full(st.value, bound)
            for tgt in st.targets:
                if isinstance(tgt, ast.Name):
                    bound[tgt.id] = full
                elif isinstance(tgt, ast.Subscript) and full:
                    yield ctx.finding(
                        "BCG-JIT-OUTSHARD", st,
                        "a full leaf stored into a mesh function's tree without "
                        "shard_leaf — every rank holds it whole",
                    )


ALL_RULES: Sequence = (
    rule_host_sync,
    rule_jit_np,
    rule_jit_branch,
    rule_env_raw,
    rule_env_unreg,
    rule_except_broad,
    rule_mut_default,
    rule_lock_call,
    rule_time_wall,
    rule_retry_sleep,
    rule_obs_name,
    rule_obs_bucket,
    rule_lock_order,
    rule_lock_block,
    rule_shared_mut,
    rule_shard_axis,
    rule_shard_divisor,
    rule_jit_outshard,
)

RULE_IDS: List[str] = [r.rule_id for r in ALL_RULES]
