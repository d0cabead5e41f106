"""Per-decode-step launch census (``BCG_TPU_HLO_CENSUS``) — the port of
``bcg_tpu/obs/hlo.py``.

The JAX module lowers each jit entry once more and counts the
kernel-launching ops of its ``while`` body: the kernels one decode step
dispatches.  The PyTorch engine's decode step is a Python loop body, so
the census watches one step run instead.  When the census is on, each
decode loop entry (``decode_loop``, ``ff_decode_loop``,
``spec_decode_loop``, with a ``paged_`` prefix over the block pool) asks
:func:`step_census` for a recorder at its first call and brackets step
:data:`CENSUS_STEP` with :meth:`StepCensus.begin` /
:meth:`StepCensus.end`.  The record counts, for that one step:

* ``calls`` — the hand-written kernels' wrapper calls by kind (each
  dispatcher's ``.calls``; both devices: on the CPU the wrapper runs its
  plain version);
* ``launches`` — the same wrappers' kernel launches (``.launches``; only
  a CUDA tensor launches);
* ``kernels`` — on a CUDA card, every operation the step put on the
  device, by kind (:data:`KERNEL_KINDS`, from ``torch.profiler``'s CUDA
  events; ``"other"`` is what no fragment names: elementwise, reduction
  and copy kernels, memory copies and sets).

It publishes them as gauges ``engine.hlo.<entry>.<metric>`` under the
JAX module's names where one exists: ``step_ops`` (every kernel of the
step, on the card), ``step_custom_calls`` (the hand-written kernels'
calls: what the JAX census counts as custom calls), ``step_dots``
(matrix products), ``step_fusions`` (the rest); and
``engine.hlo.<entry>.{calls,launches,kernels}_<kind>`` (one name segment
after the entry, as every census gauge has: ``scripts/trace_report.py``
reads the segment before the last dot as the entry).  The drift gate
over these records is ``bcg_tpu_torch/tools/census_gate.py``, with its
own baseline: the JAX baseline is TPU HLO.

Cost: two profiled steps per entry (the one before the counted step
warms the profiler up; a device synchronization on each side, the
profiler's start and stop), which is why the census is OFF by default.  Recording never raises into the loop: a failed
profiler leaves a partial record naming the failure.  No torch import
at module scope.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.runtime import envflags

# The step the census records: not the first, so a call that finishes
# within one step records nothing and the next call tries again.  On a
# card the profiler starts a step earlier, so it is collecting when the
# counted step starts, and two spin kernels (``torch.cuda._sleep``) mark
# the counted step's ends on the device timeline: only what runs between
# them is counted.
CENSUS_STEP = 1
_MARK_KERNEL = "spin_kernel"
_MARK_CYCLES = 1000

# Kind -> the kernel wrappers (ops module, dispatcher) whose calls and
# launches it sums.  The kinds are :data:`KERNEL_KINDS`'s, so the
# wrappers' launches and the card's kernels compare kind by kind.
WRAPPERS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "flash_prefill": (("attention", "flash_attention"),),
    "decode_attention": (("decode_attention", "decode_attention"),),
    "chunk_decode_attention": (("decode_attention", "chunk_decode_attention"),),
    "decode_attention_int8": (("decode_attention", "decode_attention_int8"),
                              ("decode_attention", "chunk_decode_attention_int8")),
    "paged_attention": (("paged_attention", "paged_decode_attention"),
                        ("paged_attention", "paged_chunk_attention")),
    "guided_sampler": (("guided_sampler", "sample_rows"),),
    "w4a16_matmul": (("w4_matmul", "w4a16_matmul"),),
}

# Kernel name fragments -> kind, first match wins (cuBLAS's matrix
# products show up as nvjet / gemm / gemv kernels, its int8 products with
# s8 / i8 / imma in the name).  "dequant" is the int4 unpack's shift
# kernels; B1 is its mask pre-pass and its kernel, two launches a call.
KERNEL_KINDS = (
    ("flash_prefill_kernel", "flash_prefill"), ("mask_pack_kernel", "flash_prefill"),
    ("decode_attention_kernel", "decode_attention"),
    ("chunk_decode_bf16_kernel", "chunk_decode_attention"),
    ("decode_int8_kernel", "decode_attention_int8"),
    ("guided_sampler_kernel", "guided_sampler"),
    ("paged_kernel", "paged_attention"),
    ("w4a16_kernel", "w4a16_matmul"),
    ("s8s8", "int8_gemm"), ("i8i8", "int8_gemm"), ("i8i32", "int8_gemm"), ("imma", "int8_gemm"),
    ("int8gemm", "int8_gemm"), ("_s8_", "int8_gemm"), ("igemm", "int8_gemm"),
    ("shift", "dequant"),
    ("nvjet", "matmul"), ("gemm", "matmul"), ("gemv", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"),
)
_DOT_KINDS = ("matmul", "int8_gemm")

# Census metric names published as gauges, in render order.
COUNT_METRICS = ("step_ops", "step_custom_calls", "step_dots", "step_fusions")


def kernel_kind(name: str) -> str:
    """The kind of a CUDA kernel by its (demangled) name."""
    low = name.lower()
    return next((kind for frag, kind in KERNEL_KINDS if frag in low), "other")


def wrapper_counts() -> Tuple[Dict[str, int], Dict[str, int]]:
    """(calls, launches) of every kernel wrapper, summed by kind."""
    import importlib

    calls: Dict[str, int] = {}
    launches: Dict[str, int] = {}
    for kind, fns in WRAPPERS.items():
        for mod, attr in fns:
            fn = getattr(importlib.import_module(f"bcg_tpu_torch.ops.{mod}"), attr)
            n = fn.launches
            calls[kind] = calls.get(kind, 0) + fn.calls
            launches[kind] = launches.get(kind, 0) + (sum(n.values()) if isinstance(n, dict) else n)
    return calls, launches


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


# --------------------------------------------------------------- recorder
# entry name -> census dict.
CENSUS: Dict[str, Dict[str, Any]] = {}
_lock = threading.Lock()
_enabled: Optional[bool] = None  # tri-state: None = read the env flag


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = envflags.get_bool("BCG_TPU_HLO_CENSUS")
    return _enabled


def reset() -> None:
    """Drop recorded censuses AND the cached enable flag — test/script
    use."""
    global _enabled
    with _lock:
        CENSUS.clear()
        _enabled = None


def recorded(entry: str) -> bool:
    return entry in CENSUS


class StepCensus:
    """Records one decode step of ``entry`` (see the module docstring).
    The loop calls :meth:`begin` and :meth:`end` around every step and
    :meth:`close` after its last."""

    def __init__(self, entry: str, device):
        self.entry = entry
        self.cuda = getattr(device, "type", str(device)) == "cuda"
        self._prof = None
        self._before: Tuple[Dict[str, int], Dict[str, int]] = ({}, {})
        self._error: Optional[str] = None

    def begin(self, step: int) -> None:
        if step == CENSUS_STEP - 1 and self.cuda:
            self._start_profiler()
        elif step == CENSUS_STEP:
            self._before = wrapper_counts()
            self._mark()

    def end(self, step: int) -> None:
        if step != CENSUS_STEP or recorded(self.entry):
            return
        census: Dict[str, Any] = {"backend": "cuda" if self.cuda else "cpu",
                                  "step": CENSUS_STEP}
        calls, launches = wrapper_counts()
        kernels = self._stop_profiler() if self._prof is not None else None
        census["calls"] = _delta(calls, self._before[0])
        census["launches"] = _delta(launches, self._before[1])
        census["step_custom_calls"] = sum(census["calls"].values())
        if kernels is not None:
            census["kernels"] = kernels
            census["step_ops"] = sum(kernels.values())
            census["step_dots"] = sum(kernels.get(k, 0) for k in _DOT_KINDS)
            census["step_fusions"] = kernels.get("other", 0)
        if self._error:
            census["error"] = self._error
        with _lock:
            if self.entry in CENSUS:  # raced
                return
            CENSUS[self.entry] = census
        publish_gauges(self.entry, census)

    def close(self) -> None:
        """Stop a profiler the loop left running (it ended before the
        counted step finished); nothing is recorded."""
        if self._prof is not None:
            try:
                self._prof.stop()
            except RuntimeError:
                pass
            self._prof = None

    def _start_profiler(self) -> None:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            if torch.autograd._profiler_enabled():
                self._error = "another profiler is active"
                return
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.start()
        except Exception as exc:  # the census never takes the loop down
            self._prof = None
            self._error = f"{type(exc).__name__}: {str(exc)[:200]}"

    def _mark(self) -> None:
        if self._prof is not None:
            import torch

            torch.cuda._sleep(_MARK_CYCLES)

    def _stop_profiler(self) -> Optional[Dict[str, int]]:
        """The device operations between the two marks, by kind; None (and
        an error) when the marks are not both in the trace."""
        try:
            import torch
            from torch.autograd import DeviceType

            self._mark()
            torch.cuda.synchronize()
            self._prof.stop()
            # The raw events: key_averages() would build the Python event
            # tree for the same counts.
            events = sorted(
                (evt.start_ns(), evt.name())
                for evt in self._prof.profiler.kineto_results.events()
                if evt.device_type() == DeviceType.CUDA)
            marks = [i for i, (_, name) in enumerate(events) if _MARK_KERNEL in name]
            if len(marks) != 2:
                self._error = f"{len(marks)} step marks in the trace, not 2"
                return None
            kernels: Dict[str, int] = {}
            for _, name in events[marks[0] + 1:marks[1]]:
                kind = kernel_kind(name)
                kernels[kind] = kernels.get(kind, 0) + 1
            return kernels
        except Exception as exc:
            self._error = f"{type(exc).__name__}: {str(exc)[:200]}"
            return None
        finally:
            self._prof = None


def step_census(entry: str, device) -> Optional[StepCensus]:
    """A recorder for ``entry``'s decode step on ``device``, or None when
    the census is off or ``entry`` is already recorded (the loop's only
    cost then)."""
    if not enabled() or entry in CENSUS:
        return None
    return StepCensus(entry, device)


def publish_gauges(entry: str, census: Dict[str, Any]) -> None:
    """Mirror one census into registry gauges
    (``engine.hlo.<entry>.<metric>``)."""
    for metric in COUNT_METRICS:
        value = census.get(metric)
        if value is not None:
            obs_counters.set_gauge(f"engine.hlo.{entry}.{metric}", value)
    for table in ("calls", "launches", "kernels"):
        for kind, value in census.get(table, {}).items():
            obs_counters.set_gauge(f"engine.hlo.{entry}.{table}_{kind}", value)


def snapshot() -> Dict[str, Dict[str, Any]]:
    """Copy of every recorded census (entry -> metrics)."""
    with _lock:
        return {k: {m: (dict(v) if isinstance(v, dict) else v) for m, v in c.items()}
                for k, c in CENSUS.items()}
