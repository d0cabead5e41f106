"""The device trace of a traced window, reduced to what the metrics read.

The window runs under ``torch.profiler`` with CUDA activity only (kernels,
copies and the CUDA runtime calls that launched them).  Kineto's raw
events are read directly: building ``key_averages()``' event tree takes
tens of seconds for a window's hundreds of thousands of launches.

* Device busy time is the UNION of the device operations' intervals, so
  overlapping operations are counted once.  The idle share is one minus
  busy over the traced window, both from the same traced interval.
* Each idle gap between device operations is labelled by the CUDA
  runtime call that covers most of it on the host (a synchronise or a
  copy: the host waited on the card), or as host work before the next
  runtime call (the host was still dispatching).

:func:`kernel_kind` is a frozen copy of the port's kernel classifier
(``bcg_tpu_torch/obs/hlo.py``), so the benchmark's grouping does not move
when the program's does.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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


def kernel_kind(name: str) -> str:
    low = name.lower()
    return next((kind for frag, kind in KERNEL_KINDS if frag in low), "other")


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge ``(start, end)`` intervals into disjoint sorted ones."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(merged: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The idle intervals between consecutive merged busy intervals."""
    return [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]


def label_gaps(idle: Sequence[Tuple[int, int]],
               host: Sequence[Tuple[int, int, str]]) -> List[Tuple[str, int]]:
    """``(label, ns)`` of each idle gap: ``"host waits: <call>"`` where one
    runtime call covers at least half of the gap, else ``"host dispatch
    before <next call>"`` (or ``"host, no CUDA call"``)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    # reach[i]: the call of host[:i + 1] that ends last (a call that
    # started before a gap covers most of it only if it ends late).
    reach: List[int] = []
    for i, h in enumerate(host):
        reach.append(i if not reach or h[1] >= host[reach[-1]][1] else reach[-1])
    out = []
    for s, e in idle:
        i = bisect.bisect_right(starts, s)
        cands = ([reach[i - 1]] if i else []) + list(range(i, min(i + 8, len(host))))
        best, best_cover = None, 0
        for k in cands:
            hs, he, name = host[k]
            cover = min(e, he) - max(s, hs)
            if cover > best_cover:
                best, best_cover = name, cover
        if best is not None and 2 * best_cover >= e - s:
            label = f"host waits: {best}"
        else:
            nxt = host[i][2] if i < len(host) else None
            label = f"host dispatch before {nxt}" if nxt else "host, no CUDA call"
        out.append((label, e - s))
    return out


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    # kernel name -> (seconds, launches)
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    # label -> (seconds, gaps, longest seconds)
    idle_by_label: Dict[str, Tuple[float, int, float]] = field(default_factory=dict)
    device_events: int = 0

    def kernel_seconds(self, fragments: Sequence[str]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose names hold any
        of ``fragments``."""
        secs, n = 0.0, 0
        for name, (s, c) in self.by_name.items():
            if any(f in name for f in fragments):
                secs += s
                n += c
        return secs, n

    def seconds_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, (s, _) in self.by_name.items():
            kind = kernel_kind(name)
            out[kind] = out.get(kind, 0.0) + s
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(((s, name) for name, (s, _) in self.by_name.items()), reverse=True)[:top]
        idle = sorted(((s, f"{label} ({n} gaps, longest {longest:.6f} s)")
                       for label, (s, n, longest) in self.idle_by_label.items()),
                      reverse=True)[:top]
        return {"device_ops": [[name[:160], s] for s, name in ops],
                "idle_gaps": [[label, s] for s, label in idle]}


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce kineto's raw events (``prof.profiler.kineto_results
    .events()``) of a traced window."""
    from torch.autograd import DeviceType

    device: List[Tuple[int, int]] = []
    host: List[Tuple[int, int, str]] = []
    by_name: Dict[str, Tuple[float, int]] = {}
    for evt in events:
        start, dur = evt.start_ns(), evt.duration_ns()
        if evt.device_type() == DeviceType.CUDA:
            device.append((start, start + dur))
            s, n = by_name.get(evt.name(), (0.0, 0))
            by_name[evt.name()] = (s + dur / 1e9, n + 1)
        elif evt.name().startswith("cuda"):
            host.append((start, start + dur, evt.name()))
    merged = union(device)
    idle: Dict[str, Tuple[float, int, float]] = {}
    for label, ns in label_gaps(gaps(merged), host):
        s, n, longest = idle.get(label, (0.0, 0, 0.0))
        idle[label] = (s + ns / 1e9, n + 1, max(longest, ns / 1e9))
    return TraceSummary(window_s=window_s, busy_s=sum(e - s for s, e in merged) / 1e9,
                        by_name=by_name, idle_by_label=idle, device_events=len(device))


class Profiled:
    """A ``torch.profiler`` session around a window (CUDA activity only),
    or nothing when ``on`` is false."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.stop_s: Optional[float] = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            import time

            t0 = time.perf_counter()
            self.prof.__exit__(*exc)
            self.stop_s = time.perf_counter() - t0
        return False

    def summary(self, window_s: float) -> Optional[TraceSummary]:
        if self.prof is None:
            return None
        return summarize(self.prof.profiler.kineto_results.events(), window_s)
