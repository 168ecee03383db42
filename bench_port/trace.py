"""The traced request of a ``--trace 1`` run: one request under
``torch.profiler``, reduced to what the per-layer metrics read.

While it runs, every kernel entry that a file of ``bench_port/counts/``
names is wrapped so that each call's shapes are recorded; the file's
``cost`` turns them into operations and bytes after the request. The
device's busy time is the union of its operations' spans inside the
request's window.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

Span = Tuple[float, float, str]  # (start us, end us, name)
REQUEST_SPAN = "bench_port.request"
SHORT_GAP_US = 20.0  # idle gaps shorter than this are summed unnamed


@dataclasses.dataclass
class Trace:
    counts: Dict[str, object]  # the counts modules, by kernel name
    kernels: List[Span]  # device kernels inside the window
    transfers: List[Span]  # device copies and fills inside the window
    window_s: float
    busy_s: float
    steps: int  # Gibbs steps in the traced request
    calls: Dict[str, List[dict]]  # counts module -> recorded calls
    model_flops: float  # the request's model operations (bench_port.flops)
    gaps: List[Tuple[str, float]]  # idle seconds by what the host ran
    # the towers' parameters and buffers (bench_port.system.weights_bytes)
    weights_bytes: int = 0

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(e - s for s, e, n in self.kernels if match(n)) / 1e6


def counts_modules(root: Path) -> Dict[str, object]:
    """Every module of ``<root>/bench_port/counts/``, by its name."""
    from bench_port.run import load_module

    folder = Path(root) / "bench_port" / "counts"
    return {p.stem: load_module(p) for p in sorted(folder.glob("*.py"))
            if p.stem != "__init__"}


@contextlib.contextmanager
def recording(mods: Dict[str, object], calls: Dict[str, List[dict]]):
    """Wrap each counts module's ``TARGETS`` ("module:attribute") so that
    every call appends ``record(args, kwargs)``; restore them after."""
    saved = []
    try:
        for name, mod in mods.items():
            calls[name] = []
            for target in mod.TARGETS:
                mod_name, attr = target.split(":")
                owner = importlib.import_module(mod_name)
                fn = getattr(owner, attr)
                saved.append((owner, attr, fn))

                def wrapped(*args, _fn=fn, _mod=mod, _sink=calls[name],
                            **kwargs):
                    _sink.append(_mod.record(args, kwargs))
                    return _fn(*args, **kwargs)

                setattr(owner, attr, wrapped)
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)


def _union(spans: List[Span], lo: float, hi: float
           ) -> Tuple[float, List[Tuple[float, float]]]:
    """Busy microseconds of ``spans`` clipped to [lo, hi], and the idle
    gaps between them."""
    busy, reach, gaps = 0.0, lo, []
    for s, e, _ in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > reach:
            gaps.append((reach, s))
        busy += max(0.0, e - max(s, reach))
        reach = max(reach, e)
    if hi > reach:
        gaps.append((reach, hi))
    return busy, gaps


def _label_gaps(gaps: List[Tuple[float, float]], host: List[Span]
                ) -> List[Tuple[str, float]]:
    """Idle seconds by the innermost host operation running at each gap's
    middle (an ``aten::`` operation first, else an annotation of the
    benchmark's); gaps under SHORT_GAP_US are summed under one name."""
    ops = sorted(x for x in host if x[2].startswith("aten::"))
    marks = sorted(x for x in host if x[2].startswith("bench_port."))
    starts = [x[0] for x in ops]
    by: Dict[str, float] = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_US:
            name = f"gaps under {SHORT_GAP_US:g} us"
        else:
            mid = (a + b) / 2
            name = None
            i = bisect.bisect_right(starts, mid)
            best = None
            for s, e, n in ops[max(0, i - 64):i]:
                if e >= mid and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, n)
            if best is None:
                inner = [x for x in marks if x[0] <= mid <= x[1]]
                best = min(inner, key=lambda x: x[1] - x[0], default=None)
            name = best[2] if best else "host Python, no torch operation"
        by[name] = by.get(name, 0.0) + (b - a) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])


def _events(prof):
    """(name, on the device, is an annotation, start us, end us) of every
    event, from the profiler's raw results (no FunctionEvent tree is
    built: a request launches some hundred thousand kernels)."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        yield (e.name(), e.device_type() == DeviceType.CUDA,
               e.is_user_annotation(), start, start + e.duration_ns() / 1e3)


def traced(run_request: Callable[[], object], steps: int,
           model_flops: float, sync: Callable[[], None],
           mods: Dict[str, object]) -> Tuple[object, Trace]:
    """Run one request under the profiler, with the kernel entries of the
    counts modules ``mods`` recorded; returns (its result, Trace).
    ``sync`` waits for the device."""
    from torch.profiler import ProfilerActivity, profile, record_function

    calls: Dict[str, List[dict]] = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with recording(mods, calls):
            with record_function(REQUEST_SPAN):
                result = run_request()
                sync()
    device, host, window = [], [], None
    for name, on_device, annotation, start, end in _events(prof):
        span = (start, end, name)
        if on_device:
            # the device-side copies of the benchmark's annotations are no
            # operations
            if end > start and not (annotation
                                    or name.startswith("bench_port.")):
                device.append(span)
        elif name == REQUEST_SPAN:
            window = span
        else:
            host.append(span)
    if window is None:
        raise RuntimeError("the profiler recorded no request span")
    lo, hi = window[0], window[1]
    device.sort()
    busy, gaps = _union(device, lo, hi)
    inside = [x for x in device if x[1] > lo and x[0] < hi]
    is_copy = [x[2].startswith(("Memcpy", "Memset")) for x in inside]
    return result, Trace(
        counts=mods, kernels=[x for x, c in zip(inside, is_copy) if not c],
        transfers=[x for x, c in zip(inside, is_copy) if c],
        window_s=(hi - lo) / 1e6, busy_s=busy / 1e6, steps=steps,
        calls=calls, model_flops=model_flops,
        gaps=_label_gaps(gaps, host))


def top_device_ops(trace: Trace, n: int = 10) -> List[List]:
    by: Dict[str, float] = {}
    for s, e, name in trace.kernels + trace.transfers:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def roofline_share(trace: Trace, kernel: str, peaks) -> Optional[float]:
    """The least time of the recorded calls of ``kernel`` (the larger of
    operations over the peak rate and bytes over the memory bandwidth,
    per call) over the device time of its kernels, in %; None when the
    request ran none."""
    mod = trace.counts.get(kernel)
    if mod is None:
        return None
    device_s = trace.device_seconds(
        lambda n: any(k in n for k in mod.KERNEL_NAMES))
    recs = trace.calls.get(kernel) or []
    if not recs or device_s <= 0:
        return None
    least = 0.0
    for rec in recs:
        flops, nbytes = mod.cost(rec)
        least += max(flops / peaks.flops_per_s(rec["dtype"]),
                     nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * least / device_s
