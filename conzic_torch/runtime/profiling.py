"""Tracing and stage timing.

Counterpart of ``conzic_tpu/runtime/profiling.py``:

  - ``StageTimers``: named wall-clock stages accumulated into a report;
  - ``trace``: ``torch.profiler`` over a block, CPU and (when there is a
    card) CUDA activity, written as a Chrome trace into ``trace_dir`` or
    ``$CONZIC_TRACE_DIR``; a no-op when neither is set;
  - ``annotate``: ``torch.profiler.record_function``, so that host stages
    show on the trace's timeline beside the device's kernels.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch


class StageTimers:
    """Accumulating named wall-clock timers."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["stage timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(f"  {name}: {self.totals[name]:.3f}s over "
                         f"{self.counts[name]} call(s)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the block when a directory is configured; the trace is
    ``<trace_dir>/trace_<pid>_<time>.json``."""
    trace_dir = trace_dir or os.environ.get("CONZIC_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with torch.profiler.record_function(name):
        yield
