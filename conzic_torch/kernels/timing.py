"""Device time of one call, for the scripts that measure the kernels
(``chip_smoke.py``, ``python3 -m conzic_torch.kernels.ablate``). The port
calls nothing of this."""

from __future__ import annotations

from typing import Callable

import torch


def time_ms(fn: Callable[[], object], reps: int) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls are captured
    in one CUDA graph and the graph's replay is timed with CUDA events, so
    the host's launch overhead is left out of the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)
