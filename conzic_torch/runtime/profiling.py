"""Tracing: spans and counters inside the program, and the trace exporter.

Counterpart of ``conzic_tpu/runtime/profiling.py``:

  - ``request_span`` and ``span``: ``torch.profiler.record_function``
    ranges named ``conzic.<name>``, which the profiler records on the
    clock of the card's kernels, so that host stages show on the trace's
    timeline beside them. They are live only while a profiler records: a
    request span (the image tower, a generation) looks once whether one
    does, and for its duration turns on every inner span and counter,
    which read one module flag. With no profiler the sites cost that flag
    read; a ``record_function`` with none would cost some 11 us a call.
  - ``count`` and ``take_counts``: in-memory counters that count only
    while the spans are live (on the host, or on the device for a count
    that lies there), read and reset by the caller.
  - ``trace``: ``torch.profiler`` over a block, CPU (every thread) and,
    when there is a card, CUDA activity, written as a Chrome trace into
    ``trace_dir`` or ``$CONZIC_TRACE_DIR``; a no-op when neither is set.

The spans of a generation, each under the one before it in time:
``engine.generate`` > ``engine.prefix_kv``, ``engine.iteration`` >
``engine.step`` > ``towers.lm``, ``engine.candidates``,
``towers.text_chunk`` (``towers.match_text`` under a bidirectional
matcher, SigLIP's: one a chunk of whole rows), ``engine.commit``; then
``engine.fetch`` and ``engine.decode``. The span and parallel orders run ``towers.lm`` once a
span or sweep, beside the steps. ``entry.encode_images`` runs the image
tower, ``entry.preprocess`` a batch's preprocessing on the command line's
worker thread; inside the image tower, SigLIP's runs as
``towers.match_image``; inside a proposer with experts (SDAR's),
``towers.lm.experts`` runs a layer's router and held experts, one a
layer a forward where the layers run eagerly (on the card they replay
as one CUDA graph, which records no spans of its own). The counters:
``towers.weight_casts``, the parameters cast to the compute type on a
call (``models/layers.py``
``cast_param``); ``towers.match_text_positions``, the positions a
bidirectional matcher's text tower encodes, rows times their width a
chunk (``models/siglip.py`` ``encode_full_rows``);
``towers.attention_kernel_calls`` and ``towers.attention_library_calls``,
the einsum attentions of the ``"xla"`` routes that ran the hand-written
kernel or the library formula (``ops/attention.py`` ``xla_attention``);
``towers.layer_norm_calls.vecs<V>.rows_per_warp<R>``, the LayerNorm kernel's
calls by the plan they took: the instance (V 16-byte vectors a lane) and
the rows its busiest warp walked (``kernels/layer_norm.py``);
``towers.lm_expert_rows``, the token-expert rows that a proposer's held
experts give the layer's result, summed over its layers (the tokens a
token's top k routes to this device's experts, ``models/sdar.py``
``held_rows``: a device scalar a forward, summed on the device and read
by ``take_counts``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, Optional

import torch

PREFIX = "conzic."
WEIGHT_CASTS = "towers.weight_casts"
MATCH_TEXT_POSITIONS = "towers.match_text_positions"
ATTENTION_KERNEL_CALLS = "towers.attention_kernel_calls"
ATTENTION_LIBRARY_CALLS = "towers.attention_library_calls"
LAYER_NORM_CALLS = "towers.layer_norm_calls"
LM_EXPERT_ROWS = "towers.lm_expert_rows"

_lock = threading.Lock()
_live = 0  # request spans and traces open while a profiler records
_on = False  # _live > 0: the inner spans and the counters are live
_counts: Dict[str, int] = {}
_OFF = contextlib.nullcontext()


def _hold(delta: int) -> None:
    global _live, _on
    with _lock:
        _live += delta
        _on = _live > 0


@contextlib.contextmanager
def request_span(name: str) -> Iterator[None]:
    """The span of a request's stage (``entry.encode_images``,
    ``engine.generate``): recorded, and the inner spans and counters live
    inside it, when a profiler records on this thread or ``trace`` made
    the spans live (a profiler of every thread reads as none here)."""
    if not (_on or torch.autograd._profiler_enabled()):
        yield
        return
    _hold(1)
    try:
        with torch.profiler.record_function(PREFIX + name):
            yield
    finally:
        _hold(-1)


def span(name: str):
    """An inner span: recorded when a request span or ``trace`` made the
    spans live, else a shared no-op context."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def live() -> bool:
    """Whether the spans and counters are live: for a site whose count
    costs work of its own."""
    return _on


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name`` while the spans are live: a whole
    number, or a device scalar, added on the device and read once by
    :func:`take_counts`. Under a lock: a mesh runs its blocks on threads of
    one process."""
    if _on:
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


def take_counts() -> Dict[str, int]:
    """The counters since the last call, which resets them; a counter
    kept on the device is read here."""
    with _lock:
        out = dict(_counts)
        _counts.clear()
    return {name: int(n) for name, n in out.items()}


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """Profile the block when a directory is configured, with the spans
    live throughout; the trace is ``<trace_dir>/trace_<pid>_<time>.json``,
    and the block's counters are in its metadata as ``conzic.<name>``."""
    trace_dir = trace_dir or os.environ.get("CONZIC_TRACE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    # every thread: the command line preprocesses on a worker thread
    all_threads = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=activities,
                 experimental_config=all_threads) as prof:
        _hold(1)
        try:
            yield
        finally:
            _hold(-1)
            for name, n in take_counts().items():
                prof.add_metadata_json(PREFIX + name, str(n))
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
