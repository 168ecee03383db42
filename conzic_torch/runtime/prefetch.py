"""Host-side pipeline prefetch.

Counterpart of ``conzic_tpu/runtime/prefetch.py``, with its semantics. The
batched runner's host work (image decode, bicubic resize, normalisation)
for batch i+1 runs on a worker thread while batch i's generation runs on
the card; the main thread holds no GIL while it waits on the device, so the
overlap works on a host with one core too. The reference's own runner loads
images inline on the main thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def prefetch_map(fn: Callable[[T], U], iterable: Iterable[T],
                 depth: int = 1, workers: int = 1) -> Iterator[U]:
    """``map(fn, iterable)`` computed ``depth`` items ahead on worker
    thread(s). Order-preserving; exceptions from ``fn`` (or the iterable)
    re-raise at the consuming site. ``workers > 1`` maps that many items at
    once on a thread pool (PIL's decode and resize release the GIL), for
    hosts whose one decode thread cannot keep the card fed."""
    if workers > 1:
        return _pool_map(fn, iterable, depth, workers)
    return _thread_map(fn, iterable, depth)


def _thread_map(fn, iterable, depth):
    """The single-worker one-ahead form."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def put(entry) -> bool:
        # bounded put that gives up when the consumer abandoned the
        # generator; otherwise the worker blocks on the full queue forever,
        # leaking the thread and a decoded batch
        while not stop.is_set():
            try:
                q.put(entry, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not put((True, fn(item))):
                    return
        except BaseException as e:  # propagate to the consumer
            put((False, e))
            return
        put((True, _SENTINEL))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            ok, item = q.get()
            if not ok:
                raise item
            if item is _SENTINEL:
                return
            yield item
    finally:
        # runs on exhaustion, consumer exception, or generator.close()
        stop.set()


def _pool_map(fn, iterable, depth, workers):
    """Ordered thread-pool map with bounded in-flight work
    (``workers + depth`` items); exceptions re-raise in order at the
    consuming site, and abandoning the generator cancels the pending work
    and shuts the pool down without leaking threads."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    def gen():
        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending = collections.deque()
            it = iter(iterable)
            exhausted = False
            try:
                while True:
                    while not exhausted and len(pending) < workers + depth:
                        try:
                            item = next(it)
                        except StopIteration:
                            exhausted = True
                            break
                        pending.append(ex.submit(fn, item))
                    if not pending:
                        return
                    yield pending.popleft().result()
            finally:
                for f in pending:  # abandoned consumer: stop new work
                    f.cancel()

    return gen()
