"""Per-layer metrics, one module a metric, found by the metric's name in
``BENCHMARK.json``. Each has ``read(trace)``, which takes the
:class:`bench_port.trace.Trace` of the traced request and returns the
value, or None when the request gave it nothing to read (the run then
leaves the metric out)."""
