"""Layer: towers. Device milliseconds per Gibbs step in every kernel that
is not a matrix product, one of the port's attention or LayerNorm
kernels, or a sort or gather: the unfused elementwise work, reductions,
softmax and concatenations. A kernel no class names falls here."""

from bench_port.metrics.matmul_ms_per_step import PORT, is_matmul

SORT_GATHER = ("sort", "Sort", "radix", "gather", "Gather", "index",
               "Index", "scatter", "Scatter")


def is_elementwise(name: str) -> bool:
    return not (is_matmul(name) or any(k in name for k in PORT)
                or any(k in name for k in SORT_GATHER))


def read(trace):
    if not trace.kernels or not trace.steps:
        return None
    return 1e3 * trace.device_seconds(is_elementwise) / trace.steps
