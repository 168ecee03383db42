"""Layer: device. The whole request's model operations
(``bench_port/flops.py``, counted whatever implements them) over the
traced window times the card's published bf16 peak, in %."""

from bench_port import peaks


def read(trace):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * trace.model_flops / (trace.window_s
                                        * peaks.BF16_FLOPS_PER_S)
