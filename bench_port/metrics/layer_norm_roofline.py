"""Layer: kernels. ``layer_norm``'s share of its roofline in the traced
request, in %: the least time of its calls (``counts/layer_norm.py``,
bound by bytes) over the device time of its kernels."""

from bench_port import peaks
from bench_port.trace import roofline_share


def read(trace):
    return roofline_share(trace, "layer_norm", peaks)
