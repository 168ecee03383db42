"""Layer: kernels. ``dot_product_attention``'s share of its roofline in
the traced request, in %: the least time of its calls
(``counts/dot_product_attention.py``, bound by bytes) over the device time
of its kernels. None where the request ran no such kernel."""

from bench_port import peaks
from bench_port.trace import roofline_share


def read(trace):
    return roofline_share(trace, "dot_product_attention", peaks)
