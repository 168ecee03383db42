"""Layer: kernels. ``masked_attention``'s share of its roofline in the
traced request, in %: the least time of its calls (``counts/
masked_attention.py``) over the device time of its kernels. Nothing to
read where no attention goes through the kernel (the library route)."""

from bench_port import peaks
from bench_port.trace import roofline_share


def read(trace):
    return roofline_share(trace, "masked_attention", peaks)
