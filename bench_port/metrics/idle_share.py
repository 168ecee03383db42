"""Layer: device. The share of the traced request's window in which no
operation ran on the card, in %: 1 - (union of the device spans / the
window), the arithmetic of ``chip_smoke.py``'s ``phase_profile``."""


def read(trace):
    if trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
