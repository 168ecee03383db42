"""Layer: engine. Device kernels launched per Gibbs step of the traced
request (copies and fills not counted), the image tower's included."""


def read(trace):
    if not trace.kernels or not trace.steps:
        return None
    return len(trace.kernels) / trace.steps
