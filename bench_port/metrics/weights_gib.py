"""Layer: towers. The bytes of the towers' parameters and buffers as the
program holds them on the card, each storage once, in GiB: the part of
``peak_mem_gib`` that stays resident from set-up on."""


def read(trace):
    if not trace.weights_bytes:
        return None
    return trace.weights_bytes / 2 ** 30
