"""``fused_dot_product_attention`` (``conzic_torch/kernels/
dot_product_attention.py``): the library route's attention in one kernel,
as ``conzic_torch/ops/attention.py`` ``xla_attention`` calls it where a
row's keys fit on chip; the calls that stay on the library formula never
reach this entry. q and the output (N, Sq, H, D), k and v (N, Sk, H, D),
key lengths (N,) int32 or none. Bytes: q, k, v read and the output written
once, and the key lengths. Operations: the two products, 2 Sq Sk D each a
row and head; the kernel is bound by its bytes.

A program without that kernel gives no target, so a traced run of any
cell records nothing here and raises nothing."""

from __future__ import annotations

import importlib.util

_KERNEL = "conzic_torch.kernels.dot_product_attention"


def _targets():
    try:
        found = importlib.util.find_spec(_KERNEL) is not None
    except ModuleNotFoundError:  # no conzic_torch.kernels at all
        found = False
    return (("conzic_torch.ops.attention:fused_dot_product_attention",)
            if found else ())


TARGETS = _targets()
KERNEL_NAMES = ("dot_product_attention_kernel",)


def record(args, kwargs) -> dict:
    q, k = args[0], args[1]
    lens = args[3] if len(args) > 3 else kwargs.get("lens")
    N, Sq, H, D = q.shape
    return {"N": N, "Sq": Sq, "Sk": k.shape[1], "H": H, "D": D,
            "elem": q.element_size(), "lens": lens is not None,
            "dtype": str(q.dtype).replace("torch.", "")}


def cost(rec: dict):
    N, Sq, Sk, H, D = (rec[x] for x in ("N", "Sq", "Sk", "H", "D"))
    flops = 4 * N * H * Sq * Sk * D
    nbytes = 2 * N * (Sq + Sk) * H * D * rec["elem"]
    return flops, nbytes + (4 * N if rec["lens"] else 0)
