"""A proposer's held experts (``conzic_torch/models/sdar.py``, SDAR's
expert layers): each call of ``held_rows``, which the program makes once
a forward while the spans are live, with the forward's routing, the
experts each token's top k chose in each layer. The harness's reading of
the program's counter ``towers.lm_expert_rows``: the rows routed to the
held experts are counted from a copy of that routing once the traced
request has ended. No kernel of its own: its products run in the
library's kernels. Operations: those rows through SwiGLU's three
products. Bytes: every layer's held experts' weights as the forward takes
them, and its tokens read and its result written.

A program without that entry (one that has no SDAR) gives no target, so
a traced run of any cell records nothing here and raises nothing."""

from __future__ import annotations

import importlib.util

_MODULE = "conzic_torch.models.sdar"


def _targets():
    try:
        found = importlib.util.find_spec(_MODULE) is not None
    except ModuleNotFoundError:  # no conzic_torch.models at all
        found = False
    return (f"{_MODULE}:held_rows",) if found else ()


TARGETS = _targets()
KERNEL_NAMES = ()
_ARGS = ("model", "routes")


def record(args, kwargs) -> dict:
    a = {**dict(zip(_ARGS, args)), **kwargs}
    model, routes = a["model"], a["routes"]
    c = model.config
    elem = model.dtype.itemsize
    # the routing lies in the buffers that the program's next forward
    # writes: a copy, on the device, in the stream's order
    return {"routes": routes.clone(), "layers": routes.shape[0],
            "tokens": routes.shape[1], "held": c.experts_held,
            "offset": c.expert_offset, "hidden": c.hidden_size,
            "width": c.moe_intermediate_size, "w_elem": elem,
            "x_elem": elem, "dtype": str(model.dtype).replace("torch.", "")}


def rows(rec: dict) -> int:
    """The token-expert rows routed to the held experts, over the
    forward's layers (reads the device)."""
    local = rec["routes"] - rec["offset"]
    return int(((local >= 0) & (local < rec["held"])).sum())


def cost(rec: dict):
    E, width = rec["hidden"], rec["width"]
    flops = rows(rec) * 3 * 2 * E * width
    nbytes = rec["layers"] * (
        3 * rec["held"] * E * width * rec["w_elem"]
        + 2 * rec["tokens"] * E * rec["x_elem"])
    return flops, nbytes
