"""The matcher's text tower over whole rows
(``conzic_torch/models/siglip.py`` ``encode_full_rows``, the engine's
entry into a bidirectional tower, SigLIP's): the rows and positions of
each call, the harness's reading of the program's counter
``towers.match_text_positions``. No kernel of its own: its products run
in the library's kernels. Operations: each position through every layer
(projections, MLP, attention over all the row's positions), then the
head. Bytes: the ids read and the embeddings written.

A program without that entry (one that has no SigLIP) gives no target,
so a traced run of any cell records nothing here and raises nothing."""

from __future__ import annotations

import importlib.util

from bench_port.flops import layer

_MODULE = "conzic_torch.models.siglip"


def _targets():
    try:
        found = importlib.util.find_spec(_MODULE) is not None
    except ModuleNotFoundError:  # no conzic_torch.models at all
        found = False
    return (f"{_MODULE}:encode_full_rows",) if found else ()


TARGETS = _targets()
KERNEL_NAMES = ()


def record(args, kwargs) -> dict:
    model, ids = args[0], args[1]
    t = model.config.text
    return {"rows": ids.shape[0], "positions": ids.shape[1],
            "layers": t.num_layers, "hidden": t.hidden_size,
            "intermediate": t.intermediate_size,
            "projection": t.projection_size, "ids_elem": ids.element_size(),
            "out_elem": model.dtype.itemsize,
            "dtype": str(model.dtype).replace("torch.", "")}


def cost(rec: dict):
    N, S, E = rec["rows"], rec["positions"], rec["hidden"]
    flops = rec["layers"] * N * S * (layer(E, rec["intermediate"])
                                     + 4 * S * E)
    flops += N * 2 * E * rec["projection"]
    nbytes = N * (S * rec["ids_elem"] + rec["projection"] * rec["out_elem"])
    return flops, nbytes
