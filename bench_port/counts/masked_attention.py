"""``masked_attention`` (``conzic_torch/kernels/masked_attention.py``):
q (N, Sq, H, D), k and v (N, Ss, H, D), an optional per-image prefix
(pk, pv), each (B, P, H, D) with N = B * G, key lengths ``lens`` (N,) over
the Sk = P + Ss keys, and a causal rule that keeps key col for query row
when col <= row + (Sk - Sq).

Operations: 4 * D for every (query, key) pair a head keeps (the logits'
and the weighted sum's products and sums). Bytes: q and k and v read, the
prefix read once per image, the output written, and the lengths read.
The same counts as ``chip_smoke.py``'s ``attn_case``."""

from __future__ import annotations

import torch

TARGETS = ("conzic_torch.models.layers:masked_attention",)
KERNEL_NAMES = ("masked_attention_",)


def record(args, kwargs) -> dict:
    names = ("q", "k", "v", "lens", "causal", "prefix_kv")
    a = dict(zip(names, args), **kwargs)
    q, k = a["q"], a["k"]
    prefix = a.get("prefix_kv")
    return {"N": q.shape[0], "Sq": q.shape[1], "H": q.shape[2],
            "D": q.shape[3], "Ss": k.shape[1],
            "B": prefix[0].shape[0] if prefix is not None else 0,
            "P": prefix[0].shape[1] if prefix is not None else 0,
            "lens": a.get("lens"), "causal": bool(a.get("causal", False)),
            "elem": q.element_size(),
            "dtype": str(q.dtype).replace("torch.", "")}


def kept_pairs(N: int, Sq: int, Sk: int, lens, causal: bool) -> int:
    """(query, key) pairs a head keeps, summed over the rows."""
    row = torch.arange(Sq)
    reach = (row + 1 + Sk - Sq) if causal else torch.full((Sq,), Sk)
    reach = reach.clamp(0, Sk)
    if lens is None:
        return int(reach.sum()) * N
    lens = lens.detach().to("cpu", torch.int64).clamp(0, Sk)
    return int(torch.minimum(reach[None, :], lens[:, None]).sum())


def cost(rec: dict):
    Sk = rec["P"] + rec["Ss"]
    kept = kept_pairs(rec["N"], rec["Sq"], Sk, rec["lens"], rec["causal"])
    flops = 4 * kept * rec["H"] * rec["D"]
    n_bytes = ((2 * rec["N"] * rec["Sq"] + 2 * rec["N"] * rec["Ss"]
                + 2 * rec["B"] * rec["P"]) * rec["H"] * rec["D"] * rec["elem"]
               + (4 * rec["N"] if rec["lens"] is not None else 0))
    return flops, n_bytes
