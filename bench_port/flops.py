"""The model operations of one request, counted from the configuration and
the traffic alone, whatever implements them: the figure ``mfu`` divides.

Each tower family counts its own (``bench_port/families/<model_type>.py``
``flops``): what it runs per Gibbs step, once per sample and once per
request. A matrix product of m x n by n x p counts 2 m n p.
"""

from __future__ import annotations

from typing import Dict


def layer(E: int, F: int) -> int:
    """Projections and MLP of one token through one block."""
    return 2 * (4 * E * E + 2 * E * F)


def request_flops(config: dict, traffic: dict,
                  families: Dict[str, object]) -> float:
    """``families``: the proposer's and the matcher's modules
    (``bench_port.run.families``)."""
    parts = [f.flops(config, traffic) for f in families.values()]
    step, sample, request = (sum(p.get(k, 0) for p in parts)
                             for k in ("step", "sample", "request"))
    steps = traffic["iterations"] * traffic["sentence_len"]
    return float(traffic["samples"] * (steps * step + sample) + request)
