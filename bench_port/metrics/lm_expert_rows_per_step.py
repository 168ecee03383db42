"""Layer: towers. The token-expert rows that the proposer's held experts
give their layers' results per Gibbs step of the traced request: the
routing of each of the proposer's forwards (``counts/lm_experts.py``),
the token-expert pairs it sends to the held experts, summed over the
forwards and divided by the steps. Uniform routing gives tokens x top k
x held / experts a layer; None where the program made no such call (a proposer
without experts, or a program without the entry)."""


def read(trace):
    mod = trace.counts.get("lm_experts")
    recs = trace.calls.get("lm_experts") or []
    if mod is None or not recs or not trace.steps:
        return None
    return sum(mod.rows(r) for r in recs) / trace.steps
