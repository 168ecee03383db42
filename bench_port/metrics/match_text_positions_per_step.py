"""Layer: towers. The positions the matcher's text tower encodes per Gibbs
step of the traced request: the rows of each call of the program's
full-row entry times their positions (``counts/match_text.py``), over the
steps. A bidirectional matcher runs every candidate row whole, so this is
B * k * the row's length; None where the program ran no such call (a
causal matcher, or a program without the entry)."""


def read(trace):
    recs = trace.calls.get("match_text") or []
    if not recs or not trace.steps:
        return None
    return sum(r["rows"] * r["positions"] for r in recs) / trace.steps
