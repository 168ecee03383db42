"""The model operations of one request, counted from the configuration and
the traffic alone, whatever implements them: the figure ``mfu`` divides.

Per Gibbs step: BERT over the B sentences (every layer at every position,
then the MLM head at the one masked slot), and CLIP's text tower over the
B * k candidate rows' suffix positions (the clip_len context less the
prompt prefix, padding included: the context is fixed), each attending
the prefix and its causal reach, then the pooled row's final projection.
Per sample: the prompt prefix through the text tower once per image. Per
request: the vision tower over the B images. A matrix product of m x n
by n x p counts 2 m n p.
"""

from __future__ import annotations

from bench_port import inputs
from bench_port.reference.text import ClipBpe


def _layer(E: int, F: int) -> int:
    """Projections and MLP of one token through one block."""
    return 2 * (4 * E * E + 2 * E * F)


def request_flops(config: dict, traffic: dict) -> float:
    lm, match = config["lm"], config["match"]
    t, v = match["text_config"], match["vision_config"]
    B, k = traffic["images_per_request"], traffic["candidate_k"]
    L = traffic["sentence_len"]
    clip_len = config["run"]["clip_len"]
    steps = traffic["iterations"] * L

    E, F, V = lm["hidden_size"], lm["intermediate_size"], lm["vocab_size"]
    S = len(traffic["prompt"].split()) + L + 2  # [CLS] prompt slots [SEP]
    bert = lm["num_hidden_layers"] * B * S * (_layer(E, F) + 4 * S * E)
    bert += B * (2 * E * E + 2 * E * V)

    Et, Ft = t["hidden_size"], t["intermediate_size"]
    bpe = ClipBpe(*inputs.clip_bpe(t["vocab_size"]))
    P = 1 + sum(len(bpe.word(w)) for w in traffic["prompt"].split())
    Ss = clip_len - P
    keys = P + (Ss + 1) / 2  # mean keys a suffix position attends
    text = t["num_hidden_layers"] * B * k * Ss * (_layer(Et, Ft)
                                                  + 4 * keys * Et)
    text += B * k * 2 * Et * match["projection_dim"]
    prefix = t["num_hidden_layers"] * B * P * (_layer(Et, Ft)
                                               + 4 * (P + 1) / 2 * Et)

    Ev, Fv = v["hidden_size"], v["intermediate_size"]
    p = v["patch_size"]
    T = (v["image_size"] // p) ** 2 + 1
    vision = v["num_hidden_layers"] * B * T * (_layer(Ev, Fv) + 4 * T * Ev)
    vision += B * (T - 1) * 2 * v["num_channels"] * p * p * Ev
    vision += B * 2 * Ev * match["projection_dim"]

    samples = traffic["samples"]
    return float(samples * (steps * (bert + text) + prefix) + vision)
