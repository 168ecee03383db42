"""SigLIP's two towers, its scores and its text rules, plainly: float32
PyTorch over a Hugging Face state dict, with TF32 off.

Written from ``transformers/models/siglip/modeling_siglip.py`` (Zhai et
al., arXiv 2303.15343) and ``tokenization_siglip.py``: pre-LayerNorm
blocks with tanh GELU (``hidden_act``); a text tower that attends every
position of its row, padding included, with no mask, and pools the last
position after the final LayerNorm, through ``text_model.head``; a vision
tower of stride-``patch_size`` patches (the convolution's bias included),
no class token and no pre-LayerNorm, a post-LayerNorm, then
``SiglipMultiheadAttentionPoolingHead``: a probe attends over the patches
through ``nn.MultiheadAttention``'s packed ``in_proj_weight`` and
``in_proj_bias`` and its ``out_proj``, then ``h + mlp(layernorm(h))``;
scores ``exp(logit_scale) * cos + logit_bias``.

Departures, none of which changes the arithmetic's result beyond
rounding: the probe's attention is written as its three products (the
packed weight cut into its q, k and v rows), as ``nn.MultiheadAttention``
computes it; positions are always ``0 .. S - 1`` (Hugging Face's
default); the rows are whole, so no attention mask is taken (Hugging
Face's, passed none, applies none). ``lowp`` makes it a control: every
matrix product's operands in ``lowp`` (``reference.models.round_rows``),
the convolution as the product of the unfolded patches.

The text rules are the tokenizer's: canonicalise (lower case, ASCII
punctuation removed, single spaces), "▁" before each word, each word cut
into the pieces by Viterbi over their scores, an end token, then padding
to the row's length; no start token. This file imports nothing of the
program under test.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench_port.reference.models import fp32_only, round_rows

WORD_START = "\u2581"  # "▁", the mark of a word's start
# Python's string.punctuation: the ASCII punctuation marks
_PUNCTUATION = str.maketrans("", "", "!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``gelu_pytorch_tanh``, written out."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


ACTIVATIONS = {"gelu_pytorch_tanh": gelu_tanh, "gelu": F.gelu}


class Unigram:
    """SigLIP's SentencePiece Unigram over ``pieces`` [(piece, score)]:
    ``row`` the ids of a text as the tower takes them."""

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int,
                 eos: str = "</s>", pad: str = "</s>"):
        self.ids = {p: i for i, (p, _) in enumerate(pieces)}
        self.score = {p: float(s) for p, s in pieces}
        self.unk_id = unk_id
        self.eos, self.pad = self.ids[eos], self.ids[pad]
        self.longest = max(len(p) for p, _ in pieces)
        self.unk_score = min(self.score.values()) - 10.0
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def canonical(text: str) -> List[str]:
        text = text.lower().translate(_PUNCTUATION)
        return re.sub(r"\s+", " ", text).strip().split()

    def word(self, word: str) -> List[int]:
        """"▁" + ``word`` cut where the pieces' scores sum highest."""
        if word in self._cache:
            return self._cache[word]
        text = WORD_START + word
        n = len(text)
        best = [(0.0, 0, -1)] + [(-math.inf, 0, -1)] * n
        for end in range(1, n + 1):
            for start in range(max(0, end - self.longest), end):
                piece = text[start:end]
                if piece in self.score:
                    s, pid = self.score[piece], self.ids[piece]
                elif end - start == 1:
                    s, pid = self.unk_score, self.unk_id
                else:
                    continue
                if best[start][0] + s > best[end][0]:
                    best[end] = (best[start][0] + s, start, pid)
        out, end = [], n
        while end > 0:
            _, start, pid = best[end]
            if not (pid == self.unk_id and out and out[-1] == self.unk_id):
                out.append(pid)
            end = start
        self._cache[word] = out[::-1]
        return self._cache[word]

    def text(self, text: str) -> List[int]:
        return [i for w in self.canonical(text) for i in self.word(w)]

    def row(self, words: Sequence[str], length: int) -> Tuple[List[int], int]:
        """Each of ``words`` tokenised as a text of its own, the end
        token, padding to ``length``; pieces past the row are dropped.
        Returns (ids, the pieces and the end token's number)."""
        pieces = [i for w in words for i in self.text(w)][:length - 1]
        row = pieces + [self.eos]
        return row + [self.pad] * (length - len(row)), len(row)


class Siglip:
    """The plain forward passes of ``SiglipModel``. ``w``: the fp32 state
    dict; ``match``: the configuration's Hugging Face dict."""

    def __init__(self, w: Dict[str, torch.Tensor], match: dict,
                 lowp: Optional[str] = None):
        self.w, self.match, self.lowp = w, match, lowp

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A matrix product's operand in the control's precision."""
        return round_rows(x, self.lowp)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = self.q(x) @ self.q(self.w[name + ".weight"]).T
        return y + self.w[name + ".bias"]

    def ln(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[name + ".weight"],
                            self.w[name + ".bias"], eps)

    def attend(self, q, k, v, heads: int) -> torch.Tensor:
        """(N, Sq, E) queries over (N, Sk, E) keys and values, every key
        attended -> (N, Sq, E)."""
        N, Sq, E = q.shape
        D = E // heads
        q, k, v = (t.reshape(N, -1, heads, D).transpose(1, 2)
                   for t in (q, k, v))
        logits = (self.q(q) @ self.q(k).transpose(-1, -2)) / math.sqrt(D)
        probs = torch.softmax(logits, dim=-1)
        # v's rows run along the keys, the product's inner axis
        v = self.q(v.transpose(-1, -2)).transpose(-1, -2)
        return (self.q(probs) @ v).transpose(1, 2).reshape(N, Sq, E)

    def _stack(self, x: torch.Tensor, prefix: str, cfg: dict):
        eps, act = cfg["layer_norm_eps"], ACTIVATIONS[cfg["hidden_act"]]
        heads = cfg["num_attention_heads"]
        for i in range(cfg["num_hidden_layers"]):
            p = f"{prefix}.encoder.layers.{i}."
            h = self.ln(x, p + "layer_norm1", eps)
            a = self.attend(self.linear(h, p + "self_attn.q_proj"),
                            self.linear(h, p + "self_attn.k_proj"),
                            self.linear(h, p + "self_attn.v_proj"), heads)
            x = x + self.linear(a, p + "self_attn.out_proj")
            h = act(self.linear(self.ln(x, p + "layer_norm2", eps),
                                p + "mlp.fc1"))
            x = x + self.linear(h, p + "mlp.fc2")
        return x

    def text_embeds(self, ids: torch.Tensor) -> torch.Tensor:
        """(N, L) ids -> (N, projection_size): every position attended,
        the last one pooled."""
        cfg = self.match["text_config"]
        with fp32_only():
            L = ids.shape[1]
            x = (self.w["text_model.embeddings.token_embedding.weight"][ids]
                 + self.w["text_model.embeddings.position_embedding.weight"]
                 [:L])
            x = self._stack(x, "text_model", cfg)
            x = self.ln(x, "text_model.final_layer_norm",
                        cfg["layer_norm_eps"])
            return self.linear(x[:, -1], "text_model.head")

    def image_embeds(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) preprocessed pixels -> (B, hidden): the pooling
        head's output."""
        cfg = self.match["vision_config"]
        eps, P = cfg["layer_norm_eps"], cfg["patch_size"]
        E, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        pre = "vision_model.embeddings.patch_embedding."
        with fp32_only():
            kernel = self.w[pre + "weight"]
            x = pixels.to(kernel.dtype).permute(0, 3, 1, 2)
            if self.lowp:
                cols = F.unfold(x, P, stride=P).transpose(1, 2)
                x = (self.q(cols) @ self.q(kernel.reshape(E, -1)).T
                     + self.w[pre + "bias"])
            else:
                x = F.conv2d(x, kernel, self.w[pre + "bias"], stride=P)
                x = x.flatten(2).transpose(1, 2)  # (B, patches, E)
            x = x + self.w["vision_model.embeddings.position_embedding.weight"]
            x = self._stack(x, "vision_model", cfg)
            x = self.ln(x, "vision_model.post_layernorm", eps)
            return self._probe_head(x, "vision_model.head.", heads, eps,
                                    ACTIVATIONS[cfg["hidden_act"]])

    def _probe_head(self, x, p: str, heads: int, eps: float, act):
        B, T, E = x.shape
        w = self.w[p + "attention.in_proj_weight"]
        b = self.w[p + "attention.in_proj_bias"]

        def project(t, rows):  # the packed weight's q, k or v rows
            return self.q(t) @ self.q(w[rows]).T + b[rows]

        probe = self.w[p + "probe"].expand(B, 1, E)
        h = self.attend(project(probe, slice(0, E)),
                        project(x, slice(E, 2 * E)),
                        project(x, slice(2 * E, 3 * E)), heads)
        h = self.linear(h, p + "attention.out_proj")
        m = act(self.linear(self.ln(h, p + "layernorm", eps), p + "mlp.fc1"))
        h = h + self.linear(m, p + "mlp.fc2")
        return h[:, 0]

    def logits(self, cos: torch.Tensor) -> torch.Tensor:
        """SigLIP's scores of cosines."""
        scale = torch.exp(self.w["logit_scale"].double()).reshape(())
        bias = self.w["logit_bias"].double().reshape(())
        return cos * scale.to(cos.dtype) + bias.to(cos.dtype)
