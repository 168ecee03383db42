"""SDAR's mixture-of-experts block-diffusion LM and its text rules, plainly:
float32 PyTorch over a Hugging Face state dict, with TF32 off.

Written from ``transformers/models/qwen3_moe/modeling_qwen3_moe.py``, whose
layers SDAR's are (SDAR was trained on from Qwen3-MoE checkpoints), and
SDAR's block rule: RMSNorm in float32; attention with per-head q/k
RMSNorm, rotate-half RoPE at ``rope_theta`` on positions 0 .. S - 1,
``num_attention_heads / num_key_value_heads`` query heads to a key/value
head, scale ``head_dim ** -0.5``, no biases, and key j visible to query
i iff ``j // block_length <= i // block_length``; a router's softmax
over all ``num_experts``, its top ``num_experts_per_tok`` renormalised
(``norm_topk_prob``), each routed expert's ``down(silu(gate x) * up x)``
weighted; the final RMSNorm and the untied head.

This device's share of an expert-parallel deployment: ``experts_held``
experts from ``expert_offset`` on. Every held expert runs on every token,
its weight 0 where the token did not route to it: the same sum as a
dispatch, with no dispatch to get wrong. The experts that are not held
add nothing. ``lowp`` makes it a control: every matrix product's
operands in ``lowp`` (``reference.models.round_rows``), float32 sums.

The text rules read the synthetic Qwen2 byte-level vocabulary: a row is
``<|endoftext|>``, the prompt's pieces, the masked slots, and
``<|endoftext|>``; a caption's text is its pieces' bytes. This file
imports nothing of the program under test.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from bench_port.reference.models import fp32_only, round_rows

SPACE = "Ġ"  # "Ġ", the byte-level mark of a leading space
END_OF_TEXT, MASK = "<|endoftext|>", "<|MASK|>"
_ALPHA = re.compile(r"^[a-zA-Z]+$")


def byte_chars() -> Dict[int, str]:
    """byte -> its character of GPT-2's byte alphabet, in id order:
    printable latin-1 bytes as themselves, then the others shifted past
    255."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    rest = [b for b in range(256) if b not in keep]
    return {**{b: chr(b) for b in keep},
            **{b: chr(256 + n) for n, b in enumerate(rest)}}


class QwenText:
    """The caption rules over a Qwen2 byte-level vocabulary: ``pieces``
    (id -> piece) with ``added`` (id -> special token) above them.

    ``tokens`` gives each id as the matchers' text rules read a proposer
    token (WordPiece's notation, ``reference/text.py``): a piece that
    starts a word ("Ġcat") its letters, one that continues a word ("cat")
    ``##`` and its letters, the mask ``[MASK]``, another special token
    ``[PAD]``; so each caption token is a word of its own to a matcher,
    as the program's bridge takes it."""

    def __init__(self, pieces: Dict[str, int], merges, added: Dict[int, str]):
        self.vocab = {**pieces, **{t: i for i, t in added.items()}}
        self.pieces = {i: t for t, i in self.vocab.items()}
        self.specials = set(added.values())
        self.mask, self.end = self.vocab[MASK], self.vocab[END_OF_TEXT]
        self.bytes = {c: b for b, c in byte_chars().items()}
        self.tokens = {i: self._notation(t) for i, t in self.pieces.items()}

    def _notation(self, piece: str) -> str:
        if piece in self.specials:
            return "[MASK]" if piece == MASK else "[PAD]"
        if piece.startswith(SPACE):
            return piece[1:]
        return "##" + piece if _ALPHA.match(piece) else piece

    def encode_words(self, text: str) -> List[int]:
        """Whitespace words, each one piece: the first as it is, the
        others after a space (the prompt's words are)."""
        ids = []
        for j, word in enumerate(text.split()):
            piece = word if j == 0 else SPACE + word
            if piece not in self.vocab:
                raise ValueError(f"{piece!r} is not one piece")
            ids.append(self.vocab[piece])
        return ids

    def init_row(self, prompt: str, sentence_len: int) -> List[int]:
        return ([self.end] + self.encode_words(prompt)
                + [self.mask] * sentence_len + [self.end])

    def allowed(self, token_id: int, last_slot: bool) -> bool:
        """A caption may use a piece of ASCII letters (after its leading
        space); the period only at the last slot."""
        piece = self.pieces[token_id]
        if piece == ".":
            return last_slot
        if piece in self.specials:
            return False
        return bool(_ALPHA.match(piece[1:] if piece.startswith(SPACE)
                                 else piece))

    def decode(self, ids: Sequence[int]) -> str:
        """The pieces' bytes, special tokens dropped, as UTF-8."""
        raw = bytearray()
        for i in ids:
            piece = self.pieces[int(i)]
            if piece not in self.specials:
                raw += bytes(self.bytes[c] for c in piece)
        return raw.decode("utf-8", errors="replace")


class Sdar:
    """The plain forward pass. ``w``: the fp32 state dict; ``cfg``: the
    configuration's ``lm`` dict (``sdar_moe``)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 lowp: Optional[str] = None):
        self.w, self.c, self.lowp = w, cfg, lowp
        first = cfg.get("expert_offset", 0)
        self.held = range(first,
                          first + cfg.get("experts_held", cfg["num_experts"]))
        self.block = cfg.get("block_length", 4)
        self.eps = cfg["rms_norm_eps"]

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return round_rows(x, self.lowp)

    def linear(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.q(x) @ self.q(self.w[name + ".weight"]).T

    def norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
                * self.w[name + ".weight"])

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, S, heads, D) rotated by position, the halves' form."""
        S, D = x.shape[1], x.shape[-1]
        inv = 1.0 / (self.c["rope_theta"]
                     ** (torch.arange(0, D, 2, device=x.device).float() / D))
        angle = torch.arange(S, device=x.device).float()[:, None] * inv
        angle = torch.cat([angle, angle], dim=-1)[:, None]  # (S, 1, D)
        half = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
        return x * angle.cos() + half * angle.sin()

    def attention(self, x: torch.Tensor, p: str) -> torch.Tensor:
        c = self.c
        N, S, _ = x.shape
        H, G = c["num_attention_heads"], c["num_key_value_heads"]
        D = c["head_dim"]
        a = p + "self_attn."
        q = self.rope(self.norm(self.linear(x, a + "q_proj").view(N, S, H, D),
                                a + "q_norm"))
        k = self.rope(self.norm(self.linear(x, a + "k_proj").view(N, S, G, D),
                                a + "k_norm"))
        v = self.linear(x, a + "v_proj").view(N, S, G, D)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        k, v = (t.repeat_interleave(H // G, dim=1) for t in (k, v))
        logits = (self.q(q) @ self.q(k).transpose(-1, -2)) / math.sqrt(D)
        blk = torch.arange(S, device=x.device) // self.block
        logits = logits.masked_fill(blk[None, :] > blk[:, None],
                                    float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        v = self.q(v.transpose(-1, -2)).transpose(-1, -2)
        ctx = (self.q(probs) @ v).transpose(1, 2).reshape(N, S, H * D)
        return self.linear(ctx, a + "o_proj")

    def experts(self, u: torch.Tensor, p: str) -> torch.Tensor:
        """(T, E) -> (T, E): the held experts' part of the layer."""
        c = self.c
        probs = torch.softmax(self.linear(u, p + "mlp.gate"), dim=-1)
        top_w, top_e = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
        if c.get("norm_topk_prob", True):
            top_w = top_w / top_w.sum(-1, keepdim=True)
        y = torch.zeros_like(u)
        for e in self.held:
            weight = (top_w * (top_e == e)).sum(-1, keepdim=True)
            name = f"{p}mlp.experts.{e}."
            h = (F.silu(self.linear(u, name + "gate_proj"))
                 * self.linear(u, name + "up_proj"))
            y = y + weight * self.linear(h, name + "down_proj")
        return y

    def hidden(self, ids: torch.Tensor) -> torch.Tensor:
        """(N, S) ids -> (N, S, E), the last layer's states before the
        final RMSNorm."""
        with fp32_only():
            x = self.w["model.embed_tokens.weight"][ids]
            N, S, E = x.shape
            for i in range(self.c["num_hidden_layers"]):
                p = f"model.layers.{i}."
                x = x + self.attention(self.norm(x, p + "input_layernorm"), p)
                u = self.norm(x, p + "post_attention_layernorm")
                x = x + self.experts(u.reshape(N * S, E), p).view(N, S, E)
            return x

    def logits(self, ids: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
        """(N, S) ids -> (N, V) vocabulary logits at columns ``cols``."""
        x = self.hidden(ids)
        with fp32_only():
            h = self.norm(x[torch.arange(ids.shape[0], device=ids.device),
                            cols], "model.norm")
            return self.q(h) @ self.q(self.w["lm_head.weight"]).T
