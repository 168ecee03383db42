"""SDAR's mixture-of-experts block-diffusion LM as the proposer.

SDAR (JetLM, ``JetLM/SDAR-30B-A3B-Chat``, ``model_type`` ``sdar_moe``)
predicts the masked tokens of a block from that block and the blocks
before it, which is the proposer's contract: mask one slot, read the
distribution there. Its layers are Qwen3-MoE's (Hugging Face's
``modeling_qwen3_moe.py``), with no biases anywhere:

- ``RMSNorm(x) = w * x / sqrt(mean(x^2) + eps)``, in fp32, cast back;
- ``h = x + o(Attn(RoPE(qn(q(n1 x))), RoPE(kn(k(n1 x))), v(n1 x)))``:
  ``qn`` and ``kn`` RMSNorms over each head, rotate-half RoPE at
  ``rope_theta`` on positions 0 .. S - 1, each key/value head shared by
  ``num_heads / num_kv_heads`` query heads, scale ``head_dim ** -0.5``,
  and key j visible to query i iff ``j // block_length <= i //
  block_length`` (the block rule);
- ``y = h + sum over e in top_k(p) of p_e / sum(top_k p) *
  down_e(silu(gate_e u) * up_e u)``, ``u = n2 h``, ``p = softmax(router
  u)`` in fp32 over all ``num_experts``;
- the vocabulary logits of ``head(norm(y))``, at the masked slot only.

This device holds ``experts_held`` experts of every layer from
``expert_offset`` on, its share of an expert-parallel deployment: the
router routes over all ``num_experts``, :func:`held_experts` computes what
the held ones give, and that partial result goes on to the next layer.
Every token goes through every held expert, one batched product for gate
and up and one for down, weighted 0 where it did not route there: at the
proposer's hundred-odd tokens a step each held expert's weights are read
once either way, with no dispatch and no host synchronisation. A layer's
matrices are five parameters: ``qkv``, ``o``, ``router``, and the held
experts' ``gate_up`` and ``down`` stacked.

A step's rows are short, so its 48 layers' thousands of library calls
would pace it by the host. On the card (with no gradients) ``hidden``
therefore runs as one CUDA graph a shape, captured at the shape's first
call (:class:`Captured`); the CPU runs the layers eagerly. A replay shows
no spans of its own layers: the span ``towers.lm.experts`` is recorded
where the layers run eagerly, and ``towers.lm_expert_rows`` is counted
from the routing a forward returns (:func:`held_rows`).

Attention is plain PyTorch products under the block rule's bias
(:func:`block_bias`), the one route (``attn_impl`` "xla") it takes; the
towers take no quant tier. :func:`hf_names` is the checkpoint names, those
of the held experts only.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from conzic_torch.models.configs import SdarMoeConfig
from conzic_torch.models.layers import cast_param
from conzic_torch.ops.attention import NEG_INF
from conzic_torch.runtime import profiling
from conzic_torch.runtime.profiling import span


class RMSNorm(nn.Module):
    """RMSNorm over the last axis in fp32, cast back to x's type."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.rms_norm(x.float(), (x.shape[-1],), self.scale.float(),
                       self.eps)
        return y.to(x.dtype)


def rope_tables(S: int, D: int, theta: float, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (S, 1, D) fp32, of positions 0 .. S - 1:
    frequencies ``theta ** (-2i / D)``, each twice (rotate-half); the
    first half of ``sin`` negated, as :func:`rope` takes it."""
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, device=device).float()
                           / D))
    freqs = torch.arange(S, device=device).float()[:, None] * inv[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)[:, None]
    sign = torch.cat([-torch.ones(D // 2, device=device),
                      torch.ones(D // 2, device=device)])
    return emb.cos(), emb.sin() * sign


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """Rotate-half RoPE of fp32 ``x`` (N, S, heads, D) by
    :func:`rope_tables`'s tables: ``x * cos + (-x2, x1) * sin``, the
    halves swapped by a roll and the sign carried by the table."""
    return x * cos + torch.roll(x, x.shape[-1] // 2, dims=-1) * sin


def block_bias(S: int, block: int, device: torch.device) -> torch.Tensor:
    """The block rule over S positions as an (S, S) additive fp32 bias: 0
    where key j is visible to query i (``j // block <= i // block``),
    ``NEG_INF`` elsewhere."""
    blk = torch.arange(S, device=device) // block
    return torch.where(blk[None, :] <= blk[:, None], 0.0, NEG_INF)


def block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention: q (N, S, H, D) and k (N, S, G, D) in fp32,
    v (N, S, G, D) in the compute type, ``bias`` (S, S) additive fp32 ->
    (N, S, H * D) in v's type. Query head h reads key/value head h // (H
    / G); fp32 logits scaled by D ** -0.5, the softmax's weights cast to
    v's type for the value product."""
    N, S, H, D = q.shape
    G = k.shape[2]
    q = q.view(N, S, G, H // G, D)
    logits = torch.einsum("nqgrd,nkgd->ngrqk", q, k) * D ** -0.5 + bias
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    ctx = torch.einsum("ngrqk,nkgd->nqgrd", weights, v)
    return ctx.reshape(N, S, H * D)


def route(logits: torch.Tensor, k: int, renormalise: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits (T, n_experts) -> (weights, experts), each (T, k): the
    top k of the fp32 softmax over all experts, their weights divided by
    their sum when ``renormalise``."""
    weights, experts = torch.topk(torch.softmax(logits.float(), dim=-1), k,
                                  dim=-1)
    if renormalise:
        weights = weights / weights.sum(-1, keepdim=True)
    return weights, experts


def held_experts(x: torch.Tensor, weights: torch.Tensor,
                 experts: torch.Tensor, gate_up: torch.Tensor,
                 down: torch.Tensor, offset: int) -> torch.Tensor:
    """What the held experts ``offset`` .. ``offset + n - 1`` give the
    layer's result: (T, E) tokens x with their routing (T, k) ``weights``
    (fp32) over ``experts`` (ids of all the router's experts), and the held
    experts' weights in x's type, ``gate_up`` (n, 2I, E) (each expert's
    gate rows, then its up rows) and ``down`` (n, E, I) -> (T, E) in x's
    type: the sum over a token's routed held experts of its weight times
    ``down_e(silu(gate_e x) * up_e x)``.

    Every token goes through every held expert, one batched product for
    gate and up and one for down, its weight 0 where it did not route
    there."""
    n, two_width, E = gate_up.shape
    T, width = x.shape[0], two_width // 2
    held = torch.arange(offset, offset + n, device=x.device)[:, None, None]
    # (n, T, 1): a token's weight at each held expert, 0 where not routed
    mix = (weights * (experts == held)).sum(-1, keepdim=True).to(x.dtype)
    gu = torch.bmm(x.expand(n, T, E), gate_up.transpose(1, 2))
    h = F.silu(gu[..., :width]) * gu[..., width:] * mix
    # (n, T, I) x (n, I, E) -> (n, T, E), summed over the held experts
    return torch.bmm(h, down.transpose(1, 2)).sum(0)


def held_rows(model: "SdarMoeLM", routes: torch.Tensor) -> torch.Tensor:
    """The token-expert rows that a forward's routing ``routes`` (layers,
    T, k), the experts each token's top k chose in each layer, sends to
    ``model``'s held experts: a device scalar, read by no one here."""
    c = model.config
    local = routes - c.expert_offset
    return ((local >= 0) & (local < c.experts_held)).sum()


class SdarLayer(nn.Module):
    """One decoder layer: the two RMSNorms and the head norms, the
    attention's ``qkv`` (q, k and v rows stacked) and ``o``, the
    ``router`` over all experts, and the held experts' ``gate_up`` (n,
    2I, E: each expert's gate rows, then its up rows) and ``down`` (n, E,
    I)."""

    def __init__(self, config: SdarMoeConfig, dtype: torch.dtype):
        super().__init__()
        c = self.config = config
        self.dtype = dtype
        E, D, width = c.hidden_size, c.head_dim, c.moe_intermediate_size
        n = c.experts_held
        self.norm1 = RMSNorm(E, c.rms_norm_eps)
        self.q_norm = RMSNorm(D, c.rms_norm_eps)
        self.k_norm = RMSNorm(D, c.rms_norm_eps)
        self.norm2 = RMSNorm(E, c.rms_norm_eps)
        self.qkv = nn.Parameter(torch.empty(
            (c.num_heads + 2 * c.num_kv_heads) * D, E))
        self.o = nn.Parameter(torch.empty(E, c.num_heads * D))
        self.router = nn.Parameter(torch.empty(c.num_experts, E))
        self.gate_up = nn.Parameter(torch.empty(n, 2 * width, E))
        self.down = nn.Parameter(torch.empty(n, E, width))

    def attention(self, x: torch.Tensor, shape: Tuple[int, int],
                  cos: torch.Tensor, sin: torch.Tensor, bias: torch.Tensor
                  ) -> torch.Tensor:
        """(T, E) normed states of ``shape`` (N, S) rows -> (T, H * D), the
        context before the output projection."""
        c = self.config
        N, S = shape
        H, G, D = c.num_heads, c.num_kv_heads, c.head_dim
        qkv = F.linear(x, cast_param(self.qkv, self.dtype)).view(
            N, S, H + 2 * G, D)
        # the head norms and RoPE over q and k at once, in fp32
        scale = torch.cat([self.q_norm.scale.expand(H, D),
                           self.k_norm.scale.expand(G, D)]).float()
        qk = rope(F.rms_norm(qkv[:, :, :H + G].float(), (D,), None,
                             c.rms_norm_eps) * scale, cos, sin)
        ctx = block_attention(qk[:, :, :H], qk[:, :, H:], qkv[:, :, H + G:],
                              bias)
        return ctx.view(N * S, H * D)

    def experts(self, u: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The router over all experts and the held experts' part of the
        layer's result, for (T, E) ``u`` in the compute type -> (that part,
        the (T, k) experts each token routed to)."""
        c = self.config
        weights, experts = route(
            F.linear(u, cast_param(self.router, self.dtype)),
            c.num_experts_per_tok, c.norm_topk_prob)
        part = held_experts(u, weights, experts,
                            cast_param(self.gate_up, self.dtype),
                            cast_param(self.down, self.dtype),
                            c.expert_offset)
        return part, experts

    def forward(self, x: torch.Tensor, shape: Tuple[int, int],
                cos: torch.Tensor, sin: torch.Tensor, bias: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, E) states of ``shape`` (N, S) rows -> ((T, E), the (T, k)
        routing)."""
        ctx = self.attention(self.norm1(x), shape, cos, sin, bias)
        # the residual and o at once
        x = torch.addmm(x, ctx, cast_param(self.o, self.dtype).t())
        with span("towers.lm.experts"):
            part, experts = self.experts(self.norm2(x))
            return x + part, experts


class Captured:
    """``forward`` (ids, pool_idx) -> tensors, captured as one CUDA graph
    at the shapes of its first arguments and replayed on copies of later
    ones: the host launches a step's thousands of kernels as one. The
    parameters are read where they lay at the capture, so a module's
    weights are loaded before its first call on the card; the outputs are
    the graph's own buffers, which the next replay overwrites."""

    def __init__(self, forward: Callable, ids: torch.Tensor,
                 pool_idx: Optional[torch.Tensor]):
        self.ids = ids.clone()
        self.pool_idx = None if pool_idx is None else pool_idx.clone()
        with torch.cuda.device(ids.device):
            # one eager call on a side stream first: the libraries make
            # their handles and workspaces outside the capture
            here = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                forward(self.ids, self.pool_idx)
            here.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.out = forward(self.ids, self.pool_idx)

    def __call__(self, ids: torch.Tensor, pool_idx: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
        self.ids.copy_(ids)
        if pool_idx is not None:
            self.pool_idx.copy_(pool_idx)
        self.graph.replay()
        return self.out


class SdarMoeLM(nn.Module):
    """The proposer: ``hidden`` runs the layers, ``lm_head`` the final
    RMSNorm and the untied vocabulary projection. ``attn_impls`` and
    ``quants``: the one attention route and quant tier it takes, which
    ``Family.build`` holds the arguments to."""

    label = "SDAR"
    attn_impls = ("xla",)
    quants = ("none",)

    def __init__(self, config: SdarMoeConfig,
                 dtype: torch.dtype = torch.float32, attn_impl: str = "xla",
                 quant: str = "none"):
        super().__init__()
        self.config, self.dtype = config, dtype
        V, E = config.vocab_size, config.hidden_size
        self.embed = nn.Parameter(torch.empty(V, E))
        self.layers = nn.ModuleList(SdarLayer(config, dtype)
                                    for _ in range(config.num_layers))
        self.norm = RMSNorm(E, config.rms_norm_eps)
        self.head = nn.Parameter(torch.empty(V, E))
        self._graphs = {}  # (ids shape, pool_idx shape) -> Captured

    def forward_layers(self, input_ids: torch.Tensor,
                       pool_idx: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, S) ids -> ((B, S, E) states of the last layer, or (B, Q, E)
        at ``pool_idx`` (B, Q); the (layers, B * S, k) routing), eagerly."""
        c = self.config
        B, S = input_ids.shape
        # the rows of the table, then the cast: the table is not cast whole
        x = F.embedding(input_ids.reshape(-1), self.embed).to(self.dtype)
        cos, sin = rope_tables(S, c.head_dim, c.rope_theta, x.device)
        bias = block_bias(S, c.block_length, x.device)
        routes = []
        for layer in self.layers:
            x, experts = layer(x, (B, S), cos, sin, bias)
            routes.append(experts)
        x = x.view(B, S, -1)
        if pool_idx is not None:
            x = torch.gather(x, 1, pool_idx[:, :, None].expand(
                -1, -1, x.shape[-1]))
        return x, torch.stack(routes)

    def hidden(self, input_ids: torch.Tensor,
               pool_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S) ids -> (B, S, E) states of the last layer, or (B, Q, E) at
        ``pool_idx`` (B, Q): on the card with no gradients a replay of the
        shape's graph, else :meth:`forward_layers`. Counts the rows routed
        to the held experts while the spans are live."""
        if input_ids.is_cuda and not torch.is_grad_enabled():
            key = (tuple(input_ids.shape),
                   None if pool_idx is None else tuple(pool_idx.shape))
            if key not in self._graphs:
                self._graphs[key] = Captured(self.forward_layers, input_ids,
                                             pool_idx)
            x, routes = self._graphs[key](input_ids, pool_idx)
            x = x.clone()
        else:
            x, routes = self.forward_layers(input_ids, pool_idx)
        if profiling.live():
            profiling.count(profiling.LM_EXPERT_ROWS,
                            held_rows(self, routes))
        return x

    def lm_head(self, hidden: torch.Tensor) -> torch.Tensor:
        """fp32 vocabulary logits of ``head(norm(hidden))``: the product of
        compute-type operands, left in fp32 (as BERT's head: no rounding of
        the logits before the low-temperature softmax)."""
        h = self.norm(hidden)
        return F.linear(h.float(), cast_param(self.head, self.dtype).float())


# Hugging Face's names: a layer's, after "model.layers.{i}."
_HF_LAYER = {"norm1": "input_layernorm", "q_norm": "self_attn.q_norm",
             "k_norm": "self_attn.k_norm", "norm2": "post_attention_layernorm",
             "o": "self_attn.o_proj.weight", "router": "mlp.gate.weight"}
_HF_OTHER = {"embed": "model.embed_tokens.weight", "norm": "model.norm",
             "head": "lm_head.weight"}


def hf_names(path: str, config: SdarMoeConfig) -> tuple:
    """The checkpoint names of the module path ``path``. ``qkv``,
    ``gate_up`` and ``down`` are joined from parts: the candidate is the
    tuple of their names (q, k, v; each held expert's gate and up; each
    held expert's down)."""
    if path in _HF_OTHER:
        return (_HF_OTHER[path],)
    _, i, rest = path.split(".", 2)  # layers.{i}.{rest}
    p = f"model.layers.{i}."
    if rest in _HF_LAYER:
        return (p + _HF_LAYER[rest],)
    if rest == "qkv":
        return (tuple(f"{p}self_attn.{x}_proj.weight" for x in "qkv"),)
    held = range(config.expert_offset,
                 config.expert_offset + config.experts_held)
    projs = ("gate", "up") if rest == "gate_up" else ("down",)
    return (tuple(f"{p}mlp.experts.{e}.{x}_proj.weight"
                  for e in held for x in projs),)
