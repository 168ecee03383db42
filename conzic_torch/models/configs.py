"""Model hyperparameter configs.

Mirrors the architectures the reference loads from HuggingFace at
``reference demo.py:125`` (``bert-base-uncased`` via
``AutoModelForMaskedLM``) and ``reference clip/clip.py:12``
(``openai/clip-vit-base-patch32`` via ``CLIPModel``), re-specified here as
plain dataclasses so the rebuild carries no torch/transformers dependency in
its compute path. :class:`SiglipConfig` is the port's own second matcher,
``google/siglip-so400m-patch14-384``'s family, and :class:`SdarMoeConfig`
its own second kind of proposer, ``JetLM/SDAR-30B-A3B-Chat``'s; the
reference loads neither.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT encoder + masked-LM head.

    Defaults are ``bert-base-uncased`` (110M params, 12L/768H, vocab 30,522).
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"  # exact (erf) gelu, as HF BERT
    pad_token_id: int = 0
    # RoBERTa: position ids start at pad_token_id + 1 = 2 for unpadded
    # sequences (HF create_position_ids_from_input_ids); BERT: 0
    position_offset: int = 0

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def model_type(self) -> str:
        """The family (``models/families.py``): "roberta" where positions
        start past the padding id, as only RoBERTa's do, else "bert". The
        fields stay the JAX package's ``BertConfig``'s."""
        return "roberta" if self.position_offset else "bert"

    @staticmethod
    def tiny(vocab_size: int = 1024) -> "BertConfig":
        """Small config for tests / dry-runs."""
        return BertConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=64,
        )

    @staticmethod
    def from_hf_dict(d: dict) -> "BertConfig":
        is_roberta = d.get("model_type") == "roberta"
        pad = d.get("pad_token_id", 1 if is_roberta else 0)
        return BertConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            intermediate_size=d["intermediate_size"],
            max_position_embeddings=d["max_position_embeddings"],
            type_vocab_size=d.get("type_vocab_size", 2),
            layer_norm_eps=d.get("layer_norm_eps", 1e-12),
            hidden_act=d.get("hidden_act", "gelu"),
            pad_token_id=pad,
            position_offset=(pad + 1) if is_roberta else 0,
        )


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower. Defaults: ViT-B/32 text encoder (12L/512H, BPE vocab
    49,408, context 77, pooled at EOT position)."""

    vocab_size: int = 49408
    hidden_size: int = 512
    num_layers: int = 12
    num_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # x * sigmoid(1.702 x)
    eos_token_id: int = 49407

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 512) -> "CLIPTextConfig":
        return CLIPTextConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=77,
            eos_token_id=vocab_size - 1,
        )


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP vision tower. Defaults: ViT-B/32 (12L/768H, 224px, 32px patches)."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 32
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + class token

    @staticmethod
    def tiny() -> "CLIPVisionConfig":
        return CLIPVisionConfig(
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            image_size=64,
            patch_size=16,
        )


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """Full dual-tower CLIP: vision + text + joint projection space.

    The reference exposes image/text embeddings through
    ``clip/clip.py:48-84`` and similarity through ``clip/clip.py:86-98``
    (L2-normalize, ``logit_scale.exp()`` scaled cosine).
    """

    model_type = "clip"  # the family (models/families.py); not a field

    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    vision: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    projection_dim: int = 512
    # HF stores logit_scale as a learned scalar; init value ln(100) ~ 4.6052
    logit_scale_init: float = 4.6052

    @staticmethod
    def tiny() -> "CLIPConfig":
        return CLIPConfig(
            text=CLIPTextConfig.tiny(),
            vision=CLIPVisionConfig.tiny(),
            projection_dim=32,
        )

    @staticmethod
    def from_hf_dict(d: dict) -> "CLIPConfig":
        t, v = d["text_config"], d["vision_config"]
        return CLIPConfig(
            text=CLIPTextConfig(
                vocab_size=t["vocab_size"],
                hidden_size=t["hidden_size"],
                num_layers=t["num_hidden_layers"],
                num_heads=t["num_attention_heads"],
                intermediate_size=t["intermediate_size"],
                max_position_embeddings=t["max_position_embeddings"],
                layer_norm_eps=t.get("layer_norm_eps", 1e-5),
                hidden_act=t.get("hidden_act", "quick_gelu"),
                eos_token_id=t.get("eos_token_id", 49407),
            ),
            vision=CLIPVisionConfig(
                hidden_size=v["hidden_size"],
                num_layers=v["num_hidden_layers"],
                num_heads=v["num_attention_heads"],
                intermediate_size=v["intermediate_size"],
                image_size=v["image_size"],
                patch_size=v["patch_size"],
                layer_norm_eps=v.get("layer_norm_eps", 1e-5),
                hidden_act=v.get("hidden_act", "quick_gelu"),
            ),
            projection_dim=d["projection_dim"],
            logit_scale_init=d.get("logit_scale_init_value", 4.6052),
        )


@dataclasses.dataclass(frozen=True)
class SiglipTextConfig:
    """SigLIP text tower: bidirectional over a fixed row of
    ``max_position_embeddings`` SentencePiece ids, pooled at the last
    position, then a linear head. Defaults: Hugging Face's
    ``SiglipTextConfig``."""

    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 64
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"
    projection_size: int = 768

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class SiglipVisionConfig:
    """SigLIP vision tower: patches with no class token, a post-LayerNorm
    and an attention-pooling head. Defaults: Hugging Face's
    ``SiglipVisionConfig``."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    hidden_act: str = "gelu_pytorch_tanh"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class SiglipConfig:
    """SigLIP (Zhai et al., arXiv 2303.15343): the two towers, and the
    scores ``exp(logit_scale) * cos + logit_bias``. Hugging Face's config
    holds no values of the two scalars; they start at the paper's
    initialisation, ln 10 and -10, until a checkpoint's replace them."""

    model_type = "siglip"  # the family (models/families.py); not a field

    text: SiglipTextConfig = dataclasses.field(
        default_factory=SiglipTextConfig)
    vision: SiglipVisionConfig = dataclasses.field(
        default_factory=SiglipVisionConfig)
    logit_scale_init: float = 2.302585092994046
    logit_bias_init: float = -10.0

    @staticmethod
    def tiny() -> "SiglipConfig":
        """Two layers of two heads of 72, the published head size."""
        return SiglipConfig(
            text=SiglipTextConfig(vocab_size=512, hidden_size=144,
                                  num_layers=2, num_heads=2,
                                  intermediate_size=176,
                                  projection_size=144),
            vision=SiglipVisionConfig(hidden_size=144, num_layers=2,
                                      num_heads=2, intermediate_size=176,
                                      image_size=56, patch_size=14))

    @staticmethod
    def from_hf_dict(d: dict) -> "SiglipConfig":
        """``SiglipConfig``'s dict, each tower's missing keys at Hugging
        Face's defaults (``projection_size``: the text width)."""
        text = _from_hf(SiglipTextConfig, d["text_config"])
        if not d["text_config"].get("projection_size"):
            text = dataclasses.replace(text,
                                       projection_size=text.hidden_size)
        return SiglipConfig(text=text,
                            vision=_from_hf(SiglipVisionConfig,
                                            d["vision_config"]))


@dataclasses.dataclass(frozen=True)
class SdarMoeConfig:
    """SDAR's mixture-of-experts block-diffusion LM (``sdar_moe``): Qwen3-MoE's
    decoder layers (GQA with per-head q/k RMSNorm and rotate-half RoPE, a
    softmax router over ``num_experts`` SwiGLU experts with renormalised
    top-k) under a block-causal mask of ``block_length``. Defaults:
    ``JetLM/SDAR-30B-A3B-Chat``'s ``config.json``.

    ``experts_held`` and ``expert_offset``: the experts this device holds
    of every layer, ``expert_offset`` .. ``expert_offset + experts_held -
    1``, its share of an expert-parallel deployment; the router keeps its
    ``num_experts`` outputs and the experts that are not held add
    nothing. ``block_length`` is an inference setting, not in the
    published config."""

    model_type = "sdar_moe"  # the family (models/families.py); not a field

    vocab_size: int = 151936
    hidden_size: int = 2048
    num_layers: int = 48
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 128
    moe_intermediate_size: int = 768
    num_experts: int = 128
    num_experts_per_tok: int = 8
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    max_position_embeddings: int = 32768
    experts_held: int = 128
    expert_offset: int = 0
    block_length: int = 4

    def __post_init__(self):
        first, n = self.expert_offset, self.experts_held
        if not (0 <= first and 0 < n and first + n <= self.num_experts):
            raise ValueError(f"experts {first} .. {first + n - 1} held of "
                             f"{self.num_experts}")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(f"{self.num_heads} query heads do not share "
                             f"{self.num_kv_heads} key/value heads evenly")

    @staticmethod
    def tiny(vocab_size: int = 2048, **kw) -> "SdarMoeConfig":
        """Two layers of 4 query and 2 key/value heads of 16, 8 experts of
        32, top 2."""
        return SdarMoeConfig(**{**dict(
            vocab_size=vocab_size, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, moe_intermediate_size=32,
            num_experts=8, num_experts_per_tok=2, experts_held=8,
            max_position_embeddings=64), **kw})

    @staticmethod
    def from_hf_dict(d: dict) -> "SdarMoeConfig":
        """An ``sdar_moe`` ``config.json`` (``experts_held``,
        ``expert_offset`` and ``block_length`` where given); a mechanism
        the model does not implement raises, naming its key."""
        unsupported = {
            "mlp_only_layers": d.get("mlp_only_layers", []) != [],
            "decoder_sparse_step": d.get("decoder_sparse_step", 1) != 1,
            "attention_bias": bool(d.get("attention_bias", False)),
            "use_sliding_window": bool(d.get("use_sliding_window", False)),
            "rope_scaling": d.get("rope_scaling") is not None,
            "tie_word_embeddings": bool(d.get("tie_word_embeddings", False)),
        }
        found = sorted(k for k, bad in unsupported.items() if bad)
        if found:
            raise ValueError(f"sdar_moe config: {found} not implemented "
                             "(every layer sparse, no biases, full "
                             "attention, plain RoPE, an untied head)")
        n = d["num_experts"]
        return SdarMoeConfig(
            vocab_size=d["vocab_size"],
            hidden_size=d["hidden_size"],
            num_layers=d["num_hidden_layers"],
            num_heads=d["num_attention_heads"],
            num_kv_heads=d["num_key_value_heads"],
            head_dim=d.get("head_dim",
                           d["hidden_size"] // d["num_attention_heads"]),
            moe_intermediate_size=d["moe_intermediate_size"],
            num_experts=n,
            num_experts_per_tok=d["num_experts_per_tok"],
            norm_topk_prob=d.get("norm_topk_prob", True),
            rms_norm_eps=d.get("rms_norm_eps", 1e-6),
            rope_theta=d.get("rope_theta", 1e6),
            max_position_embeddings=d.get("max_position_embeddings", 32768),
            experts_held=d.get("experts_held", n),
            expert_offset=d.get("expert_offset", 0),
            block_length=d.get("block_length", 4),
        )


# Hugging Face's names of the fields the port names otherwise
_HF_NAMES = {"num_layers": "num_hidden_layers",
             "num_heads": "num_attention_heads"}


def _from_hf(cls, d: dict):
    """``cls`` from a Hugging Face tower dict: each field under its own or
    its Hugging Face name, else at its default."""
    return cls(**{f.name: d[_HF_NAMES.get(f.name, f.name)]
                  for f in dataclasses.fields(cls)
                  if _HF_NAMES.get(f.name, f.name) in d})


def load_hf_config(path: str) -> dict:
    """Read an HF ``config.json`` from a local checkpoint directory."""
    with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
        return json.load(f)
