"""Helpers shared by the ``tests/test_torch_*.py`` files: carry a
``conzic_tpu`` model or captioner over to ``conzic_torch`` on the CPU.

Configs are rebuilt field by field and parameters travel as numpy arrays,
so the two packages never share an object.
"""

import dataclasses
import os
import tempfile

import jax
import numpy as np

from conzic_torch.config import ConzicConfig as PortConfig
from conzic_torch.engine.sampler import Captioner as PortCaptioner
from conzic_torch.models import configs as port_configs
from conzic_torch.text.bpe import CLIPBPETokenizer as PortBPE
from conzic_torch.text.vocab import make_test_bpe_files as port_bpe_files
from conzic_torch.text.wordpiece import WordPieceTokenizer as PortWordPiece

TRAINED_TINY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "trained_tiny")


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def port_bert_config(cfg):
    return port_configs.BertConfig(**dataclasses.asdict(cfg))


def port_clip_config(cfg):
    return port_configs.CLIPConfig(
        text=port_configs.CLIPTextConfig(**dataclasses.asdict(cfg.text)),
        vision=port_configs.CLIPVisionConfig(**dataclasses.asdict(cfg.vision)),
        projection_dim=cfg.projection_dim,
        logit_scale_init=cfg.logit_scale_init,
    )


def port_captioner(jax_cap, bpe_dir=None, **cfg_kw):
    """The port's Captioner on the CPU with the weights and vocabularies of
    ``jax_cap``; ``bpe_dir`` holds the BPE files (the synthetic ones when
    None)."""
    if bpe_dir is None:
        bpe = PortBPE.from_files(*port_bpe_files(tempfile.mkdtemp()))
    else:
        bpe = PortBPE.from_files(os.path.join(bpe_dir, "bpe_vocab.json"),
                                 os.path.join(bpe_dir, "bpe_merges.txt"))
    return PortCaptioner.from_jax_params(
        port_bert_config(jax_cap.bert_model.config),
        np_tree(jax_cap.params["bert"]),
        port_clip_config(jax_cap.clip_model.config),
        np_tree(jax_cap.params["clip"]),
        PortWordPiece(dict(jax_cap.wp.vocab)), bpe,
        PortConfig(**cfg_kw), device="cpu")
