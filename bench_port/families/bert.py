"""The BERT masked-LM proposer (``BertForMaskedLM``): the synthetic
WordPiece vocabulary, the weights' names, the program's ``BertConfig``
and ``WordPieceTokenizer``, the reference's logits at the slot and its
WordPiece text rules, and BERT's share of a request's operations."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from bench_port import inputs
from bench_port.flops import layer
from bench_port.reference.models import Reference
from bench_port.reference.text import WordPiece


def vocab(config: dict) -> Dict[str, int]:
    return inputs.wordpiece_vocab(config["lm"]["vocab_size"])


def spec(config: dict):
    return inputs.bert_spec(config["lm"])


def program(config: dict, vocab: Dict[str, int]):
    from conzic_torch.models.configs import BertConfig
    from conzic_torch.text.wordpiece import WordPieceTokenizer

    return WordPieceTokenizer(vocab), BertConfig.from_hf_dict(config["lm"])


class Proposer:
    def __init__(self, weights, config: dict, vocab: Dict[str, int],
                 lowp: Optional[str] = None):
        self.text = WordPiece(vocab)
        self.ref = Reference(weights, config["lm"], None, None, lowp)

    def logits(self, state: np.ndarray, col: int) -> torch.Tensor:
        dev = self.ref.w["cls.predictions.bias"].device
        masked = torch.tensor(state, device=dev, dtype=torch.long)
        masked[:, col] = self.text.vocab["[MASK]"]
        cols = torch.full((state.shape[0],), col, device=dev,
                          dtype=torch.long)
        return self.ref.bert_logits(masked, cols)


reference = Proposer


def flops(config: dict, traffic: dict) -> Dict[str, float]:
    """Per Gibbs step: every layer at every position of the B sentences
    ([CLS] prompt slots [SEP]), then the MLM head at the one masked
    slot."""
    lm = config["lm"]
    B, L = traffic["images_per_request"], traffic["sentence_len"]
    E, F, V = lm["hidden_size"], lm["intermediate_size"], lm["vocab_size"]
    S = len(traffic["prompt"].split()) + L + 2
    step = lm["num_hidden_layers"] * B * S * (layer(E, F) + 4 * S * E)
    step += B * (2 * E * E + 2 * E * V)
    return {"step": step}
