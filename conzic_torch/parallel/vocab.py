"""BERT's vocabulary cut over the model axis of a (data, model) mesh.

Counterpart of the model axis of ``conzic_tpu/parallel/mesh.py``
(``param_sharding_rules``): there GSPMD cuts the word table (V, E) and the
MLM bias (V,) along V and inserts the collectives. Here
:func:`split_vocab` makes one data row's replica of a ``BertForMaskedLM``:
every weight but those two on the row's first device, and shard j of both
on the row's j-th device. No device holds the whole table or bias.

The lookup: each shard gathers the ids of its range on its own device, the
rows go to the first device, and each output row is chosen from its one
owner (``torch.where``). The result is bit-equal to ``F.embedding`` on the
whole table; adding the other shards' zeros would not be (-0.0 + 0.0 is
+0.0).

The head: the transform (dense, gelu, LN) runs once on the first device;
each shard's fp32 logits ``h @ w_j^T + b_j`` on its device, in the operand
types of ``BertMlmHead.forward``, concatenated in vocabulary order on the
first device. Softmax, stop mask and top-k then read the (B, V) logits as
on one device.

The engine calls only ``hidden`` and ``lm_head`` (``engine/gibbs.py``);
the split replica is a ``BertForMaskedLM`` with both. :func:`cuts` is the
reference's rule for when the model axis cuts the vocabulary.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from conzic_torch.models.bert import (
    BertEmbeddings,
    BertForMaskedLM,
    BertMlmHead,
)

# the parameters of ``BertForMaskedLM`` cut along the vocabulary
VOCAB_PARAMS = ("embeddings.word", "mlm.bias")


class VocabShards(nn.Module):
    """The word table and the MLM bias cut along the vocabulary into
    ``len(row)`` equal shards, shard j of both on ``row[j]``."""

    def __init__(self, word: torch.Tensor, bias: torch.Tensor,
                 row: Sequence[torch.device]):
        super().__init__()
        self.row = [torch.device(d) for d in row]
        if word.shape[0] % len(self.row):
            raise ValueError(f"a vocabulary of {word.shape[0]} does not "
                             f"divide over {len(self.row)} devices")
        self.per = word.shape[0] // len(self.row)

        def cut(t: torch.Tensor) -> nn.ParameterList:
            # copies: a view would keep the whole tensor's storage alive
            return nn.ParameterList(
                nn.Parameter(part.to(d, copy=True), requires_grad=False)
                for part, d in zip(t.detach().split(self.per), self.row))

        self.words, self.biases = cut(word), cut(bias)

    def lookup(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The whole table's rows of ``ids`` in ``dtype``, on ``row[0]``."""
        first, out = self.row[0], None
        for j, (w, d) in enumerate(zip(self.words, self.row)):
            local = ids.to(d) - j * self.per
            rows = F.embedding(local.clamp(0, self.per - 1),
                               w.to(dtype)).to(first)
            if out is None:
                out = rows
            else:
                mine = ((local >= 0) & (local < self.per)).to(first)
                out = torch.where(mine[..., None], rows, out)
        return out

    def logits(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """fp32 ``h @ word^T + bias`` over the whole vocabulary, on
        ``row[0]``: each shard's columns on its own device."""
        return torch.cat(
            [(F.linear(h.to(d).float(), w.to(dtype).float())
              + b.float()).to(self.row[0])
             for w, b, d in zip(self.words, self.biases, self.row)], dim=-1)


class _SplitEmbeddings(BertEmbeddings):
    """``BertEmbeddings`` whose word rows come from ``shards``."""

    shards: VocabShards

    def word_rows(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.shards.lookup(input_ids, self.dtype)


class _SplitMlmHead(BertMlmHead):
    """``BertMlmHead`` whose projection and bias are ``shards``'."""

    shards: VocabShards

    def forward(self, hidden: torch.Tensor, word_embedding=None
                ) -> torch.Tensor:
        return self.shards.logits(self.transformed(hidden), self.dtype)


class VocabSplitBert(BertForMaskedLM):
    """A ``BertForMaskedLM`` whose word table and MLM bias are cut over one
    mesh row (``shards``); its ``hidden`` and ``lm_head`` give the whole
    model's results."""

    shards: VocabShards


def cuts(model: Optional[int], vocab_size: int) -> bool:
    """Whether a model axis of ``model`` devices (None: no model axis) cuts
    a vocabulary of ``vocab_size``: the reference's rule, only when it
    divides."""
    return model is not None and vocab_size % model == 0


def split_vocab(bert: BertForMaskedLM, row: Sequence[torch.device]
                ) -> VocabSplitBert:
    """One data row's replica of ``bert``: a copy of every weight but the
    word table and the MLM bias on ``row[0]``, and those two cut over
    ``row`` (the vocabulary must divide it). ``bert`` is left as it is."""
    word, bias = (bert.get_parameter(name) for name in VOCAB_PARAMS)
    # the memo makes the copy's two vocabulary parameters None: the whole
    # tensors are never copied
    body = copy.deepcopy(bert, memo={id(word): None, id(bias): None})
    body = body.to(row[0])
    shards = VocabShards(word, bias, row)
    # the copy becomes the split replica: each module keeps every
    # attribute and takes the override of its seam
    for module, kind in ((body, VocabSplitBert),
                         (body.embeddings, _SplitEmbeddings),
                         (body.mlm, _SplitMlmHead)):
        module.__class__ = kind
        module.shards = shards
    return body
