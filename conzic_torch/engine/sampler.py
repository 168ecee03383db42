"""High-level captioning API with the reference's result contract.

Counterpart of ``conzic_tpu/engine/sampler.py``: ``Captioner`` owns the
towers, tokenizers and tables, and ``run`` returns a ``GenerationResult``
whose ``gen_texts_list`` holds one caption list per iteration followed by
the best-by-cosine list at ``[-1]``. ``generate_caption`` and
``control_generate_caption`` are the reference's entry functions, returning
``(gen_texts_list, clip_score_sequence)``: ``[-2]`` is the last iteration's
caption and ``[-1]`` the best one.

The pruned and hybrid tiers build their tables on first use: the per-word
CLIP embeddings of the proxy (:meth:`Captioner._ensure_word_embeds`), the
factorized stage-1's calibrated projections
(:meth:`Captioner._ensure_stage1_calibration`) and the banned-id lists of
``mask_impl="compare"``.

The entry points run on the CUDA device unless the caller names another
device; they raise when CUDA is missing rather than fall back to the CPU.

Scale-out (``parallel/``): with ``mesh=`` (a list of devices) the
captioner keeps one replica of the towers on each and ``run`` splits the
(images x samples) rows into contiguous blocks, one a device, padded with
copies of the last row; the blocks run on one thread each, as
``torch.nn.parallel.parallel_apply`` runs replicas, and their results are
put back in order. The threads share one interpreter and the Gibbs step
is thousands of small ops: a mesh in one process measured slower than one
device, while several processes scale. A (data, model) mesh
(``parallel.mesh.make_mesh_2d``) keeps one replica a data row, on the
row's first device, with BERT's word table and MLM bias cut over the row's
devices (``parallel/vocab.py``): the same captions, less memory per
device, not more speed. In a multi-process run
(``parallel/distributed.py``) each process takes its block of the rows
and every process gathers every block's results.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from conzic_torch.config import ConzicConfig
from conzic_torch.engine.gibbs import (
    EngineSpec,
    HostCalls,
    host_bridge_fn,
    host_ctl_fn,
    run_generation,
)
from conzic_torch.engine.orders import build_schedule
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.checkpoint import (
    is_tiny_checkpoint,
    load_tiny_checkpoint,
)
from conzic_torch.models.clip import TruncatedTextTower
from conzic_torch.models.configs import BertConfig, CLIPConfig
from conzic_torch.models.convert import (
    from_hf_state_dict,
    from_jax_params,
    load_checkpoint,
)
from conzic_torch.models.families import family_of
from conzic_torch.parallel import distributed
from conzic_torch.parallel.mesh import (
    data_devices,
    mesh_rows,
    model_axis,
    pad_batch_to_mesh,
    replicate,
    shard_batch,
)
from conzic_torch.parallel.vocab import cuts, split_vocab
from conzic_torch.runtime.image import preprocess_batch_pil
from conzic_torch.runtime.profiling import request_span, span
from conzic_torch.text.bpe import CLIPBPETokenizer
from conzic_torch.text.bridge import build_bridge_table
from conzic_torch.text.lexicons import (
    build_pos_table,
    build_sentiment_table,
    template_matrix,
)
from conzic_torch.text.vocab import (
    build_token_masks,
    load_stop_words_file,
    make_test_wordpiece_vocab,
)
from conzic_torch.text.wordpiece import WordPieceTokenizer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CTLS = ("sentiment", "pos")
# the factorized stage-1's calibration floor, the reference's: the held-out
# cosine below which a warning goes to stderr, and the least that the
# automatic depth (prune_stage1_layers=0) accepts
STAGE1_CALIB_FLOOR = 0.91
# the pruned tiers' tables: the proxy's word embeddings, the factorized
# stage-1's projection and the tower pre-cut's
PRUNE_TABLES = ("word_embeds", "stage1_wcal", "stage1_wcal_pc")

logger = logging.getLogger(__name__)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device to run on; a CUDA device without CUDA raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "versions of the kernels on the CPU")
    return device


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the ``cuda:i`` it means now, so that equal devices
    compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _on(device: torch.device):
    """The context that makes ``device`` current for this thread."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# the results' batch axis: iterations lead the per-iteration arrays
_BATCH_AXIS = {"iter_ids": 1, "iter_cos": 1, "iter_ctl": 1, "best_ids": 0,
               "best_cos": 0}


def tower_quants(quant: str) -> tuple:
    """The config's ``quant`` tier as (bert_quant, clip_quant), each
    "none" or "int8": "int8" quantizes the CLIP text tower (the candidate
    scoring) only, "int8_all" the BERT encoder too. An unknown tier
    raises: a caller that sets ``cfg.quant`` after validation must not
    run the full-precision towers under a quantized label."""
    if quant not in ("none", "int8", "int8_all"):
        raise ValueError(f"unknown quant tier {quant!r} "
                         "(expected none | int8 | int8_all)")
    bert_q = "int8" if quant == "int8_all" else "none"
    clip_q = "int8" if quant in ("int8", "int8_all") else "none"
    return bert_q, clip_q


def build_towers(bert_config, clip_config, config: ConzicConfig):
    """Both towers, empty, in the config's compute type, attention route
    and quant tier: the proposer and the matcher of the configs' families
    (``models/families.py``), each refusing a route or tier its class
    does not take."""
    dtype = _DTYPES[config.dtype]
    return tuple(family_of(c).build(c, dtype, config.attn_impl, q)
                 for c, q in zip((bert_config, clip_config),
                                 tower_quants(config.quant)))


def random_init_(modules: List[nn.Module], seed: int,
                 device: torch.device) -> None:
    """Fill parameters by name, as the reference package's random init
    does: LayerNorm scales 1, biases 0, ``logit_scale`` ln(100), every
    other weight N(0, 0.02), drawn on ``device`` from a seeded
    ``torch.Generator``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    for module in modules:
        for name, p in module.named_parameters():
            if name.endswith("logit_scale"):
                value = torch.full(p.shape, 4.6052, device=device)
            elif name.endswith("scale"):
                value = torch.ones(p.shape, device=device)
            elif name.endswith("bias"):
                value = torch.zeros(p.shape, device=device)
            else:
                value = 0.02 * torch.randn(p.shape, generator=gen,
                                           device=device)
            p.data = value


@dataclasses.dataclass
class GenerationResult:
    gen_texts_list: List[List[str]]  # per-iteration captions + best at [-1]
    clip_score_sequence: List[List[float]]
    iter_ids: np.ndarray  # (I, B, S)
    iter_ctl: np.ndarray  # (I, B) control score of the last commit; 0 free
    best_ids: np.ndarray  # (B, S)
    best_cos: np.ndarray  # (B,)
    elapsed_s: float


class Captioner:
    def __init__(self, bert_model: BertForMaskedLM, clip_model: nn.Module,
                 wp: WordPieceTokenizer, bpe,
                 config: Optional[ConzicConfig] = None,
                 device: Union[str, torch.device] = "cuda", mesh=None):
        """``bert_model`` and ``wp``, ``clip_model`` and ``bpe``: the
        proposer, the matcher and their tokenizers, of any family
        (``models/families.py``). ``mesh``: a data mesh
        (``parallel.mesh.make_mesh``, a list of devices) or a (data, model)
        mesh (``make_mesh_2d``, a list of rows); the captioner's own device
        is then the mesh's first."""
        self.cfg = config or ConzicConfig()
        self.cfg.validate()
        self.mesh = mesh
        if mesh is not None:
            device = data_devices(mesh)[0]
        if model_axis(mesh) is not None and distributed.process_count() > 1:
            raise ValueError(
                "a (data, model) mesh runs in one process; over several "
                "processes (--multihost) give each a data mesh or none")
        self.device = resolve_device(device)
        self.wp, self.bpe = wp, bpe
        stop_words = (load_stop_words_file(self.cfg.stop_words_path)
                      if self.cfg.stop_words_path else None)
        mask_mid, mask_last = build_token_masks(
            wp.vocab, extra_stop_words=self.cfg.add_extra_stopwords,
            stop_words=stop_words)
        self.bridge = build_bridge_table(wp, bpe)
        # the exact modes' host callables, built on first use
        self._host_bridges: Dict[int, object] = {}
        self._host_ctls: Dict[tuple, object] = {}
        # the factorized stage-1's calibration once fit: its cache key
        # (layers, clip_len, tower pre-cut layers) and held-out cosines
        self.stage1_key: Optional[tuple] = None
        self.stage1_calib_cos: Optional[float] = None
        self.stage1_pc_calib_cos: Optional[float] = None
        # the prefix-K/V bound assumes every selectable token adds >= 1
        # CLIP piece; a user stop-words file may leave empty ones selectable
        self._mask_allows_empty_piece = bool(
            (((mask_mid > 0) | (mask_last > 0)) & (self.bridge.lens == 0))
            .any())
        dev = self.device
        self.tables: Dict[str, torch.Tensor] = {
            "mask_mid": torch.from_numpy(mask_mid).to(dev),
            "mask_last": torch.from_numpy(mask_last).to(dev),
            "bridge_ids": torch.from_numpy(self.bridge.ids).to(dev),
            "bridge_lens": torch.from_numpy(self.bridge.lens).to(dev),
        }
        self.bert_model = bert_model.to(dev).eval().requires_grad_(False)
        self.clip_model = clip_model.to(dev).eval().requires_grad_(False)
        if self.cfg.param_dtype == "bfloat16":
            # logit_scale (and SigLIP's logit_bias) stay in their type:
            # similarity exponentiates the scale
            for model in (self.bert_model, self.clip_model):
                for name, p in model.named_parameters():
                    if (p.dtype == torch.float32 and not name.endswith(
                            ("logit_scale", "logit_bias"))):
                        p.data = p.data.to(torch.bfloat16)
        self._replicas = self._make_replicas()

    @property
    def spread(self) -> bool:
        """True when a run is split over a mesh or over processes."""
        return self.mesh is not None or distributed.process_count() > 1

    @property
    def _rows(self) -> List[tuple]:
        """The devices of each data row a run's row blocks go to: the
        mesh's rows (one device each on a data mesh), or the captioner's
        own device."""
        return [tuple(_indexed(resolve_device(d)) for d in row)
                for row in mesh_rows(self.mesh or [self.device])]

    def _make_replicas(self) -> Dict[tuple, tuple]:
        """(bert, clip) per data row: the captioner's own towers on its own
        device, a copy on any other (equal rows share one). When the
        mesh's model axis divides the vocabulary, every row's BERT has its
        word table and MLM bias cut over the row (``parallel/vocab.py``),
        the captioner's own too: no device holds them whole."""
        model, V = model_axis(self.mesh), self.bert_model.config.vocab_size
        split = cuts(model, V)
        if model is not None and not split:
            logger.info("a vocabulary of %d does not divide the model "
                        "axis of %d: BERT's word table and MLM bias stay "
                        "whole", V, model)
        own = _indexed(self.device)
        replicas = {}
        for row in self._rows:
            if row in replicas:
                continue
            if split:
                bert = split_vocab(self.bert_model, row)
            elif row[0] == own:
                bert = self.bert_model
            else:
                bert = copy.deepcopy(self.bert_model).to(row[0])
            replicas[row] = (bert, self.clip_model if row[0] == own
                             else copy.deepcopy(self.clip_model).to(row[0]))
        if split:
            self.bert_model = replicas[self._rows[0]][0]
        return replicas

    # ------------------------------------------------------------------
    @classmethod
    def from_random(cls, config: Optional[ConzicConfig] = None,
                    bert_config: Optional[BertConfig] = None,
                    clip_config=None, seed: int = 0,
                    wp_vocab: Optional[dict] = None,
                    clip_text_vocab_size: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda",
                    mesh=None) -> "Captioner":
        """Seeded random towers over synthetic vocabularies: tiny by
        default, full width when given ``BertConfig()`` / ``CLIPConfig()``
        and the full-size vocabulary. The matcher's tokenizer is its
        family's synthetic one (``models/families.py``): SigLIP's Unigram
        pieces are the proposer's words."""
        config = config or ConzicConfig()
        if mesh is not None:
            device = data_devices(mesh)[0]
        device = resolve_device(device)
        vocab = wp_vocab or make_test_wordpiece_vocab()
        wp = WordPieceTokenizer(
            {t: i for i, t in enumerate(sorted(vocab, key=vocab.get))})
        bert_config = dataclasses.replace(
            bert_config or BertConfig.tiny(), vocab_size=wp.vocab_size)
        clip_config = clip_config or CLIPConfig.tiny()
        match = family_of(clip_config)
        bpe = match.test_tokenizer(wp, clip_config)
        text_vocab = max(bpe.vocab_size, clip_text_vocab_size or 0,
                         clip_config.text.vocab_size)
        text = dataclasses.replace(clip_config.text, vocab_size=text_vocab)
        clip_config = dataclasses.replace(clip_config,
                                          text=match.fit_text(text, bpe))
        with torch.device(device):
            bert, clip = build_towers(bert_config, clip_config, config)
        random_init_([bert, clip], seed, device)
        return cls(bert, clip, wp, bpe, config, device, mesh)

    @classmethod
    def from_jax_params(cls, bert_config: BertConfig, bert_params,
                        clip_config: CLIPConfig, clip_params,
                        wp: WordPieceTokenizer, bpe: CLIPBPETokenizer,
                        config: Optional[ConzicConfig] = None,
                        device: Union[str, torch.device] = "cuda", mesh=None
                        ) -> "Captioner":
        """Towers carrying a ``conzic_tpu`` parameter tree (numpy leaves,
        models/convert.py layout)."""
        config = config or ConzicConfig()
        if mesh is None:
            resolve_device(device)
        bert, clip = build_towers(bert_config, clip_config, config)
        bert = from_jax_params(bert, bert_params)
        clip = from_jax_params(clip, clip_params)
        return cls(bert, clip, wp, bpe, config, device, mesh)

    @classmethod
    def from_pretrained(cls, config: ConzicConfig,
                        device: Union[str, torch.device] = "cuda", mesh=None
                        ) -> "Captioner":
        """Towers and tokenizers from the local checkpoint directories
        ``config.lm_model`` (an HF masked LM) and ``config.match_model``
        (an HF dual encoder), each of the family its ``model_type`` names
        (``models/families.py``). A directory of the JAX package's
        trained checkpoints (``conzic_tiny.json``) carries both towers and
        goes to :meth:`from_tiny_dir`."""
        if is_tiny_checkpoint(config.lm_model):
            # a trained directory holds both towers: a different
            # match_model would be silently replaced by its CLIP
            if config.match_model not in (None, "", config.lm_model,
                                          ConzicConfig.match_model):
                raise ValueError(
                    f"lm_model={config.lm_model!r} is a trained-tiny "
                    f"checkpoint (single artifact with both towers) but "
                    f"match_model={config.match_model!r} names a "
                    f"different directory — pass the same path for both "
                    f"(or leave match_model at its default).")
            return cls.from_tiny_dir(config, config.lm_model, device, mesh)
        if mesh is None:
            resolve_device(device)
        bert_config, bert_sd = load_checkpoint(config.lm_model, "lm")
        clip_config, clip_sd = load_checkpoint(config.match_model, "match")
        bert, clip = build_towers(bert_config, clip_config, config)
        bert = from_hf_state_dict(bert, bert_sd)
        clip = from_hf_state_dict(clip, clip_sd)
        wp = family_of(bert_config).tokenizer.from_pretrained(config.lm_model)
        bpe = family_of(clip_config).tokenizer.from_pretrained(
            config.match_model)
        return cls(bert, clip, wp, bpe, config, device, mesh)

    @classmethod
    def from_tiny_dir(cls, config: Optional[ConzicConfig], path: str,
                      device: Union[str, torch.device] = "cuda", mesh=None
                      ) -> "Captioner":
        """A checkpoint directory of the JAX package's
        ``models/checkpoint.py`` (``conzic_tiny.json``, both towers' flax
        msgpack, both tokenizers' files), read without flax."""
        bert_config, bert_params, clip_config, clip_params, _ = (
            load_tiny_checkpoint(path))
        wp = WordPieceTokenizer.from_vocab_file(
            os.path.join(path, "vocab.txt"))
        bpe = CLIPBPETokenizer.from_files(
            os.path.join(path, "bpe_vocab.json"),
            os.path.join(path, "bpe_merges.txt"))
        return cls.from_jax_params(bert_config, bert_params, clip_config,
                                   clip_params, wp, bpe, config, device, mesh)

    # ------------------------------------------------------------------
    def encode_images(self, pixels, local: bool = False) -> torch.Tensor:
        """A list of PIL images, or preprocessed NHWC pixels (B, H, W, C) or
        (H, W, C) -> (B, D) image embeddings on the device. The image tower
        runs once per generation.

        ``local``: in a multi-process run, ``pixels`` are this process's
        ``distributed.local_slice`` of a global batch; each process
        encodes its block and the global (B_global, D) embeddings come
        back on every process. In one process it changes nothing."""
        if isinstance(pixels, (list, tuple)):
            pixels = preprocess_batch_pil(
                pixels, self.clip_model.config.vision.image_size,
                kind=self.clip_model.preprocessing)
        if not isinstance(pixels, torch.Tensor):
            pixels = torch.tensor(np.asarray(pixels, np.float32))
        if pixels.dim() == 3:
            pixels = pixels[None]
        with torch.inference_mode(), request_span("entry.encode_images"):
            emb = self.clip_model.encode_image(pixels.to(self.device))
        if local and distributed.process_count() > 1:
            global_b = emb.shape[0] * distributed.process_count()
            return distributed.put_local_shard(emb, global_b, self.device)
        return emb

    def init_ids(self, prompt: str, max_len: int,
                 batch_size: int) -> np.ndarray:
        """[CLS] prompt [MASK]*L [SEP], replicated."""
        row = self.wp.encode(prompt + self.wp.mask_token * max_len)
        return np.tile(np.asarray(row, np.int32), (batch_size, 1))

    def seed_len(self, prompt: str) -> int:
        """[CLS] + prompt length, from an actual init encoding."""
        return int(len(self.init_ids(prompt, 1, 1)[0])) - 2

    def _ensure_ctl_tables(self) -> None:
        """The control tables, built on first use: per-token sentiment
        valence and POS tag over the vocabulary, and the template matrix
        of ``cfg.pos_type``."""
        if "senti" in self.tables:
            return
        vocab, dev = self.wp.vocab, self.device
        self.tables["senti"] = torch.from_numpy(
            build_sentiment_table(vocab)).to(dev)
        self.tables["pos"] = torch.from_numpy(build_pos_table(vocab)).to(dev)
        self.tables["template"] = torch.from_numpy(
            template_matrix(self.cfg.pos_type)).to(dev)

    def _ensure_banned_tables(self) -> None:
        """``mask_impl="compare"``'s banned-id lists (the ids each mask
        sets to 0), padded to one length with -1, which no id matches;
        built on first use."""
        if "banned_mid" in self.tables:
            return
        banned = {out: torch.nonzero(self.tables[src] == 0)[:, 0]
                  for out, src in (("banned_mid", "mask_mid"),
                                   ("banned_last", "mask_last"))}
        nb = max(a.numel() for a in banned.values())
        for key, a in banned.items():
            self.tables[key] = torch.nn.functional.pad(
                a, (0, nb - a.numel()), value=-1)

    def _encode_rows(self, encode, ids: np.ndarray, mask: np.ndarray,
                     chunk: int) -> np.ndarray:
        """``encode`` over (N, S) host rows in chunks of ``chunk`` rows on
        the device -> (N, D) float32 on the host."""
        dev, out = self.device, []
        with torch.inference_mode():
            for s in range(0, ids.shape[0], chunk):
                i_c = torch.from_numpy(ids[s:s + chunk]).long().to(dev)
                m_c = torch.from_numpy(mask[s:s + chunk]).to(dev)
                out.append(encode(i_c, m_c).float().cpu().numpy())
        return np.concatenate(out)

    def _ensure_word_embeds(self) -> None:
        """The proxy's (V, D) table, built on first use: each vocabulary
        token as a one-word caption ([BOS] pieces [EOS]) through the full
        text tower in chunks of 4,096 rows (the last padded with copies of
        its last row), in the captioner's dtype; specials exactly 0."""
        if "word_embeds" in self.tables:
            return
        br = self.bridge
        V, M = br.ids.shape
        seq_len = min(M + 2, 77)
        ids = np.full((V, seq_len), br.pad_id, np.int32)
        ids[:, 0] = br.bos_id
        lens = np.minimum(br.lens, seq_len - 2)
        for m in range(min(M, seq_len - 2)):
            sel = lens > m
            ids[sel, 1 + m] = br.ids[sel, m]
        ids[np.arange(V), 1 + lens] = br.eos_id
        mask = (np.arange(seq_len)[None, :] <= 1 + lens[:, None]).astype(
            np.int32)
        chunk = 4096
        pad = (-V) % chunk
        if pad:
            ids = np.concatenate([ids, np.repeat(ids[-1:], pad, axis=0)])
            mask = np.concatenate([mask, np.repeat(mask[-1:], pad, axis=0)])
        emb = self._encode_rows(self.clip_model.encode_text, ids, mask,
                                chunk)[:V]
        emb[np.asarray(br.lens) == 0] = 0.0
        self.tables["word_embeds"] = torch.from_numpy(emb).to(self.device)

    def _calibration_rows(self, n_sentences: int, seed: int):
        """The calibration's random captions: 3 to 12 words drawn from the
        tokens that bridge to at least one CLIP piece, as (N, clip_len)
        CLIP ids and mask, drawn from ``RandomState(seed)`` as the
        reference draws them."""
        br = self.bridge
        rng = np.random.RandomState(seed)
        lens = np.asarray(br.lens)
        valid = np.where(lens > 0)[0]
        L = self.cfg.clip_len
        rows = np.full((n_sentences, L), br.pad_id, np.int32)
        mask = np.zeros((n_sentences, L), np.int32)
        ids_tab = np.asarray(br.ids)
        for i in range(n_sentences):
            row = [br.bos_id]
            for w in rng.choice(valid, rng.randint(3, 13)):
                row.extend(ids_tab[w][:lens[w]].tolist())
                if len(row) >= L - 1:
                    break
            row = row[:L - 1] + [br.eos_id]
            rows[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return rows, mask

    def _ensure_stage1_calibration(self, n_sentences: int = 2048,
                                   seed: int = 0) -> None:
        """The factorized stage-1's projection ``tables["stage1_wcal"]``
        (H, D) fp32, fit on first use: a ridge least-squares map (float64,
        on the host) from the truncated tower's pooled states to the full
        tower's embeddings of random captions, the last eighth (at least
        32) held out; its mean held-out cosine is ``stage1_calib_cos``.
        ``prune_stage1_layers=0`` takes the smallest depth from 2 whose
        held-out cosine reaches :data:`STAGE1_CALIB_FLOOR` (else the best)
        and writes it into the config; a cosine below the floor warns on
        stderr. The tower pre-cut has its own fit,
        ``tables["stage1_wcal_pc"]``. Refit when the depths or clip_len
        change."""
        requested = self.cfg.prune_stage1_layers
        full_layers = self.clip_model.config.text.num_layers
        if requested and not 1 <= requested < full_layers:
            raise ValueError(
                f"prune_stage1_layers={requested} must be in [1, "
                f"{full_layers - 1}] (full tower has {full_layers} layers) "
                "or 0 for auto-select")
        pc_layers = 0
        if (self.cfg.prune_stage1_precut
                and self.cfg.prune_stage1_precut_mode == "tower"):
            pc_layers = self.cfg.prune_stage1_precut_layers
            if not 1 <= pc_layers < full_layers:
                raise ValueError(
                    f"prune_stage1_precut_layers={pc_layers} must be in "
                    f"[1, {full_layers - 1}]")
        meta = (requested, self.cfg.clip_len, pc_layers)
        if "stage1_wcal" in self.tables and self.stage1_key == meta:
            return
        rows, mask = self._calibration_rows(n_sentences, seed)
        chunk = 1024
        y = self._encode_rows(self.clip_model.encode_text, rows, mask,
                              chunk).astype(np.float64)
        n_hold = max(32, len(y) // 8)

        def fit(nl):
            """Ridge fit at ``nl`` layers -> (w, mean held-out cosine)."""
            tower = TruncatedTextTower(self.clip_model.text_model, nl)
            h = self._encode_rows(tower, rows, mask, chunk).astype(
                np.float64)
            h_fit, y_fit = h[:-n_hold], y[:-n_hold]
            w = np.linalg.solve(h_fit.T @ h_fit + 1e-3 * np.eye(h.shape[1]),
                                h_fit.T @ y_fit)
            pred, tgt = h[-n_hold:] @ w, y[-n_hold:]
            cos = np.sum(pred * tgt, axis=1) / (
                np.linalg.norm(pred, axis=1) * np.linalg.norm(tgt, axis=1)
                + 1e-9)
            return w, float(np.mean(cos))

        if requested:
            n_layers = requested
            w, calib = fit(n_layers)
        else:
            best = n_layers = None
            for nl in range(min(2, full_layers - 1), full_layers):
                w_nl, cos_nl = fit(nl)
                if best is None or cos_nl > best[2]:
                    best = (nl, w_nl, cos_nl)
                if cos_nl >= STAGE1_CALIB_FLOOR:
                    n_layers, w, calib = nl, w_nl, cos_nl
                    break
            if n_layers is None:
                n_layers, w, calib = best
            self.cfg.prune_stage1_layers = n_layers  # the resolved depth
            if self.cfg.verbose:
                print(f"factorized stage-1 auto-selected "
                      f"{n_layers}/{full_layers} layers "
                      f"(held-out cosine {calib:.4f})")
        self.stage1_calib_cos = calib
        if calib < STAGE1_CALIB_FLOOR:
            print(f"WARNING: factorized stage-1 calibration held-out cosine "
                  f"{calib:.4f} < {STAGE1_CALIB_FLOOR} for "
                  f"prune_stage1_layers={n_layers} on this checkpoint — the "
                  f"under-gate quality cells were measured at 0.917-0.975 "
                  f"(the over-gate ones at 0.854); raise the layer count or "
                  f"treat quality as unbounded.", file=sys.stderr)
        elif self.cfg.verbose:
            print(f"factorized stage-1 calibration held-out cosine "
                  f"{calib:.4f} (layers={n_layers})")
        self.tables["stage1_wcal"] = torch.from_numpy(
            w.astype(np.float32)).to(self.device)
        if pc_layers:
            if pc_layers >= n_layers:
                raise ValueError(
                    f"prune_stage1_precut_layers={pc_layers} must be "
                    f"shallower than the (resolved) prune_stage1_layers="
                    f"{n_layers}")
            w_pc, self.stage1_pc_calib_cos = fit(pc_layers)
            self.tables["stage1_wcal_pc"] = torch.from_numpy(
                w_pc.astype(np.float32)).to(self.device)
            if self.cfg.verbose:
                print(f"factorized tower pre-cut calibration held-out "
                      f"cosine {self.stage1_pc_calib_cos:.4f} "
                      f"(layers={pc_layers})")
        self.stage1_key = (self.cfg.prune_stage1_layers, self.cfg.clip_len,
                           pc_layers)

    def adopt_prune_tables(self, tables, stage1_key: Optional[tuple] = None,
                           calib_cos: Optional[float] = None,
                           pc_calib_cos: Optional[float] = None) -> None:
        """Take pruned-tier tables built elsewhere (on another device, or by
        the reference): those of ``tables`` named in :data:`PRUNE_TABLES`,
        as fp32 on this captioner's device, with the calibration's cache
        key and held-out cosines, so that nothing is refit while the config
        requests the key's depths. Two builds agree only to the last bits,
        so this lets two runs share one set."""
        for name in PRUNE_TABLES:
            if name in tables:
                t = tables[name]
                if not isinstance(t, torch.Tensor):
                    t = torch.from_numpy(np.asarray(t, np.float32))
                self.tables[name] = t.to(self.device, torch.float32)
        self.stage1_key = stage1_key
        self.stage1_calib_cos = calib_cos
        self.stage1_pc_calib_cos = pc_calib_cos

    def _get_host_bridge(self, clip_len: int):
        """``bridge_mode="exact"``'s host callable, one per context
        length."""
        fn = self._host_bridges.get(clip_len)
        if fn is None:
            fn = self._host_bridges[clip_len] = host_bridge_fn(
                self.wp, self.bpe, clip_len)
        return fn

    def _get_host_ctl(self, ctl: str, negative: bool, template):
        """``ctl_mode="exact"``'s host callable, one per control, polarity
        and POS template."""
        key = (ctl, negative, json.dumps(template))
        fn = self._host_ctls.get(key)
        if fn is None:
            fn = self._host_ctls[key] = host_ctl_fn(self.wp, ctl, negative,
                                                    template)
        return fn

    def _prefix_chunks(self, order: str, init_row: np.ndarray,
                       seed_len: int, max_len: int):
        """Static ((prefix_len, n_steps), ...) chunks for exact prefix-K/V
        reuse: the bound for a step is 1 (BOS) + the CLIP pieces of the
        prompt + the sentence words surely committed before the edited
        position (sequential: the position index; other orders: 0)."""
        if self.cfg.kv_chunk_size <= 0:
            return None
        lens = np.asarray(self.bridge.lens)
        prompt_ids = np.asarray(init_row[0][1:seed_len])
        if prompt_ids.size and (lens[prompt_ids] <= 0).any():
            return None  # the prompt itself bridges to nothing provable
        base = 1 + int(lens[prompt_ids].sum())
        per_word = 0 if self._mask_allows_empty_piece else 1
        if order != "sequential" or per_word == 0:
            return ((base, max_len),)
        sz = self.cfg.kv_chunk_size
        return tuple((base + start * per_word, min(sz, max_len - start))
                     for start in range(0, max_len, sz))

    def _clip_pad_to(self) -> int:
        """-1 = auto: round contexts longer than 64 up to a multiple of 8;
        0 = off; N = pad to N (ignored unless > clip_len)."""
        pad, L = self.cfg.clip_pad_to, self.cfg.clip_len
        if pad < 0:
            pad = (L + 7) // 8 * 8 if L > 64 and L % 8 else 0
        return pad if pad > L else 0

    def _clip_window(self) -> int:
        """``clip_window`` rounded up to a multiple of 8; 0 when that is not
        narrower than the rows' static width. Refused on a mesh or over
        processes, as the reference refuses it."""
        w = self.cfg.clip_window
        if not w:
            return 0
        if self.spread:
            raise ValueError(
                "--clip_window requires a single chip (no "
                "--mesh_data_axis): the per-step fit check is a "
                "cross-shard reduction on the batch-sharded candidate "
                "rows, which would insert a collective into the "
                "engine's zero-collective data-parallel program. Drop "
                "the window or the mesh.")
        w = (w + 7) // 8 * 8
        return w if w < (self._clip_pad_to() or self.cfg.clip_len) else 0

    def _spec(self, seed_len: int, max_len: int, top_k: int,
              prefix_chunks, order_kind: str = "single",
              ctl: Optional[str] = None, negative: bool = False,
              prune_k: Optional[int] = None,
              final_exact: bool = False) -> EngineSpec:
        exact = self.cfg.bridge_mode == "exact"
        if self.cfg.topk_mode == "approx" and not prune_k:
            raise ValueError(
                "topk_mode='approx' is a pruned-tier-only lever: it relaxes "
                "the candidate set (non-parity) and is refused without "
                "prune_k so the full-parity tier stays exact")
        if self.cfg.mask_impl not in ("gather", "compare"):
            raise ValueError(f"unknown mask_impl {self.cfg.mask_impl!r} "
                             "(expected gather | compare)")
        row_chunk = self.cfg.clip_row_chunk
        budget = self.cfg.clip_token_budget
        bidirectional = self.clip_model.bidirectional
        if (row_chunk and budget and self.cfg.clip_len > 48
                and not bidirectional):
            row_chunk = min(row_chunk, max(1, budget // self.cfg.clip_len))
        return EngineSpec(
            seed_len=seed_len,
            sentence_len=max_len,
            seq_len=seed_len + max_len + 1,
            candidate_k=top_k,
            clip_len=self.cfg.clip_len,
            mask_token_id=self.wp.mask_token_id,
            clip_bos_id=self.bridge.bos_id,
            clip_eos_id=self.bridge.eos_id,
            clip_pad_id=self.bridge.pad_id,
            # the exact bridge's rows share no provable prefix
            prefix_chunks=None if exact else prefix_chunks,
            clip_row_chunk=row_chunk,
            clip_pad_to=self._clip_pad_to(),
            order_kind=order_kind,
            ctl=ctl,
            negative=negative,
            ctl_mode=self.cfg.ctl_mode if ctl is not None else "table",
            exact_bridge=exact,
            prune_k=prune_k,
            final_exact=bool(final_exact and prune_k is not None),
            prune_stage1=self.cfg.prune_stage1,
            stage1_layers=self.cfg.prune_stage1_layers,
            stage1_precut=self.cfg.prune_stage1_precut,
            stage1_precut_mode=self.cfg.prune_stage1_precut_mode,
            stage1_precut_layers=self.cfg.prune_stage1_precut_layers,
            # "auto" and "on" alike: only controlled pruned runs rank so
            stage1_ctl=(self.cfg.prune_stage1_ctl != "off"
                        and ctl is not None and prune_k is not None),
            clip_window=self._clip_window(),
            topk_chunk=self.cfg.topk_chunk,
            mask_impl=self.cfg.mask_impl,
            bidirectional=bidirectional,
        )

    def _check_bidirectional(self, prune_k: Optional[int]) -> None:
        """A bidirectional matcher's rows are its fixed length and run
        whole: ``clip_len`` must be the text tower's positions; the
        window, which trims rows, and the pruned tiers, which read a
        causal tower's prompt K/V, are refused."""
        if not self.clip_model.bidirectional:
            return
        label = self.clip_model.label
        L = self.clip_model.config.text.max_position_embeddings
        if self.cfg.clip_len != L:
            raise ValueError(
                f"clip_len={self.cfg.clip_len} with a {label} matcher: its "
                f"text tower pools the last of its {L} positions, so rows "
                f"are {L} long; set clip_len={L}")
        if self.cfg.clip_window:
            raise ValueError(f"clip_window with a {label} matcher: its "
                             "text tower attends every position, so rows "
                             "run whole")
        if prune_k is not None:
            raise ValueError(f"prune_k with a {label} matcher: the pruned "
                             "tiers read a causal text tower's prompt K/V")

    def _ensure_prune_tables(self, prune_k: Optional[int]) -> None:
        """The tables this run's tier reads, built on first use."""
        if prune_k is not None:
            if self.cfg.prune_stage1 == "factorized":
                self._ensure_stage1_calibration()
                if (self.cfg.prune_stage1_precut
                        and self.cfg.prune_stage1_precut_mode == "proxy"):
                    self._ensure_word_embeds()  # the pre-cut's proxy
            else:
                self._ensure_word_embeds()
        if self.cfg.mask_impl == "compare":
            self._ensure_banned_tables()

    @request_span("engine.generate")
    def run(self, image_embeds, *, prompt: str, max_len: int, top_k: int,
            temperature: float, max_iter: int, alpha: float, beta: float,
            gamma: float = 0.0, order: str = "sequential",
            ctl: Optional[str] = None, negative: bool = False,
            rng: Optional[np.random.RandomState] = None,
            n_samples: int = 1, prune_k: Optional[int] = None,
            prune_final_exact: bool = False,
            pos_template=None) -> GenerationResult:
        """One full generation; snapshots are decoded on the host after it.

        ``ctl`` ("sentiment" or "pos") adds ``gamma`` times the control
        energy (and, for sentiment, the repeat penalty); ``negative`` flips
        the sentiment; ``pos_template`` replaces ``cfg.pos_type`` for this
        call only. ``n_samples > 1`` runs independent samples as extra
        batch rows (sample-major), each with its own schedule drawn from
        ``rng`` in turn, so the result equals ``n_samples`` separate calls;
        unpack it with :meth:`split_samples`.

        ``prune_k`` (default ``cfg.prune_k``; off when 0 or not below
        ``top_k``) scores only that many stage-1 survivors through the full
        tower; ``prune_final_exact`` (or ``cfg.prune_final_exact``) scores
        all k in the last iteration."""
        if ctl is not None and ctl not in CTLS:
            raise ValueError(f"unknown ctl {ctl!r} (None or one of {CTLS})")
        rng = rng or np.random.RandomState(self.cfg.seed)
        top_k = min(top_k, self.wp.vocab_size)
        scheds = [build_schedule(order, max_len, max_iter, rng)
                  for _ in range(n_samples)]
        if prune_k is None:  # the config's tier; an argument overrides it
            prune_k = self.cfg.prune_k or None
        prune_final_exact = prune_final_exact or self.cfg.prune_final_exact
        if prune_k is not None and prune_k >= top_k:
            prune_k = None
        self._check_bidirectional(prune_k)
        self._ensure_prune_tables(prune_k)
        init_row = self.init_ids(prompt, max_len, 1)
        seed_len = init_row.shape[1] - max_len - 1
        kind = scheds[0].kind
        spec = self._spec(seed_len, max_len, top_k, self._prefix_chunks(
            order, init_row, seed_len, max_len), kind, ctl, negative,
            prune_k=prune_k, final_exact=prune_final_exact)
        dev = self.device
        tables, host = self.tables, HostCalls()
        if self.spread and (spec.exact_bridge or (
                ctl is not None and spec.ctl_mode == "exact")):
            raise NotImplementedError(
                "bridge_mode='exact' / ctl_mode='exact' on a mesh: the exact "
                "modes' host calls run in the Gibbs loop of one device")
        if spec.exact_bridge:
            host = host._replace(bridge=self._get_host_bridge(spec.clip_len))
        if ctl is not None and spec.ctl_mode == "exact":
            template = (pos_template if pos_template is not None
                        else self.cfg.pos_type) if ctl == "pos" else None
            host = host._replace(ctl=self._get_host_ctl(ctl, negative,
                                                        template))
        # the table terms; under ctl_mode="exact" the control-aware
        # stage-1 rank still reads them
        if ctl is not None and (spec.ctl_mode != "exact" or spec.stage1_ctl):
            self._ensure_ctl_tables()
            if pos_template is not None:
                # this call's template; the shared tables stay as they are
                tables = {**self.tables, "template": torch.from_numpy(
                    template_matrix(pos_template)).to(dev)}
        if not isinstance(image_embeds, torch.Tensor):
            image_embeds = torch.tensor(np.asarray(image_embeds, np.float32))
        image_embeds = image_embeds.to(dev, torch.float32)
        B0 = image_embeds.shape[0]
        B = B0 * n_samples
        image_embeds = torch.cat([image_embeds] * n_samples, dim=0)
        init = self.init_ids(prompt, max_len, B)
        n_masks = int((init[0] == self.wp.mask_token_id).sum())
        if n_masks != max_len:
            raise ValueError(f"prompt {prompt!r} encoded {n_masks} mask "
                             f"slots, expected {max_len}")
        span_sizes = None
        if kind == "single":
            # (I, steps, B): per-row positions, sample-major blocks
            positions = torch.from_numpy(np.concatenate(
                [np.repeat(s.positions[:, :, None], B0, axis=2)
                 for s in scheds], axis=2)).long().to(dev)
        else:
            # span and parallel schedules carry no randomness: one for all
            # rows, kept on the host, where the sweep's loops read them
            positions = scheds[0].positions
            span_sizes = scheds[0].span_sizes
        hyper = {"alpha": alpha, "beta": beta, "gamma": gamma,
                 "temperature": temperature}
        t0 = time.perf_counter()
        out = self._generate(spec, tables, hyper, image_embeds, init,
                             positions, span_sizes, host)
        return self._package_result(out, time.perf_counter() - t0)

    def _generate(self, spec: EngineSpec, tables, hyper, image_embeds,
                  init: np.ndarray, positions, span_sizes,
                  host: HostCalls) -> Dict[str, np.ndarray]:
        """``run_generation`` over the run's B rows -> its outputs on the
        host. Without a mesh and in one process: one call on the device.
        Else the rows, padded with copies of the last to a multiple of the
        data devices of every process, go in contiguous blocks to the data
        devices (this process's share of them), one thread a block, and
        every process gathers every block's outputs; the padding is cut
        off."""
        rows = self._rows
        devices = [row[0] for row in rows]
        procs = distributed.process_count()
        # every input's rows on its leading axis; positions are (I, steps, B)
        by_pos = isinstance(positions, torch.Tensor)
        batch = [image_embeds, torch.from_numpy(init).long()]
        if by_pos:
            batch.append(positions.movedim(2, 0))
        batch, B = pad_batch_to_mesh(batch, self.mesh, procs)
        mine = distributed.local_slice(batch[0].shape[0])
        embeds, ids, *pos = [shard_batch(devices, x[mine]) for x in batch]
        tabs = {k: replicate(devices, v) for k, v in tables.items()}

        def block(j: int) -> Dict[str, np.ndarray]:
            d = devices[j]
            bert, clip = self._replicas[rows[j]]
            with torch.inference_mode(), _on(d):
                gen = run_generation(
                    spec, bert, clip, {k: v[j] for k, v in tabs.items()},
                    hyper, embeds[j], ids[j],
                    pos[0][j].movedim(0, 2) if by_pos else positions,
                    span_sizes, host)
                with span("engine.fetch"):
                    return {k: getattr(gen, k).cpu().numpy()
                            for k in _BATCH_AXIS}

        if len(devices) == 1:
            outs = [block(0)]
        else:
            with ThreadPoolExecutor(len(devices)) as pool:
                outs = list(pool.map(block, range(len(devices))))
        out = {k: np.concatenate([o[k] for o in outs], axis=ax)
               for k, ax in _BATCH_AXIS.items()}
        if procs > 1:
            out = {k: distributed.gather_to_host(v, _BATCH_AXIS[k])
                   for k, v in out.items()}
        return {k: (v[:, :B] if _BATCH_AXIS[k] == 1 else v[:B])
                for k, v in out.items()}

    def _package_result(self, out: Dict[str, np.ndarray],
                        elapsed: float) -> GenerationResult:
        """Decode snapshots into the reference-contract result."""
        iter_ids = out["iter_ids"].astype(np.int32)
        best_ids = out["best_ids"].astype(np.int32)
        iter_cos, iter_ctl = out["iter_cos"], out["iter_ctl"]
        best_cos = out["best_cos"]
        with span("engine.decode"):
            gen_texts_list = [
                self.wp.batch_decode(ids, skip_special_tokens=True)
                for ids in iter_ids]
            decoded_best = self.wp.batch_decode(best_ids,
                                                skip_special_tokens=True)
        clip_score_sequence = [[float(c) for c in cos] for cos in iter_cos]
        # "None" where the best never rose above the 0-initialised tracker
        gen_texts_list.append([
            decoded_best[b] if best_cos[b] > 0 else "None"
            for b in range(best_ids.shape[0])])
        clip_score_sequence.append([float(c) for c in best_cos])
        return GenerationResult(
            gen_texts_list=gen_texts_list,
            clip_score_sequence=clip_score_sequence,
            iter_ids=iter_ids,
            iter_ctl=iter_ctl,
            best_ids=best_ids,
            best_cos=best_cos,
            elapsed_s=elapsed,
        )

    @staticmethod
    def split_samples(result: GenerationResult,
                      n_samples: int) -> List[GenerationResult]:
        """Unpack a fused ``n_samples`` run into per-sample results."""
        B0 = result.iter_ids.shape[1] // n_samples
        out = []
        for s in range(n_samples):
            sl = slice(s * B0, (s + 1) * B0)
            out.append(GenerationResult(
                gen_texts_list=[row[sl] for row in result.gen_texts_list],
                clip_score_sequence=[row[sl] for row in
                                     result.clip_score_sequence],
                iter_ids=result.iter_ids[:, sl],
                iter_ctl=result.iter_ctl[:, sl],
                best_ids=result.best_ids[sl],
                best_cos=result.best_cos[sl],
                elapsed_s=result.elapsed_s,
            ))
        return out

    def log_iterations(self, logger: logging.Logger, img_name: Sequence[str],
                       result: GenerationResult,
                       with_ctl: bool = False) -> None:
        """Per-iteration logs in the reference's format, written after the
        run."""
        for i in range(result.iter_ids.shape[0]):
            for_print = self.wp.batch_decode(result.iter_ids[i])
            for jj in range(result.iter_ids.shape[1]):
                cos = result.clip_score_sequence[i][jj]
                if with_ctl:
                    logger.info(
                        f"iter {i + 1}, The {jj + 1}-th image: "
                        f"{img_name[jj]}, clip score {cos:.3f}, ctl score "
                        f"{result.iter_ctl[i][jj]:.3f}: " + for_print[jj])
                else:
                    logger.info(
                        f"iter {i + 1}, The {jj + 1}-th image: "
                        f"{img_name[jj]},clip score {cos:.3f}: "
                        + for_print[jj])


# ---------------------------------------------------------------------------
# The reference's entry functions
# ---------------------------------------------------------------------------


def _image_embeds(captioner: Captioner, image_instance, batch_size: int):
    """(B, D) image embeddings as given; or images to encode: a list of PIL
    images, preprocessed NHWC pixels (B, H, W, C), or one image, PIL or
    (H, W, C), that is captioned ``batch_size`` times, as the reference
    replicates a single image."""
    x = image_instance
    if isinstance(x, (list, tuple)):
        return captioner.encode_images(x)
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        return captioner.encode_images([x] * batch_size)  # one PIL image
    if x.ndim == 2:
        return x
    if x.ndim == 3:
        x = x[None].repeat(batch_size, *([1] * x.ndim)) if isinstance(
            x, torch.Tensor) else np.repeat(x[None], batch_size, axis=0)
    return captioner.encode_images(x)


def _log_captions(logger: logging.Logger, img_name, result, start: float):
    logger.info("Finished in %.3fs" % (time.time() - start))
    final_caption = result.gen_texts_list[-2]
    best_caption = result.gen_texts_list[-1]
    for i in range(len(final_caption)):
        logger.info(f"The {i + 1}-th image: {img_name[i]}")
        logger.info(f"final caption: {final_caption[i]}")
        logger.info(f"best caption: {best_caption[i]}")


def generate_caption(img_name, captioner: Captioner, image_instance,
                     logger: logging.Logger, prompt: str = "",
                     batch_size: int = 1, max_len: int = 15,
                     top_k: int = 100, temperature: float = 1.0,
                     max_iter: int = 500, alpha: float = 0.7,
                     beta: float = 1.0, generate_order: str = "sequential",
                     rng: Optional[np.random.RandomState] = None):
    """Free captioning; returns (gen_texts_list, clip_score_sequence)."""
    start = time.time()
    result = captioner.run(
        _image_embeds(captioner, image_instance, batch_size), prompt=prompt,
        max_len=max_len, top_k=top_k, temperature=temperature,
        max_iter=max_iter, alpha=alpha, beta=beta, order=generate_order,
        rng=rng)
    if captioner.cfg.verbose:
        captioner.log_iterations(logger, img_name, result)
    _log_captions(logger, img_name, result, start)
    return result.gen_texts_list, result.clip_score_sequence


def control_generate_caption(
        img_name, captioner: Captioner, image_instance,
        logger: logging.Logger, prompt: str = "", batch_size: int = 10,
        max_len: int = 25, top_k: int = 100, temperature: float = 1.0,
        max_iter: int = 500, alpha: float = 0.7, beta: float = 1.0,
        gamma: float = 5.0, ctl_type: str = "sentiment",
        style_type: str = "positive", pos_type=None,
        generate_order: str = "sequential",
        rng: Optional[np.random.RandomState] = None):
    """Controlled captioning; returns (gen_texts_list,
    clip_score_sequence). Sentiment runs the sequential or shuffle order
    (any other falls back to shuffle); POS runs the sequential order
    only, whatever is asked."""
    start = time.time()
    if ctl_type == "sentiment":
        order = (generate_order if generate_order in ("sequential", "shuffle")
                 else "shuffle")
        ctl, negative = "sentiment", style_type == "negative"
    else:
        order, ctl, negative = "sequential", "pos", False
    result = captioner.run(
        _image_embeds(captioner, image_instance, batch_size), prompt=prompt,
        max_len=max_len, top_k=top_k, temperature=temperature,
        max_iter=max_iter, alpha=alpha, beta=beta, gamma=gamma, order=order,
        ctl=ctl, negative=negative, rng=rng,
        pos_template=pos_type if ctl == "pos" else None)
    if captioner.cfg.verbose:
        captioner.log_iterations(logger, img_name, result, with_ctl=True)
    _log_captions(logger, img_name, result, start)
    return result.gen_texts_list, result.clip_score_sequence
