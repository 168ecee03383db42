"""Train the tiny semantic CLIP and BERT of the synthetic shape world.

Counterpart of the JAX package's ``tools/train_tiny.py``, with its flags,
names and defaults: render the seeded image-caption world
(``data/synthetic.py``), train a small CLIP contrastively and a small BERT
as a masked LM over the captions, validate that the weights carry the
world's semantics, and save a checkpoint directory that
``Captioner.from_tiny_dir`` of either package reads (``--lm_model DIR`` on
any command line).

Both towers compute in bf16 with fp32 parameters and the reference
einsum attention (``attn_impl="xla"``, the JAX trainer's default); every
LayerNorm runs the LayerNorm kernel forward and the reference's backward.
The dataset lives on the device as uint8 and batches are gathered there
by index. With the same ``--seed`` the port draws the JAX trainer's batch
indices (``--chunk`` indices at a time, from one ``RandomState``) and
shuffles its validation captions alike; the parameters' and masks' draws
come from torch generators (the same distributions, other bits).

    python -m conzic_torch.train.tiny --out DIR             # on the card
    python -m conzic_torch.train.tiny --out DIR --device cpu --smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from conzic_torch.data import synthetic as syn
from conzic_torch.models.bert import BertForMaskedLM
from conzic_torch.models.checkpoint import save_tiny_checkpoint
from conzic_torch.models.clip import CLIPModel
from conzic_torch.models.configs import (
    BertConfig,
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
)
from conzic_torch.models.convert import flax_ndim
from conzic_torch.engine.sampler import resolve_device
from conzic_torch.kernels.build import card_line
from conzic_torch.models.init import init_params
from conzic_torch.runtime.image import CLIP_MEAN, CLIP_STD
from conzic_torch.text.bpe import CLIPBPETokenizer
from conzic_torch.text.wordpiece import WordPieceTokenizer
from conzic_torch.train.optim import AdamW

TRAINER = "conzic_torch.train.tiny"
CLIP_LEN = 24  # the CLIP side's token rows
BERT_MASK_RATE = (0.15, 1.0)  # per-row masking rate of a training row
VAL_MASK_RATE = 0.15


def small_bert_config(vocab_size: int, hidden: int = 128, heads: int = 4,
                      intermediate: int = 512, layers: int = 4) -> BertConfig:
    return BertConfig(
        vocab_size=vocab_size, hidden_size=hidden, num_layers=layers,
        num_heads=heads, intermediate_size=intermediate,
        max_position_embeddings=64,
    )


def small_clip_config(text_vocab_size: int, eos_token_id: int,
                      text_layers: int = 4, hidden: int = 128,
                      heads: int = 4, intermediate: int = 512,
                      projection_dim: int = 64) -> CLIPConfig:
    return CLIPConfig(
        text=CLIPTextConfig(
            vocab_size=text_vocab_size, hidden_size=hidden,
            num_layers=text_layers, num_heads=heads,
            intermediate_size=intermediate, max_position_embeddings=77,
            eos_token_id=eos_token_id,
        ),
        vision=CLIPVisionConfig(
            hidden_size=hidden, num_layers=4, num_heads=heads,
            intermediate_size=intermediate, image_size=64, patch_size=8,
        ),
        projection_dim=projection_dim,
        # temperature 0.07 at the start (ln(1/0.07)); clamped at ln(100)
        # in the loss, as standard for CLIP training
        logit_scale_init=2.6593,
    )


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m conzic_torch.train.tiny",
        description=__doc__.split("\n")[0])
    p.add_argument("--out", default="trained_tiny")
    p.add_argument("--overwrite", action="store_true",
                   help="replace a checkpoint already in --out (refused "
                        "otherwise: the default is the committed "
                        "trained_tiny/)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--clip_steps", type=int, default=4000)
    p.add_argument("--bert_steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--train_n", type=int, default=16384)
    p.add_argument("--val_n", type=int, default=512)
    p.add_argument("--vocab_size", type=int, default=4096)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=200)
    p.add_argument("--chunk", type=int, default=25,
                   help="train steps per draw of batch indices (the JAX "
                        "trainer's lax.scan chunk)")
    p.add_argument("--clip_text_layers", type=int, default=4)
    p.add_argument("--world", choices=["tiny", "rich"], default="tiny",
                   help="rich = the mid-size world: 14-21-word two-object "
                        "captions with ungrounded valence adjectives")
    p.add_argument("--hidden", type=int, default=128,
                   help="model width (both towers)")
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--intermediate", type=int, default=0,
                   help="MLP width (0 = 4*hidden)")
    p.add_argument("--bert_layers", type=int, default=4)
    p.add_argument("--projection_dim", type=int, default=0,
                   help="CLIP projection dim (0 = hidden // 2)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_dtype", choices=["bfloat16", "float32"],
                   default="bfloat16")
    p.add_argument("--smoke", action="store_true",
                   help="CI-sized run: tiny dataset/steps, still end-to-end")
    args = p.parse_args(argv)
    if args.smoke:
        args.clip_steps = min(args.clip_steps, 30)
        args.bert_steps = min(args.bert_steps, 30)
        args.train_n = min(args.train_n, 256)
        args.val_n = min(args.val_n, 64)
        args.batch = min(args.batch, 32)
        args.chunk = min(args.chunk, 5)
    return args


# ---------------------------------------------------------------------------
# the world, the towers and the device-resident dataset
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class World:
    """The rendered scenes, their captions and both tokenizers' rows."""

    wp_vocab: Dict[str, int]
    wp: WordPieceTokenizer
    bpe: CLIPBPETokenizer
    bpe_vocab_file: str
    bpe_merges_file: str
    images: np.ndarray  # uint8 (n, 64, 64, 3)
    captions: List[str]
    clip_ids: np.ndarray  # (n, CLIP_LEN)
    clip_mask: np.ndarray
    wp_ids: np.ndarray  # (n, S_wp), right-padded
    wp_mask: np.ndarray

    @property
    def special_ids(self) -> List[int]:
        """The WordPiece ids never masked: PAD, CLS, SEP."""
        return [self.wp.vocab[self.wp.pad_token], self.wp.vocab["[CLS]"],
                self.wp.vocab["[SEP]"]]


def build_world(n: int, seed: int, vocab_size: int, rich: bool,
                staging: str) -> World:
    """The JAX trainer's world: its vocabularies (the BPE files written to
    ``staging``), ``n`` scenes rendered from ``seed + 1``, every caption
    tokenized once."""
    wp_vocab = syn.make_tiny_wordpiece_vocab(vocab_size, rich=rich)
    bpe_vocab_file, bpe_merges_file = syn.make_word_bpe_files(
        list(wp_vocab), staging)
    bpe = CLIPBPETokenizer.from_files(bpe_vocab_file, bpe_merges_file)
    wp = WordPieceTokenizer(wp_vocab)
    images, captions, _ = syn.build_dataset(n, seed=seed + 1, rich=rich)
    clip_ids, clip_mask = bpe.batch_encode(captions, max_length=CLIP_LEN,
                                           pad_to_max=True)
    rows = [wp.encode(c) for c in captions]
    S = max(len(r) for r in rows)
    wp_ids = np.full((len(rows), S), wp.pad_token_id, np.int32)
    wp_mask = np.zeros((len(rows), S), np.int32)
    for i, r in enumerate(rows):
        wp_ids[i, :len(r)] = r
        wp_mask[i, :len(r)] = 1
    return World(wp_vocab, wp, bpe, bpe_vocab_file, bpe_merges_file, images,
                 captions, clip_ids, clip_mask, wp_ids, wp_mask)


def tower_configs(args: argparse.Namespace, world: World):
    inter = args.intermediate or 4 * args.hidden
    proj = args.projection_dim or args.hidden // 2
    bert_cfg = small_bert_config(
        world.wp.vocab_size, hidden=args.hidden, heads=args.heads,
        intermediate=inter, layers=args.bert_layers)
    clip_cfg = small_clip_config(
        world.bpe.vocab_size, world.bpe.eos_token_id,
        text_layers=args.clip_text_layers, hidden=args.hidden,
        heads=args.heads, intermediate=inter, projection_dim=proj)
    return bert_cfg, clip_cfg


def build_towers(bert_cfg: BertConfig, clip_cfg: CLIPConfig,
                 device: torch.device, dtype: torch.dtype, seed: int):
    """Both towers on ``device``, fp32 parameters drawn by flax's
    initialisers from generators seeded by ``seed``, computing in
    ``dtype`` through the reference's einsum attention."""
    with torch.device(device):
        bert = BertForMaskedLM(bert_cfg, dtype=dtype, attn_impl="xla")
        clip = CLIPModel(clip_cfg, dtype=dtype, attn_impl="xla")
    for i, model in enumerate((bert, clip)):
        init_params(model, torch.Generator(device=device).manual_seed(
            seed * 2 + i))
    return bert, clip


class DeviceData:
    """The training split on the device: uint8 images and token rows,
    gathered into batches by index there."""

    def __init__(self, world: World, n: int, device: torch.device):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[:n])).to(device)

        self.images = put(world.images)
        self.clip_ids, self.clip_mask = put(world.clip_ids), put(
            world.clip_mask)
        self.wp_ids, self.wp_mask = put(world.wp_ids), put(world.wp_mask)
        self.mean = torch.from_numpy(CLIP_MEAN).to(device)
        self.std = torch.from_numpy(CLIP_STD).to(device)

    def pixels_of(self, idx: torch.Tensor) -> torch.Tensor:
        return normalize(self.images[idx], self.mean, self.std)


def normalize(images: torch.Tensor, mean: torch.Tensor,
              std: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> CLIP's normalized fp32 pixels."""
    return (images.float() / 255.0 - mean) / std


# ---------------------------------------------------------------------------
# losses and the training loop
# ---------------------------------------------------------------------------


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def clip_loss(clip: CLIPModel, pixels: torch.Tensor, ids: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """The symmetric contrastive loss over a batch of matched pairs, with
    the fp32 logit scale clamped to [0, ln 100] (zero gradient outside)."""
    img = unit(clip.encode_image(pixels).float())
    txt = unit(clip.encode_text(ids, mask).float())
    scale = torch.exp(torch.clamp(clip.logit_scale, 0.0, math.log(100.0)))
    logits = scale * img @ txt.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.T, labels)) / 2


def mlm_mask(ids: torch.Tensor, att: torch.Tensor, special: torch.Tensor,
             gen: torch.Generator,
             rate: Optional[float] = None) -> torch.Tensor:
    """The slots a masked-LM row hides: real, non-special tokens, each with
    probability ``rate``, or with a rate drawn per row uniform in
    [0.15, 1.0) when ``rate`` is None (the engine starts from all slots
    masked, so high-rate rows keep its first iteration in-domain)."""
    maskable = att.bool() & ~torch.isin(ids, special)
    if rate is None:
        lo, hi = BERT_MASK_RATE
        rate = lo + (hi - lo) * torch.rand(
            (ids.shape[0], 1), generator=gen, device=ids.device)
    return (torch.rand(ids.shape, generator=gen, device=ids.device)
            < rate) & maskable


def bert_loss(bert: BertForMaskedLM, ids: torch.Tensor, att: torch.Tensor,
              m: torch.Tensor, mask_id: int) -> torch.Tensor:
    """Cross-entropy of the fp32 logits at the masked slots ``m`` (the
    mean over them, 0 when none is)."""
    x = torch.where(m, mask_id, ids)
    logits = bert(x, att).float()
    ce = F.cross_entropy(logits.flatten(0, 1), ids.flatten().long(),
                         reduction="none").view(ids.shape)
    w = m.float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def make_optimizer(model: nn.Module, args: argparse.Namespace,
                   steps: int) -> AdamW:
    """The JAX trainer's chain over ``model``'s parameters: decay on the
    leaves of two or more axes in the flax layout."""
    names, params = zip(*model.named_parameters())
    return AdamW(list(params),
                 [flax_ndim(n, p) >= 2 for n, p in zip(names, params)],
                 lr=args.lr, warmup=args.warmup,
                 decay_steps=max(steps, args.warmup + 1))


def train_step(opt: AdamW, loss: torch.Tensor) -> torch.Tensor:
    """Gradients of ``loss`` for every parameter, then one update."""
    return opt.step(torch.autograd.grad(loss, opt.params))


def train_tower(label: str, opt: AdamW,
                loss_of: Callable[[torch.Tensor], torch.Tensor], steps: int,
                args: argparse.Namespace, rng: np.random.RandomState,
                device: torch.device, t0: float) -> List[float]:
    """``steps`` updates of ``loss_of(batch indices)``, the indices drawn
    ``args.chunk`` steps at a time from ``rng`` as the JAX trainer draws
    them; prints the chunk's mean loss every 8 chunks, as it does, and
    returns every chunk's mean loss."""
    means = []
    done = 0
    while done < steps:
        k = min(args.chunk, steps - done)
        idx = torch.from_numpy(rng.randint(
            0, args.train_n, size=(k, args.batch)).astype(np.int32)).to(
                device)
        losses = []
        for i in range(k):
            loss = loss_of(idx[i])
            train_step(opt, loss)
            losses.append(loss.detach())
        means.append(torch.stack(losses).mean())
        done += k
        if done % (args.chunk * 8) < args.chunk or done >= steps:
            print(f"  {label} step {done:5d}  loss {float(means[-1]):.4f}  "
                  f"[{time.time() - t0:6.1f}s]", flush=True)
    return [float(x) for x in means]


# ---------------------------------------------------------------------------
# validation, metadata and the command
# ---------------------------------------------------------------------------


def shuffled_captions(captions: List[str],
                      rng: np.random.RandomState) -> List[str]:
    """Each caption's words shuffled (the final '.' kept last), drawn from
    ``rng`` as the JAX trainer draws them."""
    out = []
    for c in captions:
        words = c.split()
        body = words[:-1] if words[-1] == "." else words
        rng.shuffle(body)
        out.append(" ".join(body) + " .")
    return out


@torch.inference_mode()
def validate(bert: BertForMaskedLM, clip: CLIPModel, world: World,
             val: slice, rng: np.random.RandomState,
             device: torch.device, gen: torch.Generator) -> Dict:
    """The JAX trainer's held-out checks: image-to-caption retrieval, the
    cosine of matched, mismatched and word-shuffled captions, and the
    masked LM's top-1 accuracy at 15% masking."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    mean = torch.from_numpy(CLIP_MEAN).to(device)
    std = torch.from_numpy(CLIP_STD).to(device)
    caps = world.captions[val]
    img = unit(clip.encode_image(
        normalize(put(world.images[val]), mean, std)).float())
    txt = unit(clip.encode_text(put(world.clip_ids[val]),
                                put(world.clip_mask[val])).float())
    sc_ids, sc_mask = world.bpe.batch_encode(
        shuffled_captions(caps, rng), max_length=CLIP_LEN, pad_to_max=True)
    shf = unit(clip.encode_text(put(sc_ids), put(sc_mask)).float())
    sim = (img @ txt.T).cpu().numpy()
    n = sim.shape[0]
    ranks = (-sim).argsort(axis=1)
    diag = sim[np.arange(n), np.arange(n)]
    off = (sim.sum(1) - diag) / (n - 1)
    cos_shuf = (img * shf).sum(-1).cpu().numpy()

    ids, att = put(world.wp_ids[val]), put(world.wp_mask[val])
    special = torch.tensor(world.special_ids, device=device,
                           dtype=ids.dtype)
    m = mlm_mask(ids, att, special, gen, rate=VAL_MASK_RATE)
    pred = bert(torch.where(m, world.wp.mask_token_id, ids), att).argmax(-1)
    hits = ((pred == ids) & m).sum()
    acc = float(hits / torch.clamp(m.sum(), min=1))
    return {
        "clip_retrieval_top1": float((ranks[:, 0] == np.arange(n)).mean()),
        "clip_retrieval_top5": float(
            (ranks[:, :5] == np.arange(n)[:, None]).any(1).mean()),
        "cos_matched_mean": float(diag.mean()),
        "cos_mismatched_mean": float(off.mean()),
        "cos_shuffled_mean": float(cos_shuf.mean()),
        "separation_matched_minus_mismatched": float((diag - off).mean()),
        "separation_matched_minus_shuffled": float(
            (diag - cos_shuf).mean()),
        "bert_masked_top1_acc": acc,
        "n_val": n,
    }


def main(argv=None) -> Dict:
    """Train, validate and save as the flags say; returns the validation
    dict, each tower's chunk losses, steps and seconds, and the output
    path."""
    args = parse_args(argv)
    if (os.path.exists(os.path.join(args.out, "conzic_tiny.json"))
            and not args.overwrite):
        raise SystemExit(f"{args.out} already holds a checkpoint; pass "
                         f"--overwrite to replace it")
    device = resolve_device(args.device)
    t0 = time.time()
    rng = np.random.RandomState(args.seed)
    with tempfile.TemporaryDirectory(prefix="conzic_tiny_bpe_") as staging:
        world = build_world(args.train_n + args.val_n, args.seed,
                            args.vocab_size, args.world == "rich", staging)
        print(f"[{time.time() - t0:6.1f}s] rendered {args.train_n}+"
              f"{args.val_n} scenes", flush=True)
        bert_cfg, clip_cfg = tower_configs(args, world)
        bert, clip = build_towers(bert_cfg, clip_cfg, device,
                                  torch.bfloat16, args.seed)
        n_bert = sum(p.numel() for p in bert.parameters())
        n_clip = sum(p.numel() for p in clip.parameters())
        card = card_line() if device.type == "cuda" else None
        print(f"[{time.time() - t0:6.1f}s] params: bert {n_bert / 1e6:.2f}M,"
              f" clip {n_clip / 1e6:.2f}M; device={device} card={card}",
              flush=True)
        data = DeviceData(world, args.train_n, device)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1000)
        special = torch.tensor(world.special_ids, device=device,
                               dtype=data.wp_ids.dtype)

        def clip_of(idx):
            return clip_loss(clip, data.pixels_of(idx), data.clip_ids[idx],
                             data.clip_mask[idx])

        def bert_of(idx):
            ids, att = data.wp_ids[idx], data.wp_mask[idx]
            return bert_loss(bert, ids, att, mlm_mask(ids, att, special, gen),
                             world.wp.mask_token_id)

        def sync():
            if device.type == "cuda":
                torch.cuda.synchronize(device)

        result = {"out": args.out}
        for tower, model, loss_of, steps in (
                ("clip", clip, clip_of, args.clip_steps),
                ("bert", bert, bert_of, args.bert_steps)):
            print(f"[{time.time() - t0:6.1f}s] {tower.upper()}: {steps} "
                  f"steps @B={args.batch} (chunks of {args.chunk})",
                  flush=True)
            sync()
            t = time.perf_counter()
            losses = train_tower(tower, make_optimizer(model, args, steps),
                                 loss_of, steps, args, rng, device, t0)
            sync()
            result[tower] = dict(losses=losses, steps=steps,
                                 seconds=time.perf_counter() - t)
        steps_per_s = {t: result[t]["steps"] / result[t]["seconds"]
                       for t in ("clip", "bert")}
        for tower, rate in steps_per_s.items():
            print(f"{tower}: {result[tower]['steps']} steps in "
                  f"{result[tower]['seconds']:.3f} s, {rate:.4f} steps/s",
                  flush=True)

        print(f"[{time.time() - t0:6.1f}s] validating on {args.val_n} "
              f"held-out scenes", flush=True)
        validation = validate(
            bert, clip, world, slice(args.train_n, None), rng, device,
            torch.Generator(device=device).manual_seed(args.seed + 999))
        print(json.dumps(validation, indent=1))
        result["validation"] = validation
        meta = {
            "trainer": TRAINER,
            "args": vars(args),
            "backend": device.type,
            "card": card,
            "params_m": {"bert": n_bert / 1e6, "clip": n_clip / 1e6},
            "dataset": {"train_n": args.train_n, "val_n": args.val_n,
                        "wp_vocab": world.wp.vocab_size,
                        "bpe_vocab": world.bpe.vocab_size,
                        "wp_seq": int(world.wp_ids.shape[1])},
            "validation": validation,
            "steps_per_s": steps_per_s,
            "wall_s": round(time.time() - t0, 1),
        }
        save_tiny_checkpoint(
            args.out, bert_cfg, bert, clip_cfg, clip, world.wp_vocab,
            world.bpe_vocab_file, world.bpe_merges_file, meta=meta,
            save_dtype=args.save_dtype)
    print(f"[{time.time() - t0:6.1f}s] saved {args.out}", flush=True)
    return result


if __name__ == "__main__":
    main()
