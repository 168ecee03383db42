"""SigLIP as the port's matcher, on the CPU at a tiny size that keeps the
published head size of 72: the towers and scores against the plain
reference (``bench_port/reference/siglip.py``) and it against
``transformers``' ``SiglipModel``; the Unigram tokenizer and the bridge
with no start token; Gibbs steps of the engine judged by the reference's
Gibbs step; the prefix K/V that a CLIP matcher takes and a SigLIP matcher
never does; its spans and counter; what it refuses."""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_port import one_torch_thread  # noqa: F401
from bench_port import check, inputs, system
from bench_port.conftest import TINY_LM
from bench_port.families import bert as bert_family
from bench_port.families import siglip as siglip_family
from bench_port.reference import gibbs
from bench_port.reference.siglip import Siglip, Unigram
from conzic_torch.config import ConzicConfig
from conzic_torch.engine import gibbs as engine_gibbs
from conzic_torch.engine.sampler import Captioner, build_towers
from conzic_torch.models.clip import CLIPModel
from conzic_torch.models.configs import BertConfig, SiglipConfig
from conzic_torch.models.convert import from_hf_state_dict
from conzic_torch.models.siglip import SiglipModel
from conzic_torch.runtime import profiling
from conzic_torch.text.bridge import assemble_clip_ids, build_bridge_table
from conzic_torch.text.unigram import SiglipTokenizer
from conzic_torch.text.wordpiece import WordPieceTokenizer

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 11
# fp32 on the CPU: the port and the reference agree to rounding
TOL = 2e-5

TINY_MATCH = {
    "model_type": "siglip",
    "text_config": {"vocab_size": 1000, "hidden_size": 144,
                    "num_hidden_layers": 2, "num_attention_heads": 2,
                    "intermediate_size": 176, "max_position_embeddings": 64,
                    "hidden_act": "gelu_pytorch_tanh",
                    "layer_norm_eps": 1e-6, "projection_size": 144},
    "vision_config": {"hidden_size": 144, "num_hidden_layers": 2,
                      "num_attention_heads": 2, "intermediate_size": 176,
                      "image_size": 56, "patch_size": 14, "num_channels": 3,
                      "hidden_act": "gelu_pytorch_tanh",
                      "layer_norm_eps": 1e-6}}
TRAFFIC = {"images_per_request": 2, "samples": 1, "candidate_k": 8,
           "sentence_len": 4, "iterations": 2, "order": "shuffle",
           "prompt": "Image of a", "lm_temperature": 0.1, "alpha": 0.02,
           "beta": 2.0, "check_requests": 1, "check_steps": 8}


def tiny_config():
    cfg = json.loads((ROOT / "bench_port" / "configs"
                      / "conzic-so400m.json").read_text())
    cfg["lm"].update(TINY_LM)
    cfg["match"] = json.loads(json.dumps(TINY_MATCH))
    cfg["run"]["dtype"] = "float32"
    return cfg


@pytest.fixture(scope="module")
def world():
    """The tiny configuration, its vocabularies, weights and families."""
    cfg = tiny_config()
    fams = {"lm": bert_family, "match": siglip_family}
    vocab = {r: f.vocab(cfg) for r, f in fams.items()}
    spec = bert_family.spec(cfg) + siglip_family.spec(cfg)
    weights = inputs.make_weights(spec, SEED, "cpu", cfg["weights"])
    return cfg, fams, vocab, weights


def port_model(cfg, weights):
    model = SiglipModel(SiglipConfig.from_hf_dict(cfg["match"]))
    return from_hf_state_dict(model, weights).eval()


def rel(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=-1)
                  / torch.linalg.vector_norm(want, dim=-1)).max())


def test_head_size_is_the_published_72(world):
    cfg = world[0]
    for tower in ("text_config", "vision_config"):
        c = cfg["match"][tower]
        assert c["hidden_size"] // c["num_attention_heads"] == 72


def test_towers_and_scores_match_the_reference(world):
    cfg, _, _, weights = world
    model, ref = port_model(cfg, weights), Siglip(weights, cfg["match"])
    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 1000, (5, 64), generator=gen)
    px = siglip_family.pixels(cfg, 7, 3, "cpu")
    with torch.inference_mode():
        text, image = model.encode_text(ids), model.encode_image(px)
        want_text, want_image = ref.text_embeds(ids), ref.image_embeds(px)
        assert rel(text, want_text) < TOL
        assert rel(image, want_image) < TOL
        probs, cos = model.similarity(image[:1], text)
        unit_t = want_text / want_text.norm(dim=-1, keepdim=True)
        unit_i = want_image[0] / want_image[0].norm()
        want_cos = unit_t @ unit_i
        want_logits = ref.logits(want_cos.double())
        # the scale ln 10 and the bias -10, as the configuration sets them
        assert torch.allclose(want_logits, 10.0 * want_cos.double() - 10.0,
                              atol=1e-9)
        assert torch.allclose(cos[0], want_cos, atol=1e-6)
        assert torch.allclose(probs[0].double(),
                              torch.softmax(want_logits, 0), atol=1e-6)


def test_reference_matches_transformers(world):
    transformers = pytest.importorskip("transformers")
    cfg, _, _, weights = world
    m = cfg["match"]
    hf = transformers.SiglipModel(transformers.SiglipConfig(
        text_config=m["text_config"], vision_config=m["vision_config"]))
    state = {k: v.reshape(1) if k in ("logit_scale", "logit_bias") else v
             for k, v in weights.items()
             if k.startswith(("text_model.", "vision_model.", "logit_"))}
    hf.load_state_dict(state, strict=True)
    hf.eval()
    ref = Siglip(weights, m)
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(0, 1000, (4, 64), generator=gen)
    px = siglip_family.pixels(cfg, 9, 2, "cpu")
    with torch.inference_mode():
        out = hf(input_ids=ids, pixel_values=px.permute(0, 3, 1, 2))
        want_text, want_image = ref.text_embeds(ids), ref.image_embeds(px)
        assert rel(out.text_embeds, want_text / want_text.norm(
            dim=-1, keepdim=True)) < TOL
        assert rel(out.image_embeds, want_image / want_image.norm(
            dim=-1, keepdim=True)) < TOL
        cos = out.text_embeds @ out.image_embeds.T
        assert torch.allclose(out.logits_per_text.double(),
                              ref.logits(cos.double()), atol=1e-4)


PIECES = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁a", -2.0),
          ("▁cat", -3.0), ("▁ca", -4.0), ("t", -4.5),
          ("s", -5.0), ("▁", -6.0), ("c", -6.0), ("a", -6.0),
          ("▁dog", -3.5), ("▁do", -4.0), ("g", -3.0), ("▁cats", -9.0)]


@pytest.mark.parametrize("text, want", [
    ("a cat", ["▁a", "▁cat"]),
    ("A CAT!!", ["▁a", "▁cat"]),  # lower case, no punctuation
    ("cats.", ["▁cat", "s"]),  # -3 - 5 beats the one piece at -9
    ("  dog   a ", ["▁dog", "▁a"]),
    ("dogg", ["▁dog", "g"]),  # -3.5 - 3 beats -4 - 3 - 3
    ("caxxt", ["▁ca", "<unk>", "t"]),  # a run of unknowns is one piece
    ("...", []),
])
def test_unigram_cuts_as_the_reference(tmp_path, text, want):
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps({"model": {
        "type": "Unigram", "unk_id": 2, "vocab": [list(p) for p in PIECES]}}))
    tok = SiglipTokenizer.from_pretrained(str(tmp_path))
    ids = tok.encode_word_ids(text)
    assert [tok.pieces[i] for i in ids] == want
    assert ids == Unigram(PIECES, 2).text(text)
    assert tok.bos_token_id is None
    rows, mask = tok.batch_encode([text], max_length=64, pad_to_max=True)
    assert rows[0].tolist() == ids + [1] * (64 - len(ids))  # </s> pads
    assert mask[0].tolist() == [1] * (len(ids) + 1) + [0] * (63 - len(ids))


def test_bridge_rows_have_no_start_token(world):
    cfg, _, vocab, _ = world
    wp = WordPieceTokenizer(vocab["lm"])
    tok, _ = siglip_family.program(cfg, vocab["match"])
    table = build_bridge_table(wp, tok)
    assert table.bos_id is None
    # every caption word is one piece; the period has none
    allowed = [i for t, i in wp.vocab.items() if t.isalpha()]
    assert (table.lens[allowed] == 1).all()
    assert table.lens[wp.vocab["."]] == 0
    rules = Unigram(vocab["match"], siglip_family.UNK_ID)
    rng = np.random.RandomState(0)
    rows = rng.choice(allowed + [wp.vocab["."]], size=(6, 9))
    ids, mask = assemble_clip_ids(
        torch.from_numpy(rows), torch.from_numpy(table.ids),
        torch.from_numpy(table.lens), bos_id=None, eos_id=table.eos_id,
        pad_id=table.pad_id, clip_len=64)
    for r, got, m in zip(rows, ids.tolist(), mask.tolist()):
        want, n = rules.row([wp.ids_to_tokens[int(i)] for i in r], 64)
        assert got == want
        assert m == [1] * n + [0] * (64 - n)


def test_gibbs_steps_commit_what_the_reference_commits(world):
    cfg, fams, vocab, weights = world
    cap = system.build(cfg, TRAFFIC, fams, vocab, weights, "cpu")
    driver = system.Driver(cap, TRAFFIC)
    px = siglip_family.pixels(cfg, 5, 2, "cpu")
    served = driver.request(px, 5, 6)
    judge = check.Judge(cfg, TRAFFIC, fams, vocab, weights, "cpu")
    masks = gibbs.token_masks(judge.text, "cpu")
    with torch.inference_mode():
        img = judge.match.image_embeds(px)
        assert rel(served.image_embeds, img) < TOL
        steps = 0
        for i in range(TRAFFIC["iterations"]):
            for j in range(TRAFFIC["sentence_len"]):
                state, col, last, committed = judge.state(served, 0, i, j)
                chosen = gibbs.choose_step(
                    judge.lm, judge.match, masks, state, col, last, img,
                    TRAFFIC["candidate_k"], TRAFFIC["lm_temperature"],
                    TRAFFIC["alpha"], TRAFFIC["beta"])
                assert chosen.tolist() == committed.tolist(), (i, j)
                steps += 1
        assert steps == 8
        # the served rows' matcher logits, the program's against the
        # reference's, over rows the engine's bridge assembled
        rows = served.iter_ids[0].reshape(-1, served.iter_ids[0].shape[-1])
        tab = cap.tables
        ids, _ = assemble_clip_ids(
            torch.from_numpy(rows[:, 1:-1]).long(), tab["bridge_ids"],
            tab["bridge_lens"], bos_id=None, eos_id=cap.bridge.eos_id,
            pad_id=cap.bridge.pad_id, clip_len=64)
        want_ids = [judge.match.row(judge.text, r)[0] for r in rows]
        assert ids.tolist() == want_ids
        emb = cap.clip_model.encode_text(ids.long())
        assert rel(emb, judge.match.text_embeds(ids.long(), None)) < TOL
        # the served cosines, and the scores the program takes of them
        I = TRAFFIC["iterations"]
        want_cos = gibbs.cosines(judge.match, judge.text, rows,
                                 img.repeat(I, 1)).reshape(I, -1)
        got_cos = torch.tensor(served.cosines[0][:I])
        assert (got_cos - want_cos).abs().max() < 1e-5
        probs, _ = cap.clip_model.similarity(
            served.image_embeds, emb.reshape(I, 2, -1).transpose(0, 1))
        want_p = torch.softmax(judge.match.logits(want_cos.T.double()), 1)
        assert torch.allclose(probs.double(), want_p, atol=1e-6)


def clip_captioner():
    cfg = ConzicConfig(attn_impl="xla")
    cfg.clip_row_chunk, cfg.clip_len = 16, 24
    return Captioner.from_random(cfg, device="cpu")


def generate(cap, pixels):
    emb = cap.encode_images(pixels)
    return cap.run(emb, prompt="Image of a", max_len=3, top_k=8,
                   temperature=0.1, max_iter=1, alpha=0.02, beta=2.0,
                   order="shuffle", rng=np.random.RandomState(3))


def test_clip_takes_the_prefix_kv_and_siglip_never(world, monkeypatch):
    calls = {"prefix": 0, "full": []}
    real_prefix = CLIPModel.text_prefix_kvs
    real_full = engine_gibbs.siglip.encode_full_rows

    def prefix(self, ids):
        calls["prefix"] += 1
        return real_prefix(self, ids)

    def full(model, ids):
        calls["full"].append(tuple(ids.shape))
        return real_full(model, ids)

    monkeypatch.setattr(CLIPModel, "text_prefix_kvs", prefix)
    monkeypatch.setattr(engine_gibbs.siglip, "encode_full_rows", full)
    generate(clip_captioner(), torch.rand(2, 64, 64, 3))
    assert calls["prefix"] == 1 and calls["full"] == []

    cfg, fams, vocab, weights = world
    cap = system.build(cfg, TRAFFIC, fams, vocab, weights, "cpu")
    assert not hasattr(cap.clip_model, "text_prefix_kvs")
    assert cap._spec(4, 3, 8, ((4, 3),)).bidirectional
    generate(cap, siglip_family.pixels(cfg, 1, 2, "cpu"))
    assert calls["prefix"] == 1
    # 3 steps, each all 2 x 8 rows whole at 64 positions
    assert calls["full"] == [(16, 64)] * 3


def test_siglip_spans_and_positions_counter(world):
    cfg, fams, vocab, weights = world
    traffic = dict(TRAFFIC, candidate_k=8)
    cap = system.build(cfg, traffic, fams, vocab, weights, "cpu")
    cap.cfg.clip_row_chunk = 8  # two chunks of 2 x 4 rows a step
    profiling.take_counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate(cap, siglip_family.pixels(cfg, 1, 2, "cpu"))
    names = [e.name()[len(profiling.PREFIX):]
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.PREFIX)]
    counts = profiling.take_counts()
    assert names.count("towers.match_image") == 1
    assert names.count("towers.match_text") == 3 * 2
    assert "towers.text_chunk" not in names
    assert "engine.prefix_kv" not in names
    assert counts[profiling.MATCH_TEXT_POSITIONS] == 3 * 2 * 8 * 64


@pytest.mark.parametrize("change, word", [
    (dict(quant="int8"), "int8"),
    (dict(attn_impl="pallas"), "attention kernels"),
    (dict(attn_impl="pallas_block"), "attention kernels"),
])
def test_siglip_refuses_the_tiers_it_lacks_at_build(change, word):
    cfg = ConzicConfig(attn_impl="xla")
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(ValueError) as err:
        build_towers(BertConfig.tiny(), SiglipConfig.tiny(), cfg)
    assert "SigLIP" in str(err.value) and word in str(err.value)


@pytest.mark.parametrize("change, kw, word", [
    (dict(clip_len=32), {}, "clip_len=64"),
    (dict(clip_window=16), {}, "clip_window"),
    ({}, dict(prune_k=4), "pruned tiers"),
])
def test_siglip_refuses_the_tiers_it_lacks_at_run(world, change, kw, word):
    cfg, fams, vocab, weights = world
    cap = system.build(cfg, TRAFFIC, fams, vocab, weights, "cpu")
    for k, v in change.items():
        setattr(cap.cfg, k, v)
    emb = cap.encode_images(siglip_family.pixels(cfg, 1, 2, "cpu"))
    with pytest.raises(ValueError) as err:
        cap.run(emb, prompt="Image of a", max_len=3, top_k=8,
                temperature=0.1, max_iter=1, alpha=0.02, beta=2.0,
                order="shuffle", **kw)
    assert "SigLIP" in str(err.value) and word in str(err.value)


def test_reference_imports_neither_jax_nor_the_port():
    tree = ast.parse((ROOT / "bench_port" / "reference"
                      / "siglip.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "re", "typing", "torch",
                     "bench_port"}, names
    assert not names & {"jax", "jaxlib", "flax", "conzic_tpu",
                        "conzic_torch"}


def test_hf_config_defaults_and_published_widths():
    cfg = json.loads((ROOT / "bench_port" / "configs"
                      / "conzic-so400m.json").read_text())
    s = SiglipConfig.from_hf_dict(cfg["match"])
    assert (s.text.hidden_size, s.text.num_layers, s.text.num_heads,
            s.text.intermediate_size, s.text.max_position_embeddings,
            s.text.vocab_size, s.text.projection_size) == (
        1152, 27, 16, 4304, 64, 32000, 1152)
    assert (s.vision.image_size, s.vision.patch_size,
            s.vision.num_patches) == (384, 14, 729)
    assert s.text.head_dim == s.vision.head_dim == 72
    bare = SiglipConfig.from_hf_dict({"model_type": "siglip",
                                      "text_config": {"hidden_size": 96},
                                      "vision_config": {}})
    assert bare.text.projection_size == 96
    assert bare.text.hidden_act == "gelu_pytorch_tanh"
    assert math.isclose(s.logit_scale_init, math.log(10.0))
    assert s.logit_bias_init == -10.0


def test_from_pretrained_reads_a_siglip_directory(world, tmp_path):
    transformers = pytest.importorskip("transformers")
    from PIL import Image

    from conzic_torch.models.convert import hf_names
    from conzic_torch.runtime.image import preprocess_batch_pil

    cfg, _, vocab, weights = world
    # BERT's and SigLIP's directories as save_pretrained writes them
    bert_dir, match_dir = tmp_path / "bert", tmp_path / "siglip"
    lm = cfg["lm"]
    bert = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=lm["vocab_size"], hidden_size=lm["hidden_size"],
        num_hidden_layers=lm["num_hidden_layers"],
        num_attention_heads=lm["num_attention_heads"],
        intermediate_size=lm["intermediate_size"],
        max_position_embeddings=lm["max_position_embeddings"]))
    bert.save_pretrained(str(bert_dir))
    tokens = sorted(vocab["lm"], key=vocab["lm"].get)
    (bert_dir / "vocab.txt").write_text("\n".join(tokens) + "\n")
    m = cfg["match"]
    hf = transformers.SiglipModel(transformers.SiglipConfig(
        text_config=m["text_config"], vision_config=m["vision_config"]))
    hf.save_pretrained(str(match_dir))
    (match_dir / "tokenizer.json").write_text(json.dumps({"model": {
        "type": "Unigram", "unk_id": siglip_family.UNK_ID,
        "vocab": [list(p) for p in vocab["match"]]}}))
    conf = ConzicConfig(lm_model=str(bert_dir), match_model=str(match_dir),
                        attn_impl="xla", clip_len=64, dtype="float32")
    cap = Captioner.from_pretrained(conf, device="cpu")
    assert isinstance(cap.clip_model, SiglipModel)
    assert isinstance(cap.bpe, SiglipTokenizer)
    read = {n for name, _ in cap.clip_model.named_parameters()
            for n in hf_names(cap.clip_model, name)}
    assert set(hf.state_dict()) <= read  # every tensor of the checkpoint
    # PIL images take SigLIP's preprocessing: HF's, and the tower's input
    rng = np.random.RandomState(0)
    images = [Image.fromarray(rng.randint(0, 255, (40, 70, 3), np.uint8))
              for _ in range(2)]
    px = preprocess_batch_pil(images, 56, kind="siglip")
    want = transformers.SiglipImageProcessor(
        size={"height": 56, "width": 56})(images, return_tensors="np")
    assert np.abs(px - want["pixel_values"].transpose(0, 2, 3, 1)).max() < 1e-5
    with torch.inference_mode():
        got = cap.encode_images(images)
        assert rel(got, hf.get_image_features(
            pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2))) < TOL
