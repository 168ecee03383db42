"""SDAR's mixture-of-experts block-diffusion LM as the port's proposer, on
the CPU at a tiny size (2 layers of 4 query and 2 key/value heads of 16, 8
experts of 32, top 2, 4 held): the port against the plain reference
(``bench_port/reference/sdar.py``) and it against ``transformers``'
Qwen3-MoE with the block mask; the expert shares against the uncut layer;
the block rule; the Qwen2 BPE and its bridge; the family's entry and
refusals; and ``api.run`` over checkpoint directories against the
reference's Gibbs loop, id for id."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401
    one_torch_thread,
    sdar_tiny_captioner,
    sdar_tiny_config,
)
from bench_port import inputs
from bench_port.families import clip as clip_family
from bench_port.families import sdar_moe as sdar_family
from bench_port.reference import gibbs
from bench_port.reference.sdar import QwenText, Sdar
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.sampler import Captioner, build_towers
from conzic_torch.models import sdar
from conzic_torch.models.configs import CLIPConfig, SdarMoeConfig
from conzic_torch.models.convert import from_hf_state_dict, joined
from conzic_torch.models.families import family
from conzic_torch.text.bridge import build_bridge_table
from conzic_torch.text.qwen_bpe import QwenBPETokenizer

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 23
# fp32 on the CPU: the port and the reference differ in the order of
# their sums only (the port's fused RMSNorm, its products over all held
# experts at once and their sum, the reference's loop over the experts):
# a few float32 roundings through two layers
TOL = 2e-5
# the same sums in another order, per element, against transformers
TOL_HF = 1e-5


@pytest.fixture(scope="module")
def world():
    """The tiny configuration, its families, vocabularies and weights: the
    held experts' (0 to 3), and every expert's (``uncut``)."""
    cfg = sdar_tiny_config()
    fams = {"lm": sdar_family, "match": clip_family}
    vocab = {r: f.vocab(cfg) for r, f in fams.items()}
    spec = (sdar_family.spec(sdar_tiny_config(experts_held=8))
            + clip_family.spec(cfg))
    uncut = inputs.make_weights(spec, SEED, "cpu", cfg["weights"])
    return cfg, fams, vocab, uncut


def port(lm: dict, weights, dtype=torch.float32) -> sdar.SdarMoeLM:
    model = sdar.SdarMoeLM(SdarMoeConfig.from_hf_dict(lm), dtype=dtype)
    return from_hf_state_dict(model, weights).eval()


def rel(got, want):
    return float((torch.linalg.vector_norm(got - want, dim=-1)
                  / torch.linalg.vector_norm(want, dim=-1)).max())


def seeded_ids(n, S, V=2048, seed=1):
    return torch.randint(0, V, (n, S), generator=torch.Generator()
                         .manual_seed(seed))


def test_port_matches_the_reference(world):
    cfg, _, _, w = world
    model, ref = port(cfg["lm"], w), Sdar(w, cfg["lm"])
    ids = seeded_ids(3, 15)
    cols = torch.tensor([4, 9, 13])
    with torch.inference_mode():
        assert rel(model.hidden(ids), ref.hidden(ids)) < TOL
        got = model.lm_head(model.hidden(ids, pool_idx=cols[:, None])[:, 0])
        assert rel(got, ref.logits(ids, cols)) < TOL


def test_reference_matches_transformers_qwen3_moe(world):
    """All 8 experts held; the block rule as a 4-D additive mask."""
    transformers = pytest.importorskip("transformers")
    cfg, _, _, w = world
    lm = dict(cfg["lm"], experts_held=8)
    hf = transformers.Qwen3MoeModel(transformers.Qwen3MoeConfig(
        vocab_size=lm["vocab_size"], hidden_size=lm["hidden_size"],
        num_hidden_layers=lm["num_hidden_layers"],
        num_attention_heads=lm["num_attention_heads"],
        num_key_value_heads=lm["num_key_value_heads"],
        head_dim=lm["head_dim"], num_experts=lm["num_experts"],
        num_experts_per_tok=lm["num_experts_per_tok"],
        moe_intermediate_size=lm["moe_intermediate_size"],
        norm_topk_prob=True, rms_norm_eps=lm["rms_norm_eps"],
        rope_theta=lm["rope_theta"], attn_implementation="eager"))
    state = {k[len("model."):]: v for k, v in w.items()
             if k.startswith("model.")}
    hf.load_state_dict(state, strict=True)
    hf.eval()
    ids = seeded_ids(2, 15, seed=2)
    blk = torch.arange(15) // 4
    mask = torch.where(blk[None, :] <= blk[:, None], 0.0,
                       torch.finfo(torch.float32).min)[None, None]
    ref = Sdar(w, lm)
    with torch.inference_mode():
        want = hf(input_ids=ids, attention_mask=mask.expand(2, 1, 15, 15)
                  ).last_hidden_state
        got = ref.norm(ref.hidden(ids), "model.norm")
    assert rel(got, want) < TOL_HF


def test_expert_shares_add_up_to_the_uncut_layer(world):
    """The two disjoint halves of the experts, each a device's share, give
    parts whose sum is the layer with every expert (the port's and the
    reference's), and a share alone is not."""
    cfg, _, _, w = world
    u = torch.randn(30, 64, generator=torch.Generator().manual_seed(3))
    p = "model.layers.1."

    layers = [port(dict(cfg["lm"], **held), w).layers[1]
              for held in (dict(experts_held=4, expert_offset=0),
                           dict(experts_held=4, expert_offset=4),
                           dict(experts_held=8))]
    with torch.inference_mode():  # fp32: the weights need no cast
        low, high, whole = (layer.experts(u)[0] for layer in layers)
        ref_whole = Sdar(w, dict(cfg["lm"], experts_held=8)).experts(u, p)
        ref_low = Sdar(w, cfg["lm"]).experts(u, p)
    # over the whole output: a token whose top 2 both lie in the other
    # half gets a row of zeros from this one
    def rel_all(got, want):
        return float(torch.linalg.vector_norm(got - want)
                     / torch.linalg.vector_norm(want))

    assert rel_all(low + high, whole) < TOL
    assert rel_all(whole, ref_whole) < TOL
    assert rel_all(low, ref_low) < TOL
    assert rel_all(low, whole) > 0.1


def test_block_rule_hides_later_blocks(world):
    cfg, _, _, w = world
    model = port(cfg["lm"], w)
    ids = seeded_ids(1, 15, seed=4)
    later = ids.clone()
    later[0, 9] = (later[0, 9] + 1) % 2048  # block 2
    with torch.inference_mode():
        a, b = model.hidden(ids), model.hidden(later)
    assert torch.equal(a[0, :8], b[0, :8])  # blocks 0 and 1 see nothing
    assert not torch.allclose(a[0, 8:12], b[0, 8:12])  # its own block does
    bias = sdar.block_bias(6, 4, "cpu")
    assert bias.dtype == torch.float32
    assert (bias == 0).int().tolist() == (
        [[1, 1, 1, 1, 0, 0]] * 4 + [[1] * 6] * 2)
    assert set(bias.unique().tolist()) == {0.0, -1e9}


def test_a_layers_matrices_are_one_view_of_the_buffer(world):
    """A state dict drawn in one buffer, each stack's parts side by side
    (the harness's draw), loads a layer's q, k and v, its held experts'
    gates and ups and their downs as views of that buffer; parts elsewhere
    are copied."""
    cfg, _, _, _ = world
    w = inputs.make_weights(sdar_family.spec(cfg), SEED, "cpu", {})
    layer = port(cfg["lm"], w).layers[1]
    p = "model.layers.1."
    base = w[p + "self_attn.q_proj.weight"].untyped_storage().data_ptr()
    for stacked in (layer.qkv, layer.o, layer.router, layer.gate_up,
                    layer.down):
        assert stacked.untyped_storage().data_ptr() == base
    E = 64
    assert torch.equal(layer.qkv, torch.cat([
        w[p + f"self_attn.{x}_proj.weight"] for x in "qkv"]))
    assert torch.equal(layer.o, w[p + "self_attn.o_proj.weight"])
    assert torch.equal(layer.router, w[p + "mlp.gate.weight"])
    for j, e in enumerate(range(4)):
        x = f"{p}mlp.experts.{e}."
        assert torch.equal(layer.gate_up[j], torch.cat(
            [w[x + "gate_proj.weight"], w[x + "up_proj.weight"]]))
        assert torch.equal(layer.down[j], w[x + "down_proj.weight"])
    assert layer.gate_up.shape == (4, 64, E)
    apart = [torch.randn(3, 2), torch.randn(5)]
    got = joined(apart)
    assert torch.equal(got, torch.cat([apart[0].reshape(-1), apart[1]]))
    assert got.untyped_storage().data_ptr() != (
        apart[0].untyped_storage().data_ptr())


def test_qwen_bpe_round_trip_and_bridge(world):
    cfg, fams, vocab, _ = world
    tok, lm_cfg = sdar_family.program(cfg, vocab["lm"])
    text = QwenText(*vocab["lm"])
    assert tok.vocab_size == lm_cfg.vocab_size == 2048
    row = tok.encode("Image of a" + tok.mask_token * 4)
    assert row == text.init_row("Image of a", 4)
    assert tok.convert_ids_to_tokens(row[:4]) == [
        "<|endoftext|>", "Image", "Ġof", "Ġa"]
    for s in ("Image of a girl playing.", "a dog, 3 cats\nand émile's hat"):
        ids = tok.encode(s, add_special_tokens=False)
        assert tok.decode(ids) == s
        assert text.decode(ids) == s
    caption = tok.encode("Image of a girl baba.")
    assert tok.decode(caption, skip_special_tokens=True) == (
        "Image of a girl baba.")
    # every Ġ piece bridges as its word: CLIP's pieces of the word alone
    bpe, _ = clip_family.program(cfg, vocab["match"])
    table = build_bridge_table(tok, bpe)
    for piece in ("Ġgirl", "girl", "Ġbaba", "Image"):
        i = tok.vocab[piece]
        want = bpe.encode_word_ids(piece.lstrip("Ġ"))
        assert table.ids[i, :table.lens[i]].tolist() == want
    assert table.lens[tok.vocab["Ġ"]] == 0
    assert table.lens[tok.mask_token_id] == 0
    # the matchers read the pieces as words, in WordPiece's notation
    assert text.tokens[tok.vocab["Ġgirl"]] == "girl"
    assert text.tokens[tok.vocab["girl"]] == "##girl"
    assert text.tokens[tok.mask_token_id] == "[MASK]"


def test_the_tokenizer_reserves_the_models_spare_rows(world, tmp_path):
    """A checkpoint whose model has more rows than its tokenizer has ids:
    the rows left over are reserved special tokens, which the masks never
    allow."""
    from conzic_torch.text.vocab import build_token_masks

    _, _, vocab, _ = world
    sdar_family.write_tokenizer_files(str(tmp_path), vocab["lm"])
    (tmp_path / "config.json").write_text(json.dumps({"vocab_size": 2100}))
    tok = QwenBPETokenizer.from_pretrained(str(tmp_path))
    assert tok.vocab_size == 2100 and sorted(tok.vocab.values()) == list(
        range(2100))
    mid, last = build_token_masks(tok.vocab)
    assert not mid[2048:].any() and not last[2048:].any()
    assert tok.decode([2050, tok.vocab["Ġgirl"]], True) == " girl"


def test_mask_id_and_published_vocabulary():
    pieces, merges, added = sdar_family.qwen_bpe(151936)
    assert len(pieces) + len(added) == 151936 and len(merges) == 151387
    assert added[151643] == "<|endoftext|>" and added[151669] == "<|MASK|>"


def test_family_entry_and_refusals():
    fam = family("sdar_moe", "lm")
    assert fam.model is sdar.SdarMoeLM and fam.tokenizer is QwenBPETokenizer
    with pytest.raises(ValueError, match="no matcher family"):
        family("sdar_moe", "match")
    cfg = SdarMoeConfig.tiny()
    for attn_impl, quant, word in (("pallas", "none", "attention kernels"),
                                   ("xla_bhsd", "none", "attention kernels"),
                                   ("xla", "int8", "int8")):
        with pytest.raises(ValueError) as err:
            fam.build(cfg, torch.float32, attn_impl, quant)
        assert "SDAR" in str(err.value) and word in str(err.value)
    conf = ConzicConfig(attn_impl="xla", quant="int8_all")
    with pytest.raises(ValueError, match="SDAR"):
        build_towers(cfg, CLIPConfig.tiny(), conf)
    hf = json.loads((ROOT / "bench_port" / "configs"
                     / "conzic-sdar30b-l14.json").read_text())["lm"]
    full = SdarMoeConfig.from_hf_dict(hf)
    assert (full.num_layers, full.hidden_size, full.num_heads,
            full.num_kv_heads, full.head_dim, full.num_experts,
            full.num_experts_per_tok, full.moe_intermediate_size,
            full.vocab_size, full.experts_held, full.expert_offset,
            full.block_length) == (48, 2048, 32, 4, 128, 128, 8, 768,
                                   151936, 16, 0, 4)
    for key, value in (("mlp_only_layers", [0]), ("decoder_sparse_step", 2),
                       ("attention_bias", True), ("rope_scaling", {}),
                       ("tie_word_embeddings", True)):
        with pytest.raises(ValueError, match=key):
            SdarMoeConfig.from_hf_dict({**hf, key: value})
    with pytest.raises(ValueError, match="held of 128"):
        SdarMoeConfig.from_hf_dict({**hf, "expert_offset": 120})


def write_dirs(tmp_path, cfg, vocab, w):
    """SDAR's and CLIP's checkpoint directories, as ``from_pretrained``
    reads them, and two images."""
    from PIL import Image

    lm_dir, match_dir, images = (tmp_path / n for n in ("sdar", "clip",
                                                        "images"))
    for d in (lm_dir, match_dir, images):
        d.mkdir()
    lm_names = {n for n, _, _ in sdar_family.spec(cfg)}
    (lm_dir / "config.json").write_text(json.dumps(cfg["lm"]))
    torch.save({n: w[n].clone() for n in lm_names},
               lm_dir / "pytorch_model.bin")
    sdar_family.write_tokenizer_files(str(lm_dir), vocab["lm"])
    m = cfg["match"]
    (match_dir / "config.json").write_text(json.dumps(
        dict(m, logit_scale_init_value=4.605170185988092)))
    torch.save({n: w[n].clone() for n, _, _ in clip_family.spec(cfg)},
               match_dir / "pytorch_model.bin")
    inputs.write_bpe_files(str(match_dir), vocab["match"])
    rng = np.random.RandomState(0)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.randint(0, 255, (40, 56, 3), np.uint8)).save(
            images / name)
    return lm_dir, match_dir, images


def test_api_run_ids_equal_the_reference_gibbs_loop(world, tmp_path,
                                                    monkeypatch):
    """``python -m conzic_torch.api.run`` over an SDAR and a CLIP directory
    (fp32, the shuffle order) commits, step by step, the tokens that the
    reference's Gibbs step commits from its own state."""
    from conzic_torch.api import run as api_run

    cfg, fams, vocab, uncut = world
    held = {n for n, _, _ in sdar_family.spec(cfg)}
    w = {n: t for n, t in uncut.items()
         if n in held or not n.startswith(("model.", "lm_head"))}
    lm_dir, match_dir, images = write_dirs(tmp_path, cfg, vocab, w)
    got = {"ids": [], "pixels": []}
    run, encode = Captioner.run, Captioner.encode_images

    def recording_run(self, *a, **kw):
        result = run(self, *a, **kw)
        got["ids"].append(result.iter_ids)
        return result

    def recording_encode(self, pixels, *a, **kw):
        got["pixels"].append(torch.as_tensor(np.asarray(pixels)))
        return encode(self, pixels, *a, **kw)

    monkeypatch.setattr(Captioner, "run", recording_run)
    monkeypatch.setattr(Captioner, "encode_images", recording_encode)
    monkeypatch.chdir(tmp_path)
    L, k, iters, seed = 4, 8, 2, 5
    api_run.main([
        "--device", "cpu", "--lm_model", str(lm_dir), "--match_model",
        str(match_dir), "--caption_img_path", str(images), "--batch_size",
        "2", "--samples_num", "1", "--dtype", "float32", "--attn_impl",
        "xla", "--order", "shuffle", "--sentence_len", str(L),
        "--candidate_k", str(k), "--num_iterations", str(iters),
        "--seed", str(seed)])
    (served,) = got["ids"]
    assert served.shape == (iters, 2, 15 - 10 + L)
    assert list((tmp_path / "results").rglob("best_clipscore.json"))

    lm = sdar_family.reference(w, cfg, vocab["lm"])
    match = clip_family.reference(w, cfg, vocab["match"])
    with torch.inference_mode():
        image = match.image_embeds(got["pixels"][0].float())
        masks = gibbs.token_masks(lm.text, "cpu")
        (perm,) = gibbs.slot_order("shuffle", L, 1, seed)
        init = np.array(lm.text.init_row("Image of a", L))
        state = np.tile(init, (2, 1))
        for i in range(iters):
            for pos in perm:
                col = 4 + int(pos)
                state[:, col] = gibbs.choose_step(
                    lm, match, masks, state, col, pos == L - 1, image, k,
                    0.1, 0.02, 2.0)
            assert served[i].tolist() == state.tolist(), i


def test_captioner_built_by_the_harness_runs_sdar():
    cap = sdar_tiny_captioner()
    assert isinstance(cap.bert_model, sdar.SdarMoeLM)
    assert isinstance(cap.wp, QwenBPETokenizer)
    spec = cap._spec(4, 3, 8, None)
    assert (spec.seed_len, spec.seq_len, spec.mask_token_id) == (
        4, 8, cap.wp.mask_token_id)
