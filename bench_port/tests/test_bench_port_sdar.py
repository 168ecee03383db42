"""SDAR as the proposer family (``families/sdar_moe.py``): found by the
configuration's ``model_type``, the published configuration kept, its
weights named as the program names its parameters and their count and
operations pinned, the expert layer's counts (``counts/lm_experts.py``)
and the per-layer metric that reads them, and a tiny SDAR tree's traced
run correct in fp32, with each planted fault caught."""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_port import run, trace
from bench_port.conftest import TINY_TEXT, TINY_VISION, write_tiny_tree
from bench_port.flops import request_flops

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
SEED = 2 ** 31 + 5
CELL = "sdar30b-l14-batch8"
# the published config.json of JetLM/SDAR-30B-A3B-Chat
PUBLISHED = {
    "attention_bias": False, "decoder_sparse_step": 1, "head_dim": 128,
    "hidden_act": "silu", "hidden_size": 2048, "intermediate_size": 6144,
    "max_position_embeddings": 32768, "max_window_layers": 48,
    "mlp_only_layers": [], "model_type": "sdar_moe",
    "moe_intermediate_size": 768, "norm_topk_prob": True,
    "num_attention_heads": 32, "num_experts": 128, "num_experts_per_tok": 8,
    "num_hidden_layers": 48, "num_key_value_heads": 4, "rms_norm_eps": 1e-06,
    "rope_scaling": None, "rope_theta": 1000000, "sliding_window": None,
    "tie_word_embeddings": False, "use_sliding_window": False,
    "vocab_size": 151936}
TINY_SDAR = dict(vocab_size=2048, hidden_size=64, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=16,
                 moe_intermediate_size=32, num_experts=8,
                 num_experts_per_tok=2, experts_held=4)


def load(sub, name):
    return json.loads((PKG / sub / f"{name}.json").read_text())


def write_sdar_tree(root: Path, lm=None, **traffic) -> Path:
    """The tiny tree with ``tiny``: conzic-sdar30b-l14's configuration at
    tiny widths (``lm``'s changes over ``TINY_SDAR``) in fp32, and
    ``traffic`` over the tiny traffic."""
    write_tiny_tree(root)
    cfg = load("configs", "conzic-sdar30b-l14")
    cfg["name"] = "tiny"
    cfg["lm"].update(TINY_SDAR, **(lm or {}))
    cfg["match"]["projection_dim"] = 32
    cfg["match"]["text_config"].update(TINY_TEXT)
    cfg["match"]["vision_config"].update(TINY_VISION)
    cfg["run"]["dtype"] = "float32"
    pkg = root / "bench_port"
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    path = pkg / "traffic" / "tiny.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), **traffic}))
    return root


def test_the_family_is_found_by_model_type():
    cell = run.Cell(ROOT, CELL)
    assert Path(cell.families["lm"].__file__).name == "sdar_moe.py"
    assert Path(cell.families["match"].__file__).name == "clip.py"
    assert cell.traffic["images_per_request"] == 8
    assert cell.chips == 1
    # the rate, memory and set-up; CLIP L/14's per-layer metrics as in
    # l14-batch32, and the expert layer's rows
    assert [m["name"] for m in cell.end_to_end] == [
        "caps_per_s", "peak_mem_gib", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "launches_per_step", "matmul_ms_per_step", "elementwise_ms_per_step",
        "layer_norm_roofline", "idle_share", "mfu", "quick_gelu_roofline",
        "weights_gib", "dot_product_attention_roofline",
        "lm_expert_rows_per_step"]


def test_the_published_config_is_kept():
    """The top level is the published config.json, ``lm`` the same dict,
    with the device's share of the experts beside it; the matcher and the
    run are conzic-l14's."""
    cfg = load("configs", "conzic-sdar30b-l14")
    for key, value in PUBLISHED.items():
        assert cfg[key] == value == cfg["lm"][key], key
    assert cfg["lm"] == {k: cfg[k] for k in cfg["lm"]}
    assert (cfg["lm"]["experts_held"], cfg["lm"]["expert_offset"]) == (16, 0)
    assert cfg["reduced"] == ["experts_held", "expert_offset"]
    l14 = load("configs", "conzic-l14")
    assert (cfg["match"], cfg["run"], cfg["weights"]) == (
        l14["match"], l14["run"], l14["weights"])
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [c for c in bench["configs"] if c["name"] == cfg["name"]]
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]


def test_spec_names_the_programs_parameters():
    """Every parameter of the program's model has its checkpoint names in
    the spec, with as many elements, and the spec names nothing else."""
    from conzic_torch.models.configs import SdarMoeConfig
    from conzic_torch.models.convert import hf_names
    from conzic_torch.models.sdar import SdarMoeLM

    cfg = {"lm": {**load("configs", "conzic-sdar30b-l14")["lm"],
                  **TINY_SDAR, "expert_offset": 2}}
    spec = {n: math.prod(s) for n, s, _ in
            run.families(ROOT, load("configs", "conzic-sdar30b-l14"))[
                "lm"].spec(cfg)}
    model = SdarMoeLM(SdarMoeConfig.from_hf_dict(cfg["lm"]))
    named = set()
    for name, p in model.named_parameters():
        (key,) = hf_names(model, name)
        parts = key if isinstance(key, tuple) else (key,)
        assert sum(spec[part] for part in parts) == p.numel(), name
        named.update(parts)
    assert named == set(spec)
    assert "model.layers.1.mlp.experts.5.down_proj.weight" in spec
    assert "model.layers.1.mlp.experts.6.down_proj.weight" not in spec


def test_weights_and_request_flops_are_pinned():
    cfg = load("configs", "conzic-sdar30b-l14")
    fams = run.families(ROOT, cfg)
    n = sum(math.prod(shape) for _, shape, _ in fams["lm"].spec(cfg))
    # 48 layers of 94,638,336 (attention 18,878,720, norms 4,352, router
    # 262,144, 16 experts 75,497,472), the embedding and head 2 x
    # 311,164,928, the final norm 2,048
    assert n == 48 * 94_638_336 + 2 * 311_164_928 + 2048 == 5_164_972_032
    both = n + sum(math.prod(s) for _, s, _ in fams["match"].spec(cfg))
    assert both == 5_592_588_545  # CLIP ViT-L/14: 427,616,513
    assert both * 4 / 2 ** 30 == 20.83401584997773  # weights_gib
    traffic = load("traffic", "batch8")
    step = fams["lm"].flops(cfg, traffic)["step"]
    # a token: projections 37,748,736, router 524,288, 8 x 16 / 128
    # routed rows of 9,437,184; a row of 15: 141 keys seen in all, 4 x
    # 4,096 each; 8 rows x 48 layers; the head 8 x 2 x 2,048 x 151,936
    row = 15 * (37_748_736 + 524_288 + 9_437_184) + 4 * 4096 * 141
    assert step == 8 * 48 * row + 8 * 2 * 2048 * 151936 == 280_676_532_224
    every = dict(cfg, lm=dict(cfg["lm"], experts_held=128))
    assert (fams["lm"].flops(every, traffic)["step"] - step
            == 8 * 48 * 15 * 7 * 9_437_184)
    assert request_flops(cfg, traffic, fams) == (
        100 * (step + fams["match"].flops(cfg, traffic)["step"])
        + fams["match"].flops(cfg, traffic)["sample"]
        + fams["match"].flops(cfg, traffic)["request"])


def expert_call(offset=4):
    """A forward's routing over 2 layers of 3 tokens, top 2, of a model
    holding experts 4 to 7 of 16 (E 16, I 8, bf16)."""
    from conzic_torch.models.configs import SdarMoeConfig

    routes = torch.tensor([[[4, 0], [7, 5], [1, 2]],
                           [[8, 3], [6, 4], [9, 10]]])
    config = SdarMoeConfig(vocab_size=32, hidden_size=16, num_layers=2,
                           num_heads=2, num_kv_heads=1, head_dim=8,
                           moe_intermediate_size=8, num_experts=16,
                           num_experts_per_tok=2, experts_held=4,
                           expert_offset=offset)
    model = SimpleNamespace(config=config, dtype=torch.bfloat16)
    return model, routes


def test_counts_record_and_cost():
    from conzic_torch.models import sdar

    mod = run.load_module(PKG / "counts" / "lm_experts.py")
    assert mod.TARGETS == ("conzic_torch.models.sdar:held_rows",)
    model, routes = expert_call()
    rec = mod.record((model, routes), {})
    by_name = mod.record((model,), {"routes": routes})
    assert (by_name["offset"], by_name["held"], by_name["width"],
            by_name["layers"], by_name["tokens"]) == (
        rec["offset"], rec["held"], rec["width"], rec["layers"],
        rec["tokens"]) == (4, 4, 8, 2, 3)
    # a copy: the program's next forward may overwrite its routing
    routes.fill_(5)
    # experts 4 to 7 held: 4, 7, 5, 6, 4 routed to them
    assert mod.rows(rec) == 5
    assert int(sdar.held_rows(model, rec["routes"])) == 5
    flops, nbytes = mod.cost(rec)
    assert flops == 5 * 3 * 2 * 16 * 8
    assert nbytes == 2 * (3 * 4 * 16 * 8 * 2 + 2 * 3 * 16 * 2)


def test_the_metric_reads_the_calls():
    reader = run.metric_reader(ROOT, "lm_expert_rows_per_step")
    mod = run.load_module(PKG / "counts" / "lm_experts.py")
    rec = mod.record(expert_call(), {})
    tr = SimpleNamespace(counts={"lm_experts": mod},
                         calls={"lm_experts": [rec, rec, rec]}, steps=2)
    assert reader(tr) == 15 / 2
    assert reader(SimpleNamespace(counts={"lm_experts": mod},
                                  calls={"lm_experts": []}, steps=2)) is None
    assert reader(SimpleNamespace(counts={}, calls={}, steps=2)) is None


def test_no_target_without_the_programs_entry(monkeypatch):
    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    mod = run.load_module(PKG / "counts" / "lm_experts.py")
    assert mod.TARGETS == ()


def test_tiny_traced_run_reads_the_routed_rows(tmp_path, one_thread):
    """Every expert held: each step routes every token to its top 2 in
    each layer, 2 rows x 7 positions x 2 x 2 layers."""
    root = write_sdar_tree(tmp_path, lm={"experts_held": 8},
                           sentence_len=2, iterations=1, check_steps=2)
    result = run.run(run.Cell(root, "tiny-cell"), SEED, 0, True, "cpu")
    assert result["correct"] is True, result["checked"]
    assert result["metrics"]["lm_expert_rows_per_step"]["value"] == 56


def test_tiny_sdar_run_is_correct(tmp_path, one_thread):
    cell = run.Cell(write_sdar_tree(tmp_path), "tiny-cell")
    result = run.run(cell, SEED, 0, False, "cpu", requests=2)
    assert result["correct"] is True, result["checked"]


@pytest.mark.parametrize("fault", ["half_batch", "token_altered"])
def test_tiny_sdar_check_catches_planted_faults(tmp_path, one_thread,
                                                monkeypatch, fault):
    from bench_port import faults

    cell = run.Cell(write_sdar_tree(tmp_path), "tiny-cell")
    faults.FAULTS[fault](monkeypatch.setattr)
    result = run.run(cell, SEED, 0, False, "cpu", requests=2)
    assert result["correct"] is False


def test_the_tiny_trees_count_the_expert_layer(tmp_path):
    assert "lm_experts" in trace.counts_modules(write_tiny_tree(tmp_path))
