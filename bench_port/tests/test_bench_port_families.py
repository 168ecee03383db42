"""The tower families (``bench_port/families/``): found by the
configuration's ``model_type``, a new one taken as a new file alone, and
every input, count and reading of the two measured configurations as it
was when the harness named BERT and CLIP itself (the pinned values were
computed by the harness before the families, from the same seeds)."""

import ast
import hashlib
import json
import shutil
from pathlib import Path

import pytest

from bench_port import inputs, run
from bench_port.conftest import TINY_LIMITS
from bench_port.flops import request_flops

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
SEED = 2 ** 31 + 5


def load(sub, name):
    return json.loads((PKG / sub / f"{name}.json").read_text())


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@pytest.mark.parametrize("config, want", [
    ("conzic-b32", 1370023579222016.0),
    ("conzic-l14", 3070574836973568.0),
])
def test_request_flops_are_unchanged(config, want):
    cfg = load("configs", config)
    got = request_flops(cfg, load("traffic", "batch32"),
                        run.families(ROOT, cfg))
    assert got == want


def test_tiny_inputs_are_unchanged(tiny_root):
    cell = run.Cell(tiny_root, "tiny-cell")
    cfg, fams = cell.config, cell.families
    seeds = inputs.Seeds(SEED)
    assert seeds.weights == 5670043250485142718
    assert seeds.request(0) == (59540299, 916123820)
    assert seeds.request(1) == (881808062, 4030011059)
    spec = fams["lm"].spec(cfg) + fams["match"].spec(cfg)
    w = inputs.make_weights(spec, seeds.weights, "cpu", cfg["weights"])
    h = hashlib.sha256()
    for name in sorted(w):
        h.update(name.encode())
        h.update(w[name].contiguous().numpy().tobytes())
    assert h.hexdigest() == (
        "c601390b20fefef3430447c914d7e7214d206205e0184829516a6db86afb1d39")
    assert sha256(json.dumps(fams["lm"].vocab(cfg)).encode()) == (
        "3c5bc6aa58f13b84b91884ee962d20ea36c8be7cb455ada3a2ccf6fb47dcaad0")
    assert sha256(json.dumps(fams["match"].vocab(cfg)).encode()) == (
        "3ad625a6e6359682ecd6a88db5db767ec1dfa563ac45ab19ae28d5d266127d25")
    px = fams["match"].pixels(cfg, 123, 2, "cpu")
    assert sha256(px.numpy().tobytes()) == (
        "f5e107db93bc6fa36015f4dcc4e8e5a2fc322b214ca0431bdee95fe645c0df52")


def test_tiny_fp32_readings_are_unchanged(tiny_root, one_thread):
    cell = run.Cell(tiny_root, "tiny-cell")
    result = run.run(cell, SEED, 0, False, "cpu", requests=2)
    assert result["correct"] is True
    assert result["readings"] == {
        "image_embed_err": 1.9525933225850167e-07,
        "text_cos_err": 1.1920928955078125e-07,
        "lm_gap_mean": 0.0, "commit_gap_mean": 0.0,
        "commit_gap_step_median": 0.0,
        "frame_errors": 0.0, "text_errors": 0.0}


def set_match(root: Path, **changes) -> None:
    path = root / "bench_port" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    for key, value in changes.items():
        if value is None:
            cfg["match"].pop(key, None)
        else:
            cfg["match"][key] = value
    path.write_text(json.dumps(cfg))


def test_the_tiny_tree_copies_the_families(tiny_root):
    got = sorted(p.name for p in
                 (tiny_root / "bench_port" / "families").glob("*.py"))
    assert got == sorted(p.name for p in (PKG / "families").glob("*.py"))
    assert {"bert.py", "clip.py"} <= set(got)


def test_a_matcher_family_is_found_by_its_model_type(tiny_root, one_thread,
                                                     capsys):
    # a new matcher is one new file and its configuration's model_type:
    # no file of the harness is edited, and clip.py is not there to use
    families = tiny_root / "bench_port" / "families"
    shutil.copy(families / "clip.py", families / "toyclip.py")
    (families / "clip.py").unlink()
    with open(families / "toyclip.py", "a", encoding="utf-8") as f:
        f.write("\n\nimport sys as _sys\n_vocab = vocab\n\n\n"
                "def vocab(config):\n"
                "    print('toyclip vocab', file=_sys.stderr)\n"
                "    return _vocab(config)\n")
    set_match(tiny_root, model_type="toyclip")
    argv = ["--workload", "tiny-cell", "--seed", str(SEED), "--seconds",
            "0.2", "--trace", "0"]
    assert run.main(argv, root=tiny_root, device="cpu") == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checked"]
    assert "toyclip vocab" in out.err


@pytest.mark.parametrize("model_type, named", [
    ("siglipx", "bench_port/families/siglipx.py"),
    (None, "bench_port/families/<model_type>.py"),
])
def test_an_unknown_or_missing_model_type_exits(tiny_root, model_type,
                                                named):
    set_match(tiny_root, model_type=model_type)
    with pytest.raises(SystemExit) as exit_info:
        run.Cell(tiny_root, "tiny-cell")
    message = str(exit_info.value.code)
    assert named in message and "configs/tiny.json" in message


def test_clip_with_exact_gelu_agrees_with_its_reference(tiny_root,
                                                        one_thread):
    # OpenCLIP's towers use erf GELU: the reference follows hidden_act
    path = tiny_root / "bench_port" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    for tower in ("text_config", "vision_config"):
        cfg["match"][tower]["hidden_act"] = "gelu"
    path.write_text(json.dumps(cfg))
    cell = run.Cell(tiny_root, "tiny-cell")
    result = run.run(cell, SEED, 0, False, "cpu", requests=2)
    assert result["correct"] is True, result["checked"]
    assert set(cell.limits) == set(TINY_LIMITS)


# the names that are one family's own: outside bench_port/families/ only
# the module that defines one may name it
FAMILY_NAMES = {"bert_spec", "clip_spec", "wordpiece_vocab", "clip_bpe",
                "ClipBpe", "clip_row", "Reference", "bert_logits",
                "logit_scale", "CLIPBPETokenizer", "WordPieceTokenizer",
                "BertConfig", "CLIPConfig"}


def named(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            yield from (a.name.split(".")[-1] for a in node.names)


def defined(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            yield node.name


def test_only_the_families_name_a_family():
    for path in PKG.rglob("*.py"):
        rel = path.relative_to(PKG).parts
        if rel[0] in ("families", "tests"):
            continue
        tree = ast.parse(path.read_text())
        found = (set(named(tree)) & FAMILY_NAMES) - set(defined(tree))
        assert not found, (path, found)
