"""The plain reference: float32 against a float64 run of itself at tiny
widths, its text rules, and what it imports."""

import ast
import subprocess
import sys
from pathlib import Path

import torch

from bench_port import inputs
from bench_port.conftest import TINY_LM, TINY_TEXT, TINY_VISION
from bench_port.reference.models import Reference, fp32_only
from bench_port.reference.text import ClipBpe, WordPiece, body, clip_row

PKG = Path(__file__).resolve().parents[1]
ROOT = PKG.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "conzic_tpu"}


def tiny_reference(dtype):
    import json
    cfg = json.loads((PKG / "configs" / "conzic-b32.json").read_text())
    cfg["lm"].update(TINY_LM)
    cfg["match"]["projection_dim"] = 32
    cfg["match"]["text_config"].update(TINY_TEXT)
    cfg["match"]["vision_config"].update(TINY_VISION)
    spec = inputs.bert_spec(cfg["lm"]) + inputs.clip_spec(cfg["match"])
    w = inputs.make_weights(spec, 7, "cpu", {"logit_scale": 4.6052})
    w = {k: v.to(dtype) for k, v in w.items()}
    bpe = ClipBpe(*inputs.clip_bpe(TINY_TEXT["vocab_size"]))
    return Reference(w, cfg["lm"], cfg["match"], bpe.eos), cfg, bpe


def test_float32_reference_agrees_with_float64():
    r32, cfg, bpe = tiny_reference(torch.float32)
    r64, _, _ = tiny_reference(torch.float64)
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(5, 600, (3, 9), generator=gen)
    slot = torch.tensor([1, 4, 8])
    px = torch.rand(2, 64, 64, 3, generator=gen)
    text = torch.randint(0, 150, (4, 12), generator=gen)
    text[:, 7] = bpe.eos
    n = torch.tensor([8, 8, 8, 8])
    with fp32_only():
        pairs = [(r32.bert_logits(ids, slot), r64.bert_logits(ids, slot)),
                 (r32.image_embeds(px), r64.image_embeds(px.double())),
                 (r32.text_embeds(text, n), r64.text_embeds(text, n))]
    for a, b in pairs:
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        scale = b.abs().max()
        assert (a.double() - b).abs().max() <= 1e-5 * scale


def test_bpe_and_rows():
    v, merges = inputs.clip_bpe(49408)
    bpe = ClipBpe(v, merges)
    # CLIP's layout: 256 bytes, their word ends, 48,894 merges, 2 specials
    assert len(v) == 49408 and len(merges) == 48894
    assert (bpe.bos, bpe.eos) == (49406, 49407)
    assert v["!"] == 0 and v["!</w>"] == 256
    assert bpe.word("image") == [v["image</w>"]]
    assert bpe.word("of") == [v["of</w>"]]
    assert bpe.word(".") == [v[".</w>"]]
    assert len(bpe.word("zzzz")) > 1  # not every letter string is a piece
    wp = WordPiece(inputs.wordpiece_vocab(600))
    row, n = clip_row(wp, bpe, wp.encode_words("image of a"), 32)
    assert n == 5 and row[0] == bpe.bos and row[4] == bpe.eos
    assert row[5:] == [bpe.pad] * 27
    long, n = clip_row(wp, bpe, wp.encode_words("image " * 20), 12)
    assert n == 12 and long[-1] == bpe.eos  # pieces past the context drop


def test_every_caption_word_is_one_clip_piece_in_both_tokenizers(tmp_path):
    # a candidate's whole caption reaches the text tower: each word that
    # a caption may use is one piece, in the reference's BPE and in the
    # program's tokenizer reading the files the program is given
    from conzic_torch.text.bpe import CLIPBPETokenizer

    bpe = ClipBpe(*inputs.clip_bpe(49408))
    prog = CLIPBPETokenizer.from_files(
        *inputs.write_bpe_files(str(tmp_path), inputs.clip_bpe(49408)))
    assert prog.vocab_size == 49408 and prog.eos_token_id == bpe.eos
    wp = WordPiece(inputs.wordpiece_vocab(30522))
    words = [body(t) for i, t in wp.tokens.items()
             if wp.allowed(i, last_slot=True)]
    assert len(words) > 9000
    for w in words:
        assert len(bpe.word(w)) == 1, w
        assert prog.encode_word_ids(w) == bpe.word(w), w


def test_decode_and_rules():
    wp = WordPiece({"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "[MASK]": 3,
                    "a": 4, "##b": 5, ".": 6, "x1": 7})
    assert wp.decode([1, 4, 5, 4, 6, 2]) == "ab a."
    assert wp.allowed(5, False) and not wp.allowed(7, False)
    assert wp.allowed(6, True) and not wp.allowed(6, False)
    assert not wp.allowed(3, True)


def imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        for name in imported_modules(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN | {"conzic_torch"}, (path, name)
            assert top in {"torch", "numpy", "bench_port", "__future__",
                           "re", "math", "contextlib", "dataclasses",
                           "typing"}, (path, name)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in PKG.rglob("*.py"):
        for name in imported_modules(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_a_run_loads_no_jax(tmp_path):
    # a whole tiny run in a fresh interpreter, then sys.modules by whole
    # top-level name: conzic_torch shares its first letters with conzic_tpu
    from bench_port.conftest import write_tiny_tree

    root = write_tiny_tree(tmp_path)
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from pathlib import Path\n"
        "from bench_port import run\n"
        f"cell = run.Cell(Path({str(root)!r}), 'tiny-cell')\n"
        "r = run.run(cell, 5, 0, False, 'cpu', requests=1)\n"
        "assert r['correct'], r\n"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(out.stdout.split())
    assert "conzic_torch" in top and not top & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from bench_port import run

    monkeypatch.setitem(sys.modules, "conzic_tpux", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "conzic_tpu.engine", sys)
    assert run.forbidden_modules() == ["conzic_tpu"]
