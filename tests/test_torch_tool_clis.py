"""Each study of ``conzic_torch/tools/`` through its ``main`` at its CPU
smoke size, on the committed ``trained_tiny/`` (or tiny random towers):
the file it writes has the keys of the reference tool's output (the
schemas below, read off ``tools/*.py``) and a ``device`` field; the
refusal of ``--topk_mode approx``; a CPU run diverted from the record the
bench reads; and no committed JSON record written by any of it.
"""

import glob
import hashlib
import json
import os

import pytest
from PIL import Image

from _torch_port import TRAINED_TINY, one_torch_thread  # noqa: F401
from conzic_torch.data.synthetic import build_dataset
from conzic_torch.tools import approx_quality_cells as aq
from conzic_torch.tools import control_efficacy as ce
from conzic_torch.tools import ctl_table_vs_exact as ct
from conzic_torch.tools import factorized_fidelity as ff
from conzic_torch.tools import host_feed_ceiling as hf
from conzic_torch.tools import sketchycoco_bench as sk
from conzic_torch.tools import trained_quality_cells as tq
from conzic_torch.tools import validate_pruning as vp
from conzic_torch.tools import validate_quant as vq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = {"caption_exact", "token_agreement", "best_cosine_delta", "speedup",
        "session"}
TINY = ["--n_images", "2", "--iters", "2", "--sentence_len", "5"]


@pytest.fixture(autouse=True)
def committed_records_untouched():
    """Every committed JSON record (the reference's at the root, the
    checkpoints' metadata, the port's records_torch/) is the same after
    the test as before it."""
    paths = sorted(glob.glob(os.path.join(REPO, "*.json"))
                   + glob.glob(os.path.join(REPO, "trained_*", "*.json"))
                   + glob.glob(os.path.join(REPO, "records_torch", "*.json")))

    def digests():
        out = {}
        for p in paths:
            with open(p, "rb") as f:
                out[p] = hashlib.sha256(f.read()).hexdigest()
        return out

    before = digests()
    yield
    assert digests() == before


def load(path):
    with open(path) as f:
        return json.load(f)


def test_validate_pruning_matrix(tmp_path):
    out = tmp_path / "m.json"
    vp.main(["--random_models", "tiny", "--matrix", "--cpu", *TINY,
             "--k", "16", "--prune_k", "4", "--out", str(out)])
    doc = load(out)
    # tools/validate_pruning.py:336-345, the captioner object of its
    # config's "cap_pruned" left out
    assert set(doc) == {"weights", "config", "cells",
                        "worst_best_cosine_delta", "device"}
    assert set(doc["config"]) == {"n_images", "sentence_len", "iters", "k",
                                  "topk_mode", "clip_len"}
    assert doc["weights"] == "random-tiny" and doc["device"] == "cpu"
    assert len(doc["cells"]) == 11  # 15 jobs less the 4 with prune_k >= k
    assert all(set(c) == CELL for c in doc["cells"].values())


def test_trained_quality_cells_and_the_merge_tool(tmp_path):
    out = tmp_path / "m.json"
    tq.main(["--checkpoint", TRAINED_TINY, "--prune_k", "3", "--cpu",
             *TINY, "--k", "16", "--out", str(out)])
    doc = load(out)
    # tools/trained_quality_cells.py:218-292
    assert set(doc) == {"cells", "trained", "device"}
    trained = doc["trained"]
    assert set(trained) == {"weights", "cells", "checkpoint",
                            "checkpoint_note", "validation", "train_meta",
                            "config", "session", "worst_best_cosine_delta",
                            "device"}
    (key, cell), = trained["cells"].items()
    # the default --topk_mode approx runs, and is keyed as, the exact point
    assert key == "sequential/free/prune3@n2+CPU-SMOKE"
    assert set(cell) == CELL | {"checkpoint", "tower_layers",
                                "best_cos_full", "best_cos_pruned",
                                "attr_recall_full", "attr_recall_pruned"}
    # tools/approx_quality_cells.py:103-134, merged into the same file
    aq.main(["--cpu", "--topk_mode", "exact", "--prune_k", "4",
             "--final_exact", "--out", str(out)])
    doc = load(out)
    assert set(doc) == {"cells", "trained", "device",
                        "worst_best_cosine_delta"}
    assert list(doc["cells"]) == [
        "sequential/free/prune4+final_exact+CPU-SMOKE"]
    assert set(doc["cells"]["sequential/free/prune4+final_exact+CPU-SMOKE"]
               ) == CELL
    assert doc["trained"]["cells"].keys() == trained["cells"].keys()


@pytest.mark.parametrize("main", [
    lambda out: aq.main(["--cpu", "--out", out]),
    lambda out: vp.main(["--random_models", "tiny", "--cpu", "--topk_mode",
                         "approx", "--out", out]),
])
def test_approx_is_refused(tmp_path, capsys, main):
    out = str(tmp_path / "m.json")
    with pytest.raises(SystemExit) as e:
        main(out)
    assert e.value.code == 2
    assert "conzic_torch runs the exact top-k" in capsys.readouterr().err
    assert not os.path.exists(out)


def test_factorized_fidelity(tmp_path):
    out = tmp_path / "f.json"
    ff.main(["--checkpoint", TRAINED_TINY, "--cpu", "--n_images", "2",
             "--k", "48", "--slots", "1", "--calib_n", "64",
             "--out", str(out)])
    doc = load(out)
    # tools/factorized_fidelity.py:204-216
    assert set(doc) == {"checkpoint", "n_images", "k", "slots_per_image",
                        "calibration_cos", "scorers", "device"}
    assert set(doc["scorers"]) == {"trunc1", "trunc2", "proxy", "random"}
    for per_m in doc["scorers"].values():
        assert set(per_m) == {"3", "5", "10"}
        assert all(set(v) == {"recall", "mean_regret", "p90_regret"}
                   for v in per_m.values())


def test_ctl_table_vs_exact(tmp_path):
    out = tmp_path / "c.json"
    ct.main(["--checkpoint", TRAINED_TINY, "--cpu", "--n_images", "2",
             "--iters", "1", "--sentence_len", "4", "--k", "8",
             "--out", str(out)])
    doc = load(out)
    # tools/ctl_table_vs_exact.py:90-128
    assert set(doc) == {"checkpoint", "config", "session", "results",
                        "device"}
    assert set(doc["config"]) == {"n_images", "iters", "sentence_len", "k",
                                  "gamma", "scene_seed"}
    assert set(doc["results"]) == {"sentiment", "pos"}
    for cell in doc["results"].values():
        assert set(cell) == {
            "caption_exact", "token_agreement",
            "best_cosine_delta_exact_minus_table", "ctl_score_final_table",
            "ctl_score_final_exact", "final_captions_table",
            "final_captions_exact"}


def test_control_efficacy(tmp_path):
    out = tmp_path / "e.json"
    ce.main(["--checkpoint", TRAINED_TINY, "--cpu", "--n_images", "2",
             "--iters", "1", "--sentence_len", "4", "--k", "16",
             "--out", str(out)])
    doc = load(out)
    # tools/control_efficacy.py:259-291
    assert set(doc) == {"checkpoint", "tower_layers", "config",
                        "vocab_caveat", "session", "results", "device"}
    assert set(doc["config"]) == {"n_images", "n_samples", "iters",
                                  "sentence_len", "k", "gamma", "scene_seed",
                                  "template", "tiers", "stage1_ctl"}
    assert list(doc["results"]) == [
        "free/full", "free/fact17pc24", "sent_pos/full",
        "sent_pos/fact50pc96+ctlrank", "sent_neg/full",
        "sent_neg/fact50pc96+ctlrank", "pos/full",
        "pos/fact50pc96+ctlrank"]
    for entry in doc["results"].values():
        assert set(entry) == {
            "best_cos_mean", "sentiment_mean", "positive_word_rate",
            "negative_word_rate", "pos_template_accuracy", "div_1", "div_2",
            "vocab_len", "final_captions_sample", "best_captions_sample"}


def test_host_feed_reads_only_the_port_ladder(tmp_path, monkeypatch):
    """The default record of a CPU run goes to its .cpu-smoke.json twin;
    cards per host come from the port's ladder record only, and without
    one the record holds the feed rate alone."""
    default = tmp_path / "HOST_FEED.json"
    monkeypatch.setattr(hf, "OUT_PATH", str(default))
    monkeypatch.setattr(hf, "LADDER_PATH", str(tmp_path / "LADDER.json"))
    args = ["--cpu", "--n_images", "8", "--batch_size", "4", "--repeats",
            "2", "--width", "64", "--height", "48"]
    hf.main(args)
    assert not default.exists()
    doc = load(str(default) + ".cpu-smoke.json")
    # tools/host_feed_ceiling.py:127-148
    assert set(doc) == {"images_per_sec_host_pipeline", "per_pass",
                        "config", "max_chips_per_host", "note", "device"}
    assert set(doc["config"]) == {"n_images", "batch_size", "jpeg",
                                  "image_size", "prefetch_depth", "workers",
                                  "host"}
    assert doc["max_chips_per_host"] == {} and doc["device"] == "cpu"
    with open(tmp_path / "LADDER.json", "w") as f:
        json.dump({"device": "card", "headline": {
            "pallas": {"caps_per_s": 4.0}}, "points": [
            {"name": "flagship", "caps_per_s": 25.0}]}, f)
    hf.main(args)
    chips = load(str(default) + ".cpu-smoke.json")["max_chips_per_host"]
    assert list(chips) == ["full parity pallas (4.0 caps/s, card)",
                           "flagship (25.0 caps/s, card)"]


def test_sketchycoco_bench(tmp_path, monkeypatch):
    images = tmp_path / "scenes"
    images.mkdir()
    imgs, _, _ = build_dataset(4, seed=1)
    for i, img in enumerate(imgs):
        Image.fromarray(img).save(images / f"scene_{i}.png")
    monkeypatch.chdir(tmp_path)  # the runner writes logger/ and results/
    sk.main(["--images", str(images), "--cpu", "--lm_model", TRAINED_TINY,
             "--match_model", TRAINED_TINY, "--iters", "2", "--k", "16",
             "--sentence_len", "5", "--samples", "2", "--batch_size", "2",
             "--out", "sk"])
    doc = load(tmp_path / "sk" / "report.json")
    # tools/sketchycoco_bench.py:104-111
    assert set(doc) == {"images", "samples", "captions_per_sec_incl_compile",
                        "div_1", "div_2", "vocab_len", "device"}
    assert doc["images"] == 4 and doc["samples"] == 2


def test_validate_quant_prints_its_lines(capsys):
    vq.main(["--random_models", "tiny", "--cpu", *TINY, "--k", "16"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [
        "tier", "caption exact-match", "token agreement",
        "best-cosine delta (full - int8)", "speedup"]
