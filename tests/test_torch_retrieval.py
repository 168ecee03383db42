"""The port's retrieval baseline (``conzic_torch/api/retrieval.py``) against
``conzic_tpu``'s, on the CPU.

The retrieval tests of ``tests/test_api_eval.py`` on the port, over the
same fp32 towers as the reference's (``trained_tiny/``): the index files
in the reference's format (one whitespace-separated vector per line, the
``{row: caption}`` mapping), every vector within the towers' 2e-4 of the
reference's, the trailing partial batch indexed, the same nearest caption
for every image, and the command lines with an unreadable image skipped
and counted.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu.api import retrieval as jax_retrieval
from conzic_torch.api import retrieval
from test_torch_engine import _base_pair

TOL = dict(rtol=2e-4, atol=2e-4)
CORPUS = ["a girl playing with a dog", "the beach at sunset",
          "a cat sitting on grass", "a man riding a horse",
          "two dogs running in the park"]


@pytest.fixture(scope="module")
def pair():
    return _base_pair("trained_tiny")


def _write_images(d, n, seed=6):
    rng = np.random.RandomState(seed)
    d.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (50, 60, 3), dtype=np.uint8)
                        ).save(d / f"q{i}.jpg")
    return sorted(os.listdir(d))


def test_index_files_match_reference(pair, tmp_path):
    jc, pc = pair
    (tmp_path / "corpus.json").write_text(json.dumps(CORPUS))
    jax_retrieval.build_index(jc, str(tmp_path / "corpus.json"),
                              str(tmp_path / "want"), batch_size=2)
    emb = retrieval.build_index(pc, str(tmp_path / "corpus.json"),
                                str(tmp_path / "got"), batch_size=2)
    assert emb.shape == (len(CORPUS), pc.clip_model.config.projection_dim)
    lines = (tmp_path / "got" / "index_matrix.txt").read_text().split("\n")
    assert lines[-1] == "" and len(lines) == len(CORPUS) + 1  # 5 of 2+2+1
    got = np.asarray([[float(x) for x in ln.split(" ")]
                      for ln in lines[:-1]], np.float32)
    want = np.loadtxt(tmp_path / "want" / "index_matrix.txt",
                      dtype=np.float32)
    np.testing.assert_array_equal(got, emb)
    np.testing.assert_allclose(got, want, **TOL)
    for name in ("mapping_dict.json",):
        assert ((tmp_path / "got" / name).read_text()
                == (tmp_path / "want" / name).read_text())
    assert json.loads((tmp_path / "got" / "mapping_dict.json").read_text()
                      ) == {str(i): t for i, t in enumerate(CORPUS)}


@pytest.mark.parametrize("corpus", [
    {"a": "one", "b": "two"},
    [{"caption": "one"}, {"caption": "two"}, "three"],
])
def test_corpus_layouts(corpus, tmp_path):
    path = tmp_path / "c.json"
    path.write_text(json.dumps(corpus))
    texts = retrieval.corpus_texts(str(path))
    assert texts[:2] == ["one", "two"]


def test_index_roundtrip_and_search_match_reference(pair, tmp_path):
    jc, pc = pair
    (tmp_path / "corpus.json").write_text(json.dumps(CORPUS))
    retrieval.build_index(pc, str(tmp_path / "corpus.json"),
                          str(tmp_path / "index"), batch_size=3)
    paths = [str(tmp_path / "imgs" / n)
             for n in _write_images(tmp_path / "imgs", 4)]
    files = [str(tmp_path / "index" / n) for n in ("index_matrix.txt",
                                                   "mapping_dict.json")]
    index = retrieval.CLIPIndex(*files, pc)
    want_index = jax_retrieval.CLIPIndex(*files, jc)
    assert index.matrix.shape == (len(CORPUS),
                                  pc.clip_model.config.projection_dim)
    np.testing.assert_allclose(np.linalg.norm(index.matrix, axis=1), 1.0,
                               rtol=1e-6)
    vec = index.matrix[1]
    assert index.mapping[str(int(np.argmax(vec @ index.matrix.T)))] == \
        CORPUS[1]
    for p in paths:
        np.testing.assert_allclose(index.get_image_representation(p),
                                   want_index.get_image_representation(p),
                                   **TOL)
        assert index.search_text(p) == want_index.search_text(p)


def test_retrieval_cli_end_to_end(pair, tmp_path, monkeypatch):
    """build_index_main then retrieval_main: the index and the predictions
    files; the missing image is skipped and counted."""
    _, pc = pair
    (tmp_path / "corpus.json").write_text(json.dumps(CORPUS))
    names = _write_images(tmp_path / "imgs", 2)
    (tmp_path / "test.json").write_text(json.dumps(
        [{"image_name": names[0]}, {"image_name": "missing.jpg"},
         names[1]]))
    monkeypatch.setattr(retrieval, "_make_captioner", lambda args: pc)
    retrieval.build_index_main([
        "--text_file_path", str(tmp_path / "corpus.json"),
        "--save_index_prefix", str(tmp_path / "index"),
        "--batch_size", "2", "--device", "cpu"])
    retrieval.retrieval_main([
        "--index_matrix_path", str(tmp_path / "index" / "index_matrix.txt"),
        "--mapping_dict_path", str(tmp_path / "index" / "mapping_dict.json"),
        "--test_image_prefix_path", str(tmp_path / "imgs"),
        "--test_path", str(tmp_path / "test.json"),
        "--save_path_prefix", str(tmp_path / "out"), "--device", "cpu"])
    with open(tmp_path / "out" / "retrieval_result.json") as f:
        preds = json.load(f)
    assert [p["image_name"] for p in preds] == names
    assert all(p["prediction"] in CORPUS for p in preds)


def test_retrieval_entry_points_run_on_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA is available: the default device is usable")
    (tmp_path / "corpus.json").write_text(json.dumps(CORPUS))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        retrieval.build_index_main([
            "--text_file_path", str(tmp_path / "corpus.json"),
            "--save_index_prefix", str(tmp_path / "index"),
            "--random_models", "tiny"])
    retrieval.build_index_main([
        "--text_file_path", str(tmp_path / "corpus.json"),
        "--save_index_prefix", str(tmp_path / "index"),
        "--random_models", "tiny", "--device", "cpu"])
    assert len((tmp_path / "index" / "index_matrix.txt").read_text()
               .splitlines()) == len(CORPUS)
