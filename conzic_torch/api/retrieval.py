"""The CLIP text index and the nearest-caption retrieval baseline: the
counterpart of ``conzic_tpu.api.retrieval``.

    python -m conzic_torch.api.retrieval ...   (see build_index_main,
    retrieval_main; console scripts conzic-torch-build-index and
    conzic-torch-retrieval)

In the reference's artifact formats:

  - :func:`build_index`: a corpus JSON (a list of captions, a mapping, or
    records with a ``caption``) -> CLIP text embeddings written as one
    whitespace-separated vector per line (``index_matrix.txt``) and the
    ``{row: caption}`` mapping (``mapping_dict.json``);
  - :class:`CLIPIndex`: the index with its rows normalised; the nearest
    caption of an image is the argmax of ``image_vec @ index.T``;
  - ``retrieval_main``: one prediction per test image into a JSON file;
    an image that fails is skipped and counted.

The text encoder is ``eval/clipscore.py`` ``encode_texts`` (CLIP's full
77-token context). Divergence kept from the reference package: a trailing
partial batch is indexed, not dropped. The captioner runs on the card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

import numpy as np

from conzic_torch.eval.clipscore import encode_texts


def corpus_texts(corpus_json: str) -> List[str]:
    """The captions of a corpus file, in its order."""
    with open(corpus_json, encoding="utf-8") as f:
        data = json.load(f)
    texts = data if isinstance(data, list) else list(data.values())
    return [t if isinstance(t, str) else t.get("caption", str(t))
            for t in texts]


def build_index(captioner, corpus_json: str, out_dir: str,
                batch_size: int = 128) -> np.ndarray:
    """Encode every caption of ``corpus_json`` in chunks of ``batch_size``
    and write ``index_matrix.txt`` and ``mapping_dict.json`` to
    ``out_dir``; returns the (N, D) embeddings."""
    texts = corpus_texts(corpus_json)
    emb = encode_texts(captioner, texts, batch_size)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "index_matrix.txt"), "w") as f:
        for row in emb:
            f.write(" ".join(str(float(x)) for x in row) + "\n")
    mapping = {str(i): t for i, t in enumerate(texts)}
    with open(os.path.join(out_dir, "mapping_dict.json"), "w") as f:
        json.dump(mapping, f)
    return emb


class CLIPIndex:
    """A text index read from the reference's files, rows normalised, and
    the argmax-cosine search."""

    def __init__(self, index_matrix_path: str, mapping_dict_path: str,
                 captioner):
        rows = []
        with open(index_matrix_path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rows.append([float(x) for x in line.split()])
        matrix = np.asarray(rows, np.float32)
        norm = np.linalg.norm(matrix, axis=1, keepdims=True)
        self.matrix = matrix / np.maximum(norm, 1e-12)
        with open(mapping_dict_path, encoding="utf-8") as f:
            self.mapping = json.load(f)
        self.captioner = captioner

    def get_image_representation(self, image_path: str) -> np.ndarray:
        """The image's normalised embedding."""
        from PIL import Image

        img = Image.open(image_path).convert("RGB")
        emb = self.captioner.encode_images([img]).float().cpu().numpy()[0]
        return emb / np.maximum(np.linalg.norm(emb), 1e-12)

    def search_text(self, image_path: str) -> str:
        scores = self.get_image_representation(image_path) @ self.matrix.T
        return self.mapping[str(int(np.argmax(scores)))]


def _make_captioner(args):
    from conzic_torch.api.demo import build_captioner
    from conzic_torch.config import config_from_args

    cfg = config_from_args(args)
    cfg.match_model = args.clip_name  # the reference's flag name
    return build_captioner(cfg, random_models=args.random_models,
                           device=args.device)


def _add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--clip_name", default="openai/clip-vit-base-patch32")
    p.add_argument("--lm_model", default="bert-base-uncased")
    p.add_argument("--random_models", nargs="?", const="full",
                   choices=["full", "tiny"], default=False,
                   help="seeded random towers instead of checkpoints")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels on the card and "
                        "raises without one; cpu runs their plain versions")


def build_index_main(argv=None):
    p = argparse.ArgumentParser(description="build a CLIP text index")
    _add_common_args(p)
    p.add_argument("--text_file_path", required=True)
    p.add_argument("--save_index_prefix", required=True)
    p.add_argument("--batch_size", type=int, default=128)
    args = p.parse_args(argv)
    captioner = _make_captioner(args)
    build_index(captioner, args.text_file_path, args.save_index_prefix,
                args.batch_size)
    print(f"index written to {args.save_index_prefix}")


def retrieval_main(argv=None):
    p = argparse.ArgumentParser(description="nearest-caption retrieval")
    _add_common_args(p)
    p.add_argument("--index_matrix_path", required=True)
    p.add_argument("--mapping_dict_path", required=True)
    p.add_argument("--test_image_prefix_path", required=True)
    p.add_argument("--test_path", required=True)
    p.add_argument("--save_path_prefix", default=".")
    p.add_argument("--save_name", default="retrieval_result.json")
    args = p.parse_args(argv)
    captioner = _make_captioner(args)
    index = CLIPIndex(args.index_matrix_path, args.mapping_dict_path,
                      captioner)
    with open(args.test_path, encoding="utf-8") as f:
        items = json.load(f)
    os.makedirs(args.save_path_prefix, exist_ok=True)
    results, invalid_num = [], 0
    for item in items:
        name = item["image_name"] if isinstance(item, dict) else item
        path = os.path.join(args.test_image_prefix_path, name)
        try:
            pred = index.search_text(path)
        except Exception:  # an image that fails is skipped and counted
            invalid_num += 1
            continue
        out = dict(item) if isinstance(item, dict) else {"image_name": name}
        out["prediction"] = pred
        results.append(out)
    save_path = os.path.join(args.save_path_prefix, args.save_name)
    with open(save_path, "w") as f:
        json.dump(results, f, indent=4)
    print(f"Inference completed! invalid number is {invalid_num}")


if __name__ == "__main__":
    build_index_main()
