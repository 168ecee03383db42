"""One process of the two-process CPU runs of tests/test_torch_multihost.py.

    python tests/_torch_multihost_worker.py PORT RANK OUT engine TOWERS ORDER
    python tests/_torch_multihost_worker.py PORT RANK WORKDIR cli ARGS...

``engine``: join a two-process ``gloo`` group, build the tiny fp32
captioner on the CPU from TOWERS (a pickle of the configs, the
``conzic_tpu`` parameter trees as numpy and the WordPiece vocabulary),
encode this process's block of a seeded global pixel batch, caption the
whole batch in ORDER (each process its block of rows, the results
gathered), and let process 0 write the results and the gathered
embeddings as JSON to OUT. ``cli``: run ``conzic_torch.api.run.main`` with ``--multihost`` and
the rest of the arguments in WORKDIR.
"""

import json
import os
import pickle
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def engine(port: str, rank: int, out: str, towers: str,
           order: str) -> None:
    from conzic_torch.config import ConzicConfig
    from conzic_torch.engine.sampler import Captioner
    from conzic_torch.parallel import distributed
    from conzic_torch.text.bpe import CLIPBPETokenizer
    from conzic_torch.text.vocab import make_test_bpe_files
    from conzic_torch.text.wordpiece import WordPieceTokenizer

    distributed.initialize(f"localhost:{port}", 2, rank)
    assert distributed.process_count() == 2
    with open(towers, "rb") as f:
        t = pickle.load(f)
    cap = Captioner.from_jax_params(
        t["bert_config"], t["bert_params"], t["clip_config"],
        t["clip_params"], WordPieceTokenizer(t["vocab"]),
        CLIPBPETokenizer.from_files(*make_test_bpe_files(tempfile.mkdtemp())),
        ConzicConfig(dtype="float32", verbose=False), device="cpu")
    B = 8
    side = cap.clip_model.config.vision.image_size
    pixels = np.random.RandomState(3).rand(B, side, side, 3).astype(
        np.float32)
    local = pixels[distributed.local_slice(B)]
    embeds = cap.encode_images(local, local=True)
    res = cap.run(embeds, prompt="Image of a", max_len=4, top_k=8,
                  temperature=0.1, max_iter=2, alpha=0.02, beta=2.0,
                  order=order, n_samples=2,
                  rng=np.random.RandomState(5))
    if distributed.is_primary():
        with open(out, "w") as f:
            json.dump({
                "iter_ids": res.iter_ids.tolist(),
                "best_ids": res.best_ids.tolist(),
                "texts": res.gen_texts_list,
                "best_cos": [float(x) for x in res.best_cos],
                "clip_score_sequence": res.clip_score_sequence,
                "embeds": embeds.numpy().tolist(),
            }, f)
    distributed.shutdown()


def cli(port: str, rank: int, workdir: str, argv) -> None:
    from conzic_torch.api import run

    os.chdir(workdir)
    run.main(argv + ["--multihost", "--coordinator_address",
                     f"localhost:{port}", "--num_processes", "2",
                     "--process_id", str(rank)])


if __name__ == "__main__":
    port, rank, out, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
        sys.argv[4]
    if mode == "engine":
        engine(port, rank, out, sys.argv[5], sys.argv[6])
    else:
        cli(port, rank, out, sys.argv[5:])
