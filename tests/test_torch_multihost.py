"""Several processes captioning one batch (``conzic_torch/parallel/
distributed.py``), on the CPU.

As ``tests/test_multihost.py`` runs the reference in two processes, two OS
processes join a ``gloo`` group here (``tcp://localhost``), each encodes
its block of a seeded global batch and captions its block of the rows;
the gathered results must equal one process's, ids and best cosines
byte for byte, and ``conzic_tpu``'s on the same towers and embeddings. ``api.run --multihost`` in two processes writes the
results tree once, equal to one process's. Also the helpers in one
process and the batch-size refusal.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import np_tree, port_bert_config, port_clip_config
from conzic_torch.api import run
from conzic_torch.parallel import distributed
from test_torch_engine import _base_pair

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "_torch_multihost_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_processes(out, mode, *extra):
    """Both workers, their output in files beside ``out``: read from pipes
    one at a time, a worker whose pipe is full would stop while the other
    waits for it at the group's barrier."""
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "CONZIC_MULTIHOST")}
    files = [open(os.path.join(os.path.dirname(out), f"worker{rank}.log"),
                  "w+") for rank in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, port, str(rank), str(out), mode, *extra],
        env=env, stdout=f, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for rank, f in zip((0, 1), files)]
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for p, f in zip(procs, files):
        f.seek(0)
        logs.append(f.read())
        f.close()
        assert p.returncode == 0, f"worker failed:\n{logs[-1][-4000:]}"
    return logs


def test_local_slice_contract():
    assert distributed.local_slice(8, pid=0, cnt=2) == slice(0, 4)
    assert distributed.local_slice(8, pid=1, cnt=2) == slice(4, 8)
    assert distributed.local_slice(6, pid=2, cnt=3) == slice(4, 6)
    with pytest.raises(ValueError, match="does not divide"):
        distributed.local_slice(7, pid=0, cnt=2)
    assert distributed.local_slice(5, pid=0, cnt=1) == slice(0, 5)


def test_single_process_helpers_are_the_identity():
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0 and distributed.is_primary()
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    np.testing.assert_array_equal(
        distributed.put_global(x, "cpu").numpy(), x)
    np.testing.assert_array_equal(
        distributed.put_local_shard(x, 8, "cpu").numpy(), x)
    np.testing.assert_array_equal(distributed.gather_to_host(x), x)
    np.testing.assert_array_equal(
        distributed.gather_to_host(torch.from_numpy(x), axis=1), x)
    with pytest.raises(ValueError, match="got 4 rows"):
        distributed.put_local_shard(x[:4], 8, "cpu")
    half = torch.ones(8, 2, dtype=torch.bfloat16)  # bf16 embeddings
    assert torch.equal(distributed.put_local_shard(half, 8, "cpu"), half)
    assert distributed.local_device("cpu") == torch.device("cpu")
    assert not distributed.env_requested()
    distributed.shutdown()  # no group to leave


def _two_process_run(tmp_path, order):
    """Two processes caption 8 images x 2 samples of the tiny towers in
    ``order``: ids and texts equal to one process's and to conzic_tpu's
    on the gathered embeddings, best cosines equal to one process's."""
    jc, pc = _base_pair("random")
    towers = tmp_path / "towers.pkl"
    with open(towers, "wb") as f:
        pickle.dump(dict(
            bert_config=port_bert_config(jc.bert_model.config),
            bert_params=np_tree(jc.params["bert"]),
            clip_config=port_clip_config(jc.clip_model.config),
            clip_params=np_tree(jc.params["clip"]),
            vocab=dict(jc.wp.vocab)), f)
    side = pc.clip_model.config.vision.image_size
    pixels = np.random.RandomState(3).rand(8, side, side, 3).astype(
        np.float32)
    kw = dict(prompt="Image of a", max_len=4, top_k=8, temperature=0.1,
              max_iter=2, alpha=0.02, beta=2.0, order=order, n_samples=2)
    one = pc.run(pc.encode_images(pixels), rng=np.random.RandomState(5),
                 **kw)
    out = tmp_path / "rank0.json"
    _two_processes(out, "engine", str(towers), order)
    got = json.loads(out.read_text())
    embeds = np.asarray(got["embeds"], np.float32)
    assert embeds.shape[0] == 8  # every process holds the global batch
    want = jc.run(jnp.asarray(embeds), rng=np.random.RandomState(5), **kw)
    for ref in (one, want):
        np.testing.assert_array_equal(np.asarray(got["iter_ids"]),
                                      np.asarray(ref.iter_ids))
        np.testing.assert_array_equal(np.asarray(got["best_ids"]),
                                      np.asarray(ref.best_ids))
        assert got["texts"] == ref.gen_texts_list
    np.testing.assert_array_equal(np.asarray(got["best_cos"], np.float32),
                                  one.best_cos)
    np.testing.assert_allclose(np.asarray(got["clip_score_sequence"]),
                               np.asarray(want.clip_score_sequence),
                               rtol=0, atol=1e-5)


def test_two_process_run_matches_single_process(tmp_path):
    _two_process_run(tmp_path, "shuffle")


def test_two_process_sequential_run_matches_single_process(tmp_path):
    _two_process_run(tmp_path, "sequential")


def _tree(root):
    (cfg_dir,) = os.listdir(root / "results")
    out = {}
    for sample in sorted(os.listdir(root / "results" / cfg_dir)):
        for name in sorted(os.listdir(root / "results" / cfg_dir / sample)):
            with open(root / "results" / cfg_dir / sample / name) as f:
                out[sample, name] = json.load(f)
    return out


def test_run_cli_multihost_writes_the_tree_once(tmp_path, monkeypatch):
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(5):  # two batches of 2; the fifth is dropped
        Image.fromarray(rng.randint(0, 255, (40, 56, 3), dtype=np.uint8)
                        ).save(imgs / f"img_{i}.png")
    argv = ["--random_models", "tiny", "--device", "cpu", "--dtype",
            "float32", "--order", "sequential", "--sentence_len", "3",
            "--candidate_k", "6", "--num_iterations", "1", "--samples_num",
            "1", "--batch_size", "2", "--caption_img_path", str(imgs)]
    for d in ("one", "two"):
        (tmp_path / d).mkdir()
    monkeypatch.chdir(tmp_path / "one")
    run.main(argv)
    _two_processes(tmp_path / "two", "cli", *argv)
    want, got = _tree(tmp_path / "one"), _tree(tmp_path / "two")
    assert got == want
    assert sorted(got["sample_0", "best_clipscore.json"]) == [
        f"img_{i}" for i in range(4)]
    # both processes logged; the tree was written by process 0 alone
    logs = "\n".join((tmp_path / "two" / "logger" / n).read_text()
                     for n in os.listdir(tmp_path / "two" / "logger"))
    assert logs.count("saved results to") == 1


def test_run_cli_multihost_refuses_a_batch_of_another_size(tmp_path,
                                                            monkeypatch):
    monkeypatch.setattr(distributed, "initialize", lambda *a: None)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="must be a multiple of the "
                                         "process count"):
        run.main(["--random_models", "tiny", "--device", "cpu",
                  "--multihost", "--batch_size", "3",
                  "--caption_img_path", str(tmp_path)])
