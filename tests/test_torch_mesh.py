"""Scale-out in one process (``conzic_torch/parallel/mesh.py``,
``Captioner(mesh=...)``), on the CPU.

As ``tests/test_mesh.py`` runs the reference on 8 virtual CPU devices,
these tests give the port an explicit list of 8 CPU devices: the
(images x samples) rows go in contiguous blocks to 8 replicas on 8
threads, and the caption ids must equal one device's, and the reference's,
byte for byte, ragged batches included (padded, then cut back). Also the
mesh helpers and the reference's refusals on a mesh.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import port_captioner
from conzic_torch.parallel import mesh as mesh_lib
from test_torch_engine import _base_pair, _embeds

CPUS = ["cpu"] * 8
ARGS = dict(prompt="Image of a", temperature=0.1, alpha=0.02, beta=2.0,
            max_len=4, top_k=8, max_iter=2)


def test_make_mesh_refuses_what_is_not_there():
    assert mesh_lib.make_mesh(3, devices=CPUS) == [torch.device("cpu")] * 3
    assert len(mesh_lib.make_mesh(devices=CPUS)) == 8
    with pytest.raises(ValueError, match="requested a 9-device mesh but "
                                         "only 8 device"):
        mesh_lib.make_mesh(9, devices=CPUS)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 device"):
            mesh_lib.make_mesh(2)
        with pytest.raises(ValueError, match="only 0 device"):
            mesh_lib.make_mesh_2d(2, 2)
    with pytest.raises(ValueError, match="at least one device"):
        mesh_lib.make_mesh(devices=[])
    assert mesh_lib.make_mesh_2d(4, 2, devices=CPUS) == [
        [torch.device("cpu")] * 2] * 4
    with pytest.raises(ValueError, match="requested a 3x3 mesh but only 8 "
                                         "device"):
        mesh_lib.make_mesh_2d(3, 3, devices=CPUS)


def test_pad_batch_to_mesh():
    mesh = mesh_lib.make_mesh(8, devices=CPUS)
    arrays = [np.arange(10)[:, None].repeat(3, 1)]
    padded, orig = mesh_lib.pad_batch_to_mesh(arrays, mesh)
    assert orig == 10 and padded[0].shape[0] == 16
    np.testing.assert_array_equal(padded[0][:10], arrays[0])
    np.testing.assert_array_equal(padded[0][10:], np.repeat(arrays[0][-1:],
                                                            6, axis=0))
    assert mesh_lib.data_axis_pad(mesh, 16) == 0
    assert mesh_lib.data_axis_pad(None, 5) == 0
    assert mesh_lib.data_axis_pad(None, 5, processes=2) == 1
    assert mesh_lib.pad_batch_to_mesh(arrays, None)[1] == 10


def test_pad_batch_to_mesh_pads_tensors_over_processes():
    """The rule ``Captioner.run`` pads its rows by: tensors too, and a
    multiple of the devices of every process."""
    mesh = mesh_lib.make_mesh(2, devices=CPUS)
    x = torch.arange(15.0).reshape(5, 3)
    ids = np.arange(5)
    (px, pids), orig = mesh_lib.pad_batch_to_mesh([x, ids], mesh,
                                                  processes=2)
    assert orig == 5 and px.shape == (8, 3) and pids.shape == (8,)
    assert torch.equal(px[5:], x[-1:].expand(3, 3))
    np.testing.assert_array_equal(pids, [0, 1, 2, 3, 4, 4, 4, 4])
    (same,), _ = mesh_lib.pad_batch_to_mesh([x[:4]], mesh, processes=2)
    assert same.shape[0] == 4


def test_shard_batch_and_replicate():
    mesh = mesh_lib.make_mesh(4, devices=CPUS)
    x = torch.arange(8.0)[:, None]
    blocks = mesh_lib.shard_batch(mesh, x)
    assert [b[:, 0].tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5],
                                                 [6, 7]]
    assert len(mesh_lib.replicate(mesh, x)) == 4
    assert mesh_lib.shard_batch(None, x)[0] is x
    with pytest.raises(ValueError, match="does not divide"):
        mesh_lib.shard_batch(mesh, x[:6])


_MESHED = {}


def _meshed():
    if not _MESHED:
        jc, _ = _base_pair("random")
        _MESHED["data"] = port_captioner(
            jc, dtype="float32", mesh=mesh_lib.make_mesh(8, devices=CPUS))
    return _MESHED["data"]


def _same(a, b):
    np.testing.assert_array_equal(a.iter_ids, np.asarray(b.iter_ids))
    np.testing.assert_array_equal(a.best_ids, np.asarray(b.best_ids))
    assert a.gen_texts_list == b.gen_texts_list
    np.testing.assert_allclose(np.asarray(a.clip_score_sequence),
                               np.asarray(b.clip_score_sequence),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("batch,order,n_samples", [
    (8, "sequential", 1), (5, "shuffle", 1), (3, "shuffle", 2),
])
def test_data_mesh_matches_one_device_and_reference(batch, order,
                                                    n_samples):
    jc, pc = _base_pair("random")
    embeds = _embeds("random", batch)
    kw = dict(ARGS, order=order, n_samples=n_samples)
    one = pc.run(embeds, rng=np.random.RandomState(1), **kw)
    got = _meshed().run(embeds, rng=np.random.RandomState(1), **kw)
    want = jc.run(jnp.asarray(embeds), rng=np.random.RandomState(1), **kw)
    assert got.iter_ids.shape[1] == batch * n_samples
    _same(got, one)
    _same(got, want)


def test_mesh_refusals():
    cap = _meshed()
    embeds = _embeds("random", 2)
    cap.cfg.clip_window = 8
    try:
        with pytest.raises(ValueError, match="clip_window requires a "
                                             "single chip"):
            cap.run(embeds, rng=np.random.RandomState(1),
                    **dict(ARGS, order="sequential"))
    finally:
        cap.cfg.clip_window = 0
    for knob in ("bridge_mode", "ctl_mode"):
        setattr(cap.cfg, knob, "exact")
        try:
            with pytest.raises(NotImplementedError, match="on a mesh"):
                cap.run(embeds, rng=np.random.RandomState(1),
                        ctl="sentiment" if knob == "ctl_mode" else None,
                        **dict(ARGS, order="sequential"))
        finally:
            setattr(cap.cfg, knob, "table")


def test_run_cli_mesh_flag(tmp_path, monkeypatch):
    """``--mesh_data_axis 0`` is a mesh of every visible device (the one
    CPU here): the same results tree as no mesh; a mesh of more devices
    than are visible ends with a message."""
    import json
    import os

    from PIL import Image

    from conzic_torch.api import run

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):  # a batch of 3: ragged over any mesh of 2
        Image.fromarray(rng.randint(0, 255, (40, 56, 3), dtype=np.uint8)
                        ).save(imgs / f"img_{i}.png")
    argv = ["--random_models", "tiny", "--device", "cpu", "--dtype",
            "float32", "--order", "sequential", "--sentence_len", "3",
            "--candidate_k", "6", "--num_iterations", "1", "--samples_num",
            "1", "--batch_size", "3", "--caption_img_path", str(imgs)]
    trees = {}
    for mode, extra in (("single", []), ("mesh", ["--mesh_data_axis", "0"])):
        (tmp_path / mode).mkdir()
        monkeypatch.chdir(tmp_path / mode)
        run.main(argv + extra)
        (cfg_dir,) = os.listdir(tmp_path / mode / "results")
        with open(tmp_path / mode / "results" / cfg_dir / "sample_0"
                  / "best_clipscore.json") as f:
            trees[mode] = json.load(f)
    assert trees["single"] == trees["mesh"] and len(trees["mesh"]) == 3
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="requested a 2-device mesh"):
            run.main(argv + ["--mesh_data_axis", "2"])
