"""The port's image input == ``conzic_tpu``'s: preprocessing and the
synthetic world.

``conzic_torch/runtime/image.py`` ``preprocess_pil`` and
``preprocess_batch_pil`` must give the reference package's arrays bit for
bit, and stay within HF ``CLIPImageProcessor``'s tolerance as the
reference's tests require (``tests/test_image_preprocess.py``);
``preprocess_torch``, the resize on the device, must stay within a mean
absolute difference of 0.12 of PIL, the bound the reference sets for its
``preprocess_jax``. Seeded scenes of ``conzic_torch/data/synthetic.py``
must render the reference's arrays and captions, and its vocabularies and
BPE files must be the same. A list of PIL images, or one image given to an
entry function, must reach the image tower as its preprocessed pixels do.
"""

import dataclasses
import filecmp
import logging
import os

import numpy as np
import pytest
import torch
import transformers
from PIL import Image

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from conzic_tpu.data import synthetic as jax_synthetic
from conzic_tpu.runtime import image as jax_image
from conzic_torch.data import synthetic
from conzic_torch.engine import sampler
from conzic_torch.engine.sampler import Captioner
from conzic_torch.runtime import image

HF_TOL = 1e-5


def _random_image(rng, w, h, mode="RGB"):
    arr = rng.randint(0, 255, (h, w, 4), dtype=np.uint8)
    return Image.fromarray(arr[..., :3]).convert(mode)


@pytest.mark.parametrize("size", [(320, 240), (240, 320), (224, 224),
                                  (500, 100)])
def test_preprocess_pil_matches_reference_and_hf(size):
    img = _random_image(np.random.RandomState(0), *size)
    got = image.preprocess_pil(img)
    assert got.dtype == np.float32 and got.shape == (224, 224, 3)
    assert got.tobytes() == jax_image.preprocess_pil(img).tobytes()
    hf = transformers.CLIPImageProcessor()
    ref = hf(images=img, return_tensors="np")["pixel_values"][0]
    np.testing.assert_allclose(got.transpose(2, 0, 1), ref, rtol=HF_TOL,
                               atol=HF_TOL)


def test_preprocess_pil_fuzz_sizes_and_modes():
    """Tiny, sub-crop and extreme aspect ratios, and the modes that go
    through the RGB conversion, at the full and a tiny tower's width."""
    rng = np.random.RandomState(7)
    sizes = [(5, 300), (300, 5), (100, 100), (223, 225), (1, 1000),
             (640, 480), (17, 31)]
    sizes += [tuple(rng.randint(4, 700, 2)) for _ in range(6)]
    modes = ["RGB", "L", "RGBA", "P", "CMYK"]
    for i, (w, h) in enumerate(sizes):
        img = _random_image(rng, w, h, modes[i % len(modes)])
        for side in (224, 64):
            got = image.preprocess_pil(img, side)
            want = jax_image.preprocess_pil(img, side)
            assert got.tobytes() == want.tobytes(), (w, h, side)


@pytest.mark.parametrize("workers", [0, 1, 3])
def test_preprocess_batch_pil_matches_reference(workers):
    rng = np.random.RandomState(2)
    imgs = [_random_image(rng, 90 + 7 * i, 60 + 5 * i) for i in range(9)]
    got = image.preprocess_batch_pil(imgs, 64, workers=workers)
    want = jax_image.preprocess_batch_pil(imgs, 64, workers=workers)
    assert got.shape == (9, 64, 64, 3)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("hw", [(300, 400), (400, 300), (224, 224)])
def test_preprocess_torch_close_to_pil(hw):
    arr = np.random.RandomState(1).randint(0, 255, hw + (3,), dtype=np.uint8)
    ref = image.preprocess_pil(Image.fromarray(arr))
    got = image.preprocess_torch(arr, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    assert np.abs(got.numpy() - ref).mean() < 0.12
    # a batch gives each image's own result
    batch = image.preprocess_torch(torch.from_numpy(np.stack([arr, arr])),
                                   device="cpu")
    assert torch.equal(batch[1], got)


@pytest.mark.parametrize("rich", [False, True])
def test_synthetic_scenes_render_the_reference_arrays(rich):
    images, captions, scenes = synthetic.build_dataset(12, seed=3, rich=rich)
    want = jax_synthetic.build_dataset(12, seed=3, rich=rich)
    assert images.dtype == np.uint8 and images.tobytes() == want[0].tobytes()
    assert captions == want[1]
    assert ([dataclasses.asdict(s) for s in scenes]
            == [dataclasses.asdict(s) for s in want[2]])
    scene = synthetic.sample_scene(np.random.RandomState(9))
    big = np.asarray(synthetic.render_scene(scene, 224))
    assert big.tobytes() == np.asarray(jax_synthetic.render_scene(
        jax_synthetic.sample_scene(np.random.RandomState(9)), 224)).tobytes()


def test_synthetic_vocabularies_match_reference(tmp_path):
    for rich in (False, True):
        assert (synthetic.caption_words(rich)
                == jax_synthetic.caption_words(rich))
        assert (synthetic.make_tiny_wordpiece_vocab(512, rich)
                == jax_synthetic.make_tiny_wordpiece_vocab(512, rich))
    words = synthetic.caption_words(rich=True)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ours = synthetic.make_word_bpe_files(words, str(tmp_path / "a"))
    theirs = jax_synthetic.make_word_bpe_files(words, str(tmp_path / "b"))
    for a, b in zip(ours, theirs):
        assert filecmp.cmp(a, b, shallow=False)
    assert (synthetic.scene_attribute_words(synthetic.sample_scene(
        np.random.RandomState(4))) == jax_synthetic.scene_attribute_words(
        jax_synthetic.sample_scene(np.random.RandomState(4))))


@pytest.fixture(scope="module")
def captioner():
    cap = Captioner.from_random(device="cpu")
    cap.cfg.verbose = False
    return cap


def test_encode_images_takes_pil_images(captioner):
    rng = np.random.RandomState(5)
    imgs = [_random_image(rng, 80, 50), _random_image(rng, 40, 90)]
    side = captioner.clip_model.config.vision.image_size
    want = captioner.encode_images(image.preprocess_batch_pil(imgs, side))
    assert torch.equal(captioner.encode_images(imgs), want)
    assert torch.equal(captioner.encode_images(tuple(imgs)), want)


def test_entry_function_replicates_one_pil_image(captioner):
    img = _random_image(np.random.RandomState(6), 70, 70)
    logger = logging.getLogger("torch-image")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    kw = dict(prompt="Image of a", batch_size=2, max_len=3, top_k=4,
              temperature=0.1, max_iter=1, alpha=0.02, beta=2.0)
    one = sampler.generate_caption(["a", "b"], captioner, img, logger,
                                   rng=np.random.RandomState(7), **kw)
    listed = sampler.generate_caption(["a", "b"], captioner, [img, img],
                                      logger, rng=np.random.RandomState(7),
                                      **kw)
    assert one == listed
    assert one[0][-2][0] == one[0][-2][1]


def test_synthetic_scene_files_decode_to_the_rendered_arrays(tmp_path):
    """The PNG files a scene is saved as (the card's CLI run reads such
    files) decode to the rendered array."""
    images, _, _ = synthetic.build_dataset(3, seed=0, image_size=48)
    for i, arr in enumerate(images):
        path = os.path.join(tmp_path, f"scene_{i}.png")
        Image.fromarray(arr).save(path)
        assert np.asarray(Image.open(path).convert("RGB")).tobytes() == \
            arr.tobytes()
