"""The port's checkpoint reader == flax's, and ``Captioner.from_tiny_dir``
captions == ``conzic_tpu``'s.

``conzic_torch/models/checkpoint.py`` reads the msgpack that
``flax.serialization.to_bytes`` writes without flax or msgpack: every leaf
of the three trained checkpoints, and of seeded trees of every type flax
packs, must equal ``flax.serialization.msgpack_restore``'s bit for bit (a
bfloat16 leaf as its 16-bit pattern). ``from_tiny_dir`` must load towers
equal to the JAX package's load carried over as numpy, and its free and
controlled runs on ``trained_tiny/`` must give the reference's caption ids
byte for byte with equal control scores.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from flax import serialization

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from _torch_port import TRAINED_TINY, port_captioner
from test_torch_control_engine import TEMPLATE, assert_same_result
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.engine.sampler import Captioner as JaxCaptioner
from conzic_tpu.models import checkpoint as jax_checkpoint
from conzic_torch.config import ConzicConfig
from conzic_torch.engine.sampler import Captioner
from conzic_torch.models import checkpoint

REPO = os.path.dirname(TRAINED_TINY)
_CAPS = {}


def assert_same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for key in want:
            assert_same_tree(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            assert_same_tree(g, w)
    elif isinstance(want, (np.ndarray, np.generic)) or hasattr(want,
                                                               "dtype"):
        w = np.asarray(want)
        assert isinstance(got, torch.Tensor)
        assert tuple(got.shape) == w.shape
        assert str(got.dtype).replace("torch.", "") == w.dtype.name
        g = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
        assert g.numpy().tobytes() == w.tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("name", ["bert.msgpack", "clip.msgpack"])
@pytest.mark.parametrize("world", ["trained_tiny", "trained_tiny12",
                                   "trained_mid"])
def test_reader_matches_flax_on_checkpoints(world, name):
    with open(os.path.join(REPO, world, name), "rb") as f:
        raw = f.read()
    assert_same_tree(checkpoint.msgpack_restore(raw),
                     serialization.msgpack_restore(raw))


def _seeded_tree(seed):
    rng = np.random.RandomState(seed)
    dtypes = ["float32", "float16", "float64", "int8", "int16", "int32",
              "int64", "uint8", "uint16", "uint32", "bool"]
    tree = {}
    for i, dt in enumerate(dtypes):
        shape = tuple(rng.randint(0, 4, size=rng.randint(0, 4)))
        tree[f"leaf_{i}_{dt}"] = np.asarray(
            rng.randn(*shape) * 50).astype(dt)
    tree["bf16"] = jnp.asarray(rng.randn(3, 5), jnp.bfloat16)
    tree["big"] = rng.randn(70000).astype(np.float32)  # bin32 payload
    tree["nested"] = {"": {}, "x" * 40: "s" * 300, "k" * 70000: 1}
    tree["numbers"] = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                       2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
                       -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63), 0.5, -1e300]
    tree["bytes"] = [b"", b"x" * 255, b"y" * 256, b"z" * 70000]
    tree["wide"] = {str(j): j for j in range(20)}  # a map16
    tree["long"] = list(range(20))  # an array16
    return tree


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reader_matches_flax_on_seeded_trees(seed):
    raw = serialization.msgpack_serialize(_seeded_tree(seed))
    assert_same_tree(checkpoint.msgpack_restore(raw),
                     serialization.msgpack_restore(raw))


def test_reader_refuses_what_flax_does_not_write(tmp_path):
    raw = serialization.msgpack_serialize({"a": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.msgpack_restore(raw[:-1])
    with pytest.raises(ValueError, match="trailing"):
        checkpoint.msgpack_restore(raw + b"\x00")
    with pytest.raises(ValueError, match="ext type 3"):  # a numpy scalar
        checkpoint.msgpack_restore(serialization.msgpack_serialize(
            np.float32(1.0)))
    with pytest.raises(ValueError, match="0xc3"):  # true
        checkpoint.msgpack_restore(b"\xc3")
    assert checkpoint.is_tiny_checkpoint(TRAINED_TINY)
    assert not checkpoint.is_tiny_checkpoint(str(tmp_path))
    (tmp_path / checkpoint.MARKER).write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        checkpoint.load_tiny_checkpoint(str(tmp_path))


def test_configs_match_reference():
    ours = checkpoint.load_tiny_checkpoint(TRAINED_TINY)
    theirs = jax_checkpoint.load_tiny_checkpoint(TRAINED_TINY)
    assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
    assert dataclasses.asdict(ours[2]) == dataclasses.asdict(theirs[2])
    assert ours[4] == theirs[4]
    assert_same_tree(ours[1], theirs[1])
    assert_same_tree(ours[3], theirs[3])


def test_from_tiny_dir_imports_neither_flax_nor_msgpack():
    code = textwrap.dedent(f"""
        import sys
        from conzic_torch.engine.sampler import Captioner
        cap = Captioner.from_tiny_dir(None, {TRAINED_TINY!r}, device="cpu")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "msgpack", "conzic_tpu"))
        assert not bad, bad
        print("ok", cap.wp.vocab_size)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok 4096")


def _caps():
    """(jax captioner, the port's from_tiny_dir), both fp32 on the CPU."""
    if not _CAPS:
        jc = JaxCaptioner.from_tiny_dir(JaxConfig(dtype="float32"),
                                        TRAINED_TINY)
        pc = Captioner.from_tiny_dir(ConzicConfig(dtype="float32"),
                                     TRAINED_TINY, device="cpu")
        _CAPS["pair"] = (jc, pc)
    return _CAPS["pair"]


def test_from_tiny_dir_loads_the_reference_towers():
    jc, pc = _caps()
    via_numpy = port_captioner(jc, bpe_dir=TRAINED_TINY, dtype="float32")
    for ours, theirs in ((pc.bert_model, via_numpy.bert_model),
                         (pc.clip_model, via_numpy.clip_model)):
        a, b = ours.state_dict(), theirs.state_dict()
        assert list(a) == list(b)
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            assert torch.equal(a[key], b[key]), key
    assert pc.wp.vocab == via_numpy.wp.vocab
    assert pc.bpe.encoder == via_numpy.bpe.encoder


CASES = {
    "free-sequential": ({}, dict(order="sequential")),
    "sentiment-table-positive": ({}, dict(ctl="sentiment",
                                          order="sequential")),
    "sentiment-table-negative": ({}, dict(ctl="sentiment", negative=True,
                                          order="shuffle")),
    "pos-table-default": ({}, dict(ctl="pos", order="sequential")),
    "pos-table-per-call": ({}, dict(ctl="pos", order="sequential",
                                    pos_template=TEMPLATE)),
    "sentiment-exact": (dict(ctl_mode="exact"),
                        dict(ctl="sentiment", order="sequential")),
    "pos-exact": (dict(ctl_mode="exact"), dict(ctl="pos",
                                               order="sequential")),
    "bridge-exact-sequential": (dict(bridge_mode="exact"),
                                dict(order="sequential")),
    "bridge-exact-span": (dict(bridge_mode="exact"), dict(order="span")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_from_tiny_dir_runs_match_reference(case):
    """trained_tiny's vocabulary holds five valenced words (nice, cute,
    love; lose, hate): the prompt carries one, so sentiment scores are not
    all zero, and the repeat penalty meets the word again."""
    cfg_kw, run_kw = CASES[case]
    caps = _caps()
    for c in caps:
        for k, v in cfg_kw.items():
            setattr(c.cfg, k, v)
    try:
        emb = np.random.RandomState(1).randn(
            2, caps[0].clip_model.config.projection_dim).astype(np.float32)
        args = dict(prompt="Image of a nice", max_len=5, top_k=24,
                    temperature=0.1, max_iter=2, alpha=0.02, beta=2.0,
                    gamma=5.0, **run_kw)
        want = caps[0].run(jnp.asarray(emb), rng=np.random.RandomState(7),
                           **args)
        got = caps[1].run(emb, rng=np.random.RandomState(7), **args)
    finally:
        for c in caps:
            c.cfg.ctl_mode = c.cfg.bridge_mode = "table"
    assert_same_result(got, want)
    if run_kw.get("ctl"):
        assert (got.iter_ctl != 0).any()
