"""The pruned tiers' pieces in ``conzic_torch`` == ``conzic_tpu``'s, on the CPU.

Held here: the stage-1 proxy and the control-aware rank within 1e-6 (the
parallel order's slot exclusion, rows of tied [PAD] candidates), every cut
equal to ``lax.top_k`` with its ties, the exact two-stage top-k, the
approximate and compare-form top-k, the truncated text tower within 2e-4 at
each depth (full rows and over the full tower's prefix K/V), the port's own
tables (the proxy's word embeddings within 2e-4, the calibration's held-out
cosine within 1e-5 and its held-out predictions within 1e-4 relative, the
automatic depth, the floor's warning, the cache key, the banned-id lists),
and the refusals of the pruned knobs' combinations with the reference's
messages, in ``validate``, on the command line and at ``run``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_port import (  # noqa: F401  (one_torch_thread: a fixture)
    TRAINED_TINY,
    jax_tiny_captioner,
    one_torch_thread,
    port_captioner,
)
from conzic_tpu import energies as jax_energies
from conzic_tpu.config import ConzicConfig as JaxConfig
from conzic_tpu.models.clip import CLIPTextTower as JaxTextTower
from conzic_tpu.models.clip import truncated_text_params
from conzic_torch import energies
from conzic_torch.api import run as run_cli
from conzic_torch.config import ConzicConfig
from conzic_torch.engine import sampler
from conzic_torch.models.clip import TruncatedTextTower

_CAPS = {}


def _caps():
    """(JAX captioner, port captioner) on one tiny fp32 pair whose text
    tower is 4 layers deep, built once."""
    if not _CAPS:
        jc = jax_tiny_captioner(text_layers=4)
        _CAPS["pair"] = (jc, port_captioner(jc, dtype="float32",
                                            verbose=False))
    return _CAPS["pair"]


@contextlib.contextmanager
def _fields(**kw):
    """Both captioners' config fields set to ``kw`` (both read them at run
    time), then restored."""
    caps = _caps()
    saved = [{k: getattr(c.cfg, k) for k in kw} for c in caps]
    for c in caps:
        for k, v in kw.items():
            setattr(c.cfg, k, v)
    try:
        yield caps
    finally:
        for c, old in zip(caps, saved):
            for k, v in old.items():
                setattr(c.cfg, k, v)


def _jax_tower(cap, depth):
    """The reference's truncated tower at ``depth``, compiled: its
    ``apply(params, ids, mask, pos_offset=, prefix_kvs=)``."""
    text = dataclasses.replace(cap.clip_model.config.text, num_layers=depth)
    return jax.jit(JaxTextTower(text, dtype=jnp.float32).apply,
                   static_argnames=("pos_offset",))


# ---------------------------------------------------------------------------
# energies
# ---------------------------------------------------------------------------


def _proxy_inputs(seed=0, B=4, K=12, S=9, V=40, D=16):
    rng = np.random.RandomState(seed)
    table = rng.randn(V, D).astype(np.float32)
    table[:3] = 0.0  # specials: [PAD], [MASK], ... embed to exactly 0
    base = rng.randint(3, V, size=(B, S)).astype(np.int64)
    col = rng.randint(1, S - 1, size=B).astype(np.int64)
    cand = rng.randint(3, V, size=(B, K)).astype(np.int64)
    cand[:, K // 2:] = 0  # tied [PAD] candidates, as masked winners give
    img = rng.randn(B, D).astype(np.float32)
    return table, base, col, cand, img, S


@pytest.mark.parametrize("exclude_slot", [False, True])
def test_prune_proxy_scores_match_reference(exclude_slot):
    table, base, col, cand, img, S = _proxy_inputs()
    want = jax_energies.prune_proxy_scores(
        jnp.asarray(table), jnp.asarray(base, jnp.int32),
        jnp.asarray(col, jnp.int32), jnp.asarray(cand, jnp.int32),
        jnp.asarray(img), S, exclude_slot=exclude_slot)
    got = energies.prune_proxy_scores(
        *(torch.from_numpy(a) for a in (table, base, col, cand, img)), S,
        exclude_slot=exclude_slot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the tied [PAD] candidates score exactly alike on both sides
    K = cand.shape[1]
    assert (got[:, K // 2:] == got[:, K // 2:K // 2 + 1]).all()


@pytest.mark.parametrize("ctl,negative", [("sentiment", False),
                                          ("sentiment", True), ("pos", False)])
def test_stage1_ctl_rank_matches_reference(ctl, negative):
    rng = np.random.RandomState(1)
    B, K, S, V, T, C = 3, 10, 9, 30, 6, 5
    rows = np.repeat(rng.randint(0, V, size=(B, 1, S)), K, axis=1)
    ids = rng.randint(0, V, size=(B, K))
    ids[:, -3:] = 0  # tied [PAD] candidates
    rows[np.arange(B), :, 4] = ids
    a = dict(
        surr=rng.rand(B, K).astype(np.float32) * 0.4,
        lm=np.where(rng.rand(B, K) < 0.5, 0.0, rng.rand(B, K)).astype(
            np.float32),
        senti=rng.choice([0.0, 0.5, -0.75], size=V).astype(np.float32),
        pos=rng.randint(0, C - 1, size=V).astype(np.int32),
        template=(rng.rand(T, C) < 0.5).astype(np.float32),
        lens=rng.randint(0, 3, size=V).astype(np.int32))
    kw = dict(ctl=ctl, negative=negative, seq_len=S)
    want = jax_energies.stage1_ctl_rank(
        jnp.asarray(a["surr"]), jnp.asarray(a["lm"]),
        jnp.asarray(ids, jnp.int32), jnp.asarray(rows, jnp.int32),
        logit_scale=jnp.float32(4.6052), alpha=jnp.float32(0.02),
        beta=jnp.float32(2.0), gamma=jnp.float32(5.0),
        senti=jnp.asarray(a["senti"]), pos_table=jnp.asarray(a["pos"]),
        template=jnp.asarray(a["template"]),
        bridge_lens=jnp.asarray(a["lens"]), **kw)
    t = {n: torch.from_numpy(v) for n, v in a.items()}
    got = energies.stage1_ctl_rank(
        t["surr"], t["lm"], torch.from_numpy(ids), torch.from_numpy(rows),
        logit_scale=torch.tensor(4.6052), alpha=0.02, beta=2.0, gamma=5.0,
        senti=t["senti"], pos_table=t["pos"], template=t["template"],
        bridge_lens=t["lens"], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="ctl"):
        energies.stage1_ctl_rank(t["surr"], t["lm"], torch.from_numpy(ids),
                                 torch.from_numpy(rows), ctl="style",
                                 negative=False, seq_len=S,
                                 logit_scale=torch.tensor(4.6), alpha=0.02,
                                 beta=2.0, gamma=5.0)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_stage1_cut_keeps_lax_top_k_order_among_ties(k):
    rng = np.random.RandomState(2)
    scores = rng.choice([0.1, 0.25, 0.25, 0.4, 0.0], size=(6, 12)).astype(
        np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), k)
    want_dp = jax_energies.dp_local_top_k(jnp.asarray(scores), k)[1]
    got_v, got_i = energies.top_k(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_dp))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("V,k,chunk", [(1024, 16, 256), (1000, 8, 128),
                                       (300, 16, 512), (1024, 200, 256)])
def test_exact_topk_2stage_is_the_one_sort(V, k, chunk):
    rng = np.random.RandomState(3)
    # softmax at T=0.1 ties most of the vocabulary at 0.0
    probs = np.where(rng.rand(5, V) < 0.9, 0.0, rng.rand(5, V)).astype(
        np.float32)
    t = torch.from_numpy(probs)
    want_v, want_i = energies.top_k(t, k)
    got_v, got_i = energies.exact_topk_2stage(t, k, chunk=chunk)
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_v.numpy(), want_v.numpy())
    jax_v, jax_i = jax_energies.exact_topk_2stage(jnp.asarray(probs), k,
                                                  chunk=chunk)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(jax_i))


@pytest.mark.parametrize("mode,per_row", [("exact", False), ("approx", False),
                                          ("exact", True)])
def test_topk_candidates_modes_match_reference(mode, per_row):
    # the reference's approx mode is exact off the TPU: the port's one form
    # equals both, in blocks of 16 columns (the two-stage form, taken from
    # energies.TOPK_2STAGE_MIN_ROWS rows up) and as one sort (chunk 0)
    rng = np.random.RandomState(4)
    B, V, k = 130, 64, 12  # B in [128, 256): the reference's two-stage form
    assert B >= energies.TOPK_2STAGE_MIN_ROWS
    probs = np.where(rng.rand(B, V) < 0.7, 0.0, rng.rand(B, V)).astype(
        np.float32)
    mask = (rng.rand(B, V) < 0.8).astype(np.float32) if per_row else (
        rng.rand(V) < 0.8).astype(np.float32)
    want_p, want_i = jax_energies.topk_candidates(
        jnp.asarray(probs), jnp.asarray(mask), k, chunk=16, mode=mode)
    for chunk in (0, 16):
        got_p, got_i = energies.topk_candidates(
            torch.from_numpy(probs), torch.from_numpy(mask), k, chunk=chunk)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_topk_candidates_compare_form_is_the_gather():
    rng = np.random.RandomState(5)
    B, V, k = 4, 50, 20
    probs = np.where(rng.rand(B, V) < 0.8, 0.0, rng.rand(B, V)).astype(
        np.float32)
    masks = (rng.rand(2, V) < 0.7).astype(np.float32)
    pick = rng.rand(B) < 0.5
    row_mask = np.where(pick[:, None], masks[0], masks[1])
    banned = [np.nonzero(m == 0)[0] for m in masks]
    nb = max(b.size for b in banned)
    banned = np.stack([np.pad(b, (0, nb - b.size), constant_values=-1)
                       for b in banned])
    row_banned = np.where(pick[:, None], banned[0], banned[1])
    gather = energies.topk_candidates(torch.from_numpy(probs),
                                      torch.from_numpy(row_mask), k)
    compare = energies.topk_candidates(
        torch.from_numpy(probs), torch.from_numpy(row_mask), k,
        banned_ids=torch.from_numpy(row_banned))
    want = jax_energies.topk_candidates(
        jnp.asarray(probs), jnp.asarray(row_mask), k,
        banned_ids=jnp.asarray(row_banned, jnp.int32))
    np.testing.assert_array_equal(compare[1].numpy(), gather[1].numpy())
    np.testing.assert_array_equal(compare[1].numpy(), np.asarray(want[1]))


# ---------------------------------------------------------------------------
# the truncated text tower
# ---------------------------------------------------------------------------


def _text_rows(cap, N, S, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 200, size=(N, S)).astype(np.int32)
    lens = rng.randint(3, S + 1, size=N)
    eos = cap.clip_model.config.text.eos_token_id
    ids[np.arange(N), lens - 1] = eos
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_truncated_tower_matches_reference(depth):
    jc, pc = _caps()
    jtower = _jax_tower(jc, depth)
    tparams = truncated_text_params(jc.params["clip"], depth)
    view = TruncatedTextTower(pc.clip_model.text_model, depth)
    assert view.config.num_layers == depth
    ids, mask = _text_rows(jc, 6, 14, seed=depth)
    want = jtower({"params": tparams}, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        got = view(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    # over the full tower's prompt K/V: 2 images x 3 candidates
    P = 4
    kvs = jax.jit(lambda p, i: jc.clip_model.apply(
        {"params": p}, i, method=type(jc.clip_model).text_prefix_kvs))(
            jc.params["clip"], jnp.asarray(ids[:2, :P]))
    suf = ids[:, P:].reshape(2, 3, -1)
    msuf = mask[:, P:].reshape(2, 3, -1)
    want = jtower({"params": tparams}, jnp.asarray(suf.reshape(6, -1)),
                  jnp.asarray(msuf.reshape(6, -1)), pos_offset=P,
                  prefix_kvs=list(kvs[:depth]))
    with torch.inference_mode():
        pkvs = pc.clip_model.text_prefix_kvs(torch.from_numpy(ids[:2, :P])
                                             .long())
        got = view(torch.from_numpy(suf.reshape(6, -1)).long(),
                   torch.from_numpy(msuf.reshape(6, -1)), pos_offset=P,
                   prefix_kvs=pkvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_truncated_tower_is_a_view():
    _, pc = _caps()
    tower = pc.clip_model.text_model
    view = TruncatedTextTower(tower, 2)
    assert view.tower is tower  # the same modules: no weight copied
    for bad in (0, tower.config.num_layers + 1):
        with pytest.raises(ValueError, match="layers"):
            TruncatedTextTower(tower, bad)


# ---------------------------------------------------------------------------
# the port's own tables
# ---------------------------------------------------------------------------


def test_word_embeds_match_reference():
    jc, pc = _caps()
    jc._ensure_word_embeds()
    pc.tables.pop("word_embeds", None)
    pc._ensure_word_embeds()
    want = np.asarray(jc.tables["word_embeds"])
    got = pc.tables["word_embeds"].numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    # specials contribute exactly nothing
    assert (got[np.asarray(pc.bridge.lens) == 0] == 0).all()


def _holdout_predictions(cap, layers, w, rows, mask, n_hold, port):
    if port:
        view = TruncatedTextTower(cap.clip_model.text_model, layers)
        h = cap._encode_rows(view, rows[-n_hold:], mask[-n_hold:], 1024)
    else:
        h = np.asarray(_jax_tower(cap, layers)(
            {"params": truncated_text_params(cap.params["clip"], layers)},
            jnp.asarray(rows[-n_hold:]), jnp.asarray(mask[-n_hold:])))
    return h.astype(np.float64) @ np.asarray(w, np.float64)


# (requested depth, 0 = automatic; the tower pre-cut's depth, 0 = none)
@pytest.mark.parametrize("layers,precut_layers", [(0, 0), (3, 1)])
def test_calibration_matches_reference(layers, precut_layers):
    kw = dict(prune_k=4, prune_stage1="factorized",
              prune_stage1_layers=layers)
    if precut_layers:
        kw.update(prune_stage1_precut=8, prune_stage1_precut_mode="tower",
                  prune_stage1_precut_layers=precut_layers)
    with _fields(**kw) as (jc, pc):
        for cap in (jc, pc):
            cap._ensure_stage1_calibration()
        _check_calibration(jc, pc, precut_layers)


def _check_calibration(jc, pc, precut_layers):
    # the same depth (the automatic one written into the config), the same
    # cache key, the held-out cosines within 1e-5
    layers = jc.cfg.prune_stage1_layers
    assert pc.cfg.prune_stage1_layers == layers >= 1
    assert pc.stage1_key == jc._stage1_meta == (layers, 32, precut_layers)
    assert abs(pc.stage1_calib_cos - jc.stage1_calib_cos) <= 1e-5
    rows, mask = pc._calibration_rows(2048, 0)
    n_hold = 2048 // 8
    fits = [(layers, "stage1_wcal")]
    if precut_layers:
        fits.append((precut_layers, "stage1_wcal_pc"))
        assert abs(pc.stage1_pc_calib_cos - jc.stage1_pc_calib_cos) <= 1e-5
    for depth, name in fits:
        want = _holdout_predictions(jc, depth, jc.tables[name], rows, mask,
                                    n_hold, port=False)
        got = _holdout_predictions(pc, depth, pc.tables[name].numpy(), rows,
                                   mask, n_hold, port=True)
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel <= 1e-4, (name, rel)


def test_calibration_cache_and_warning(monkeypatch, capsys):
    with _fields(prune_stage1="factorized", prune_k=4, prune_stage1_layers=1,
                 clip_len=24) as (_, pc):
        pc._ensure_stage1_calibration()
        # cached: the same request does not refit; another clip_len does
        w = pc.tables["stage1_wcal"]
        pc._ensure_stage1_calibration()
        assert pc.tables["stage1_wcal"] is w
        assert pc.stage1_key == (1, 24, 0)
        pc.cfg.clip_len = 16
        monkeypatch.setattr(sampler, "STAGE1_CALIB_FLOOR", 1.01)
        capsys.readouterr()
        pc._ensure_stage1_calibration()
        assert pc.tables["stage1_wcal"] is not w
        assert pc.stage1_key == (1, 16, 0)
        # below the floor: a warning on stderr, as the reference's
        assert "WARNING: factorized stage-1 calibration held-out cosine" in (
            capsys.readouterr().err)
        for bad in (4, 5):
            pc.cfg.prune_stage1_layers = bad
            with pytest.raises(ValueError, match="prune_stage1_layers"):
                pc._ensure_stage1_calibration()


def test_banned_tables_and_window_match_reference():
    jc, pc = _caps()
    jc._ensure_banned_tables()
    pc._ensure_banned_tables()
    for name in ("banned_mid", "banned_last"):
        np.testing.assert_array_equal(pc.tables[name].numpy(),
                                      np.asarray(jc.tables[name]))
    for clip_len, window in ((32, 0), (32, 13), (32, 32), (77, 20),
                             (77, 77), (77, 79), (24, 17)):
        with _fields(clip_len=clip_len, clip_window=window):
            assert pc._clip_window() == jc._clip_window(), (clip_len, window)


# ---------------------------------------------------------------------------
# the refusals: validate, the command line, run
# ---------------------------------------------------------------------------

# (config fields, the reference's message, or None where it gives none)
REFUSED = [
    (dict(prune_stage1="factorized"),
     "--prune_stage1 factorized requires --prune_k"),
    (dict(prune_stage1="factorized", prune_k=4, prune_stage1_precut=4),
     "--prune_stage1_precut must exceed --prune_k"),
    (dict(prune_stage1="factorized", prune_k=4, prune_stage1_precut=16,
          prune_stage1_precut_mode="tower", prune_stage1_layers=2,
          prune_stage1_precut_layers=2),
     "--prune_stage1_precut_layers must be SHALLOWER"),
    (dict(prune_k=4, prune_stage1_precut=16),
     "--prune_stage1_precut only applies to the factorized"),
    (dict(clip_window=-8), None),
    (dict(prune_stage1_layers=-1), None),
    (dict(prune_stage1_precut_layers=0), None),
    (dict(prune_stage1="deep"), None),
    (dict(mask_impl="lookup"), None),
]


@pytest.mark.parametrize("fields,message", REFUSED)
def test_validate_refuses_what_the_reference_refuses(fields, message):
    with pytest.raises(AssertionError) as want:
        JaxConfig(**fields).validate()
    with pytest.raises(ValueError) as got:
        ConzicConfig(**fields).validate()
    if message is not None:
        assert message in str(want.value)
        assert str(got.value) == str(want.value)


def test_validate_accepts_what_the_reference_accepts():
    for fields in (dict(prune_k=3, prune_stage1="factorized",
                        prune_stage1_layers=6, prune_stage1_precut=32,
                        topk_mode="approx", topk_recall=0.9),
                   dict(prune_k=5, prune_final_exact=True),
                   dict(prune_k=4, prune_stage1="factorized",
                        prune_stage1_layers=0, prune_stage1_precut=8,
                        prune_stage1_precut_mode="tower"),
                   dict(clip_window=24, clip_len=77, mask_impl="compare",
                        allow_deep_stage1=True, prune_stage1_ctl="off")):
        JaxConfig(**fields).validate()
        ConzicConfig(**fields).validate()


CLI_ARGS = ["--lm_model", TRAINED_TINY, "--match_model", TRAINED_TINY,
            "--device", "cpu", "--dtype", "float32"]


@pytest.mark.parametrize("argv,message", [
    (["--prune_stage1", "factorized"],
     "--prune_stage1 factorized requires --prune_k"),
    (["--prune_stage1", "factorized", "--prune_k", "4",
      "--prune_stage1_precut", "3"], "--prune_stage1_precut must exceed"),
    (["--prune_stage1", "factorized", "--prune_k", "4",
      "--prune_stage1_precut", "16", "--prune_stage1_precut_mode", "tower",
      "--prune_stage1_layers", "1", "--prune_stage1_precut_layers", "1"],
     "--prune_stage1_precut_layers must be SHALLOWER"),
    (["--prune_k", "4", "--prune_stage1_precut", "16"],
     "--prune_stage1_precut only applies to the factorized"),
])
def test_cli_ends_with_the_reference_message(argv, message, tmp_path,
                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        run_cli.main(CLI_ARGS + argv + ["--caption_img_path", str(tmp_path)])
    assert message in str(e.value)
    assert not (tmp_path / "results").exists()


def test_approx_top_k_without_prune_k_raises_at_run():
    args = dict(prompt="Image of a", max_len=3, top_k=8, temperature=0.1,
                max_iter=1, alpha=0.02, beta=2.0)
    with _fields(topk_mode="approx", prune_k=0) as (jc, pc):
        emb = np.zeros((1, pc.clip_model.config.projection_dim), np.float32)
        for cap, embeds in ((jc, jnp.asarray(emb)), (pc, emb)):
            with pytest.raises(ValueError, match="pruned-tier-only"):
                cap.run(embeds, **args)
            # prune_k not below top_k turns the tier off: refused too
            with pytest.raises(ValueError, match="pruned-tier-only"):
                cap.run(embeds, prune_k=8, **args)
