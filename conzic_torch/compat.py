"""Reference-shaped call signatures.

Counterpart of ``conzic_tpu/compat.py``: drop-in signatures for code
written against the reference's modules (``gen_utils.generate_caption``,
``control_gen_utils.control_generate_caption``, ``utils.*``). The reference
passes the model, CLIP, tokenizer and token mask separately; here they
live in a :class:`~conzic_torch.engine.sampler.Captioner`, which goes in
the ``model`` slot (``clip``, ``tokenizer`` and ``token_mask`` are then
ignored).

    from conzic_torch import compat as gen_utils
    texts, scores = gen_utils.generate_caption(
        img_name, captioner, None, None, image_instance, None, logger,
        prompt=..., batch_size=..., max_len=..., top_k=..., ...)
"""

from __future__ import annotations

import numpy as np

from conzic_torch.engine import sampler as _sampler
from conzic_torch.engine.sampler import Captioner
from conzic_torch.runtime.logging import create_logger  # noqa: F401 (utils)
from conzic_torch.runtime.seeding import set_seed  # noqa: F401 (utils)


def _as_captioner(model) -> Captioner:
    if isinstance(model, Captioner):
        return model
    raise TypeError(
        "conzic_torch.compat expects a conzic_torch Captioner in the "
        "`model` argument slot (build one with "
        "Captioner.from_pretrained(config)); the reference's HF model "
        "objects are not taken.")


def generate_caption(img_name, model, clip, tokenizer, image_instance,
                     token_mask, logger, prompt="", batch_size=1, max_len=15,
                     top_k=100, temperature=1.0, max_iter=500, alpha=0.7,
                     beta=1.0, generate_order="sequential"):
    """The signature of the reference's ``gen_utils.generate_caption``."""
    return _sampler.generate_caption(
        img_name, _as_captioner(model), image_instance, logger,
        prompt=prompt, batch_size=batch_size, max_len=max_len, top_k=top_k,
        temperature=temperature, max_iter=max_iter, alpha=alpha, beta=beta,
        generate_order=generate_order)


def control_generate_caption(img_name, model, clip, tokenizer, image_instance,
                             token_mask, logger, prompt="", batch_size=10,
                             max_len=25, top_k=100, temperature=1.0,
                             max_iter=500, alpha=0.7, beta=1.0, gamma=5.0,
                             ctl_type="sentiment", style_type="positive",
                             pos_type=None, generate_order="sequential"):
    """The signature of the reference's
    ``control_gen_utils.control_generate_caption``."""
    return _sampler.control_generate_caption(
        img_name, _as_captioner(model), image_instance, logger,
        prompt=prompt, batch_size=batch_size, max_len=max_len, top_k=top_k,
        temperature=temperature, max_iter=max_iter, alpha=alpha, beta=beta,
        gamma=gamma, ctl_type=ctl_type, style_type=style_type,
        pos_type=pos_type, generate_order=generate_order)


def get_init_text(tokenizer, seed_text, max_len, batch_size=1):
    """``utils.get_init_text``: takes a tokenizer or a Captioner."""
    if isinstance(tokenizer, Captioner):
        return tokenizer.init_ids(seed_text, max_len, batch_size).tolist()
    text = seed_text + tokenizer.mask_token * max_len
    ids = tokenizer.encode(text)
    return [ids] * batch_size


def update_token_mask(tokenizer, token_mask, max_len, index):
    """``utils.update_token_mask`` on a numpy mask: '.' is allowed at the
    last slot only. Takes a tokenizer with ``.vocab`` or a Captioner; a
    vocabulary without '.' leaves the mask as it is."""
    vocab = getattr(tokenizer, "vocab", None)
    if vocab is None:
        vocab = tokenizer.wp.vocab
    period = vocab.get(".")
    mask = np.asarray(token_mask).copy()
    if period is not None:
        mask[..., period] = 1.0 if index == max_len - 1 else 0.0
    return mask


def format_output(sample_num, final_caption, best_caption):
    """``utils.format_output``: the first samples joined by newlines."""
    from conzic_torch.api.app import format_output as _format_output

    return _format_output(sample_num, final_caption, best_caption)
