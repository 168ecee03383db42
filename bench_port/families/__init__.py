"""The tower families, one module a family, found by the ``model_type``
of the configuration's Hugging Face dict: ``lm`` names the masked-LM
proposer's family, ``match`` the dual-encoder matcher's
(``bench_port.run.families``).

Every family has ``vocab(config)``, its synthetic vocabulary at the
config's sizes; ``spec(config)``, (Hugging Face name, shape, kind) of
every weight, for ``bench_port.inputs.make_weights``;
``program(config, vocab)``, the program's tokenizer and tower config,
built through the port's public constructors (the only place besides
``bench_port/system.py`` that imports the program); ``reference(weights,
config, vocab, lowp=None)``, its plain float32 pieces, each matrix
product's operands in ``lowp`` for the control; and ``flops(config,
traffic)``, its model operations ``{"step": ..., "sample": ...,
"request": ...}``, a missing key counting 0.

A proposer's reference has ``text``, the caption's text rules
(``init_row``, ``allowed``, ``decode``, ``tokens``, ``vocab``), and
``logits(state, col)``: (B, V) vocabulary logits at column ``col`` of the
(B, S) rows ``state`` with that column masked. A matcher's has
``row(text, ids)``, the matcher's ids of a proposer row and their number
of valid positions; ``text_embeds(ids, n_valid)``; ``image_embeds(
pixels)``; ``logits(cos)``, the scores of cosines. A matcher also has
``pixels(config, seed, batch, device)``, a request's images preprocessed
as its tower takes them.
"""
