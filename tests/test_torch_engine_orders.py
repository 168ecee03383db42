"""The port's ``Captioner.run`` == ``conzic_tpu``'s in the span and
parallel orders and under every ``attn_impl``, caption ids byte for byte.

The cases of ``tests/test_torch_engine.py`` that run the port's other
attention routes and the two orders without randomness, on its captioner
pairs (tiny random fp32 towers initialised as ``init_mode="proper"`` does,
and ``trained_tiny/``) and its comparison: identical ids of every
iteration and of the best pick, cosines within 1e-4. A file of its own so
that the two halves run on two workers.
"""

import pytest

from _torch_port import one_torch_thread  # noqa: F401  (a fixture)
from test_torch_engine import _assert_same_run, _embeds

from conzic_torch.config import ATTN_IMPLS


# span: an odd sentence_len leaves a last span of one slot; parallel: the
# candidates come from the iteration-start rows. kv_chunk_size=0 encodes
# every candidate row in full, so pallas_block takes the text rows too
@pytest.mark.parametrize("kv_chunk_size", [16, 0])
@pytest.mark.parametrize("attn_impl", ATTN_IMPLS)
@pytest.mark.parametrize("order", ["span", "parallel"])
def test_span_and_parallel_match_reference(order, attn_impl, kv_chunk_size):
    _assert_same_run("random", dict(kv_chunk_size=kv_chunk_size),
                     _embeds("random", 2), attn_impl=attn_impl, max_len=5,
                     top_k=12, max_iter=2, order=order, n_samples=2)


@pytest.mark.parametrize("attn_impl", ["pallas_out", "pallas_block"])
@pytest.mark.parametrize("order,kv_chunk_size", [
    ("sequential", 16), ("sequential", 0), ("shuffle", 16),
])
def test_single_orders_match_reference_under_attn_impl(order, kv_chunk_size,
                                                       attn_impl):
    _assert_same_run("random", dict(kv_chunk_size=kv_chunk_size),
                     _embeds("random", 2), attn_impl=attn_impl, max_len=5,
                     top_k=12, max_iter=2, order=order)


@pytest.mark.parametrize("order,attn_impl", [
    ("span", "pallas"), ("span", "pallas_block"), ("parallel", "pallas_out"),
])
def test_trained_tiny_span_and_parallel_match_reference(order, attn_impl):
    _assert_same_run("trained_tiny", {}, _embeds("trained_tiny", 3),
                     attn_impl=attn_impl, max_len=6, top_k=16, max_iter=2,
                     order=order)
