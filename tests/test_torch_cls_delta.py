"""The port's class-delta functions (`adaprompt_tpu_torch/adaface/cls_delta.py`)
against the JAX package's on the same numpy inputs: the host scan's
results equal, the merge (two deltas in one row, offsets adding up; one
row with none) and the spread under each divisor bit-equal in float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu.adaface import cls_delta as jcd
from adaprompt_tpu_torch.adaface import cls_delta as tcd
from torch_port_helpers import torch_threads  # noqa: F401

S, D = 20, 8
EOS = 9
# class strings of two subjects: "young woman" (2 tokens), "teapot" (1)
DELTAS = {"alice": [301, 302], "pot": [303]}
WEIGHTS = {"alice": [0.25, 0.75], "pot": [1.0]}


def _ids():
    """[6, S]: three subject rows (placeholder 100) and their three class rows:
    row 3 holds "young woman" at the subject's position and "teapot" later in
    the span, row 4 "teapot" two tokens after it, row 5 no class string."""
    ids = np.full((6, S), EOS, np.int64)
    ids[:, 0] = 49406
    for r, pos in enumerate((3, 5, 2)):
        ids[r, 1:pos] = 7
        ids[r, pos] = 100
    ids[3, 1:3] = 7
    ids[3, 3:5] = DELTAS["alice"]
    ids[3, 5] = 11
    ids[3, 6] = DELTAS["pot"][0]
    ids[4, 1:7] = 7
    ids[4, 7] = DELTAS["pot"][0]
    ids[5, 1:6] = 8
    return ids, np.asarray([0, 1, 2]), np.asarray([3, 5, 2])


@pytest.mark.parametrize("span", [5, 1, 0])
def test_scan_matches_jax(span):
    ids, bi, pos = _ids()
    want = jcd.scan_cls_delta_strings(ids, bi, pos, DELTAS, max_search_span=span)
    got = tcd.scan_cls_delta_strings(torch.from_numpy(ids), bi, pos, DELTAS,
                                     max_search_span=span)
    assert got == want
    assert got == tcd.scan_cls_delta_strings(ids, bi, pos, DELTAS, max_search_span=span)
    if span == 5:
        assert want == [(3, 3, 2, "alice"), (4, 7, 1, "pot")]


def test_scan_edge_cases_match_jax():
    """No class strings, or as many subject indices as rows: nothing to scan."""
    ids, bi, pos = _ids()
    for args in ((ids, bi, pos, {}), (ids, np.arange(6), np.full(6, 2), DELTAS)):
        assert tcd.scan_cls_delta_strings(*args) == jcd.scan_cls_delta_strings(*args) == []


def test_merge_matches_jax():
    """Two deltas in one row (M = 2 then M = 3: the second written M - 1 = 1
    slot further left), one in another, a row untouched; bit-equal."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((4, S, D)).astype(np.float32)
    weights = dict(WEIGHTS, three=[0.2, 0.3, 0.5])
    indices = [(1, 9, 3, "three"), (1, 3, 2, "alice"), (3, 5, 1, "pot"), (2, 4, 2, "alice")]
    want = np.asarray(jcd.merge_cls_token_embeddings(jnp.asarray(emb), indices, weights))
    got = tcd.merge_cls_token_embeddings(torch.from_numpy(emb), indices, weights)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), emb[0])
    assert not np.array_equal(want[1], emb[1])
    np.testing.assert_array_equal(want[:, -1], emb[:, -1])          # the EOS slot stays
    x = torch.from_numpy(emb)
    assert tcd.merge_cls_token_embeddings(x, [], weights) is x
    assert np.array_equal(x.numpy(), emb)                             # out of place


@pytest.mark.parametrize("scheme", ["sqrt_M", "M", "none", None])
def test_distribute_to_m_tokens_matches_jax(scheme):
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((3, S, D)).astype(np.float32)
    for pos in ([4, 5, 6], [7, 4, 5, 4, 6, 8], [5]):
        want = np.asarray(jcd.distribute_embedding_to_M_tokens(jnp.asarray(emb), pos, scheme))
        got = tcd.distribute_embedding_to_M_tokens(torch.from_numpy(emb), pos, scheme)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(torch.from_numpy(emb).numpy(), emb)
