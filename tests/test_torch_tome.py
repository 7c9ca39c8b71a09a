"""The port's ToMe (ops/tome.py) vs the JAX package on identical float32
inputs: the merge count, the static src/dst partition, and build_merge's
merge and unmerge, including inputs whose scores tie exactly (where the
first-index argmax and the stable sort must break ties the same way)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from adaprompt_tpu.ops import tome as jtome
from adaprompt_tpu_torch.ops import tome as ttome
from torch_port_helpers import assert_close, merge_gaps, t


@pytest.mark.parametrize("n", [256, 512, 1024, 4096, 1000])
@pytest.mark.parametrize("ratio", [0.0, 0.3, 0.5, 0.75])
def test_quantize_merge_count_matches_jax(n, ratio):
    for n_src, align in ((3 * n // 4, 256), (n // 2, 8), (n, 1)):
        assert (ttome.quantize_merge_count(n, ratio, n_src, align)
                == jtome.quantize_merge_count(n, ratio, n_src, align))


@pytest.mark.parametrize("h,w,sy,sx", [(8, 8, 2, 2), (16, 32, 2, 2), (6, 9, 3, 2)])
def test_partition_matches_jax(h, w, sy, sx):
    src, dst = ttome._partition(h, w, sy, sx)
    src_j, dst_j, inv_perm_j = jtome._partition(h, w, sy, sx)
    np.testing.assert_array_equal(src, src_j)
    np.testing.assert_array_equal(dst, dst_j)
    np.testing.assert_array_equal(np.concatenate([src, dst])[inv_perm_j], np.arange(h * w))


def _one_hot_tokens(rng, b, n, c):
    """Each token a one-hot vector of c categories: every score is exactly
    0 or the same 1/(1+1e-6)^2, so most argmaxes and most of the sort tie."""
    x = np.zeros((b, n, c), np.float32)
    x[np.arange(b)[:, None], np.arange(n)[None], rng.integers(0, c, (b, n))] = 1.0
    return x


@pytest.mark.parametrize("case", ["random", "tied"])
@pytest.mark.parametrize("h,w,ratio,align", [(16, 32, 0.5, 256), (32, 32, 0.5, 256),
                                             (8, 12, 0.4, 8)])
def test_build_merge_matches_jax(case, h, w, ratio, align):
    """Equal merge indices, read off token ids carried through merge and
    unmerge: the kept tokens, and the slot every merged and destination
    token reads back from. With random scores the two packages' fp32 scores
    differ by rounding, so the seeds are ones whose decisions have margin
    (asserted); the order among kept tokens (which changes nothing after
    unmerge) is then compared only where the scores tie exactly. Merged
    features agree within fp32 rounding (the scatter-mean adds in another
    order)."""
    rng = np.random.default_rng(h * w + len(case))
    b, n = 2, h * w
    if case == "tied":
        x = _one_hot_tokens(rng, b, n, 8)
    else:
        x = rng.standard_normal((b, n, 16)).astype(np.float32)
        assert min(merge_gaps(t(x), h, w, ratio, align)) > 1e-5
    mj, uj, kept_j = jtome.build_merge(jnp.asarray(x), h, w, ratio, align=align)
    mt, ut, kept_t = ttome.build_merge(t(x), h, w, ratio, align=align)
    assert kept_t == kept_j < n
    ns = len(ttome._partition(h, w, 2, 2)[0])
    r = n - kept_t

    ids = np.broadcast_to(np.arange(n, dtype=np.float32)[None, :, None], (b, n, 1)).copy()
    kept_t_ids = mt(t(ids))[:, :ns - r, 0].numpy()
    kept_j_ids = np.asarray(mj(jnp.asarray(ids)))[:, :ns - r, 0]
    np.testing.assert_array_equal(np.sort(kept_t_ids, -1), np.sort(kept_j_ids, -1))
    slots = np.broadcast_to(np.arange(kept_t, dtype=np.float32)[None, :, None],
                            (b, kept_t, 1)).copy()
    slot_t = ut(t(slots))[..., 0].numpy()
    slot_j = np.asarray(uj(jnp.asarray(slots)))[..., 0]
    not_kept = slot_t >= ns - r                  # merged sources and destinations
    np.testing.assert_array_equal(not_kept, slot_j >= ns - r)
    np.testing.assert_array_equal(slot_t[not_kept], slot_j[not_kept])
    assert set(np.unique(slot_t)) == set(range(kept_t))
    if case == "tied":
        np.testing.assert_array_equal(kept_t_ids, kept_j_ids)
        np.testing.assert_array_equal(slot_t, slot_j)

    feats = rng.standard_normal((b, n, 24)).astype(np.float32)
    merged_t, merged_j = mt(t(feats)), np.asarray(mj(jnp.asarray(feats)))
    assert merged_t.shape == (b, kept_t, 24)
    assert_close(merged_t[:, ns - r:], merged_j[:, ns - r:], atol=1e-6)
    assert_close(ut(merged_t), uj(jnp.asarray(merged_j)), atol=1e-6)


def test_build_merge_identity_when_nothing_merges():
    x = torch.randn(1, 64, 8)
    m, u, kept = ttome.build_merge(x, 8, 8, 0.5)        # 64 tokens: keep rounds up to 256
    assert kept == 64 and m(x) is x and u(x) is x
