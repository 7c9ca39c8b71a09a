"""Token merging (ToMe) for the UNet transformer blocks of the serving path.

Port of `adaprompt_tpu/ops/tome.py` (ToMe for Stable Diffusion, Bolya &
Hoffman 2023, arXiv:2303.17604): before a transformer block runs at a large
resolution, the most similar source tokens are merged into destination
tokens (one per sy x sx window, its (0, 0) corner), the block's sub-layers
run on the reduced set, and unmerging copies each destination's output back
to the sources merged into it. The merge count r is quantized so that the
kept count stays a multiple of `align` (256).

Plain PyTorch: the cosine scores are one batched product, the stable
`torch.argsort` orders the sources as `jnp.argsort` does and `argmax` takes
the first maximum in both packages, so equal inputs give equal indices. The
JAX package's one-hot scatter-mean matmul (an XLA op there, no kernel) is an
`index_add_` here: the sums are the same up to their order of addition.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def quantize_merge_count(n: int, ratio: float, n_src: int, multiple: int = 256) -> int:
    """Largest r <= ratio*n with (n - r) % multiple == 0 and r <= n_src."""
    r = min(int(n * ratio), n_src)
    keep = -(-(n - r) // multiple) * multiple      # round keep up -> r down
    return max(n - keep, 0)


@functools.lru_cache(maxsize=32)
def _partition(h: int, w: int, sy: int, sx: int):
    """Static src/dst token split of an h x w row-major grid: dst = the
    (0, 0) corner of every sy x sx window, src = the rest.
    Returns (src_idx [Ns], dst_idx [Nd]) as numpy arrays (unmerge scatters
    by these, so the JAX package's inverse permutation is not needed)."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    is_dst = ((yy % sy == 0) & (xx % sx == 0)).reshape(-1)
    tok = np.arange(h * w)
    return tok[~is_dst], tok[is_dst]


def _gather_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, N, C], idx [B, K] -> t[b, idx[b, k]] as [B, K, C]."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def build_merge(x: torch.Tensor, h: int, w: int, ratio: float, sy: int = 2, sx: int = 2,
                align: int = 256):
    """(merge, unmerge, n_kept) from block-input features x [B, N, C]
    (N == h*w), whose cosine similarity is the matching metric (no
    gradient flows through the matching).

    merge(t [B, N, C]) -> [B, n_kept, C]   (unmerged sources, then destinations)
    unmerge(t [B, n_kept, C]) -> [B, N, C]"""
    b, n, c = x.shape
    if n != h * w:
        raise ValueError(f"{n} tokens do not form a {h}x{w} grid")
    src_np, dst_np = _partition(h, w, sy, sx)
    ns, nd = len(src_np), len(dst_np)
    r = quantize_merge_count(n, ratio, ns, align)
    if r <= 0:
        return (lambda t: t), (lambda t: t), n
    n_kept = n - r
    dev = x.device
    src_idx = torch.as_tensor(src_np, device=dev)
    dst_idx = torch.as_tensor(dst_np, device=dev)

    metric = x.detach().float()
    metric = metric / (torch.linalg.vector_norm(metric, dim=-1, keepdim=True) + 1e-6)
    scores = torch.einsum("bsc,bdc->bsd", metric[:, src_idx], metric[:, dst_idx])
    node_max = scores.amax(dim=-1)                             # [B, Ns]
    node_idx = scores.argmax(dim=-1)                           # [B, Ns], the first maximum
    order = torch.argsort(-node_max, dim=-1, stable=True)      # most similar first
    merged_pos, kept_pos = order[:, :r], order[:, r:]
    d_assign = torch.gather(node_idx, 1, merged_pos)           # [B, r] destination of each
    merged_tok = src_idx[merged_pos]                           # [B, r] token ids
    kept_tok = src_idx[kept_pos]                               # [B, Ns - r]
    flat_dst = (d_assign + torch.arange(b, device=dev)[:, None] * nd).reshape(-1)
    counts = torch.zeros(b * nd, device=dev).index_add_(
        0, flat_dst, torch.ones(b * r, device=dev)).reshape(b, nd, 1)

    def merge(t: torch.Tensor) -> torch.Tensor:
        dst_t = t[:, dst_idx]
        sums = torch.zeros(b * nd, t.shape[-1], device=dev).index_add_(
            0, flat_dst, _gather_rows(t, merged_tok).float().reshape(b * r, -1))
        dst_new = ((dst_t.float() + sums.reshape(b, nd, -1)) / (1.0 + counts)).to(t.dtype)
        return torch.cat([_gather_rows(t, kept_tok), dst_new], dim=1)

    def unmerge(t: torch.Tensor) -> torch.Tensor:
        unm_t, dst_t = t[:, :ns - r], t[:, ns - r:]
        full = torch.empty(b, n, t.shape[-1], dtype=t.dtype, device=dev)
        full[:, dst_idx] = dst_t
        full.scatter_(1, kept_tok[..., None].expand(-1, -1, t.shape[-1]), unm_t)
        full.scatter_(1, merged_tok[..., None].expand(-1, -1, t.shape[-1]),
                      _gather_rows(dst_t, d_assign))
        return full

    return merge, unmerge, n_kept
