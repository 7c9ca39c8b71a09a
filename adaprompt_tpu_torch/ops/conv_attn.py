"""Convolutional subject-token attention.

Port of `adaprompt_tpu/ops/conv_attn.py::replace_rows_by_conv_attn`: for
the ks * ks subject embeddings, the pointwise q.k score column is replaced
by a convolutional one. The subject embeddings' keys, arranged as a ks x ks
kernel per head, slide over that head's q feature map (one grouped
convolution over all instances and heads); each embedding receives a copy
of the response shifted by its own offset, with the wrapped-around borders
zeroed, so the K embeddings attend to K neighbouring offsets. The JAX
package has no Pallas kernel for it, and neither has the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PADS = {2: (0, 1, 0, 1), 3: (1, 1, 1, 1), 4: (1, 2, 1, 2)}  # left, right, top, bottom


def replace_rows_by_conv_attn(attn_mat: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
                              subj_pos: torch.Tensor, infeat_size: tuple,
                              conv_attn_kernel_size: int, sim_scale: float,
                              conv_attn_mix_weight: float = 1.0,
                              shift_attn_maps_for_diff_embs: bool = True) -> torch.Tensor:
    """attn_mat: [B, H, N, T] pre-softmax scores; q: [B, H, N, C]; k:
    [B, H, T, C]; subj_pos: [BS, M] token positions of the M subject
    embeddings of the first BS instances (M >= ks * ks; the first ks * ks
    are used); infeat_size: (h, w) with h * w == N. Returns the updated
    scores, out of place."""
    ks = conv_attn_kernel_size
    if ks == 1:
        return attn_mat
    left, right, top, bottom = _PADS[ks]
    h, w = infeat_size
    n_heads, c = q.shape[1], q.shape[-1]
    subj_pos = torch.as_tensor(subj_pos, device=attn_mat.device).long()
    bs = subj_pos.shape[0]
    k2 = ks * ks
    pos = subj_pos[:, :k2]

    # q of each instance and head as a feature map: [1, BS*H*C, h, w], padded
    qmap = q[:bs].transpose(2, 3).reshape(1, bs * n_heads * c, h, w)
    qmap = F.pad(qmap, (left, right, top, bottom))
    # the kernel of each instance and head from its subject keys: [BS*H, C, ks, ks]
    subj_k = torch.gather(k[:bs], 2, pos[:, None, :, None].expand(bs, n_heads, k2, c))
    wgt = subj_k.transpose(2, 3).reshape(bs * n_heads, c, ks, ks)
    sa = F.conv2d(qmap, wgt, groups=bs * n_heads).reshape(bs, n_heads, h, w)
    sa = sa * (sim_scale / ks ** 1.5)

    if shift_attn_maps_for_diff_embs:
        maps = []
        for dy in range(-top, bottom + 1):
            for dx in range(-left, right + 1):
                shifted = torch.roll(sa, (dy, dx), dims=(2, 3))
                # zero the wrapped-around borders (F.pad semantics)
                if dy > 0:
                    shifted[:, :, :dy, :] = 0.0
                elif dy < 0:
                    shifted[:, :, dy:, :] = 0.0
                if dx > 0:
                    shifted[:, :, :, :dx] = 0.0
                elif dx < 0:
                    shifted[:, :, :, dx:] = 0.0
                maps.append(shifted)
        sa_all = torch.stack(maps, dim=1)                   # [BS, ks2, H, h, w]
    else:
        sa_all = sa[:, None].expand(bs, k2, n_heads, h, w)
    conv_attn = sa_all.reshape(bs, k2, n_heads, h * w)

    # the columns pos[i] of the first BS rows, [BS, ks2, H, N]
    bi = torch.arange(bs, device=attn_mat.device)[:, None].expand(bs, k2)
    old = attn_mat[bi, :, :, pos]
    new = old * (1.0 - conv_attn_mix_weight) + conv_attn * conv_attn_mix_weight
    out = attn_mat.clone()
    out[bi, :, :, pos] = new.to(attn_mat.dtype)
    return out
