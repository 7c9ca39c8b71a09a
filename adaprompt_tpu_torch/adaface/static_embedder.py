"""StaticLayerwiseEmbedding: the legacy (non-zero-shot) textual-inversion
embedder.

Port of `adaprompt_tpu/adaface/static_embedder.py`. Per placeholder, 16
layerwise embeddings of K vectors are combinations of r basis vectors,

    out[l, k] = LN((basis_rand_w[l, k] + basis_comm_w[0, k]) @ basis[k])
                / sqrt(D) + bias[l, k]

with a non-affine LayerNorm, where basis[k] is the optional `pre_vecs`
(the first N basis vectors, made from init-word embeddings) followed by the
learned `basis_vecs`. The initialization draws from a `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from adaprompt_tpu_torch.ops.layers import layer_norm


@dataclasses.dataclass(frozen=True)
class StaticEmbedderConfig:
    num_layers: int = 16
    num_vectors: int = 1          # K
    out_emb_dim: int = 768
    rank: int = 6                 # r
    num_init_vecs: int = 0        # N (leading basis vectors from init words)
    has_bias: bool = True


class StaticLayerwiseEmbedding(nn.Module):
    """Parameters `basis_rand_weights` [L, K, r], `basis_comm_weights`
    [1, K, r], `basis_vecs` [K, r - N, D], and optionally `pre_vecs`
    [K, N, D] and `bias` [L, K, D]; forward() -> [L, K, D]. The random
    initialization draws from `gen` (a generator seeded 0 when None)."""

    def __init__(self, cfg: StaticEmbedderConfig, gen: torch.Generator | None = None,
                 init_vecs: torch.Tensor | None = None, init_vec_weights=None,
                 init_noise_stds=(0.1, 0.04), device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        L, K, r, D = cfg.num_layers, cfg.num_vectors, cfg.rank, cfg.out_emb_dim
        dev = torch.device("cpu") if device is None else torch.device(device)
        gen = gen if gen is not None else torch.Generator(device=dev).manual_seed(0)
        randn = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        n = 0 if init_vecs is None else init_vecs.shape[0]
        basis_rand = randn(L, K, r)
        basis_comm = torch.full((1, K, r), 1.0 / r, device=dev, dtype=dtype)
        if init_vecs is not None:
            self.pre_vecs = nn.Parameter(
                torch.as_tensor(init_vecs, device=dev, dtype=dtype)[None].repeat(K, 1, 1))
            basis_comm = torch.full((1, K, r), 1.0 / n, device=dev, dtype=dtype)
            basis_comm[:, :, n:] *= 0.4
            if init_vec_weights is not None:
                basis_comm[:, :, :n] = torch.as_tensor(
                    np.asarray(init_vec_weights, np.float32), device=dev, dtype=dtype)
            basis_rand[:, :, :n] *= init_noise_stds[1]
            basis_rand[:, :, n:] *= init_noise_stds[0]
        basis_vecs = randn(K, r - n, D)
        basis_vecs = basis_vecs / basis_vecs.norm(dim=-1, keepdim=True) / 4.0
        basis_vecs[-1] = 0.0
        self.basis_rand_weights = nn.Parameter(basis_rand)
        self.basis_comm_weights = nn.Parameter(basis_comm)
        self.basis_vecs = nn.Parameter(basis_vecs)
        if cfg.has_bias:
            self.bias = nn.Parameter(torch.zeros((L, K, D), device=dev, dtype=dtype))

    def forward(self) -> torch.Tensor:
        weights = self.basis_rand_weights + self.basis_comm_weights            # [L, K, r]
        basis = (torch.cat([self.pre_vecs, self.basis_vecs], dim=1)
                 if hasattr(self, "pre_vecs") else self.basis_vecs)            # [K, r, D]
        out = torch.einsum("lkr,krd->lkd", weights, basis)
        out = layer_norm(out, None, None).to(out.dtype) / np.sqrt(self.cfg.out_emb_dim)
        return out + self.bias if hasattr(self, "bias") else out


def from_torch(state_dict: dict, cfg: StaticEmbedderConfig, device=None,
               dtype=torch.float32) -> StaticLayerwiseEmbedding:
    """The reference's state dict (keys `basis_rand_weights`,
    `basis_comm_weights`, `basis_vecs`, optionally `pre_vecs` and `bias`)
    as a StaticLayerwiseEmbedding; its shapes set L, K, r, N and D."""
    sd = {k: torch.as_tensor(v.detach().float().cpu() if hasattr(v, "detach") else np.asarray(v))
          for k, v in state_dict.items()}
    init = sd.get("pre_vecs")
    L, K, r = sd["basis_rand_weights"].shape
    cfg = dataclasses.replace(cfg, num_layers=L, num_vectors=K, rank=r,
                              out_emb_dim=sd["basis_vecs"].shape[-1],
                              num_init_vecs=0 if init is None else init.shape[1],
                              has_bias="bias" in sd)
    module = StaticLayerwiseEmbedding(cfg, init_vecs=None if init is None else init[0],
                                      device=device, dtype=dtype)
    keys = [k for k in ("basis_rand_weights", "basis_comm_weights", "basis_vecs", "pre_vecs",
                        "bias") if k in sd]
    module.load_state_dict({k: sd[k] for k in keys}, strict=True)
    return module
