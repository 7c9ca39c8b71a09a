"""DINO ViT-S/16, the image model of the DINO similarity score and of the
object branch's features.

Port of `adaprompt_tpu/models/dino.py` (facebook/dino-vits16, a
transformers ViTModel): a pre-LN ViT with a patch conv, a CLS token,
learned positions, exact-GELU MLPs and a final LN (eps 1e-12); the image
embedding is the CLS token of the final LN. Its attention is plain PyTorch
(`dot_product_attention(..., use_flash=False)`, as the JAX package forces
it): 197 tokens are below the flash kernel's threshold in any case, so no
kernel of the port runs here.

Parameters mirror the JAX pytree (see `convert.from_jax_params`): the patch
conv is `patch_embedding` (weight OIHW, bias). `from_torch` maps a
transformers ViTModel state dict onto them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from adaprompt_tpu_torch.ops.attention import dot_product_attention
from adaprompt_tpu_torch.ops.layers import Conv2d, Linear, Norm, conv2d, gelu, layer_norm
from adaprompt_tpu_torch.utils.resize import resize
from adaprompt_tpu_torch.utils.torch_port import layer_names, renamed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 384
    intermediate_size: int = 1536
    num_layers: int = 12
    num_heads: int = 6
    layer_norm_eps: float = 1e-12

    @property
    def seq_len(self):
        return (self.image_size // self.patch_size) ** 2 + 1


DINO_VITS16 = ViTConfig()

DINO_IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
DINO_IMAGE_STD = np.array([0.229, 0.224, 0.225], np.float32)


class DINO(nn.Module):
    """Weights: cls_token [1, 1, D], patch_embedding, position_embedding
    [S, D], `layers[i]` = {ln1, attn{q, k, v, out}, ln2, mlp{fc1, fc2}},
    final_ln. Random init as the JAX package: normal(0, 0.02) weights and
    embeddings, zero biases, unit norms."""

    def __init__(self, cfg: ViTConfig = DINO_VITS16, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d, i = cfg.hidden_size, cfg.intermediate_size
        lin = lambda cin, cout: Linear(cin, cout, init_std=0.02, **kw)
        self.cls_token = nn.Parameter(torch.empty(1, 1, d, **kw), requires_grad=False)
        self.patch_embedding = Conv2d(3, d, cfg.patch_size, init_std=0.02, **kw)
        self.position_embedding = nn.Parameter(torch.empty(cfg.seq_len, d, **kw),
                                               requires_grad=False)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "ln1": Norm(d, **kw),
                "attn": nn.ModuleDict({n: lin(d, d) for n in ("q", "k", "v", "out")}),
                "ln2": Norm(d, **kw),
                "mlp": nn.ModuleDict({"fc1": lin(d, i), "fc2": lin(i, d)}),
            }) for _ in range(cfg.num_layers))
        self.final_ln = Norm(d, **kw)

    @classmethod
    def random_init(cls, seed: int, cfg: ViTConfig = DINO_VITS16, *, device=None,
                    dtype=torch.float32) -> "DINO":
        """A model with random weights from `seed`, on the card by default."""
        from adaprompt_tpu_torch.ops.layers import reset_parameters
        from adaprompt_tpu_torch.pipeline import resolve_device
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return reset_parameters(cls(cfg, device=device, dtype=dtype), gen).eval()

    def reset(self, gen: torch.Generator):
        """Random-init the embeddings (layers.reset_parameters does the rest)."""
        for p in (self.cls_token, self.position_embedding):
            p.normal_(0.0, 0.02, generator=gen)

    def encode(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values [B, H, W, 3] (DINO-normalized, NHWC) -> the CLS
        embeddings of the final LN [B, D]."""
        cfg = self.cfg
        b, d, nh = pixel_values.shape[0], cfg.hidden_size, cfg.num_heads
        pe = self.patch_embedding
        x = conv2d(pixel_values, pe.weight, pe.bias, cfg.patch_size, 0).reshape(b, -1, d)
        cls = self.cls_token.expand(b, 1, d).to(x.dtype)
        x = torch.cat([cls, x], dim=1) + self.position_embedding[None].to(x.dtype)
        eps = cfg.layer_norm_eps
        for lp in self.layers:
            h = layer_norm(x, lp["ln1"].weight, lp["ln1"].bias, eps)
            s = h.shape[1]
            q, k, v = (lp["attn"][n](h).reshape(b, s, nh, d // nh) for n in "qkv")
            a = dot_product_attention(q, k, v, use_flash=False).reshape(b, s, d)
            x = x + lp["attn"]["out"](a)
            h = layer_norm(x, lp["ln2"].weight, lp["ln2"].bias, eps)
            x = x + lp["mlp"]["fc2"](gelu(lp["mlp"]["fc1"](h)))
        x = layer_norm(x, self.final_ln.weight, self.final_ln.bias, eps)
        return x[:, 0]


def from_torch(state_dict, cfg: ViTConfig = DINO_VITS16) -> dict[str, torch.Tensor]:
    """A transformers ViTModel state dict (facebook/dino-vits16; keys under
    'vit.' or without it) -> a state dict for `DINO(cfg)`: the names change,
    the position embeddings lose their batch axis; the patch conv stays OIHW.
    Entries no parameter reads (a pooler) are left out."""
    sd = {k.removeprefix("vit."): v for k, v in state_dict.items()}
    names = {"cls_token": "embeddings.cls_token"}
    pairs = [("patch_embedding", "embeddings.patch_embeddings.projection"),
             ("final_ln", "layernorm")]
    for li in range(cfg.num_layers):
        src, dst = f"encoder.layer.{li}", f"layers.{li}"
        pairs += [(f"{dst}.ln1", f"{src}.layernorm_before"),
                  (f"{dst}.ln2", f"{src}.layernorm_after"),
                  (f"{dst}.attn.out", f"{src}.attention.output.dense"),
                  (f"{dst}.mlp.fc1", f"{src}.intermediate.dense"),
                  (f"{dst}.mlp.fc2", f"{src}.output.dense")]
        pairs += [(f"{dst}.attn.{n}", f"{src}.attention.attention.{full}")
                  for n, full in (("q", "query"), ("k", "key"), ("v", "value"))]
    out = renamed(sd, {**names, **layer_names(pairs, sd)})
    pos = renamed(sd, {"p": "embeddings.position_embeddings"})["p"]
    out["position_embedding"] = pos[0]
    return {k: v.float() for k, v in out.items()}


def preprocess(images_uint8, size: int = 224, device=None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> DINO-normalized float32 [B, size, size, 3] on
    `device`: the antialiased bicubic resize of the JAX package, then the
    ImageNet mean and std."""
    x = torch.as_tensor(np.asarray(images_uint8), device=device).float() / 255.0
    x = resize(x, size, size)
    mean = torch.as_tensor(DINO_IMAGE_MEAN, device=x.device)
    std = torch.as_tensor(DINO_IMAGE_STD, device=x.device)
    return (x - mean) / std
