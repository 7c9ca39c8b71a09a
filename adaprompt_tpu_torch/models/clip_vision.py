"""CLIP vision transformer (ViT) with the fg/bg pairwise attention mask.

Port of `adaprompt_tpu/models/clip_vision.py`. It serves the zero-shot
image features of the AdaFace background branch (`adaface/zs_features.py`):
a fg mask resized to the patch grid forms an outer-product pairwise mask
that is ADDED to the attention logits, a soft +1 bias on the pairs of
patches that are both foreground (and on every pair with the CLS token),
not -inf masking, as the reference's CLIPVisionModelWithMask passes the
raw 0/1 pairwise mask as an additive mask. The attention takes that full
[B, 1, S, S] mask, so it runs as plain attention, as in the JAX package.

Parameters mirror the JAX pytree (see convert.from_jax_params): the patch
embedding stays an HWIO leaf named `patch_embedding`. `from_torch` maps a
`transformers` CLIPVisionModel(WithProjection) state dict onto them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from adaprompt_tpu_torch.models.vae import _resize_mask_nearest
from adaprompt_tpu_torch.ops.attention import dot_product_attention
from adaprompt_tpu_torch.ops.layers import Linear, Norm, conv2d, layer_norm, quick_gelu
from adaprompt_tpu_torch.utils.resize import resize
from adaprompt_tpu_torch.utils.torch_port import layer_names, renamed


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self):
        return self.num_patches + 1


# openai/clip-vit-large-patch14's vision tower; the zero-shot features use
# the 1280-wide ViT-H/14 (LAION)
CLIP_VIT_L14_VISION = CLIPVisionConfig(hidden_size=1024, intermediate_size=4096,
                                       num_layers=24, num_heads=16, projection_dim=768)
CLIP_VIT_H14_VISION = CLIPVisionConfig(hidden_size=1280, intermediate_size=5120,
                                       num_layers=32, num_heads=16, projection_dim=1024)
CLIP_VIT_B32_VISION = CLIPVisionConfig(patch_size=32, hidden_size=768, intermediate_size=3072,
                                       num_layers=12, num_heads=12, projection_dim=512)


class CLIPVisionModel(nn.Module):
    """Weights: class/patch/position embeddings, pre_ln, `layers[i]` = {ln1,
    attn{q,k,v,out}, ln2, mlp{fc1, fc2}}, post_ln and the projection (no
    bias). Random init as the JAX package: normal(0, 0.02) weights and
    embeddings, zero biases, unit norms."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_H14_VISION, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d, i, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
        lin = lambda cin, cout, bias=True: Linear(cin, cout, bias, init_std=0.02, **kw)
        frozen = lambda *shape: nn.Parameter(torch.empty(*shape, **kw), requires_grad=False)
        self.class_embedding = frozen(d)
        self.patch_embedding = frozen(p, p, 3, d)             # HWIO
        self.position_embedding = frozen(cfg.seq_len, d)
        self.pre_ln = Norm(d, **kw)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "ln1": Norm(d, **kw),
                "attn": nn.ModuleDict({n: lin(d, d) for n in ("q", "k", "v", "out")}),
                "ln2": Norm(d, **kw),
                "mlp": nn.ModuleDict({"fc1": lin(d, i), "fc2": lin(i, d)}),
            }) for _ in range(cfg.num_layers))
        self.post_ln = Norm(d, **kw)
        self.projection = lin(d, cfg.projection_dim, bias=False)

    @classmethod
    def random_init(cls, seed: int, cfg: CLIPVisionConfig = CLIP_VIT_H14_VISION, *,
                    device=None, dtype=torch.float32) -> "CLIPVisionModel":
        """A tower with random weights from `seed`, on the card by default."""
        from adaprompt_tpu_torch.ops.layers import reset_parameters
        from adaprompt_tpu_torch.pipeline import resolve_device
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return reset_parameters(cls(cfg, device=device, dtype=dtype), gen)

    def reset(self, gen: torch.Generator):
        """Random-init the embeddings (layers.reset_parameters does the rest)."""
        for p in (self.class_embedding, self.patch_embedding, self.position_embedding):
            p.normal_(0.0, 0.02, generator=gen)

    def _attn(self, p, x, mask):
        b, s, d = x.shape
        nh = self.cfg.num_heads
        q = p["q"](x).reshape(b, s, nh, d // nh)
        k = p["k"](x).reshape(b, s, nh, d // nh)
        v = p["v"](x).reshape(b, s, nh, d // nh)
        o = dot_product_attention(q, k, v, mask=mask, use_flash=False)
        return p["out"](o.reshape(b, s, d))

    def patch_mask(self, attn_mask: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 1] fg mask -> [B, S]: nearest-resized to the patch grid,
        flattened, with a 1 prepended for the CLS token."""
        grid = int(math.sqrt(self.cfg.num_patches))
        m = _resize_mask_nearest(attn_mask, (grid, grid)).reshape(attn_mask.shape[0], -1)
        return torch.cat([torch.ones_like(m[:, :1]), m], dim=1)

    def encode(self, pixel_values: torch.Tensor, *, attn_mask: torch.Tensor | None = None,
               output_hidden_states: bool = False) -> dict:
        """pixel_values [B, H, W, 3] (CLIP-normalized, NHWC); attn_mask an
        optional [B, H, W, 1] fg mask whose pairwise product over the patch
        tokens is added to the logits.

        Returns {last_hidden_state [B, S, D], pooled [B, D] (post-LN CLS),
        image_embeds [B, P], hidden_states (the input of every layer, then
        the last output: num_layers + 1 entries) when asked}."""
        cfg = self.cfg
        b, d = pixel_values.shape[0], cfg.hidden_size
        weight = self.patch_embedding.permute(3, 2, 0, 1)     # OIHW
        patches = conv2d(pixel_values, weight, None, cfg.patch_size, 0)
        patches = patches.reshape(b, -1, d)
        cls = self.class_embedding[None, None].expand(b, 1, d).to(patches.dtype)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding[None].to(patches.dtype)
        eps = cfg.layer_norm_eps
        x = layer_norm(x, self.pre_ln.weight, self.pre_ln.bias, eps)

        mask = None
        if attn_mask is not None:
            m = self.patch_mask(attn_mask.float())
            mask = (m[:, :, None] * m[:, None, :])[:, None]      # [B, 1, S, S], added
        hidden_states = []
        for lp in self.layers:
            hidden_states.append(x)
            h = layer_norm(x, lp["ln1"].weight, lp["ln1"].bias, eps)
            x = x + self._attn(lp["attn"], h, mask)
            h = layer_norm(x, lp["ln2"].weight, lp["ln2"].bias, eps)
            x = x + lp["mlp"]["fc2"](quick_gelu(lp["mlp"]["fc1"](h)))
        hidden_states.append(x)
        pooled = layer_norm(x[:, 0], self.post_ln.weight, self.post_ln.bias, eps)
        out = {"last_hidden_state": x, "pooled": pooled, "image_embeds": self.projection(pooled)}
        if output_hidden_states:
            out["hidden_states"] = hidden_states
        return out


CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def from_torch(state_dict, cfg: CLIPVisionConfig = CLIP_VIT_H14_VISION) -> dict[str, torch.Tensor]:
    """A transformers CLIPVisionModel(WithProjection) state dict (keys under
    'vision_model.', or without it; the projection as
    'visual_projection.weight') -> a state dict for `CLIPVisionModel(cfg)`:
    the names change and the patch embedding goes from OIHW to HWIO. Without
    a visual projection the result has no 'projection.weight' (load it with
    strict=False, as the JAX package leaves the projection out). Entries no
    parameter reads (`position_ids`) are left out."""
    sd = {k.removeprefix("vision_model."): v for k, v in state_dict.items()}
    names = {"class_embedding": "embeddings.class_embedding",
             "position_embedding": "embeddings.position_embedding.weight"}
    pairs = [("pre_ln", "pre_layrnorm"), ("post_ln", "post_layernorm")]
    if "visual_projection.weight" in sd:
        pairs.append(("projection", "visual_projection"))
    for i in range(cfg.num_layers):
        src, dst = f"encoder.layers.{i}", f"layers.{i}"
        pairs += [(f"{dst}.ln1", f"{src}.layer_norm1"), (f"{dst}.ln2", f"{src}.layer_norm2"),
                  (f"{dst}.mlp.fc1", f"{src}.mlp.fc1"), (f"{dst}.mlp.fc2", f"{src}.mlp.fc2")]
        pairs += [(f"{dst}.attn.{n}", f"{src}.self_attn.{n}_proj") for n in ("q", "k", "v", "out")]
    out = renamed(sd, {**names, **layer_names(pairs, sd)})
    patch = renamed(sd, {"p": "embeddings.patch_embedding.weight"})["p"]
    out["patch_embedding"] = patch.permute(2, 3, 1, 0).contiguous()      # OIHW -> HWIO
    return out


def preprocess(images_uint8, size: int = 224, device=None) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> CLIP-normalized float32 [B, size, size, 3] on
    `device`: the antialiased bicubic resize of the JAX package
    (`utils/resize.resize`), then the CLIP mean and std."""
    x = torch.as_tensor(np.asarray(images_uint8), device=device).float() / 255.0
    x = resize(x, size, size)
    mean = torch.as_tensor(CLIP_IMAGE_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_IMAGE_STD, device=x.device)
    return (x - mean) / std
