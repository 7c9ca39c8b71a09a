"""Read diffusers-format checkpoints into the port's UNet and VAE.

Port of `adaprompt_tpu/utils/diffusers_port.py`. The Arc2Face teacher is
published as a diffusers `UNet2DConditionModel` (beside its CLIP encoder),
and many SD-1.5 forks ship the diffusers layout. The architecture is the
LDM one the port's models follow, so only names (and, for some 1x1
projections, the rank) change. `unet_from_diffusers` and
`vae_from_diffusers` return state dicts for `UNet(cfg)` / `VAE(cfg)`, the
form `models/unet.from_torch` and `models/vae.from_torch` return, which
`load_state_dict` takes.

Both forms of each diffusers naming are read, as the JAX package reads them:
  * the transformers' `proj_in` / `proj_out` as Conv2d [O, I, 1, 1] or, in
    newer diffusers, Linear [O, I] (made a 1x1 conv here);
  * the VAE mid-block attention as `to_q` / `to_k` / `to_v` / `to_out.0`
    or the legacy `query` / `key` / `value` / `proj_attn`, its norm as
    `group_norm` or `norm`, each projection Linear or 1x1 Conv2d;
  * the optional ResNet `conv_shortcut`, the attention blocks, down- and
    upsamplers, each by the presence of its key;
  * diffusers' decoder `up_blocks.0` is the deepest level, where the port's
    `decoder.up[0]` is the shallowest.
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.models.unet import SD15_UNET_CONFIG, UNetConfig
from adaprompt_tpu_torch.models.vae import SD15_VAE_CONFIG, VAEConfig


class _Names:
    """{port name: (diffusers name, as a 1x1 conv)} of one state dict."""

    def __init__(self, sd: dict):
        self.sd, self.map = sd, {}

    def has(self, key: str) -> bool:
        return key in self.sd

    def layer(self, dst: str, src: str, conv1x1: bool = False):
        """The weight and, where the file holds one, the bias of a layer."""
        self.map[dst + ".weight"] = (src + ".weight", conv1x1)
        if src + ".bias" in self.sd:
            self.map[dst + ".bias"] = (src + ".bias", False)

    def state_dict(self) -> dict[str, torch.Tensor]:
        out = {}
        for dst, (src, conv1x1) in self.map.items():
            v = self.sd[src]
            v = v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[dst] = v[:, :, None, None] if conv1x1 and v.ndim == 2 else v
        return out


def _resnet(n: _Names, dst: str, src: str):
    for d, s in (("norm_in", "norm1"), ("conv_in", "conv1"), ("emb", "time_emb_proj"),
                 ("norm_out", "norm2"), ("conv_out", "conv2")):
        n.layer(f"{dst}.{d}", f"{src}.{s}")
    if n.has(src + ".conv_shortcut.weight"):
        n.layer(dst + ".skip", src + ".conv_shortcut")


def _transformer(n: _Names, dst: str, src: str):
    b, tb = dst + ".block", src + ".transformer_blocks.0"
    n.layer(dst + ".norm", src + ".norm")
    n.layer(dst + ".proj_in", src + ".proj_in", conv1x1=True)
    n.layer(dst + ".proj_out", src + ".proj_out", conv1x1=True)
    for i in (1, 2, 3):
        n.layer(f"{b}.norm{i}", f"{tb}.norm{i}")
    for a in ("attn1", "attn2"):
        for p in ("to_q", "to_k", "to_v"):
            n.layer(f"{b}.{a}.{p}", f"{tb}.{a}.{p}")
        n.layer(f"{b}.{a}.to_out", f"{tb}.{a}.to_out.0")
    n.layer(b + ".ff.proj", tb + ".ff.net.0.proj")
    n.layer(b + ".ff.out", tb + ".ff.net.2")


def unet_from_diffusers(state_dict, cfg: UNetConfig = SD15_UNET_CONFIG) -> dict[str, torch.Tensor]:
    """A diffusers UNet2DConditionModel state dict -> a state dict for
    `UNet(cfg)`."""
    n = _Names(dict(state_dict))
    n.layer("time_embed.fc1", "time_embedding.linear_1")
    n.layer("time_embed.fc2", "time_embedding.linear_2")
    n.layer("input_blocks.0.conv", "conv_in")
    idx = 1
    for level in range(len(cfg.channel_mult)):
        p = f"down_blocks.{level}"
        for j in range(cfg.num_res_blocks):
            _resnet(n, f"input_blocks.{idx}.res", f"{p}.resnets.{j}")
            if n.has(f"{p}.attentions.{j}.proj_in.weight"):
                _transformer(n, f"input_blocks.{idx}.attn", f"{p}.attentions.{j}")
            idx += 1
        if n.has(f"{p}.downsamplers.0.conv.weight"):
            n.layer(f"input_blocks.{idx}.downsample", f"{p}.downsamplers.0.conv")
            idx += 1
    _resnet(n, "middle_block.res1", "mid_block.resnets.0")
    _transformer(n, "middle_block.attn", "mid_block.attentions.0")
    _resnet(n, "middle_block.res2", "mid_block.resnets.1")
    idx = 0
    for level in range(len(cfg.channel_mult)):       # up_blocks.0 is the deepest level
        p = f"up_blocks.{level}"
        for j in range(cfg.num_res_blocks + 1):
            _resnet(n, f"output_blocks.{idx}.res", f"{p}.resnets.{j}")
            if n.has(f"{p}.attentions.{j}.proj_in.weight"):
                _transformer(n, f"output_blocks.{idx}.attn", f"{p}.attentions.{j}")
            if j == cfg.num_res_blocks and n.has(f"{p}.upsamplers.0.conv.weight"):
                n.layer(f"output_blocks.{idx}.upsample", f"{p}.upsamplers.0.conv")
            idx += 1
    n.layer("out.norm", "conv_norm_out")
    n.layer("out.conv", "conv_out")
    return n.state_dict()


def _resnet_vae(n: _Names, dst: str, src: str):
    for i in (1, 2):
        n.layer(f"{dst}.norm{i}", f"{src}.norm{i}")
        n.layer(f"{dst}.conv{i}", f"{src}.conv{i}")
    if n.has(src + ".conv_shortcut.weight"):
        n.layer(dst + ".nin_shortcut", src + ".conv_shortcut")


def _vae_attention(n: _Names, dst: str, src: str):
    n.layer(dst + ".norm", src + (".group_norm" if n.has(src + ".group_norm.weight") else ".norm"))
    for d, new, legacy in (("q", "to_q", "query"), ("k", "to_k", "key"), ("v", "to_v", "value"),
                           ("proj_out", "to_out.0", "proj_attn")):
        name = new if n.has(f"{src}.{new}.weight") else legacy
        n.layer(f"{dst}.{d}", f"{src}.{name}", conv1x1=True)


def vae_from_diffusers(state_dict, cfg: VAEConfig = SD15_VAE_CONFIG) -> dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict -> a state dict for `VAE(cfg)`."""
    n = _Names(dict(state_dict))
    levels = cfg.num_resolutions
    for tower, kind, blocks in (("encoder", "down", cfg.num_res_blocks),
                                ("decoder", "up", cfg.num_res_blocks + 1)):
        n.layer(f"{tower}.conv_in", f"{tower}.conv_in")
        for i in range(levels):
            src = f"{tower}.{kind}_blocks.{i if kind == 'down' else levels - 1 - i}"
            dst = f"{tower}.{kind}.{i}"
            for j in range(blocks):
                _resnet_vae(n, f"{dst}.block.{j}", f"{src}.resnets.{j}")
            for resample in ("downsample", "upsample"):
                if n.has(f"{src}.{resample}rs.0.conv.weight"):
                    n.layer(f"{dst}.{resample}", f"{src}.{resample}rs.0.conv")
        mid = f"{tower}.mid_block"
        _resnet_vae(n, f"{tower}.mid.block_1", mid + ".resnets.0")
        _vae_attention(n, f"{tower}.mid.attn_1", mid + ".attentions.0")
        _resnet_vae(n, f"{tower}.mid.block_2", mid + ".resnets.1")
        n.layer(f"{tower}.norm_out", f"{tower}.conv_norm_out")
        n.layer(f"{tower}.conv_out", f"{tower}.conv_out")
    n.layer("quant_conv", "quant_conv")
    n.layer("post_quant_conv", "post_quant_conv")
    return n.state_dict()
