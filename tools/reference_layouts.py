"""Write the port's models as the reference's checkpoint files, for tests
and `chip_smoke.py` (no real weight file is needed to exercise the loaders):

  * `sd_checkpoint(pipe)`: a full SD-1.5 `.ckpt` state dict in the LDM
    layout (UNet under 'model.diffusion_model.', VAE under
    'first_stage_model.', the HF CLIP text model under
    'cond_stage_model.transformer.'), float32 as the published
    `v1-5-pruned-emaonly.ckpt` is, with some of its entries that no model
    reads ('model_ema.decay', 'model_ema.num_updates', 'alphas_cumprod',
    the text model's 'position_ids');
  * `write_adaface_pt(path, {placeholder: generator})`: an AdaFace
    `embeddings_gs-*.pt` whose `string_to_subj_basis_generator_dict` holds
    each SubjBasisGenerator pickled as a module of the reference's class
    `adaface.subj_basis_generator.SubjBasisGenerator` (its K/V-widened
    attention layers as `adaface.arc2face_models.CLIPAttentionMKV`), the
    classes registered for the save only;
  * `unet_diffusers(unet)` / `vae_diffusers(vae)`: diffusers
    UNet2DConditionModel / AutoencoderKL state dicts, float32, each in
    either form of the namings that differ between diffusers versions
    (`linear_proj`, `legacy_attn_names`), as the Arc2Face UNet is published;
  * `arcface_insightface(model)`: an IResNet state dict in the insightface
    `arcface_torch` layout (`.pth`);
  * `clip_vision_hf(vision)`: a transformers CLIPVisionModelWithProjection
    state dict, and `clip_model_hf(scorer)`: a transformers CLIPModel state
    dict (text and vision towers, both projections, `logit_scale`), the
    layout of the ViT-B/32 weights that `--clip_ckpt` takes;
  * `vit_hf(dino)`: a transformers ViTModel state dict (under 'vit.', as
    facebook/dino-vits16 is published), the DINO model's layout;
  * `retinaface_pytorch(model)`: a Pytorch_Retinaface `Resnet50_Final.pth`
    state dict (under 'module.', as the published file is), and
    `bisenet_face_parsing(model)`: a face-parsing.PyTorch `79999_iter.pth`
    state dict (with its auxiliary heads `conv_out16` / `conv_out32`, which
    no loader reads). Each BatchNorm gets random running statistics from
    `seed`, its affine adjusted so that the layer computes what the port's
    model computes: folding or applying them is then no identity, so that
    tests of the loaders cannot pass vacuously.

The key maps here are written from the reference's module names, apart
from the loaders of `adaprompt_tpu_torch`, so that the tests hold both
against the JAX package's `from_torch`.

    import sys; sys.path.insert(0, "tools"); import reference_layouts
"""

from __future__ import annotations

import contextlib
import re
import sys
import types

import numpy as np
import torch
from torch import nn


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(device="cpu", dtype=torch.float32).contiguous()


def _layer(out: dict, key: str, m: nn.Module):
    """weight (and bias, where the layer has one) of a Linear/Conv2d/Norm."""
    out[key + ".weight"] = _f32(m.weight)
    if getattr(m, "bias", None) is not None:
        out[key + ".bias"] = _f32(m.bias)


def unet_ldm(unet) -> dict:
    """The port's UNet -> an openaimodel UNetModel state dict."""
    out = {}

    def res(key, r):
        for src, dst in (("norm_in", "in_layers.0"), ("conv_in", "in_layers.2"),
                         ("emb", "emb_layers.1"), ("norm_out", "out_layers.0"),
                         ("conv_out", "out_layers.3"), ("skip", "skip_connection")):
            if src in r:
                _layer(out, f"{key}.{dst}", r[src])

    def transformer(key, a):
        for n in ("norm", "proj_in", "proj_out"):
            _layer(out, f"{key}.{n}", a[n])
        b, tb = a["block"], key + ".transformer_blocks.0"
        for n in ("norm1", "norm2", "norm3"):
            _layer(out, f"{tb}.{n}", b[n])
        for at in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _layer(out, f"{tb}.{at}.{n}", b[at][n])
            _layer(out, f"{tb}.{at}.to_out.0", b[at]["to_out"])
        _layer(out, tb + ".ff.net.0.proj", b["ff"]["proj"])
        _layer(out, tb + ".ff.net.2", b["ff"]["out"])

    _layer(out, "time_embed.0", unet.time_embed["fc1"])
    _layer(out, "time_embed.2", unet.time_embed["fc2"])
    for i, blk in enumerate(unet.input_blocks):
        key = f"input_blocks.{i}"
        if "conv" in blk:
            _layer(out, key + ".0", blk["conv"])
        elif "downsample" in blk:
            _layer(out, key + ".0.op", blk["downsample"])
        else:
            res(key + ".0", blk["res"])
            if "attn" in blk:
                transformer(key + ".1", blk["attn"])
    mb = unet.middle_block
    res("middle_block.0", mb["res1"])
    transformer("middle_block.1", mb["attn"])
    res("middle_block.2", mb["res2"])
    for i, blk in enumerate(unet.output_blocks):
        key = f"output_blocks.{i}"
        res(key + ".0", blk["res"])
        if "attn" in blk:
            transformer(key + ".1", blk["attn"])
        if "upsample" in blk:
            _layer(out, f"{key}.{2 if 'attn' in blk else 1}.conv", blk["upsample"])
    _layer(out, "out.0", unet.out["norm"])
    _layer(out, "out.2", unet.out["conv"])
    return out


def vae_ldm(vae) -> dict:
    """The port's VAE -> an LDM AutoencoderKL state dict (the resampling
    convs under 'downsample.conv' / 'upsample.conv')."""
    return {re.sub(r"\.(down|up)sample\.(weight|bias)$", r".\1sample.conv.\2", k): _f32(v)
            for k, v in vae.named_parameters()}


# a ResnetBlock2D's layers: (the port's UNet's name, the VAE's name, diffusers' name)
_RESNET = (("norm_in", "norm1", "norm1"), ("conv_in", "conv1", "conv1"),
           ("emb", None, "time_emb_proj"), ("norm_out", "norm2", "norm2"),
           ("conv_out", "conv2", "conv2"), ("skip", "nin_shortcut", "conv_shortcut"))


def _diffusers_resnet(out: dict, key: str, r, vae: bool = False):
    for unet_name, vae_name, dst in _RESNET:
        src = vae_name if vae else unet_name
        if src in r:
            _layer(out, f"{key}.{dst}", r[src])


def unet_diffusers(unet, linear_proj: bool = False) -> dict:
    """The port's UNet -> a diffusers UNet2DConditionModel state dict
    (down_blocks / mid_block / up_blocks, up_blocks.0 the deepest level);
    `linear_proj`: the transformers' proj_in / proj_out as Linear [O, I]
    weights (diffusers' use_linear_projection) instead of 1x1 convs."""
    out = {}
    nr = unet.cfg.num_res_blocks

    def transformer(key, a):
        _layer(out, key + ".norm", a["norm"])
        for n in ("proj_in", "proj_out"):
            _layer(out, f"{key}.{n}", a[n])
            if linear_proj:
                out[f"{key}.{n}.weight"] = out[f"{key}.{n}.weight"][:, :, 0, 0].contiguous()
        b, tb = a["block"], key + ".transformer_blocks.0"
        for n in ("norm1", "norm2", "norm3"):
            _layer(out, f"{tb}.{n}", b[n])
        for at in ("attn1", "attn2"):
            for n in ("to_q", "to_k", "to_v"):
                _layer(out, f"{tb}.{at}.{n}", b[at][n])
            _layer(out, f"{tb}.{at}.to_out.0", b[at]["to_out"])
        _layer(out, tb + ".ff.net.0.proj", b["ff"]["proj"])
        _layer(out, tb + ".ff.net.2", b["ff"]["out"])

    _layer(out, "time_embedding.linear_1", unet.time_embed["fc1"])
    _layer(out, "time_embedding.linear_2", unet.time_embed["fc2"])
    _layer(out, "conv_in", unet.input_blocks[0]["conv"])
    level, j = 0, 0
    for blk in list(unet.input_blocks)[1:]:
        if "downsample" in blk:         # closes the level just written
            _layer(out, f"down_blocks.{level - 1}.downsamplers.0.conv", blk["downsample"])
            continue
        _diffusers_resnet(out, f"down_blocks.{level}.resnets.{j}", blk["res"])
        if "attn" in blk:
            transformer(f"down_blocks.{level}.attentions.{j}", blk["attn"])
        level, j = (level + 1, 0) if j + 1 == nr else (level, j + 1)
    mb = unet.middle_block
    _diffusers_resnet(out, "mid_block.resnets.0", mb["res1"])
    transformer("mid_block.attentions.0", mb["attn"])
    _diffusers_resnet(out, "mid_block.resnets.1", mb["res2"])
    for i, blk in enumerate(unet.output_blocks):
        key = f"up_blocks.{i // (nr + 1)}"
        _diffusers_resnet(out, f"{key}.resnets.{i % (nr + 1)}", blk["res"])
        if "attn" in blk:
            transformer(f"{key}.attentions.{i % (nr + 1)}", blk["attn"])
        if "upsample" in blk:
            _layer(out, key + ".upsamplers.0.conv", blk["upsample"])
    _layer(out, "conv_norm_out", unet.out["norm"])
    _layer(out, "conv_out", unet.out["conv"])
    return out


def vae_diffusers(vae, legacy_attn_names: bool = False) -> dict:
    """The port's VAE -> a diffusers AutoencoderKL state dict (the decoder's
    up_blocks.0 the deepest level). The mid-block attention as diffusers
    writes it now (`group_norm`, Linear `to_q` / `to_k` / `to_v` /
    `to_out.0`) or, with `legacy_attn_names`, under the older names
    (`norm`, `query` / `key` / `value` / `proj_attn`) with 1x1 Conv2d
    weights: between them the two forms of each naming a loader meets."""
    out = {}
    attn = (("norm", "q", "k", "v", "proj_out"),
            ("norm", "query", "key", "value", "proj_attn") if legacy_attn_names
            else ("group_norm", "to_q", "to_k", "to_v", "to_out.0"))
    n_levels = vae.cfg.num_resolutions
    for tower, kind in (("encoder", "down"), ("decoder", "up")):
        t = getattr(vae, tower)
        for n in ("conv_in", "conv_out"):
            _layer(out, f"{tower}.{n}", t[n])
        _layer(out, f"{tower}.conv_norm_out", t["norm_out"])
        for i, lvl in enumerate(t[kind]):
            key = f"{tower}.{kind}_blocks.{i if kind == 'down' else n_levels - 1 - i}"
            for j, r in enumerate(lvl["block"]):
                _diffusers_resnet(out, f"{key}.resnets.{j}", r, vae=True)
            if f"{kind}sample" in lvl:
                _layer(out, f"{key}.{kind}samplers.0.conv", lvl[f"{kind}sample"])
        mid = t["mid"]
        _diffusers_resnet(out, f"{tower}.mid_block.resnets.0", mid["block_1"], vae=True)
        _diffusers_resnet(out, f"{tower}.mid_block.resnets.1", mid["block_2"], vae=True)
        for src, dst in zip(*attn):
            key = f"{tower}.mid_block.attentions.0.{dst}"
            _layer(out, key, mid["attn_1"][src])
            if src != "norm" and not legacy_attn_names:
                out[key + ".weight"] = out[key + ".weight"][:, :, 0, 0].contiguous()
    _layer(out, "quant_conv", vae.quant_conv)
    _layer(out, "post_quant_conv", vae.post_quant_conv)
    return out


def clip_hf(text, vocab_rows: int | None = None, position_ids: bool = True) -> dict:
    """The port's CLIPTextModel -> a transformers CLIPTextModel state dict
    (under 'text_model.'); the token table cut to `vocab_rows` (a table
    that AdaFacePipeline grew keeps its first cfg.vocab_size rows)."""
    rows = vocab_rows or text.cfg.vocab_size
    out = {"text_model.embeddings.token_embedding.weight": _f32(text.token_embedding[:rows]),
           "text_model.embeddings.position_embedding.weight": _f32(text.position_embedding)}
    if position_ids:
        out["text_model.embeddings.position_ids"] = torch.arange(text.cfg.max_positions)[None]
    for i, lp in enumerate(text.layers):
        key = f"text_model.encoder.layers.{i}"
        _layer(out, key + ".layer_norm1", lp["ln1"])
        _layer(out, key + ".layer_norm2", lp["ln2"])
        for n in ("q", "k", "v", "out"):
            _layer(out, f"{key}.self_attn.{n}_proj", lp["attn"][n])
        _layer(out, key + ".mlp.fc1", lp["mlp"]["fc1"])
        _layer(out, key + ".mlp.fc2", lp["mlp"]["fc2"])
    _layer(out, "text_model.final_layer_norm", text.final_ln)
    return out


def sd_alphas_cumprod() -> torch.Tensor:
    """SD-1.5's scaled-linear schedule (0.00085 .. 0.012 over 1000 steps)."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32))


def sd_checkpoint(pipe) -> dict:
    """A StableDiffusionPipeline -> the contents of an SD-1.5 `.ckpt`
    ({'state_dict': ..., 'global_step': ...}), every tensor float32."""
    sd = {"model.diffusion_model." + k: v for k, v in unet_ldm(pipe.unet).items()}
    sd.update({"first_stage_model." + k: v for k, v in vae_ldm(pipe.vae).items()})
    sd.update({"cond_stage_model.transformer." + k: v for k, v in clip_hf(pipe.text).items()})
    sd["model_ema.decay"] = torch.tensor(0.9999)
    sd["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
    sd["alphas_cumprod"] = sd_alphas_cumprod()
    return {"state_dict": sd, "global_step": 840000}


def subj_basis_reference(sbg) -> dict:
    """The port's SubjBasisGenerator -> the reference module's state dict."""
    out = {}
    if sbg.cfg.placeholder_is_bg:
        for n in ("pos_embs", "latent_queries"):
            out[n] = _f32(getattr(sbg, n))
        for n in ("pos_embs_ln", "latent_queries_ln"):
            _layer(out, n, getattr(sbg, n))
        pairs = [("bg_proj_in", sbg.bg_proj_in)] + [
            (f"prompt_translator.to_{n}", sbg.prompt_translator[f"to_{n}"]) for n in "qkv"]
        for key, m in pairs:
            out[key + ".0.weight"] = _f32(m.weight)
            _layer(out, key + ".1", m.ln)
        return out
    out["hidden_state_layer_weights"] = _f32(sbg.hidden_state_layer_weights)
    out.update({"prompt2token_proj." + k: v for k, v in clip_hf(sbg.prompt2token_proj).items()})
    out["obj_proj_in.0.weight"] = _f32(sbg.obj_proj_in.weight)
    _layer(out, "obj_proj_in.2", sbg.obj_proj_in.ln)
    return out


@contextlib.contextmanager
def reference_classes():
    """Register the reference's module paths ('adaface',
    'adaface.subj_basis_generator', 'adaface.arc2face_models') in
    sys.modules, each a types.ModuleType holding an nn.Module class of the
    reference's name, for as long as the context lasts; yields the classes
    {'SubjBasisGenerator': ..., 'CLIPAttentionMKV': ...}."""
    names = ("adaface", "adaface.subj_basis_generator", "adaface.arc2face_models")
    saved = {n: sys.modules.get(n) for n in names}
    mods = {n: types.ModuleType(n) for n in names}
    mods["adaface"].__path__ = []
    classes = {}
    for mod, cls in (("adaface.subj_basis_generator", "SubjBasisGenerator"),
                     ("adaface.arc2face_models", "CLIPAttentionMKV")):
        classes[cls] = type(cls, (nn.Module,), {"__module__": mod})
        setattr(mods[mod], cls, classes[cls])
    sys.modules.update(mods)
    try:
        yield classes
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def _module_tree(flat: dict, root: nn.Module, classes_by_prefix: dict) -> nn.Module:
    """Parameters of `flat` placed into nested modules under `root` (each
    a plain nn.Module unless its prefix is in `classes_by_prefix`);
    integer entries become buffers."""
    for name, t in flat.items():
        *path, leaf = name.split(".")
        m = root
        for j, part in enumerate(path):
            if part not in m._modules:
                m.add_module(part, classes_by_prefix.get(".".join(path[:j + 1]), nn.Module)())
            m = m._modules[part]
        if t.is_floating_point():
            m.register_parameter(leaf, nn.Parameter(t.clone()))
        else:
            m.register_buffer(leaf, t.clone())
    return root


def write_adaface_pt(path: str, generators: dict, string_to_token: dict | None = None):
    """An `embeddings_gs-*.pt` holding `generators` ({placeholder: the port's
    SubjBasisGenerator}) as reference modules; self-attention layers whose
    k_proj is wider than q_proj are of class CLIPAttentionMKV."""
    with reference_classes() as classes:
        mods = nn.ModuleDict()
        for placeholder, sbg in generators.items():
            flat = subj_basis_reference(sbg)
            wide = {k.rsplit(".", 2)[0] for k in flat
                    if k.endswith("self_attn.k_proj.weight")
                    and flat[k].shape[0] > flat[k.replace("k_proj", "q_proj")].shape[0]}
            mods[placeholder] = _module_tree(flat, classes["SubjBasisGenerator"](),
                                             {w: classes["CLIPAttentionMKV"] for w in wide})
        ckpt = {"string_to_subj_basis_generator_dict": mods,
                "string_to_token_dict": dict(string_to_token or {}),
                "emb_global_scale_scores": torch.zeros(len(generators)),
                "token2num_vectors": {p: 16 for p in generators}}
        torch.save(ckpt, path)
    return path


def arcface_insightface(model) -> dict:
    """The port's ArcFace -> an arcface_torch iresnet state dict: `stages.i.j`
    as `layer<i+1>.j`, `down_conv`/`down_bn` as `downsample.0/1`, PReLU
    `alpha` as `weight`, `features_bn` as `features`, every BatchNorm with
    its `num_batches_tracked`, and the fc weight's input in NCHW order."""
    out = {}

    def bn(key, m):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{key}.{leaf}"] = _f32(getattr(m, leaf))
        out[key + ".num_batches_tracked"] = torch.tensor(0)

    out["conv1.weight"] = _f32(model.conv1.weight)
    bn("bn1", model.bn1)
    out["prelu.weight"] = _f32(model.prelu.alpha)
    for si, blocks in enumerate(model.stages, start=1):
        for bi, b in enumerate(blocks):
            key = f"layer{si}.{bi}"
            bn(key + ".bn1", b.bn1)
            out[key + ".conv1.weight"] = _f32(b.conv1.weight)
            bn(key + ".bn2", b.bn2)
            out[key + ".prelu.weight"] = _f32(b.prelu.alpha)
            out[key + ".conv2.weight"] = _f32(b.conv2.weight)
            bn(key + ".bn3", b.bn3)
            if hasattr(b, "down_conv"):
                out[key + ".downsample.0.weight"] = _f32(b.down_conv.weight)
                bn(key + ".downsample.1", b.down_bn)
    bn("bn2", model.bn2)
    cfg = model.cfg
    s, c, f = cfg.input_size // 16, cfg.planes[-1], cfg.num_features
    w = _f32(model.fc.weight).reshape(f, s, s, c).permute(0, 3, 1, 2).reshape(f, c * s * s)
    out["fc.weight"] = w.contiguous()
    out["fc.bias"] = _f32(model.fc.bias)
    bn("features", model.features_bn)
    return out


def clip_vision_hf(vision, position_ids: bool = True) -> dict:
    """The port's CLIPVisionModel -> a transformers
    CLIPVisionModelWithProjection state dict: the tower under
    'vision_model.' (the patch embedding as an OIHW conv weight, the
    published 'pre_layrnorm' spelling) and 'visual_projection.weight'."""
    out = {"vision_model.embeddings.class_embedding": _f32(vision.class_embedding),
           "vision_model.embeddings.patch_embedding.weight":
               _f32(vision.patch_embedding).permute(3, 2, 0, 1).contiguous(),
           "vision_model.embeddings.position_embedding.weight": _f32(vision.position_embedding)}
    if position_ids:
        out["vision_model.embeddings.position_ids"] = torch.arange(vision.cfg.seq_len)[None]
    _layer(out, "vision_model.pre_layrnorm", vision.pre_ln)
    for i, lp in enumerate(vision.layers):
        key = f"vision_model.encoder.layers.{i}"
        _layer(out, key + ".layer_norm1", lp["ln1"])
        _layer(out, key + ".layer_norm2", lp["ln2"])
        for n in ("q", "k", "v", "out"):
            _layer(out, f"{key}.self_attn.{n}_proj", lp["attn"][n])
        _layer(out, key + ".mlp.fc1", lp["mlp"]["fc1"])
        _layer(out, key + ".mlp.fc2", lp["mlp"]["fc2"])
    _layer(out, "vision_model.post_layernorm", vision.post_ln)
    out["visual_projection.weight"] = _f32(vision.projection.weight)
    return out


def clip_model_hf(scorer) -> dict:
    """The port's CLIPScorer -> a transformers CLIPModel state dict: the
    text tower (`clip_hf`), the vision tower with its projection
    (`clip_vision_hf`), 'text_projection.weight' [P, D] and 'logit_scale'
    (ln 100, as published)."""
    out = clip_hf(scorer.text)
    out.update(clip_vision_hf(scorer.vision))
    out["text_projection.weight"] = _f32(scorer.text_projection).t().contiguous()
    out["logit_scale"] = torch.tensor(float(np.log(100.0)))
    return out


def vit_hf(dino, prefix: str = "vit.") -> dict:
    """The port's DINO -> a transformers ViTModel state dict: the patch conv
    under 'embeddings.patch_embeddings.projection' (OIHW), the position
    embeddings with a batch axis [1, S, D], each layer's
    'layernorm_before' / 'attention.attention.{query,key,value}' /
    'attention.output.dense' / 'layernorm_after' / 'intermediate.dense' /
    'output.dense', the final 'layernorm'."""
    out = {prefix + "embeddings.cls_token": _f32(dino.cls_token),
           prefix + "embeddings.position_embeddings": _f32(dino.position_embedding)[None]}
    _layer(out, prefix + "embeddings.patch_embeddings.projection", dino.patch_embedding)
    for i, lp in enumerate(dino.layers):
        key = f"{prefix}encoder.layer.{i}"
        _layer(out, key + ".layernorm_before", lp["ln1"])
        for n, full in (("q", "query"), ("k", "key"), ("v", "value")):
            _layer(out, f"{key}.attention.attention.{full}", lp["attn"][n])
        _layer(out, key + ".attention.output.dense", lp["attn"]["out"])
        _layer(out, key + ".layernorm_after", lp["ln2"])
        _layer(out, key + ".intermediate.dense", lp["mlp"]["fc1"])
        _layer(out, key + ".output.dense", lp["mlp"]["fc2"])
    _layer(out, prefix + "layernorm", dino.final_ln)
    return out


_BN_EPS = 1e-5


def _bn_as_stats(out: dict, key: str, scale, shift, rng: np.random.Generator):
    """A BatchNorm computing x * scale + shift, with random running
    statistics: weight = scale * sqrt(var + eps), bias = shift + mean * scale."""
    scale = np.asarray(scale, np.float64)
    shift = np.asarray(shift, np.float64)
    mean = rng.normal(0.0, 0.1, scale.shape)
    var = rng.uniform(0.5, 1.5, scale.shape)
    for leaf, v in (("weight", scale * np.sqrt(var + _BN_EPS)), ("bias", shift + mean * scale),
                    ("running_mean", mean), ("running_var", var)):
        out[f"{key}.{leaf}"] = torch.from_numpy(v.astype(np.float32))
    out[key + ".num_batches_tracked"] = torch.tensor(0)


def retinaface_pytorch(model, seed: int = 0, prefix: str = "module.") -> dict:
    """The port's RetinaFace -> a Pytorch_Retinaface `Resnet50_Final.pth`
    state dict: `stem` as body.conv1/bn1, `stages.s.i.convJ` as
    body.layer<s+1>.i.convJ/bnJ, `down` as downsample.0/1, the FPN and SSH
    convs as `<name>.0` with their BatchNorm as `<name>.1`, the heads as
    `<Head>.<level>.conv1x1`; each folded scale and shift as a BatchNorm
    with random statistics (`_bn_as_stats`)."""
    rng = np.random.default_rng(seed)
    out = {}

    def conv_bn(conv_key, bn_key, m):
        out[conv_key + ".weight"] = _f32(m.weight)
        _bn_as_stats(out, bn_key, _f32(m.scale).numpy(), _f32(m.shift).numpy(), rng)

    conv_bn("body.conv1", "body.bn1", model.stem)
    for s, blocks in enumerate(model.stages, start=1):
        for i, b in enumerate(blocks):
            key = f"body.layer{s}.{i}"
            for j in (1, 2, 3):
                conv_bn(f"{key}.conv{j}", f"{key}.bn{j}", getattr(b, f"conv{j}"))
            if hasattr(b, "down"):
                conv_bn(key + ".downsample.0", key + ".downsample.1", b.down)
    for name, m in model.fpn.items():
        conv_bn(f"fpn.{name}.0", f"fpn.{name}.1", m)
    for n, ssh in enumerate(model.ssh, start=1):
        for name in ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3"):
            conv_bn(f"ssh{n}.{name}.0", f"ssh{n}.{name}.1", getattr(ssh, name))
    for name, heads in model.heads.items():
        for i, h in enumerate(heads):
            _layer(out, f"{name}.{i}.conv1x1", h)
    return {prefix + k: v for k, v in out.items()}


def bisenet_face_parsing(model, seed: int = 0) -> dict:
    """The port's BiSeNet -> a face-parsing.PyTorch `79999_iter.pth` state
    dict: the context path under 'cp.' (`resnet.layers.i.j` as
    cp.resnet.layer<i+1>.j, `down_conv`/`down_bn` as downsample.0/1), `ffm.*`
    and `conv_out.*` as they are (the 1x1 convs' biases only where they are
    not zero: the published file has none), every BatchNorm with random
    statistics (`_bn_as_stats`), and random auxiliary heads `conv_out16` /
    `conv_out32` (128 -> 64 -> classes) that no loader reads."""
    rng = np.random.default_rng(seed)
    out = {}

    def bn(key, m):
        inv = _f32(m.weight).numpy() / np.sqrt(_f32(m.running_var).numpy() + m.eps)
        _bn_as_stats(out, key, inv, _f32(m.bias).numpy() - _f32(m.running_mean).numpy() * inv,
                     rng)

    def conv(key, m):
        out[key + ".weight"] = _f32(m.weight)
        if getattr(m, "bias", None) is not None and bool(m.bias.any()):
            out[key + ".bias"] = _f32(m.bias)

    def cbr(key, m):
        conv(key + ".conv", m.conv)
        bn(key + ".bn", m.bn)

    r = model.resnet
    conv("cp.resnet.conv1", r.conv1)
    bn("cp.resnet.bn1", r.bn1)
    for si, blocks in enumerate(r.layers, start=1):
        for bi, b in enumerate(blocks):
            key = f"cp.resnet.layer{si}.{bi}"
            for j in (1, 2):
                conv(f"{key}.conv{j}", getattr(b, f"conv{j}"))
                bn(f"{key}.bn{j}", getattr(b, f"bn{j}"))
            if hasattr(b, "down_conv"):
                conv(key + ".downsample.0", b.down_conv)
                bn(key + ".downsample.1", b.down_bn)
    for arm in ("arm16", "arm32"):
        a = getattr(model, arm)
        cbr(f"cp.{arm}.conv", a.conv)
        conv(f"cp.{arm}.conv_atten", a.conv_atten)
        bn(f"cp.{arm}.bn_atten", a.bn_atten)
    for name in ("conv_avg", "conv_head32", "conv_head16"):
        cbr("cp." + name, getattr(model, name))
    cbr("ffm.convblk", model.ffm.convblk)
    conv("ffm.conv1", model.ffm.conv1)
    conv("ffm.conv2", model.ffm.conv2)
    cbr("conv_out.conv", model.conv_out.conv)
    conv("conv_out.conv_out", model.conv_out.conv_out)
    n_classes = model.cfg.n_classes
    for aux in ("conv_out16", "conv_out32"):
        out[aux + ".conv.conv.weight"] = torch.from_numpy(
            rng.normal(0.0, 0.03, (64, 128, 3, 3)).astype(np.float32))
        _bn_as_stats(out, aux + ".conv.bn", np.ones(64), np.zeros(64), rng)
        out[aux + ".conv_out.weight"] = torch.from_numpy(
            rng.normal(0.0, 0.1, (n_classes, 64, 1, 1)).astype(np.float32))
    return out
