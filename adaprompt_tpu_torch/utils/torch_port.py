"""Read PyTorch / safetensors / npz checkpoints into numpy state dicts, and
split a full SD checkpoint into its three models' state dicts.

Port of `adaprompt_tpu/utils/torch_port.py`. The layouts:
  * a full SD-1.5 checkpoint (`v1-5-pruned-emaonly.ckpt`): the UNet under
    'model.diffusion_model.', the VAE under 'first_stage_model.', the CLIP
    text model under 'cond_stage_model.transformer.', beside entries no
    model reads ('model_ema.decay', 'alphas_cumprod', ...);
  * AdaFace's `embeddings_gs-*.pt` is read by
    `adaface/checkpoint.load_reference_checkpoint`.
`safetensors` is imported only for a `.safetensors` file.
"""

from __future__ import annotations

import numpy as np
import torch

SD_PREFIXES = {"unet": "model.diffusion_model.", "vae": "first_stage_model.",
               "text": "cond_stage_model.transformer."}


def load_state_dict(path: str) -> dict:
    """A .ckpt/.pt/.pth/.bin (torch.load, a 'state_dict' entry unwrapped),
    .safetensors or flat .npz file -> {name: float32 numpy array}; entries
    that are not tensors pass through as they are."""
    if path.endswith(".npz"):
        data = np.load(path, allow_pickle=False)
        return {k: data[k] for k in data.files if k != "__meta__"}
    if path.endswith(".safetensors"):
        from safetensors import safe_open
        with safe_open(path, framework="np") as f:
            return {k: f.get_tensor(k) for k in f.keys()}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().to(torch.float32).cpu().numpy() if hasattr(v, "detach") else v
            for k, v in obj.items()}


def split_sd_checkpoint(sd: dict) -> dict:
    """A full SD checkpoint -> {'unet', 'vae', 'text'} state dicts, each
    with its prefix taken off; every other entry is left out."""
    parts = {name: {} for name in SD_PREFIXES}
    for k, v in sd.items():
        for name, prefix in SD_PREFIXES.items():
            if k.startswith(prefix):
                parts[name][k[len(prefix):]] = v
                break
    return parts


def renamed(sd: dict, names: dict) -> dict[str, torch.Tensor]:
    """{new name: sd[old name]} for `names` = {new: old}, each entry a
    tensor (a numpy array shared, not copied)."""
    return {dst: sd[src].detach() if isinstance(sd[src], torch.Tensor)
            else torch.from_numpy(np.asarray(sd[src])) for dst, src in names.items()}


def layer_names(pairs, sd: dict) -> dict:
    """{new: old} names of the weight and, where `sd` holds one, the bias of
    each (new layer, old layer) prefix pair."""
    names = {}
    for dst, src in pairs:
        names[dst + ".weight"] = src + ".weight"
        if src + ".bias" in sd:
            names[dst + ".bias"] = src + ".bias"
    return names
