"""Zero-shot image features of the AdaFace encoder.

Port of `adaprompt_tpu/adaface/zs_features.py`: the masked CLIP vision
tower's second-to-last hidden states over the fg-masked and the bg-masked
image, each minus the features of an all-zero image and scaled by the
flattened patch mask (CLS row 1), concatenated to [B, 2S, D]; the ArcFace
identity embeddings of faces, or the DINO CLS embeddings of objects; and
the average over a reference set (the mean identity or DINO embedding
L2-normalized). The fg masks reach only the CLIP tower.

A faceless image's random identity comes from a `torch.Generator`, where
the JAX package draws it from a jax.random key: the same distribution, not
the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.models import dino as dino_mod
from adaprompt_tpu_torch.models.clip_vision import CLIPVisionModel, preprocess
from adaprompt_tpu_torch.train.fgbg import bilinear_resize_torch


def extract_zs_clip_features(vision: CLIPVisionModel, pixel_values: torch.Tensor,
                             fg_masks: torch.Tensor | None,
                             neg_features: torch.Tensor | None = None):
    """pixel_values [B, H, W, 3] CLIP-normalized; fg_masks [B, h, w, 1] in
    [0, 1] (None: all ones), bilinear-resized to the pixel grid. Returns
    (clip_features [B, 2S, D], neg_features [1, S, D]) with S = patches + 1;
    neg_features, the zero image's, are computed without gradient when not
    given."""
    if fg_masks is None:
        fg_masks = torch.ones(pixel_values.shape[:3] + (1,), device=pixel_values.device)
    else:
        fg_masks = bilinear_resize_torch(fg_masks.float(), tuple(pixel_values.shape[1:3]))
    if neg_features is None:
        with torch.no_grad():
            neg = vision.encode(torch.zeros_like(pixel_values[:1]), output_hidden_states=True)
        neg_features = neg["hidden_states"][-2]

    def masked_pass(mask):
        out = vision.encode(pixel_values, attn_mask=mask, output_hidden_states=True)
        feats = out["hidden_states"][-2] - neg_features
        return feats * vision.patch_mask(mask)[..., None].to(feats.dtype)

    fg_feats = masked_pass(fg_masks)
    bg_feats = masked_pass(1.0 - fg_masks)
    return torch.cat([fg_feats, bg_feats], dim=1), neg_features


class ZeroShotFeatureExtractor:
    """The masked CLIP vision tower, the face embedder and the DINO model
    over uint8 photos."""

    def __init__(self, vision: CLIPVisionModel, face_embedder=None,
                 dino: dino_mod.DINO | None = None):
        self.vision = vision
        self.face_embedder = face_embedder
        self.dino = dino
        self._neg_features = None

    def __call__(self, images_uint8, fg_masks=None, is_face: bool = True,
                 calc_avg: bool = False, gen: torch.Generator | None = None):
        """images_uint8: [H, W, 3] uint8 photos; fg_masks: matching [H, W]
        {0, 1} arrays or None. Returns (clip_features [B or 1, 2S, D],
        id_embs or None, the number of faceless photos): id_embs are the
        ArcFace embeddings [B or 1, 512] of faces (with a face embedder), or
        the DINO CLS embeddings [B or 1, 384] of objects (`is_face` False,
        with a DINO model)."""
        dev = self.vision.position_embedding.device
        imgs = np.stack([np.asarray(i) for i in images_uint8])
        pixel_values = preprocess(imgs, self.vision.cfg.image_size, device=dev)
        masks = None
        if fg_masks is not None:
            masks = torch.as_tensor(np.stack([np.asarray(m, np.float32) for m in fg_masks]),
                                    device=dev)[..., None]
        clip_features, self._neg_features = extract_zs_clip_features(
            self.vision, pixel_values, masks, self._neg_features)

        faceless, id_embs = 0, None
        if is_face and self.face_embedder is not None:
            embs = []
            for img in imgs:
                e = self.face_embedder.embed_image(img)
                if len(e) == 0:
                    faceless += 1
                    gen = gen or torch.Generator().manual_seed(0)
                    embs.append(torch.randn(512, generator=gen).numpy())
                else:
                    embs.append(np.asarray(e[0], np.float32))
            id_embs = torch.as_tensor(np.stack(embs), device=dev)
        elif not is_face and self.dino is not None:
            x = dino_mod.preprocess(imgs, self.dino.cfg.image_size,
                                    device=self.dino.position_embedding.device)
            id_embs = self.dino.encode(x)
        if calc_avg:
            clip_features = clip_features.mean(dim=0, keepdim=True)
            if id_embs is not None:
                m = id_embs.mean(dim=0, keepdim=True)
                id_embs = m / m.norm(dim=-1, keepdim=True)
        return clip_features, id_embs, faceless
