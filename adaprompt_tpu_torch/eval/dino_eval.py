"""DINO image similarity: the pairwise cosine similarity of the DINO
ViT-S/16 CLS embeddings of reference and generated images.

Port of `adaprompt_tpu/eval/dino_eval.py` (the reference's
evaluation/dino_eval.py). The model runs on its own device, in plain
PyTorch: no kernel of the port runs here.
"""

from __future__ import annotations

import numpy as np
import torch

from adaprompt_tpu_torch.models import dino


class DINOEvaluator:
    def __init__(self, model: dino.DINO):
        self.model = model.eval()
        self.cfg = model.cfg

    @torch.no_grad()
    def get_image_features(self, images_uint8, norm: bool = True) -> torch.Tensor:
        """uint8 [H, W, 3] images (all of one size) -> CLS embeddings [N, D]."""
        x = dino.preprocess(np.stack([np.asarray(i) for i in images_uint8]),
                            self.cfg.image_size, device=self.model.position_embedding.device)
        feats = self.model.encode(x)
        return feats / feats.norm(dim=-1, keepdim=True) if norm else feats

    def image_pairwise_similarity(self, images1, images2, reduction="mean"):
        """The mean (reduction 'mean') or the matrix [N1, N2] ('none') of
        the cosine similarities."""
        scores = self.get_image_features(images1) @ self.get_image_features(images2).T
        if reduction == "mean":
            return scores.mean()
        if reduction == "none":
            return scores
        raise NotImplementedError(reduction)
