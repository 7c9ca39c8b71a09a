"""CLIP similarity scoring on the device: ViT-B/32 image-image and
text-image cosine similarities.

Port of `adaprompt_tpu/eval/clip_scorer.py` without `from_torch` (loading
published ViT-B/32 weights). The text tower is the port's CLIPTextModel at
ViT-B/32's text widths with the text projection; images go through the
port's CLIPVisionModel with its visual projection. Images are [-1, 1] float
[B, H, W, 3] (generator output), mapped to [0, 1], resized to the tower's
size with the antialiased Keys-cubic weights of `jax.image.resize(...,
"bicubic")` (`clip_vision.bicubic_weights`) and CLIP-normalized. Its
attentions are plain PyTorch: no kernel of the port runs here.
"""

from __future__ import annotations

import torch
from torch import nn

from adaprompt_tpu_torch.models import clip_text, clip_vision
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer

# openai CLIP ViT-B/32 text tower
CLIP_B32_TEXT = clip_text.CLIPTextConfig(hidden_size=512, intermediate_size=2048,
                                         num_layers=12, num_heads=8)


class CLIPScorer(nn.Module):
    """Weights: `text` (CLIPTextModel), `text_projection` [D, P] and `vision`
    (CLIPVisionModel, its `projection` included), in float32."""

    def __init__(self, tokenizer: CLIPTokenizer, text_cfg: clip_text.CLIPTextConfig = CLIP_B32_TEXT,
                 vision_cfg: clip_vision.CLIPVisionConfig = clip_vision.CLIP_VIT_B32_VISION, *,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.tokenizer, self.text_cfg, self.vision_cfg = tokenizer, text_cfg, vision_cfg
        self.text = clip_text.CLIPTextModel(text_cfg, device=device, dtype=dtype)
        self.text_projection = nn.Parameter(
            torch.empty(text_cfg.hidden_size, vision_cfg.projection_dim, device=device, dtype=dtype),
            requires_grad=False)
        self.vision = clip_vision.CLIPVisionModel(vision_cfg, device=device, dtype=dtype)
        self.requires_grad_(False)

    @classmethod
    def random_init(cls, seed: int, tokenizer: CLIPTokenizer | None = None,
                    text_cfg: clip_text.CLIPTextConfig = CLIP_B32_TEXT,
                    vision_cfg: clip_vision.CLIPVisionConfig = clip_vision.CLIP_VIT_B32_VISION,
                    *, device=None) -> "CLIPScorer":
        """A scorer with random weights from `seed` (normal(0, 0.02) weights,
        embeddings and text projection), on the card by default."""
        from adaprompt_tpu_torch.ops.layers import reset_parameters
        from adaprompt_tpu_torch.pipeline import resolve_device
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        scorer = cls(tokenizer or CLIPTokenizer.fallback(), text_cfg, vision_cfg, device=device)
        reset_parameters(scorer, gen)
        return scorer

    def reset(self, gen: torch.Generator):
        """Random-init the text projection (layers.reset_parameters does the rest)."""
        self.text_projection.normal_(0.0, 0.02, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.text_projection.device

    # -- features -------------------------------------------------------------

    @torch.no_grad()
    def get_text_features(self, texts, norm: bool = True) -> torch.Tensor:
        ids = torch.as_tensor(self.tokenizer(list(texts), max_length=self.text_cfg.max_positions),
                              device=self.device).long()
        _, pooled = self.text.encode(ids, return_pooled=True)
        feats = pooled @ self.text_projection
        return _norm(feats) if norm else feats

    @torch.no_grad()
    def get_image_features(self, images_pm1, norm: bool = True) -> torch.Tensor:
        """images in [-1, 1], [B, H, W, 3] NHWC."""
        feats = self.vision.encode(self._preprocess(images_pm1))["image_embeds"]
        return _norm(feats) if norm else feats

    def _preprocess(self, images_pm1) -> torch.Tensor:
        x = (torch.as_tensor(images_pm1, device=self.device).float() + 1.0) / 2.0
        size = self.vision_cfg.image_size
        h, w = x.shape[1], x.shape[2]
        if h != size:
            wh = torch.as_tensor(clip_vision.bicubic_weights(h, size), device=x.device)
            x = torch.einsum("bhwc,ho->bowc", x, wh)
        if w != size:
            ww = torch.as_tensor(clip_vision.bicubic_weights(w, size), device=x.device)
            x = torch.einsum("bhwc,wo->bhoc", x, ww)
        mean = torch.as_tensor(clip_vision.CLIP_IMAGE_MEAN, device=x.device)
        std = torch.as_tensor(clip_vision.CLIP_IMAGE_STD, device=x.device)
        return (x - mean) / std

    # -- similarities -----------------------------------------------------------

    def image_pairwise_similarity(self, images1, images2, reduction="mean"):
        f1 = self.get_image_features(images1)
        f2 = self.get_image_features(images2)
        return _reduce(f1 @ f2.T, reduction)

    def txt_to_img_similarity(self, text, images, reduction="mean"):
        tf = self.get_text_features([text] if isinstance(text, str) else text)
        imf = self.get_image_features(images)
        return _reduce(tf @ imf.T, reduction)

    def evaluate(self, gen_samples, gt_samples, target_text):
        """-> (image similarity, text similarity) as floats; target_text
        loses the placeholder '*'."""
        sim_img = self.image_pairwise_similarity(gt_samples, gen_samples)
        sim_text = self.txt_to_img_similarity(target_text.replace("*", ""), gen_samples)
        return float(sim_img), float(sim_text)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True)


def _reduce(scores: torch.Tensor, reduction: str):
    if reduction == "mean":
        return scores.mean()
    if reduction == "diag":
        return scores.diagonal()
    if reduction == "diagmean":
        return scores.diagonal().mean()
    if reduction == "none":
        return scores
    raise NotImplementedError(reduction)
