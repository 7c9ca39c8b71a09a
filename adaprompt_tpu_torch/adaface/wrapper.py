"""AdaFacePipeline: subject photos in, personalized SD generations out.

Port of `adaprompt_tpu/adaface/wrapper.py`, the zero-shot personalization
entry point:

  1. ArcFace ID embedding of the photos (mean over photos, L2-normalized,
     optional noise),
  2. the Arc2Face text encoder -> 16 core ID prompt embeddings
     (input_max_length=22: 3 template tokens + 16 ID + BOS/EOS),
  3. SubjBasisGenerator -> 16 subject vectors in SD token space (the layers
     collapse to one at inference),
  4. 16 new tokens z_0..z_15 appended to the tokenizer, their rows of the
     token-embedding table overwritten with the subject vectors,
  5. the prompt rewritten 'z' -> 'z_0 ... z_15',
  6. txt2img through `StableDiffusionPipeline.generate` (DDIM-50 and the
     PuLID negative prompt by default; every sampler and `fast=` pass through).

Face detection stays on the host and pluggable (`eval/face_eval.py`);
recognition runs on the device through `models/arcface.py`.

Random draws come from a `torch.Generator` seeded with `seed`, so a random
face (`gen_rand_face`) or the noise of `noise_level` differs from the JAX
package's draw for the same seed; `noise=` injects a given draw.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

from adaprompt_tpu_torch.adaface import arc2face
from adaprompt_tpu_torch.adaface.subj_basis_generator import SubjBasisConfig, SubjBasisGenerator
from adaprompt_tpu_torch.models.clip_text import CLIPTextModel
from adaprompt_tpu_torch.pipeline import DEFAULT_NEGATIVE_PROMPT, StableDiffusionPipeline


def add_noise_keep_norm(x: torch.Tensor, noise_std: float,
                        generator: torch.Generator | None = None,
                        noise: torch.Tensor | None = None) -> torch.Tensor:
    """x plus Gaussian noise of `noise_std` times x's mean per-row standard
    deviation, rescaled to x's row norms. The standard-normal `noise` is
    drawn from `generator` unless given."""
    rel = x.std(dim=-1, unbiased=False).mean() * noise_std
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    orig_norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    y = x + noise.to(x) * rel
    new_norm = torch.linalg.norm(y, dim=-1, keepdim=True).detach()
    return y * orig_norm / (new_norm + 1e-8)


class AdaFacePipeline:
    def __init__(self, sd_pipeline: StableDiffusionPipeline, subj_basis: SubjBasisGenerator,
                 subj_basis_cfg: SubjBasisConfig | None, arc2face_text: CLIPTextModel,
                 arc2face_text_cfg=None, face_embedder=None, subject_string: str = "z",
                 num_vectors: int = 16, num_inference_steps: int = 50,
                 negative_prompt: str | None = None):
        """subj_basis and arc2face_text are modules on the pipeline's device
        (their configurations, when given, must be the modules' own);
        face_embedder: photos -> [N, 512] embeddings, e.g. a
        `FaceSimilarityEvaluator`."""
        if subj_basis_cfg is not None and subj_basis_cfg != subj_basis.cfg:
            raise ValueError("subj_basis_cfg is not the SubjBasisGenerator's configuration")
        if arc2face_text_cfg is not None and arc2face_text_cfg != arc2face_text.cfg:
            raise ValueError("arc2face_text_cfg is not the Arc2Face text encoder's configuration")
        self.pipe = sd_pipeline
        self.device = sd_pipeline.device
        self.subj_basis = subj_basis.eval()
        self.subj_basis_cfg = subj_basis.cfg
        self.arc2face_text = arc2face_text
        self.arc2face_text_cfg = arc2face_text.cfg
        self.face_embedder = face_embedder
        self.subject_string = subject_string
        self.num_vectors = num_vectors
        self.num_inference_steps = num_inference_steps
        self.negative_prompt = negative_prompt or DEFAULT_NEGATIVE_PROMPT
        self._extend_tokenizer_and_text_encoder()

    @classmethod
    def random_init(cls, seed: int = 0, *, device=None, dtype=torch.bfloat16, unet_cfg=None,
                    vae_cfg=None, text_cfg=None, arcface_cfg=None,
                    tokenizer=None) -> "AdaFacePipeline":
        """A pipeline with random weights from `seed`, made on the device
        (CUDA unless `device` says otherwise; raises when CUDA is asked for
        and absent): the SD pipeline (UNet and VAE in `dtype`), and in
        float32 a separate Arc2Face text encoder, the SubjBasisGenerator and
        an ArcFace trunk (IResNet-100 unless `arcface_cfg`) behind a
        centre-crop `FaceSimilarityEvaluator`."""
        from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator
        from adaprompt_tpu_torch.models import arcface
        from adaprompt_tpu_torch.ops.layers import reset_parameters
        cfgs = {k: v for k, v in dict(unet_cfg=unet_cfg, vae_cfg=vae_cfg,
                                      text_cfg=text_cfg).items() if v is not None}
        pipe = StableDiffusionPipeline.random_init(seed, device=device, dtype=dtype,
                                                   tokenizer=tokenizer, **cfgs)
        text_cfg = pipe.text.cfg
        gen = torch.Generator(device=pipe.device).manual_seed(seed + 1)
        a2f_text = reset_parameters(CLIPTextModel(text_cfg, device=pipe.device), gen)
        sbg_cfg = SubjBasisConfig(output_dim=text_cfg.hidden_size, text_cfg=text_cfg)
        sbg = reset_parameters(SubjBasisGenerator(sbg_cfg, device=pipe.device), gen)
        face = arcface.ArcFace.random_init(seed + 2, arcface_cfg or arcface.IRESNET100,
                                           device=pipe.device)
        return cls(pipe, sbg, sbg_cfg, a2f_text, text_cfg,
                   face_embedder=FaceSimilarityEvaluator(face))

    # -- token table extension ---------------------------------------------------

    def _extend_tokenizer_and_text_encoder(self):
        tok = self.pipe.tokenizer
        self.placeholder_tokens = [f"{self.subject_string}_{i}" for i in range(self.num_vectors)]
        self.placeholder_tokens_str = " ".join(self.placeholder_tokens)
        tok.add_tokens(self.placeholder_tokens)
        self.placeholder_token_ids = tok.convert_tokens_to_ids(self.placeholder_tokens)

        text = self.pipe.text
        table = text.token_embedding
        need = tok.vocab_size_with_added
        if table.shape[0] < need:
            extra = torch.zeros((need - table.shape[0], table.shape[1]), dtype=table.dtype,
                                device=table.device)
            text.token_embedding = nn.Parameter(torch.cat([table.detach(), extra], dim=0),
                                                requires_grad=table.requires_grad)

    @torch.no_grad()
    def update_text_encoder_subj_embs(self, subj_embs: torch.Tensor):
        """Write the subject vectors into their rows of the token-embedding table."""
        table = self.pipe.text.token_embedding
        ids = torch.as_tensor(self.placeholder_token_ids, device=table.device)
        table[ids] = subj_embs.to(device=table.device, dtype=table.dtype)

    # -- prompt rewrite -------------------------------------------------------------

    def update_prompt(self, prompt: str) -> str:
        if self.placeholder_tokens_str in prompt:
            return prompt
        if re.search(r"\b" + self.subject_string + r"\b", prompt) is None:
            return self.placeholder_tokens_str + " " + prompt
        return re.sub(r"\b" + self.subject_string + r"\b", self.placeholder_tokens_str, prompt)

    # -- ID embedding generation ---------------------------------------------------

    def extract_faceid_embeds(self, images_np=None, image_paths=None) -> torch.Tensor | None:
        """Mean L2-normalized ArcFace embedding over the given photos
        ([1, 512] float32); None when no face is found, or there is no
        embedder or no photo."""
        if self.face_embedder is None or (images_np is None and image_paths is None):
            return None
        embs = self.face_embedder(images_np=images_np, image_paths=image_paths)
        if embs is None or len(embs) == 0:
            return None
        m = torch.as_tensor(np.asarray(embs), dtype=torch.float32,
                            device=self.device).mean(dim=0, keepdim=True)
        return m / torch.linalg.norm(m, dim=-1, keepdim=True)

    @torch.no_grad()
    def _id_to_subj(self, faceid: torch.Tensor, out_id_embs_scale: float) -> torch.Tensor:
        """faceid [1, 512] -> subject vectors [num_vectors, D]: the Arc2Face
        forward, then the SubjBasisGenerator in inference form."""
        tok = self.pipe.tokenizer
        _, id_prompt_emb = arc2face.forward_face_embs(self.arc2face_text, tok, faceid,
                                                      input_max_length=22)
        subj_embs, _ = self.subj_basis(tok, id_prompt_emb, out_id_embs_scale=out_id_embs_scale,
                                       is_face=True, is_training=False,
                                       adaface_prompt_embs_inf_type="full_half_pad")
        return subj_embs[0, 0]          # [1, L, 16, D]: one layer at inference

    def generate_adaface_embeddings(self, image_paths=None, images_np=None, pre_face_embs=None,
                                    gen_rand_face: bool = False, out_id_embs_scale: float = 1.0,
                                    noise_level: float = 0.0, update_text_encoder: bool = True,
                                    seed: int = 0,
                                    noise: torch.Tensor | None = None) -> torch.Tensor | None:
        """Photos (or given / random ArcFace embeddings) -> [16, 768] subject
        vectors, written into the token table unless `update_text_encoder`
        is False. None when no face is found and none was given. `noise`: the
        standard-normal draw [1, 512] of `noise_level`, instead of the
        generator's."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if gen_rand_face:
            faceid = pre_face_embs if pre_face_embs is not None else \
                torch.randn((1, 512), generator=gen, device=self.device)
        else:
            faceid = self.extract_faceid_embeds(images_np=images_np, image_paths=image_paths)
            if faceid is None and pre_face_embs is not None:
                faceid = pre_face_embs
            if faceid is None:
                return None
        faceid = torch.as_tensor(faceid, dtype=torch.float32, device=self.device)
        if noise_level > 0:
            faceid = add_noise_keep_norm(faceid, noise_level, gen, noise)
        faceid = faceid / torch.linalg.norm(faceid, dim=-1, keepdim=True)
        subj_embs = self._id_to_subj(faceid, float(out_id_embs_scale))
        if update_text_encoder:
            self.update_text_encoder_subj_embs(subj_embs)
        return subj_embs

    # -- generation -----------------------------------------------------------------

    def encode_prompt(self, prompt: str, negative_prompt: str | None = None):
        """-> (cond, uncond), each [1, 77, 768]: the rewritten prompt and the
        negative prompt through the (extended) SD text encoder."""
        negative_prompt = negative_prompt or self.negative_prompt
        prompt = self.update_prompt(prompt)
        return self.pipe.encode_prompt([prompt]), self.pipe.encode_prompt([negative_prompt])

    def __call__(self, prompt: str, *, negative_prompt: str | None = None,
                 guidance_scale: float = 4.0, out_image_count: int = 4,
                 num_steps: int | None = None, seed: int = 0, height: int = 512,
                 width: int = 512, sampler: str = "ddim", fast=None) -> np.ndarray:
        """Personalized txt2img: uint8 [N, H, W, 3]. sampler: "ddim" or
        "dpmpp" (DPM-Solver++(2M); pass ~20 steps); fast: an opt-in
        `pipeline.FastConfig`, which composes with either."""
        cond, uncond = self.encode_prompt(prompt, negative_prompt)
        cond = cond.repeat(out_image_count, 1, 1)
        uncond = uncond.repeat(out_image_count, 1, 1)
        return self.pipe.generate(
            None, context=cond[None], context_uncond=uncond[None],
            num_steps=num_steps or self.num_inference_steps, guidance_scale=guidance_scale,
            height=height, width=width, seed=seed, sampler=sampler, fast=fast)

    def warmup(self, *, out_image_counts=(1, 4), num_steps: int | None = None,
               height: int = 512, width: int = 512, sampler: str = "ddim", fast=None,
               seed: int = 0) -> None:
        """Run everything a serving process runs once, before the first
        request: the personalization chain on a random face, the face
        embedder on a flat image, and one generate per requested image
        count. On the card this builds the CUDA kernels (first use) and lets
        cuDNN and cuBLAS pick their algorithms for every shape; there is no
        compilation to cache beyond that. Writes throwaway subject rows into
        the token table; the next personalization overwrites them."""
        self.generate_adaface_embeddings(gen_rand_face=True, seed=seed)
        if self.face_embedder is not None:
            self.face_embedder.embed_image(np.full((height, width, 3), 128, np.uint8))
        for n in out_image_counts:
            self("portrait of a z person", out_image_count=int(n), num_steps=num_steps,
                 height=height, width=width, seed=seed, sampler=sampler, fast=fast)
