"""adaprompt_tpu_torch — the PyTorch and CUDA port of adaprompt_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports torch
and never jax, nor anything of `adaprompt_tpu`. Its layout mirrors the JAX
package:
  ops/       layers in plain PyTorch; the hand-written CUDA kernels' wrappers
             (flash attention forward and backward, fused cross-attention,
             fused GEGLU), each beside its plain version, the differentiable
             ones under autograd Functions; cuda_build compiles csrc/*.cu
  models/    CLIP text encoder, UNet, VAE as nn.Modules
  sampling/  the noise schedule, DDIM with annealed classifier-free guidance
  adaface/   Arc2Face embeddings, the SubjBasisGenerator (face branch),
             placeholders, .npz checkpoints
  train/     Stage-1 Arc2Face distillation: losses, teacher chain, the step,
             Prodigy, the trainer
  utils/     the CLIP tokenizer
  pipeline   StableDiffusionPipeline: txt2img on the card
  convert    JAX parameter pytrees -> the port's state dicts
"""

__version__ = "0.1.0"
