"""adaprompt_tpu_torch — the PyTorch and CUDA port of adaprompt_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports torch
and never jax, nor anything of `adaprompt_tpu`. Its layout mirrors the JAX
package:
  ops/       layers in plain PyTorch; the hand-written CUDA kernels' wrappers
             (flash attention, fused cross-attention, fused GEGLU), each beside
             its plain version; cuda_build compiles csrc/*.cu with nvcc
  models/    CLIP text encoder, UNet (inference), VAE as nn.Modules
  sampling/  DDIM with annealed classifier-free guidance
  utils/     the CLIP tokenizer
  pipeline   StableDiffusionPipeline: txt2img on the card
  convert    JAX parameter pytrees -> the port's state dicts
"""

__version__ = "0.1.0"
