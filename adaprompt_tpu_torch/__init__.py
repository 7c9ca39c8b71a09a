"""adaprompt_tpu_torch — the PyTorch and CUDA port of adaprompt_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports torch
and never jax, nor anything of `adaprompt_tpu`. Its layout mirrors the JAX
package:
  ops/       layers in plain PyTorch; the hand-written CUDA kernels' wrappers
             (flash attention forward and backward, fused cross-attention,
             fused GEGLU, and the w8a8 int8 variants of the last two), each
             beside its plain version, the differentiable ones under
             autograd Functions; int8 quantization; ToMe token merging;
             cuda_build compiles csrc/*.cu
  models/    CLIP text encoder, UNet (with DeepCache, ToMe and int8), VAE as
             nn.Modules
  sampling/  the noise schedule, DDIM and DPM-Solver++(2M) with annealed
             classifier-free guidance, the DeepCache / CFG-tail loop
  adaface/   Arc2Face embeddings, the SubjBasisGenerator (face branch),
             placeholders, .npz checkpoints
  train/     Stage-1 Arc2Face distillation: losses, teacher chain, the step,
             Prodigy, the trainer
  utils/     the CLIP tokenizer
  pipeline   StableDiffusionPipeline: txt2img on the card, and the serving
             stack (FastConfig, sampler="dpmpp", quant="int8")
  convert    JAX parameter pytrees -> the port's state dicts
"""

__version__ = "0.1.0"
