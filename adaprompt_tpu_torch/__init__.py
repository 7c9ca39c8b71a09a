"""adaprompt_tpu_torch — the PyTorch and CUDA port of adaprompt_tpu.

A second package beside the JAX one, for one NVIDIA H100. It imports torch
and never jax, nor anything of `adaprompt_tpu`. Its layout mirrors the JAX
package:
  ops/       layers in plain PyTorch; the hand-written CUDA kernels' wrappers
             (flash attention forward and backward, fused cross-attention,
             fused GEGLU, the w8a8 int8 variants of the last two, and the
             three 3x3 conv kernels of conv_halo: fused GroupNorm-SiLU-conv,
             plain nine-tap, im2col), each beside its plain version, the differentiable ones under
             autograd Functions; int8 quantization; ToMe token merging;
             cuda_build compiles csrc/*.cu
  models/    CLIP text encoder, UNet (with DeepCache, ToMe, int8 and
             fused_conv), VAE and the ArcFace IResNet trunk as nn.Modules
  sampling/  the noise schedule, DDIM and DPM-Solver++(2M) with annealed
             classifier-free guidance, the DeepCache / CFG-tail loop
  adaface/   Arc2Face embeddings, the SubjBasisGenerator (face branch),
             placeholders, .npz checkpoints, and wrapper.AdaFacePipeline:
             photos -> 16 subject tokens -> personalized generations
  eval/      the ArcFace face embedder and identity similarity
  train/     Stage-1 Arc2Face distillation: losses, teacher chain, the step,
             Prodigy, the trainer
  utils/     the CLIP tokenizer, the ONNX initializer reader
  pipeline   StableDiffusionPipeline: txt2img on the card, and the serving
             stack (FastConfig, sampler="dpmpp", quant="int8")
  convert    JAX parameter pytrees -> the port's state dicts
  profile_step  device time by kernel class for each path
"""

__version__ = "0.1.0"
