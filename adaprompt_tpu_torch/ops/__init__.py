"""Ops of the port: plain PyTorch layers and the CUDA kernels' wrappers.

Every kernel wrapper carries a `launches` count (see `kernel_wrappers`)."""


def kernel_wrappers() -> dict:
    """{name: wrapper} for every kernel of the port: those of its paths
    (txt2img, Stage-1 training, the int8 serving stack, the personalized
    product path under fused_conv) and the two plain 3x3 conv kernels, which
    no model calls (as in the JAX package)."""
    from adaprompt_tpu_torch.ops.attention import (flash_attention_bwd, flash_attention_fwd,
                                                   fused_cross_attention,
                                                   fused_cross_attention_int8)
    from adaprompt_tpu_torch.ops.conv_halo import (conv3x3_halo, conv3x3_im2col,
                                                   gn_silu_conv3x3_halo)
    from adaprompt_tpu_torch.ops.geglu import geglu_fwd, geglu_int8
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "fused_cross_attention": fused_cross_attention,
            "geglu_fwd": geglu_fwd,
            "fused_cross_attention_int8": fused_cross_attention_int8,
            "geglu_int8": geglu_int8,
            "gn_silu_conv3x3_halo": gn_silu_conv3x3_halo,
            "conv3x3_halo": conv3x3_halo,
            "conv3x3_im2col": conv3x3_im2col}
