"""Ops of the port: plain PyTorch layers and the CUDA kernels' wrappers.

Every kernel wrapper carries a `launches` count (see `kernel_wrappers`)."""


def kernel_wrappers() -> dict:
    """{name: wrapper} for every kernel of the port's paths (txt2img and
    Stage-1 training)."""
    from adaprompt_tpu_torch.ops.attention import (flash_attention_bwd, flash_attention_fwd,
                                                   fused_cross_attention)
    from adaprompt_tpu_torch.ops.geglu import geglu_fwd
    return {"flash_attention_fwd": flash_attention_fwd,
            "flash_attention_bwd": flash_attention_bwd,
            "fused_cross_attention": fused_cross_attention,
            "geglu_fwd": geglu_fwd}
