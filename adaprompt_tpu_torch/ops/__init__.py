"""Ops of the port: plain PyTorch layers and the CUDA kernels' wrappers.

Every kernel wrapper carries a `launches` count (see `kernel_wrappers`)."""


def kernel_wrappers() -> dict:
    """{name: wrapper} for every kernel of the main path."""
    from adaprompt_tpu_torch.ops.attention import flash_attention_fwd, fused_cross_attention
    from adaprompt_tpu_torch.ops.geglu import geglu
    return {"flash_attention_fwd": flash_attention_fwd,
            "fused_cross_attention": fused_cross_attention,
            "geglu": geglu}
