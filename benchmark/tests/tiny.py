"""A tiny configuration and traffic mix of the adaface cell, for CPU tests."""

import copy

TINY_CONFIG = {
    "unet": {"in_channels": 4, "out_channels": 4, "model_channels": 32, "channel_mult": [1, 1, 2, 2],
             "num_res_blocks": 1, "attention_ds": [1, 2, 4], "num_heads": 2, "context_dim": 64},
    "unet_options": {"fused_conv": False},
    "vae": {"ch": 32, "ch_mult": [1, 2, 2, 2], "num_res_blocks": 1, "in_channels": 3, "out_channels": 3,
            "z_channels": 4, "embed_dim": 4},
    "text": {"vocab_size": 49408, "hidden_size": 64, "intermediate_size": 128, "num_layers": 2,
             "num_heads": 2, "max_positions": 77, "layer_norm_eps": 1e-05},
    "prompt2token_proj_kv_mult": [1, 2],
    "arcface": {"layers": [1, 1, 1, 1], "planes": [8, 16, 16, 32], "num_features": 32, "input_size": 112,
                "bn_eps": 1e-05},
    "subject_string": "z", "num_vectors": 16,
    "dtype": {m: "float32" for m in ("unet", "vae", "text", "arc2face", "sbg", "arcface")},
}


def tiny_mix(mix: dict) -> dict:
    return dict(copy.deepcopy(mix), photos=2, photo_size=[80, 64], out_image_count=2,
                num_steps=3, height=64, width=64)


def run_tiny(seed=2**31 + 17, seconds=0.5, traced=False, config=None):
    """A run of adaface.ddim50_x4 at the tiny size on the CPU: (result, checks text)."""
    import time

    import torch

    from benchmark.harness import core, manifest
    man = manifest.manifest()
    wl = manifest.workload("adaface.ddim50_x4")
    return core.run_cell(man, wl, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                         config or TINY_CONFIG, tiny_mix(manifest.traffic(wl["traffic"])))


TINY_STAGE1 = dict(
    {k: copy.deepcopy(v) for k, v in TINY_CONFIG.items() if k not in ("arcface", "prompt2token_proj_kv_mult", "dtype")},
    prompt2token_proj_kv_mult=[1, 1], batch_size=8,
    dtype={m: "float32" for m in ("unet", "teacher", "vae", "text", "arc2face", "sbg")},
    trainer={"max_steps": 120000, "grad_accum": 2, "grad_clip": 0.5, "optimizer_type": "Prodigy", "d_coef": 1.0,
             "prodigy_betas": [0.9, 0.999], "warm_up_steps": 600, "arc2face_distill_iter_prob": 1.0,
             "max_num_denoising_steps": 5, "num_denoising_steps_probs": [0.4, 0.3, 0.2, 0.1],
             "skip_weights": [1.0, 2.0, 2.0], "compute_dtype": "float32", "seed": 17})


def tiny_stage1_mix(mix: dict) -> dict:
    return dict(copy.deepcopy(mix), image_size=64, face_dim=32, fg_box=[16, 48, 20, 44], pad_left=18)


def run_tiny_stage1(seed=2**31 + 29, seconds=0.5, traced=False, config=None):
    """A run of stage1.distill_bs8 at the tiny size on the CPU: (result, checks text)."""
    import time

    import torch

    from benchmark.harness import core, manifest
    man = manifest.manifest()
    wl = manifest.workload("stage1.distill_bs8")
    return core.run_cell(man, wl, seed, seconds, traced, torch.device("cpu"), time.perf_counter(),
                         config or TINY_STAGE1, tiny_stage1_mix(manifest.traffic(wl["traffic"])))
