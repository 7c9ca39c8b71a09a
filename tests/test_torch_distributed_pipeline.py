"""The port's StableDiffusionPipeline over a 2-rank dp mesh (distribute, gloo
ranks on the CPU) vs the JAX pipeline and the port's single-rank generate,
on shared tiny weights (64x64, float32): 8 prompts in 2 DDIM steps from
seed 5 split 4 + 4 over the ranks, every rank returning all 8 images,
within one uint8 level of JAX's undistributed generate on the same x_T
(JAX's own mesh generate is held in the slow tier,
tests/test_torch_distributed_slow.py) and of the port's single-rank one;
the fast path and DPM-Solver++ over the mesh; and the ValueError of a batch
that dp does not divide."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaprompt_tpu import pipeline as jpipe
from adaprompt_tpu_torch import pipeline as tpipe
from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
import torch_dist_workers as workers
from torch_port_helpers import JAX_UNET, JAX_VAE, JAX_TEXT, TORCH_TEXT, TORCH_UNET, TORCH_VAE
from torch_port_helpers import tiny_models
from torch_port_helpers import torch_threads  # noqa: F401

PROMPTS = ["a photo of a cat", "a red car", "a bowl of fruit", "a tall tree"] * 2
KW = dict(num_steps=2, height=64, width=64, seed=5)


def run_all(tmp):
    """(each rank's results, the port's single-rank generate, JAX's
    undistributed generate on the port's x_T, the JAX pipeline, that x_T)."""
    tmp.mkdir(exist_ok=True)
    (ju, jv, jt), (tu, tv, tt) = tiny_models(1)
    torch.save({"unet": tu.state_dict(), "vae": tv.state_dict(), "text": tt.state_dict()},
               tmp / "states.pt")
    spec = {"states": str(tmp / "states.pt"), "cfgs": (TORCH_UNET, TORCH_VAE, TORCH_TEXT),
            "prompts": PROMPTS, "kw": KW}
    workers.spawn(workers.pipeline_rank, 2, tmp, spec)
    ranks = [workers.load(tmp / f"pipeline-{r}.pkl") for r in range(2)]
    tp = tpipe.StableDiffusionPipeline(tu, tv, tt, CLIPTokenizer.fallback())
    single = {"images": tp.generate(PROMPTS, **KW),
              "dpmpp": tp.generate(PROMPTS, **dict(KW, num_steps=3), sampler="dpmpp")}
    jp = jpipe.StableDiffusionPipeline(jpipe.SDParams(unet=ju, vae=jv, text=jt),
                                       unet_cfg=JAX_UNET, vae_cfg=JAX_VAE, text_cfg=JAX_TEXT,
                                       compute_dtype=jnp.float32)
    # the port's x_T, drawn whole from the seed as its generate draws it
    x_T = torch.randn((8, 8, 8, 4), generator=torch.Generator().manual_seed(KW["seed"])).numpy()
    cond = jp.encode_prompt(PROMPTS)[None]
    uncond = jp.encode_prompt([jpipe.DEFAULT_NEGATIVE_PROMPT] * 8)[None]
    want = np.asarray(jpipe._generate_jit(jp.params.unet, jp.params.vae, cond, uncond,
                                          jnp.asarray(x_T), KW["num_steps"], (4.0, 1.0), False,
                                          JAX_UNET, JAX_VAE, jp.sched, jnp.float32))
    return ranks, single, want, jp, x_T


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(tmp_path_factory.mktemp("dist_pipeline"))[:3]


def _within_one_level(a, b):
    assert a.shape == b.shape == (8, 64, 64, 3) and a.dtype == np.uint8
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_generate_matches_jax_and_single_rank(runs):
    ranks, single, want = runs
    for r in ranks:
        _within_one_level(r["images"], want)
        _within_one_level(r["images"], single["images"])
        assert r["images"].std() > 0
        _within_one_level(r["dpmpp"], single["dpmpp"])
    np.testing.assert_array_equal(ranks[0]["images"], ranks[1]["images"])


def test_fast_path_over_the_mesh(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert r["fast"].shape == (8, 64, 64, 3) and r["fast"].std() > 0
    np.testing.assert_array_equal(ranks[0]["fast"], ranks[1]["fast"])


def test_batch_not_divisible_raises(runs):
    ranks, _, _ = runs
    for r in ranks:
        assert "not divisible by the mesh dp size 2" in r["error"]
