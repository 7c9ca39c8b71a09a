"""The port's multi-rank paths against the JAX package's own mesh (slow tier):
the port's 2x2 (dp, fsdp) recon step (gloo ranks) against JAX's trainer
after distribute(fsdp=2) on a 4-device mesh, and the port's 2-rank generate
against JAX's generate sharded over make_mesh(8), on the port's x_T.

Runs in a SUBPROCESS, as tests/test_trainer_mesh.py does: XLA:CPU's
collective rendezvous can wedge late in a long pytest session
(tests/conftest.py), while the same program passes in a fresh interpreter."""

import os
import subprocess
import sys

import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))


def _main(tmp):
    """The subprocess: both comparisons; prints DIST_MESH_OK."""
    import pathlib

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from adaprompt_tpu import pipeline as jpipe
    from adaprompt_tpu.parallel import mesh as jmesh
    import test_torch_distributed_pipeline as tpipe_test
    import test_torch_distributed_trainer as ttrainer_test
    import torch_dist_workers as workers

    torch.set_num_threads(1)
    tmp = pathlib.Path(tmp)
    # the trainer: JAX's distributed recon step vs every port rank's
    want, spec = ttrainer_test.jax_and_spec(tmp, mesh=jmesh.make_mesh(
        4, fsdp=2, devices=jax.devices()[:4]), steps=("recon",))
    d = tmp / "2x2"
    d.mkdir()
    workers.spawn(workers.trainer_rank, 4, d, dict(spec, fsdp=2))
    for r in range(4):
        got = workers.load(d / f"trainer-{r}.pkl")
        ttrainer_test._close_metrics(got["recon"], want["recon"], list(want["recon"]),
                                     ttrainer_test.LOSS_RTOL, "2x2 vs JAX's mesh")
    # the pipeline: JAX's generate over an 8-device dp mesh vs the port's 2 ranks
    ranks, _, _, jp, x_T = tpipe_test.run_all(tmp / "pipe")
    dist = jp.distribute(jmesh.make_mesh(8))
    cond = dist.encode_prompt(tpipe_test.PROMPTS)[None]
    uncond = dist.encode_prompt([jpipe.DEFAULT_NEGATIVE_PROMPT] * 8)[None]
    cond, uncond, x = dist._shard_batch(cond, uncond, jnp.asarray(x_T))
    kw = tpipe_test.KW
    out = np.asarray(jpipe._generate_jit(dist.params.unet, dist.params.vae, cond, uncond, x,
                                         kw["num_steps"], (4.0, 1.0), False, dist.unet_cfg,
                                         dist.vae_cfg, dist.sched, jnp.float32))
    for r in ranks:
        assert np.abs(r["images"].astype(np.int32) - out.astype(np.int32)).max() <= 1
    print("DIST_MESH_OK")


@pytest.mark.slow
def test_port_mesh_matches_jax_mesh(tmp_path):
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    repo = os.path.dirname(TESTS)
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {repo!r}]; "
            f"import test_torch_distributed_slow as t; t._main({str(tmp_path)!r})")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=1500)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    assert "DIST_MESH_OK" in res.stdout
