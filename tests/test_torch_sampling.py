"""Port DDIM sampling vs the JAX package: the schedule, the DDIM parameters,
the annealed guidance and the sampler loop itself on a toy eps-model that
both frameworks compute identically (float32)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from adaprompt_tpu.sampling import ddim as jddim, schedule as jsched
from adaprompt_tpu_torch.sampling import ddim as tddim, schedule as tsched
from torch_port_helpers import assert_close


def test_schedule_matches():
    np.testing.assert_array_equal(tsched.SD15_SCHEDULE.alphas_cumprod,
                                  jsched.SD15_SCHEDULE.alphas_cumprod)
    np.testing.assert_array_equal(tsched.SD15_SCHEDULE.betas, jsched.SD15_SCHEDULE.betas)


@pytest.mark.parametrize("steps", [1, 3, 50])
def test_ddim_params_and_guidance_match(steps):
    ts_t, a_t, ap_t, sig_t = tsched.make_ddim_params(tsched.SD15_SCHEDULE, steps)
    ts_j, a_j, ap_j, sig_j = jsched.make_ddim_params(jsched.SD15_SCHEDULE, steps)
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(ap_t, ap_j)
    np.testing.assert_array_equal(sig_t, sig_j)
    assert not sig_j.any()                       # eta = 0: no noise on either side
    for g in [(4.0, 1.0), 7.5, 1.5]:
        np.testing.assert_array_equal(tddim.guidance_schedule(steps, g),
                                      jddim.guidance_schedule(steps, g))
    if steps == 50:
        assert ts_t[-1] == 981 and ts_t[0] == 1


def test_ddim_loop_matches_on_toy_model():
    """eps = tanh(w * x) + t/1000 on the doubled batch, with a cond/uncond
    difference, so the CFG mix, its (cond, uncond) order and the update
    arithmetic are all exercised."""
    rng = np.random.default_rng(0)
    x_T = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    w = np.asarray([0.5, 0.5, -0.8, -0.8], np.float32)[:, None, None, None]

    def model_j(x, t):
        return jnp.tanh(jnp.asarray(w) * x) + (t.astype(jnp.float32) / 1000.0)[:, None, None, None]

    def model_t(x, t):
        return torch.tanh(torch.from_numpy(w) * x) + (t.float() / 1000.0)[:, None, None, None]

    z_j = jddim.ddim_sample(model_j, jnp.asarray(x_T), num_steps=7, guidance_scale=(4.0, 1.0))
    z_t = tddim.ddim_sample(model_t, torch.from_numpy(x_T), num_steps=7,
                            guidance_scale=(4.0, 1.0))
    assert_close(z_t, z_j, atol=1e-5, rtol=1e-5)
