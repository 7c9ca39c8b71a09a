"""The segmented DeepCache / CFG-tail sampling loop of the serving fast path.

Port of `adaprompt_tpu/sampling/fastloop.py` as a Python loop with the
same semantics; DDIM (sampling/ddim.py) and DPM-Solver++(2M)
(sampling/dpm.py) share it:
  * DeepCache deep-feature reuse (arXiv:2312.00858): a FULL UNet pass
    every `cache_interval` steps, uniformly across a segment (step j of a
    segment is full when j % interval == 0, so a remainder opens with a
    full pass), shallow passes from the cached deep feature in between;
  * CFG-tail truncation (guidance-interval family, arXiv:2404.07724): the
    first `n_cfg` steps run the doubled (cond, uncond) batch, the rest
    cond-only. Each of the two segments starts with a fresh cache and a
    full pass.
The JAX package's two loop structures (group scan, or one scan with a
full/shallow flag) are two compilations of this one schedule; an eager loop
needs neither.

The solver plugs in as `update(carry, e_t, ps) -> carry`: `carry` is the
solver state whose first element is the latent x, `ps` this step's entries
of `arrs`, with ps[0] the ddpm timestep and ps[1] the guidance scale.
"""

from __future__ import annotations

import numpy as np
import torch


def cfg_tail(g_all: np.ndarray, cfg_tail_frac: float):
    """(guidance scales, n_cfg): the number of leading steps that keep CFG,
    and the scales with the tail pinned to exactly 1 (which makes dropping
    the uncond half exact for that schedule)."""
    num_steps = len(g_all)
    n_cfg = max(min(int(round(num_steps * (1.0 - cfg_tail_frac))), num_steps), 0)
    if cfg_tail_frac > 0:
        g_all = g_all.copy()
        g_all[n_cfg:] = 1.0
    return g_all, n_cfg


def fast_cached_loop(model_full, model_shallow, carry, arrs, update, *,
                     cache_interval: int = 1, n_cfg: int | None = None):
    """Run the segmented DeepCache/CFG-tail denoise loop.

    model_full: (x_in, t_in) -> (eps, deep_cache), on the doubled CFG batch
    (cond first) and on the plain batch; model_shallow: (x_in, t_in,
    deep_cache) -> eps. carry: the solver state, carry[0] the [B, H, W, C]
    latent. arrs: per-step arrays in denoise order (arrs[0] timesteps,
    arrs[1] guidance scales, the rest the solver's). n_cfg: leading steps
    with CFG (None: all). Returns the final carry."""
    b = carry[0].shape[0]
    total = len(arrs[0])
    n_cfg = total if n_cfg is None else n_cfg
    interval = max(int(cache_interval), 1)

    def eps(x, ps, use_cfg, cache):
        tb = torch.full((b,), int(ps[0]), dtype=torch.int64, device=x.device)
        if use_cfg:
            x, tb = torch.cat([x, x]), torch.cat([tb, tb])
        if cache is None:
            e, cache = model_full(x, tb)
        else:
            e = model_shallow(x, tb, cache)
        if use_cfg:
            e_c, e_u = e.chunk(2)
            e = e_u + float(ps[1]) * (e_c - e_u)
        return e, cache

    for start, stop, use_cfg in ((0, n_cfg, True), (n_cfg, total, False)):
        cache = None
        for j in range(stop - start):
            ps = tuple(a[start + j] for a in arrs)
            if j % interval == 0:
                cache = None                        # a full pass refreshes the cache
            e_t, cache = eps(carry[0], ps, use_cfg, cache)
            carry = update(carry, e_t, ps)
    return carry
