"""Seeded weights, made on the device in one large draw a model.

A model's weights are listed by its reference (`param_shapes`: name, shape,
init). One standard-normal draw of all their elements, from a
`torch.Generator` on the device, is cut into the tensors and shaped by each
init: ("normal", std) z * std; ("one", std) 1 + z * std; ("const_plus", v,
std) v + z * std; ("values", [...]) the values given. The same seed on the
same device gives the same weights, so the reference can make them again
after the program has run, and the program's state is never read.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def seed_for(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose of a run (a model's weights, a request)."""
    rng = np.random.default_rng([int(seed) % (1 << 128), *[int(p) for p in purpose]])
    return int(rng.integers(0, (1 << 63) - 1))


def make(shapes: list, seed: int, device, dtype) -> dict:
    """{name: tensor} for the reference's (name, shape, init) list."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init in shapes:
        n = int(np.prod(shape))
        v = z[at:at + n].reshape(shape)
        at += n
        kind = init[0]
        if kind == "normal":
            t = v * init[1]
        elif kind == "one":
            t = 1.0 + v * init[1]
        elif kind == "const_plus":
            t = init[1] + v * init[2]
        elif kind == "values":
            t = torch.tensor(init[1], dtype=torch.float32, device=device).reshape(shape)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
        out[name] = t.to(dtype)
    del z
    return out
