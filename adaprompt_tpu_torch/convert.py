"""Turn the JAX package's parameter pytrees into the port's weights.

The port's modules name their parameters after the JAX pytree paths, so the
conversion is mechanical: a leaf at path `a.b.0.c.kernel` becomes
`a.b.0.c.weight`; a 2-D kernel [in, out] becomes a linear weight [out, in]
(transposed); a 4-D kernel HWIO becomes a conv weight OIHW; `scale`
(norms) becomes `weight`; every other leaf keeps its name and values.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def from_jax_params(np_tree) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts/lists of numpy arrays) -> a state
    dict for the port's module of the same model (load with
    `module.load_state_dict(..., strict=True)`)."""
    state = {}
    for path, arr in _flatten(np_tree):
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel" and arr.ndim == 2:
            arr = arr.T
        elif leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
        if leaf in ("kernel", "scale"):
            leaf = "weight"
        state[f"{head}.{leaf}" if head else leaf] = torch.from_numpy(np.array(arr))
    return state
