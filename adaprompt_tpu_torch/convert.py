"""Turn the JAX package's parameter pytrees into the port's weights.

The port's modules name their parameters after the JAX pytree paths, so the
conversion is mechanical: a leaf at path `a.b.0.c.kernel` becomes
`a.b.0.c.weight`; a 2-D kernel [in, out] becomes a linear weight [out, in]
(transposed); a 4-D kernel HWIO becomes a conv weight OIHW; `scale`
(norms) becomes `weight`, unless a `kernel` sits beside it (a conv with its
BatchNorm folded in, RetinaFace's: `scale` and `shift` keep their names); a
BatchNorm's `mean` and `var` (ArcFace, BiSeNet) become `running_mean` and
`running_var`; every other leaf (PReLU's `alpha` among them) keeps its name
and values.
"""

from __future__ import annotations

import numpy as np
import torch


def flatten(tree, prefix=""):
    """(dotted path, numpy array) for every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def from_jax_params(np_tree) -> dict[str, torch.Tensor]:
    """JAX parameter pytree (nested dicts/lists of numpy arrays) -> a state
    dict for the port's module of the same model (load with
    `module.load_state_dict(..., strict=True)`)."""
    leaves = list(flatten(np_tree))
    with_kernel = {path.rpartition(".")[0] for path, _ in leaves
                   if path.rpartition(".")[2] == "kernel"}
    state = {}
    for path, arr in leaves:
        head, _, leaf = path.rpartition(".")
        if leaf == "kernel" and arr.ndim == 2:
            arr = arr.T
        elif leaf == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel":
            raise ValueError(f"{path}: kernel of rank {arr.ndim}")
        if leaf == "kernel" or (leaf == "scale" and head not in with_kernel):
            leaf = "weight"
        elif leaf in ("mean", "var"):
            leaf = "running_" + leaf
        state[f"{head}.{leaf}" if head else leaf] = torch.from_numpy(np.array(arr))
    return state
