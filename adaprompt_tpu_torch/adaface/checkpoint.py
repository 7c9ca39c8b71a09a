"""AdaFace checkpoints as native .npz files.

Port of the native part of `adaprompt_tpu/adaface/checkpoint.py`: trees of
arrays stored flat as '<name>/<path>' entries plus a JSON '__meta__' entry,
so that either package reads what the other wrote. Trees here are nested
dicts and lists of numpy arrays in the JAX package's layout; `module_tree`
and `load_module_tree` go between such a tree and a module's parameters
(the inverse of `convert.from_jax_params`). Loading the reference's
`.pt` checkpoints is not ported yet.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from adaprompt_tpu_torch import convert


def _unflatten(flat: dict):
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.isdigit() for k in keys) \
                and sorted(int(k) for k in keys) == list(range(len(keys))):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def module_tree(module: torch.nn.Module) -> dict:
    """A module's parameters as a JAX-layout tree of float32 numpy arrays:
    linear weights become [in, out] kernels, conv weights HWIO kernels, 1-D
    norm weights `scale`; other leaves keep their names."""
    flat = {}
    for name, p in module.named_parameters():
        head, _, leaf = name.rpartition(".")
        a = p.detach().float().cpu().numpy()
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            elif a.ndim == 2:
                leaf, a = "kernel", a.T
            elif a.ndim == 4:
                leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        flat[(f"{head}.{leaf}" if head else leaf).replace(".", "/")] = np.ascontiguousarray(a)
    return _unflatten(flat)


def load_module_tree(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Copy a JAX-layout tree into a module's parameters (strict)."""
    own = module.state_dict()
    state = {k: v.to(dtype=own[k].dtype) if k in own else v
             for k, v in convert.from_jax_params(tree).items()}
    module.load_state_dict(state, strict=True)
    return module


def save_checkpoint(path: str, trees: dict, meta: dict | None = None):
    """trees: {name: tree}; stored flat as '<name>/<path>' arrays."""
    flat = {path.replace(".", "/"): arr for name, tree in trees.items()
            for path, arr in convert.flatten(tree, name + ".")}
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_checkpoint(path: str):
    """-> (trees dict, meta dict)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    groups: dict = {}
    for k in data.files:
        if k != "__meta__":
            name, rest = k.split("/", 1)
            groups.setdefault(name, {})[rest] = data[k]
    return {name: _unflatten(g) for name, g in groups.items()}, meta
