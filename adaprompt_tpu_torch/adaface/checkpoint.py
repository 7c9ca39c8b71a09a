"""AdaFace checkpoints as native .npz files.

Port of the native part of `adaprompt_tpu/adaface/checkpoint.py`: trees of
arrays stored flat as '<name>/<path>' entries plus a JSON '__meta__' entry,
so that either package reads what the other wrote. Trees here are nested
dicts and lists of numpy arrays in the JAX package's layout; `module_tree`
and `load_module_tree` go between such a tree and a module's parameters
(the inverse of `convert.from_jax_params`). Loading the reference's
`.pt` checkpoints is not ported yet.

The trainer's full state (`AdaPromptTrainer.save_full_state`) is one flat
.npz too: module trees in the JAX layout through `_flatten`, and tensors
keyed by qualified name (`tensor_entries`); the optimizer's state, which
has no counterpart in optax's leaf order, under the port's own keys
(`optimizer_entries`: 'optstate/acc/<name>', 'optstate/<slot>/<name>',
'optstate/<scalar>').
"""

from __future__ import annotations

import json

import numpy as np
import torch

from adaprompt_tpu_torch import convert


def _flatten(tree, prefix=""):
    """A nested dict/list tree as {'<prefix><path>': numpy array}, the path
    '/'-joined."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _numpy(tree)
    return out


def _numpy(a) -> np.ndarray:
    """A host copy; bfloat16, which numpy lacks, as float32 (lossless)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def group(flat: dict, prefix: str) -> dict:
    """The entries under `prefix`, the prefix taken off their keys."""
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def tensor_entries(prefix: str, tensors: dict) -> dict:
    """{name: tensor} as {'<prefix><name>': numpy array}."""
    return {prefix + name: _numpy(t) for name, t in tensors.items()}


@torch.no_grad()
def load_tensor_entries(prefix: str, tensors: dict, flat: dict):
    """Copy the entries under `prefix` into the tensors of the same names,
    in place (each keeps its device and dtype); every name must be there."""
    for name, t in tensors.items():
        t.copy_(torch.as_tensor(flat[prefix + name]))


def optimizer_entries(pipe, names: list) -> tuple[dict, dict]:
    """A `prodigy.GradientPipeline`'s state: its accumulator and its inner
    optimizer's per-parameter slots by the parameters' qualified `names`
    (in the pipeline's order), the inner optimizer's scalar tensors, and
    (meta) its type, update count and the pipeline's micro-step."""
    inner = pipe.inner
    flat = tensor_entries("optstate/acc/", dict(zip(names, pipe.acc)))
    for name, p in zip(names, pipe.params):
        for slot, t in inner.state[p].items():
            flat[f"optstate/{slot}/{name}"] = _numpy(t)
    flat.update(tensor_entries("optstate/", {a: getattr(inner, a) for a in inner.SCALARS}))
    meta = {"type": type(inner).__name__, "count": inner.count, "mini_step": pipe.mini_step}
    return flat, meta


@torch.no_grad()
def load_optimizer_entries(pipe, names: list, flat: dict, meta: dict):
    """Restore what `optimizer_entries` saved, in place, onto a pipeline of
    the same type over parameters of the same names."""
    inner = pipe.inner
    if meta["type"] != type(inner).__name__:
        raise ValueError(f"the state holds a {meta['type']} optimizer, the trainer builds "
                         f"a {type(inner).__name__}")
    load_tensor_entries("optstate/acc/", dict(zip(names, pipe.acc)), flat)
    for name, p in zip(names, pipe.params):
        load_tensor_entries("optstate/", {f"{slot}/{name}": t
                                          for slot, t in inner.state[p].items()}, flat)
    for a in inner.SCALARS:
        setattr(inner, a, torch.as_tensor(flat["optstate/" + a]).to(getattr(inner, a).device))
    inner.count, pipe.mini_step = int(meta["count"]), int(meta["mini_step"])


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
    return named_tree(module.named_parameters())


def named_tree(named) -> dict:
    """`module_tree` of (parameter name, tensor) pairs."""
    flat = {}
    for name, p in named:
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
