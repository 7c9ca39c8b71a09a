"""AdaFace checkpoints as native .npz files.

Port of the native part of `adaprompt_tpu/adaface/checkpoint.py`: trees of
arrays stored flat as '<name>/<path>' entries plus a JSON '__meta__' entry,
so that either package reads what the other wrote. Trees here are nested
dicts and lists of numpy arrays in the JAX package's layout; `module_tree`
and `load_module_tree` go between such a tree and a module's parameters
(the inverse of `convert.from_jax_params`).

`load_reference_checkpoint` reads the reference's training artifact,
`embeddings_gs-<step>.pt` (a torch pickle whose
`string_to_subj_basis_generator_dict` holds the generators as nn.Module
objects), without the reference's code: the unpickler maps every class of
the 'adaface.*' and 'ldm.*' modules to a skeleton nn.Module (unpickling
restores `__dict__` without calling `__init__`), and each generator's
parameters and buffers are walked into a flat state dict for
`subj_basis_generator.from_torch`.

The trainer's full state (`AdaPromptTrainer.save_full_state`) is one flat
.npz too: module trees in the JAX layout through `_flatten`, and tensors
keyed by qualified name (`tensor_entries`); the optimizer's state, which
has no counterpart in optax's leaf order, under the port's own keys
(`optimizer_entries`: 'optstate/acc/<name>', 'optstate/<slot>/<name>',
'optstate/<scalar>').
"""

from __future__ import annotations

import json
import pickle

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


def optimizer_entries(pipe, names: list, whole=None) -> tuple[dict, dict]:
    """A `prodigy.GradientPipeline`'s state: its accumulator and its inner
    optimizer's per-parameter slots by the parameters' qualified `names`
    (in the pipeline's order), the inner optimizer's scalar tensors, and
    (meta) its type, update count and the pipeline's micro-step. `whole`
    (tensor, parameter) -> the whole tensor of a sharded parameter's slot
    (`parallel/mesh.py`'s unshard)."""
    inner = pipe.inner
    whole = whole or (lambda t, p: t)
    flat = {f"optstate/acc/{name}": _numpy(whole(a, p))
            for name, a, p in zip(names, pipe.acc, pipe.params)}
    for name, p in zip(names, pipe.params):
        for slot, t in inner.state[p].items():
            flat[f"optstate/{slot}/{name}"] = _numpy(whole(t, p))
    flat.update(tensor_entries("optstate/", {a: getattr(inner, a) for a in inner.SCALARS}))
    meta = {"type": type(inner).__name__, "count": inner.count, "mini_step": pipe.mini_step}
    return flat, meta


@torch.no_grad()
def load_optimizer_entries(pipe, names: list, flat: dict, meta: dict, local=None):
    """Restore what `optimizer_entries` saved, in place, onto a pipeline of
    the same type over parameters of the same names. `local` (whole
    tensor, parameter) -> a sharded parameter's rows of it
    (`parallel/mesh.py`'s local_rows)."""
    inner = pipe.inner
    if meta["type"] != type(inner).__name__:
        raise ValueError(f"the state holds a {meta['type']} optimizer, the trainer builds "
                         f"a {type(inner).__name__}")
    local = local or (lambda t, p: t)
    for name, p, acc in zip(names, pipe.params, pipe.acc):
        for slot, t in {"acc": acc, **inner.state[p]}.items():
            t.copy_(local(torch.as_tensor(flat[f"optstate/{slot}/{name}"]), p))
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


def _extract_state_dict(module_obj, prefix: str = "") -> dict:
    """A skeleton module's parameters and buffers, walked through its
    `_parameters`, `_buffers` and `_modules`, as float32 numpy arrays."""
    sd = {}
    for table in ("_parameters", "_buffers"):
        for name, t in (getattr(module_obj, table, None) or {}).items():
            if t is not None:
                sd[prefix + name] = t.detach().float().cpu().numpy()
    for name, m in (getattr(module_obj, "_modules", None) or {}).items():
        if m is not None:
            sd.update(_extract_state_dict(m, prefix + name + "."))
    return sd


class _SkeletonModule(torch.nn.Module):
    """Stands in for a class of the reference's code when unpickling."""


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".", 1)[0] in ("adaface", "ldm"):
            return type(name, (_SkeletonModule,), {"__module__": module})
        return super().find_class(module, name)


class _PickleShim:
    """A `pickle_module` for torch.load whose Unpickler knows no reference class."""
    Unpickler = _Unpickler

    @staticmethod
    def load(f, **kw):
        return _Unpickler(f, **kw).load()


def load_reference_checkpoint(path: str) -> dict:
    """An `embeddings_gs-*.pt` -> {'subj_basis_generators': {placeholder:
    flat numpy state dict}, 'string_to_token': {placeholder: token id} if
    present, 'raw': every other entry (tensors as float32 numpy arrays)}."""
    ckpt = torch.load(path, map_location="cpu", pickle_module=_PickleShim,
                      weights_only=False)
    out = {"subj_basis_generators": {}, "raw": {}}
    sbg_dict = ckpt.get("string_to_subj_basis_generator_dict")
    if sbg_dict is not None:
        mods = getattr(sbg_dict, "_modules", None) or dict(sbg_dict)
        for placeholder, mod in mods.items():
            out["subj_basis_generators"][placeholder] = _extract_state_dict(mod)
    for k, v in ckpt.items():
        if k == "string_to_subj_basis_generator_dict":
            continue
        if hasattr(v, "detach"):
            out["raw"][k] = v.detach().float().cpu().numpy()
        elif isinstance(v, dict) and k == "string_to_token_dict":
            out["string_to_token"] = {s: int(t) for s, t in v.items()}
        else:
            out["raw"][k] = v
    return out
