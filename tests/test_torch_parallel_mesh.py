"""The port's parallel/mesh.py vs the JAX package's parallel/mesh.py: make_mesh's
shapes and errors (a 4-rank gloo world on the CPU against JAX's mesh over 4
of the conftest's 8 virtual CPU devices), the FSDP rule of param_spec and
shard_params on every leaf of a tiny UNet, CLIP text model and
SubjBasisGenerator (names and axes mapped through the port's key maps, the
divisibility fallback included), that a sharded model computes what the
whole one does, and shard_batch's rows and whole keys."""

import numpy as np
import pytest
import torch

import jax
from adaprompt_tpu.parallel import mesh as jmesh
from adaprompt_tpu_torch import convert
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.adaface.checkpoint import module_tree
from adaprompt_tpu_torch.models import clip_text as tclip, unet as tunet
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.parallel import mesh as tmesh
import torch_dist_workers as workers
from torch_port_helpers import TORCH_TEXT, TORCH_UNET
from torch_port_helpers import torch_threads  # noqa: F401

WORLD = 4
FSDP_SIZES = (2, 4)
MIN_SIZE = 2 ** 10       # small enough that the tiny models' leaves shard
MESHES = {"default": {}, "fsdp2": {"fsdp": 2}, "fsdp4": {"fsdp": 4}, "n2": {"n_devices": 2},
          "n2_fsdp2": {"n_devices": 2, "fsdp": 2}, "n8": {"n_devices": 8},
          "fsdp3": {"fsdp": 3}}


def _models():
    gen = torch.Generator().manual_seed(0)
    scfg = tsbg.SubjBasisConfig(output_dim=64, num_heads=4, text_cfg=TORCH_TEXT)
    return {"unet": (tunet.UNet, TORCH_UNET), "clip": (tclip.CLIPTextModel, TORCH_TEXT),
            "sbg": (tsbg.SubjBasisGenerator, scfg)}, gen


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of one 4-rank world."""
    tmp = tmp_path_factory.mktemp("mesh")
    models, gen = _models()
    states = {name: reset_parameters(cls(cfg), gen).state_dict()
              for name, (cls, cfg) in models.items()}
    torch.save(states, tmp / "states.pt")
    batch = {"z0": np.arange(8.0).reshape(4, 2), "one": np.ones((1, 3)), "three": np.arange(3.0),
             "skip_weights": np.arange(4.0), "emb_noise_std": np.float32(0.03)}
    spec = {"meshes": MESHES, "states": str(tmp / "states.pt"), "models": models,
            "fsdp_sizes": FSDP_SIZES, "fsdp_min_size": MIN_SIZE, "batch": batch,
            "run": {"unet": workers.run_unet, "clip": workers.run_clip}}
    workers.spawn(workers.mesh_rank, WORLD, tmp, spec)
    return [workers.load(tmp / f"mesh-{r}.pkl") for r in range(WORLD)], states, models


def test_make_mesh_matches_jax(ranks):
    """Shapes of every mesh, and the errors: more ranks than the group holds
    (ValueError, JAX's wording) and an fsdp size that does not divide."""
    results = ranks[0]
    devices = jax.devices()[:WORLD]
    for key, kw in MESHES.items():
        try:
            want = dict(jmesh.make_mesh(devices=devices, **kw).shape)
        except (ValueError, AssertionError) as e:
            for r in results:
                assert r["errors"][key] == type(e).__name__, key
            continue
        for r in results:
            assert r["shapes"][key] == want, key
    assert set(results[0]["errors"]) == {"n8", "fsdp3"}


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="torchrun"):
        tmesh.init_distributed("cpu")


def _jax_axes(state, fsdp):
    """{port name: the axis JAX's shard_params shards, or None} of a port
    state's leaves, through the JAX layout and back: each leaf's position
    along its sharded axis, carried by convert.from_jax_params."""
    mesh = jmesh.make_mesh(WORLD, fsdp=fsdp, devices=jax.devices()[:WORLD])
    placed = jmesh.shard_params(_tree(state), mesh, fsdp_min_size=MIN_SIZE)

    def marker(leaf):
        spec = list(leaf.sharding.spec) + [None] * (leaf.ndim - len(leaf.sharding.spec))
        if "fsdp" not in spec:
            return np.zeros(leaf.shape, np.float32)
        return np.indices(leaf.shape)[spec.index("fsdp")].astype(np.float32)
    axes = {}
    for name, m in convert.from_jax_params(jax.tree.map(marker, placed)).items():
        m = m.numpy()
        varying = [a for a in range(m.ndim) if (np.diff(m, axis=a) != 0).any()]
        axes[name] = varying[0] if varying else None
    return axes


def _tree(state):
    """The JAX-layout tree of a port state dict."""
    holder = torch.nn.Module()
    for name, v in state.items():
        parent = holder
        *heads, leaf = name.split(".")
        for part in heads:
            if not hasattr(parent, part):
                parent.add_module(part, torch.nn.Module())
            parent = getattr(parent, part)
        parent.register_parameter(leaf, torch.nn.Parameter(v.float(), requires_grad=False))
    return module_tree(holder)


def _params(models, states, model):
    cls, cfg = models[model]
    return {n: states[model][n] for n, _ in cls(cfg).named_parameters()}


@pytest.mark.parametrize("fsdp", FSDP_SIZES)
@pytest.mark.parametrize("model", ["unet", "clip", "sbg"])
def test_shard_params_matches_jax(ranks, fsdp, model):
    """The leaves each rank shards, and on which axis, are JAX's: the
    largest axis of every leaf of at least MIN_SIZE elements with ndim >= 2,
    whole where fsdp does not divide it; a square leaf's tie takes the
    first axis in each package's layout, so there the sizes are compared. A
    CLIP text model's token and position tables stay whole (its
    `whole_leaves`). The sharded model's output is the whole one's, bit for
    bit, and so is the UNet's context gradient, whose backward recomputes
    each block from its gathered weights."""
    results, states, models = ranks
    state = _params(models, states, model)
    want = {n: a for n, a in _jax_axes(state, fsdp).items() if a is not None}
    for n in getattr(models[model][0], "whole_leaves", ()):
        want.pop(n, None)
    assert len(want) >= 3
    for r in results:
        got = r["placements"][(fsdp, model)]
        assert set(got) == set(want), set(got) ^ set(want)
        for n, a in got.items():
            shape = state[n].shape
            assert shape[a] == shape[want[n]] == max(shape), n
            if list(shape).count(max(shape)) == 1:
                assert a == want[n], n
        if model in ("unet", "clip"):
            assert r["same_output"][(fsdp, model)], model
        if model == "unet":
            assert r["same_grad"][fsdp]


def test_fallback_to_whole(ranks):
    """Leaves whose sharded axis fsdp does not divide stay whole in both
    packages (the 4-way mesh has some: 77 positions, 5 tokens ...)."""
    results, states, models = ranks
    state = _params(models, states, "sbg")
    fallback = [n for n, v in state.items()
                if (d := tmesh.param_spec(n, v, MIN_SIZE)) is not None and v.shape[d] % 4]
    assert fallback
    jax_axes = _jax_axes(state, 4)
    for n in fallback:
        assert jax_axes[n] is None, n
        assert all(n not in r["placements"][(4, "sbg")] for r in results), n


def test_param_spec_rule():
    """The rule itself on every leaf of the tiny models: JAX's param_spec on
    the JAX-layout leaf shards an axis of the same size, or neither does."""
    models, gen = _models()
    for cls, cfg in models.values():
        for name, p in reset_parameters(cls(cfg), gen).named_parameters():
            d = tmesh.param_spec(name, p, MIN_SIZE)
            shape = p.shape[::-1] if p.ndim == 2 else (
                (p.shape[2], p.shape[3], p.shape[1], p.shape[0]) if p.ndim == 4 else p.shape)
            jspec = tuple(jmesh.param_spec((), np.zeros(shape, np.float32), MIN_SIZE))
            assert (d is None) == ("fsdp" not in jspec), name
            if d is not None:
                assert p.shape[d] == max(p.shape) == shape[jspec.index("fsdp")], name


def test_shard_batch_rows(ranks):
    """P('dp'): each rank holds its dp block of the batch's rows, the fsdp
    peers the same block; leading size 1, sizes dp does not divide and the
    whole keys stay whole."""
    results, _, _ = ranks
    z0 = np.arange(8.0).reshape(4, 2)
    for r in results:
        for fsdp in FSDP_SIZES:
            dp_rank, _ = r["coords"][fsdp]
            n = 4 // (WORLD // fsdp)
            rows = r["rows"][fsdp]
            np.testing.assert_array_equal(rows["z0"], z0[dp_rank * n:(dp_rank + 1) * n])
            np.testing.assert_array_equal(rows["one"], np.ones((1, 3)))
            np.testing.assert_array_equal(rows["three"], np.arange(3.0))
            np.testing.assert_array_equal(rows["skip_weights"], np.arange(4.0))
            assert float(rows["emb_noise_std"]) == pytest.approx(0.03)
