"""Device mesh and sharding rules over torch.distributed.

Port of `adaprompt_tpu/parallel/mesh.py`. A (dp, fsdp) `DeviceMesh` over the
ranks of the initialised process group (one rank a card, launched by
`torchrun`):

  * dim 'dp'   - data parallel: each rank of a dp group holds its block of
    the batch's rows; the gradients are summed over dp;
  * dim 'fsdp' - parameter sharding (ZeRO-style): a large leaf keeps 1/fsdp
    of its largest axis on each rank and is all-gathered where it is used.

JAX's GSPMD computes the global batch exactly whatever the sharding. Here a
rank sees only its own rows, so a step over a split batch (`split_rows`)
makes every reduction that mixes rows global by hand: a loss normalised by
a mask or a count is each rank's share, its numerator over the global
denominator (`global_sum`, `share_of_mean`); the shares' gradients and
values are summed over dp (`sync_grads`, `sum_over_rows`). The random draws
of a step are made for the global batch on every rank and sliced
(`take_rows`), so a split step takes the very numbers of the whole one.

Sharded parameters (`shard_params`) are written by hand rather than with
FSDP2's `fully_shard`, which refuses the channels-last conv weights the
port's kernels read. A sharded leaf keeps its rows (its largest axis moved
to the front, split in fsdp blocks) as the parameter's data, so the
optimizer and the EMA update the shard in place. Every method of the model
that reads its weights (`GATHER_METHODS`) runs with the whole weights
swapped in: all-gathered over fsdp into a tensor of the leaf's original
shape and strides, so the kernel wrappers see plain contiguous tensors; a
trainable leaf's gradient is cut back to the shard's rows as it
accumulates. Leaves that code outside the model's methods reads (a CLIP
text model's `whole_leaves`, the token table of a splice) stay whole.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import os

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

# batch keys whose leading axis is not the batch axis: every rank keeps them whole
WHOLE_KEYS = frozenset({"skip_weights", "emb_scale_perturb", "emb_noise_std",
                        "training_percent"})
# the model methods that read the weights: each runs with the whole weights gathered
GATHER_METHODS = ("forward", "encode", "decode", "precompute_cross_kv", "quantize_int8",
                  "pack_fused_conv_weights")


def init_distributed(device=None, *, backend: str | None = None,
                     init_method: str = "env://", rank: int | None = None,
                     world_size: int | None = None) -> torch.device:
    """Join the process group that torchrun describes (RANK, WORLD_SIZE,
    LOCAL_RANK; `rank` and `world_size` override them) and return this
    rank's device. CUDA, the default, takes NCCL and cuda:LOCAL_RANK, and
    raises without CUDA; the CPU takes gloo. `backend` names another (gloo
    over CUDA tensors); `init_method` may be a file:// rendezvous. A group
    already initialised is kept."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if (rank is None or world_size is None) and not {"RANK", "WORLD_SIZE"} <= set(os.environ):
            raise RuntimeError("no process group to join: RANK and WORLD_SIZE are unset "
                               "(launch the ranks with torchrun)")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, **kw)
    return device


def make_mesh(n_devices: int | None = None, fsdp: int = 1, device_type: str | None = None):
    """2D (dp, fsdp) DeviceMesh over the first n_devices ranks of the
    initialised group (all of them by default); fsdp=1 -> pure data
    parallel. device_type: 'cuda' under NCCL, else 'cpu', unless named."""
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: launch with torchrun "
                           "and call init_distributed() first")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if world < n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {world} ranks are in the process "
            f"group ({dist.get_backend()}); launch with torchrun --nproc_per_node "
            f"{n_devices}, or ask for a smaller mesh")
    assert n_devices % fsdp == 0, (n_devices, fsdp)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_devices).reshape(n_devices // fsdp, fsdp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("dp", "fsdp"))


def param_spec(name: str, tensor: torch.Tensor, fsdp_min_size: int = 2 ** 18) -> int | None:
    """FSDP rule: the largest axis of a big leaf (ndim >= 2, size >=
    fsdp_min_size) is sharded over 'fsdp'; small leaves (norm scales,
    biases) stay whole (None)."""
    if tensor.ndim < 2 or tensor.numel() < fsdp_min_size:
        return None
    return int(np.argmax(tensor.shape))


# -- whole and sharded parameters ------------------------------------------------------


@torch.no_grad()
def replicate(module, mesh):
    """Every rank of the mesh holds the weights (and buffers) of its first
    rank, broadcast over the process group; `module` may be a bare tensor."""
    src = int(mesh.mesh.flatten()[0])
    tensors = ([module] if isinstance(module, torch.Tensor)
               else list(module.parameters()) + list(module.buffers()))
    for t in tensors:
        if is_sharded(t):
            continue
        buf = t.detach().contiguous()
        dist.broadcast(buf, src)
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf)
    return module


@dataclasses.dataclass(frozen=True)
class _Shard:
    owner: nn.Module      # the module whose _parameters hold the leaf
    leaf: str
    dim: int              # the sharded axis of the whole leaf
    shape: tuple          # the whole leaf's shape and strides
    stride: tuple
    group: object         # the fsdp process group
    size: int
    rank: int


def is_sharded(t) -> bool:
    return getattr(t, "_mesh_shard", None) is not None


def local_rows(full: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a tensor shaped like the whole leaf p (p itself
    when it is not sharded)."""
    if not is_sharded(p):
        return full
    s = p._mesh_shard
    return full.movedim(s.dim, 0).chunk(s.size)[s.rank].contiguous()


def unshard(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a tensor t shaped like p's shard (an optimizer
    slot, an EMA shadow, p itself), all-gathered over fsdp into the leaf's
    original shape and strides; t when p is not sharded."""
    if not is_sharded(p):
        return t
    s = p._mesh_shard
    buf = t.new_empty((s.shape[s.dim],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(buf, t.detach().contiguous(), group=s.group)
    full = torch.empty_strided(s.shape, s.stride, dtype=t.dtype, device=t.device)
    return full.copy_(buf.movedim(0, s.dim))


@torch.no_grad()
def shard_params(module: nn.Module, mesh, fsdp_min_size: int = 2 ** 18) -> nn.Module:
    """Place a module's weights on the mesh under the FSDP rule: replicated,
    then each leaf that `param_spec` shards, whose axis the fsdp size
    divides (else it stays whole, as JAX falls back to replication) and
    that is not one of the module's `whole_leaves`, cut to this rank's
    rows; the GATHER_METHODS gather them for their call. A module sharded
    before is left as it is."""
    if getattr(module, "_mesh_shards", None) is not None:
        return module
    replicate(module, mesh)
    f = mesh["fsdp"].size()
    shards = {}
    if f > 1:
        group, r = mesh.get_group("fsdp"), mesh.get_local_rank("fsdp")
        keep = set(getattr(module, "whole_leaves", ()))
        for name, p in module.named_parameters():
            d = param_spec(name, p, fsdp_min_size)
            if d is None or name in keep or p.shape[d] % f:
                continue
            head, _, leaf = name.rpartition(".")
            p._mesh_shard = _Shard(module.get_submodule(head), leaf, d, tuple(p.shape),
                                   tuple(p.stride()), group, f, r)
            p.data = p.detach().movedim(d, 0).chunk(f)[r].contiguous()
            shards[name] = p
    module._mesh_shards = shards
    for meth in GATHER_METHODS:
        if shards and hasattr(type(module), meth):
            setattr(module, meth, _gathering(module, getattr(module, meth)))
    return module


def recompute_context(module):
    """torch.utils.checkpoint's context_fn for a part of a model: its
    recompute in the backward runs with the part's sharded leaves whole."""
    return contextlib.nullcontext(), gathered(module)


def _gathering(module, fn):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        with gathered(module):
            return fn(*args, **kwargs)
    return call


def _grad_to_shard(p, full):
    g = local_rows(full.grad, p)
    p.grad = g if p.grad is None else p.grad + g
    full.grad = None


@contextlib.contextmanager
def gathered(*modules, writeback: bool = False):
    """The sharded leaves of the modules (whole models or parts of one, a
    UNet block that the backward recomputes) swapped for their whole
    tensors while the context lasts (a leaf already gathered by an
    enclosing context is left to it). A trainable leaf's gradient goes back
    to its shard's rows; with `writeback` the shards take the whole
    tensors' rows on exit (a load into the gathered module)."""
    swaps = []
    try:
        for m in modules:
            for p in [p for p in m.parameters() if is_sharded(p)]:
                s = p._mesh_shard
                with torch.no_grad():
                    full = nn.Parameter(unshard(p, p), requires_grad=p.requires_grad)
                if p.requires_grad:
                    full.register_post_accumulate_grad_hook(functools.partial(_grad_to_shard, p))
                s.owner._parameters[s.leaf] = full
                swaps.append((p, full))
        yield
    finally:
        for p, full in swaps:
            s = p._mesh_shard
            if writeback:
                with torch.no_grad():
                    p.copy_(local_rows(full.detach(), p))
            s.owner._parameters[s.leaf] = p


def param_sum(mesh):
    """A sum over parameters, (params, one value each) -> the total, that
    sums the sharded leaves' values over fsdp (each rank's is its shard's)
    and counts the whole ones once: the optimizer's and the clip's sums."""
    group = mesh.get_group("fsdp")

    def total(params, values):
        if not any(is_sharded(p) for p in params):
            return sum(values)
        sharded = sum(v for p, v in zip(params, values) if is_sharded(p)).clone()
        dist.all_reduce(sharded, group=group)
        return sharded + sum(v for p, v in zip(params, values) if not is_sharded(p))
    return total


# -- the rows of a batch ----------------------------------------------------------------


def splits_rows(b: int, mesh) -> bool:
    """Whether a batch of b rows is split over the mesh's dp (b > 1 and
    divisible by dp > 1)."""
    dp = 1 if mesh is None else mesh["dp"].size()
    return dp > 1 and b > 1 and b % dp == 0


def take_rows(x, mesh, axis: int = 0):
    """This rank's contiguous block of x's rows along `axis` over dp, as
    P('dp') places them; x when mesh is None."""
    if mesh is None:
        return x
    dp, r = mesh["dp"].size(), mesh.get_local_rank("dp")
    n = x.shape[axis] // dp
    return x[(slice(None),) * axis + (slice(r * n, (r + 1) * n),)]


def shard_batch(batch: dict, mesh) -> dict:
    """The batch this rank computes: every key with a leading batch axis
    divisible by dp (and longer than 1) cut to this rank's rows; the
    WHOLE_KEYS, scalars and the rest kept whole."""
    dp = mesh["dp"].size()
    out = {}
    for k, v in batch.items():
        if (k not in WHOLE_KEYS and getattr(v, "ndim", 0) >= 1 and v.shape[0] > 1
                and v.shape[0] % dp == 0):
            out[k] = take_rows(v, mesh)
        else:
            out[k] = v
    return out


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch of a tensor split over dp, on every rank."""
    group = mesh.get_group("dp")
    out = x.new_empty((x.shape[0] * mesh["dp"].size(),) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


# the mesh whose dp splits the batch of the step that runs (None: whole), set
# for the step's loss by split_rows, as autocast scopes a dtype: the losses it
# reaches lie several calls below the step
_ROWS = contextvars.ContextVar("split_rows", default=None)


@contextlib.contextmanager
def split_rows(mesh):
    """The batch of the step run inside is split over mesh's dp (mesh None:
    it is whole): the global_* reductions below reduce over dp."""
    token = _ROWS.set(mesh)
    try:
        yield
    finally:
        _ROWS.reset(token)


def _dp() -> int:
    rows = _ROWS.get()
    return 1 if rows is None else rows["dp"].size()


def _dp_group():
    return _ROWS.get().get_group("dp")


def global_rows(b: int) -> int:
    """The global batch of b local rows."""
    return b * _dp()


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x (a count or a denominator, without gradient) summed over the ranks
    that hold the batch's other rows; x itself on a whole batch."""
    if _ROWS.get() is None:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=_dp_group())
    return x


def global_all(flag: torch.Tensor) -> torch.Tensor:
    """A 0/1 float flag that holds on every rank's rows."""
    if _ROWS.get() is None:
        return flag
    flag = flag.detach().clone()
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=_dp_group())
    return flag


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over the global batch, without gradient."""
    if _ROWS.get() is None:
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * _dp())


def share_of_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of x over the global batch: the local
    sum over the global count (the mean itself on a whole batch). The
    shares summed over dp give the mean, their gradients its gradient."""
    if _ROWS.get() is None:
        return x.mean()
    return x.sum() / (x.numel() * _dp())


def sync_grads(params, mesh):
    """Sum the parameters' gradients (shares of a split batch's loss) over dp."""
    group = mesh.get_group("dp")
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad, group=group)


def sum_over_rows(metrics: dict, mesh) -> dict:
    """{name: scalar share} summed over dp, in one all-reduce."""
    if mesh is None or not metrics:
        return metrics
    names = list(metrics)
    v = torch.stack([metrics[n].float().reshape(()) for n in names])
    dist.all_reduce(v, group=mesh.get_group("dp"))
    return dict(zip(names, v.unbind()))
