"""Rank programs of the port's multi-rank tests (tests/test_torch_parallel_mesh.py,
test_torch_distributed_trainer.py, test_torch_distributed_pipeline.py).

`spawn` runs a rank program in `world` processes (torch.multiprocessing),
each on gloo with one intra-op thread, meeting through a file:// rendezvous
in the test's tmp directory (no TCP port shared between test workers). A
program imports no JAX: it builds the port's models from the state dicts
the test saved, and writes what it computed to an .npz (or a pickle) that
the test reads back and holds against JAX and the port's single-rank run.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from adaprompt_tpu_torch.models import clip_text as tclip, unet as tunet, vae as tvae
from adaprompt_tpu_torch.parallel import mesh as mesh_mod


def spawn(fn, world: int, tmp, *args):
    """fn(rank, world, tmp, *args) in `world` gloo ranks; raises if any rank fails."""
    torch.multiprocessing.spawn(_entry, args=(fn, world, str(tmp), args), nprocs=world,
                                join=True)


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    mesh_mod.init_distributed("cpu", init_method=f"file://{tmp}/rendezvous-{fn.__name__}",
                              rank=rank, world_size=world)
    try:
        fn(rank, world, tmp, *args)
    finally:
        dist.destroy_process_group()


def dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def tensors(tree):
    """numpy leaves (dicts, tuples) as torch tensors; ints stay integer."""
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) or isinstance(tree, np.generic):
        return torch.from_numpy(np.array(tree))
    return tree


def params_np(module) -> dict:
    """A module's parameters, whole (gathered over a mesh), as numpy by name."""
    with mesh_mod.gathered(module):
        return {n: p.detach().numpy().copy() for n, p in module.named_parameters()}


# -- make_mesh, the FSDP rule, shard_batch ------------------------------------------------


def mesh_rank(rank, world, tmp, spec):
    """make_mesh's shapes and errors; shard_params' placements (and that a
    sharded model computes what the whole one does); shard_batch's rows."""
    out = {"shapes": {}, "errors": {}, "placements": {}, "same_output": {}, "same_grad": {},
           "rows": {}}
    for key, kw in spec["meshes"].items():
        try:
            m = mesh_mod.make_mesh(**kw)
            out["shapes"][key] = dict(zip(m.mesh_dim_names, m.shape))
        except (ValueError, AssertionError) as e:
            out["errors"][key] = type(e).__name__
    states = torch.load(spec["states"])
    for fsdp in spec["fsdp_sizes"]:
        mesh = mesh_mod.make_mesh(fsdp=fsdp)
        for name, (cls, cfg) in spec["models"].items():
            model = cls(cfg)
            model.load_state_dict(states[name])
            run = spec["run"].get(name)
            ref = run(model) if run else None
            mesh_mod.shard_params(model, mesh, fsdp_min_size=spec["fsdp_min_size"])
            out["placements"][(fsdp, name)] = {
                n: p._mesh_shard.dim for n, p in model.named_parameters()
                if mesh_mod.is_sharded(p)}
            if run:
                out["same_output"][(fsdp, name)] = bool(torch.equal(ref, run(model)))
            if name == "unet":
                # the backward recomputes each block (use_checkpoint) from its sharded weights
                model = cls(cfg)
                model.load_state_dict(states[name])
                if "unet_grad" not in out:
                    out["unet_grad"] = unet_context_grad(model)
                mesh_mod.shard_params(model, mesh, fsdp_min_size=spec["fsdp_min_size"])
                out["same_grad"][fsdp] = bool(torch.equal(out["unet_grad"],
                                                          unet_context_grad(model)))
        rows = mesh_mod.shard_batch({k: torch.as_tensor(v) for k, v in spec["batch"].items()},
                                    mesh)
        out["rows"][fsdp] = {k: v.numpy() for k, v in rows.items()}
    out["coords"] = {fsdp: None for fsdp in spec["fsdp_sizes"]}
    for fsdp in spec["fsdp_sizes"]:
        mesh = mesh_mod.make_mesh(fsdp=fsdp)
        out["coords"][fsdp] = (mesh.get_local_rank("dp"), mesh.get_local_rank("fsdp"))
    dump(os.path.join(tmp, f"mesh-{rank}.pkl"), out)


def run_clip(model):
    ids = torch.arange(77)[None].expand(2, -1) % 500
    with torch.no_grad():
        return model.encode(ids, hidden_state_layer_weights=torch.tensor([0.5, 0.5]))


def run_unet(model):
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 4, generator=g)
    ctx = torch.randn(1, 2, 77, model.cfg.context_dim, generator=g)
    with torch.no_grad():
        return model(x, torch.tensor([10, 700]), ctx)


def unet_context_grad(model):
    """d(loss)/d(context) of a UNet pass under block recompute."""
    assert model.cfg.use_checkpoint
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 8, 8, 4, generator=g)
    ctx = torch.randn(1, 2, 77, model.cfg.context_dim, generator=g).requires_grad_()
    model(x, torch.tensor([10, 700]), ctx).square().mean().backward()
    return ctx.grad


# -- the trainer --------------------------------------------------------------------------


def build_trainer(spec, out_dir):
    """The port's Stage-2 trainer over the test's models (float32, CPU)."""
    from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
    from adaprompt_tpu_torch.train import steps as tsteps, trainer as ttrainer
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
    st = torch.load(spec["states"])
    unet_cfg, text_cfg, vae_cfg, scfg = spec["cfgs"]
    build = lambda m, k: (m.load_state_dict(st[k]), m.eval())[1]
    frozen = tsteps.FrozenSD(build(tunet.UNet(unet_cfg), "unet"),
                             build(tclip.CLIPTextModel(text_cfg), "text"),
                             build(tclip.CLIPTextModel(text_cfg), "arc2face_text"),
                             build(tunet.UNet(unet_cfg), "teacher_unet"))
    vae = build(tvae.VAE(vae_cfg), "vae")
    sbg = build(tsbg.SubjBasisGenerator(scfg), "sbg").train()
    tok = CLIPTokenizer.from_files(os.path.join(spec["vocab"], "vocab.json"),
                                   os.path.join(spec["vocab"], "merges.txt"))
    cfg = ttrainer.TrainerConfig.stage2(out_dir=out_dir, **spec["trainer_cfg"])
    return ttrainer.AdaPromptTrainer(frozen, vae, tok, scfg, sbg,
                                     ttrainer.synthetic_raw_batches(0, batch_size=4, size=32),
                                     cfg, synthetic_faces=True)


def run_trainer(spec, out_dir, fsdp=None) -> dict:
    """The test's sequence of steps on the port's trainer, over a (dp, fsdp)
    mesh of every rank when `fsdp` is given, else undistributed: a recon
    step (fg/bg regularizers, ragged masks), an ND=3 distillation step on
    the HALF_BS rows, a compositional iteration (each with the given JAX
    draws), a full-state save, its load and one more recon step, and two
    train_step calls with the trainer's own draws. -> each step's metrics
    and the generator (whole) after it."""
    tr = build_trainer(spec, out_dir)
    out = {}
    if fsdp is not None:
        mesh = tr.distribute(mesh_mod.make_mesh(fsdp=fsdp))
        out["sharded"] = sorted(n for n, p in tr.state.params["subj_basis"].named_parameters()
                                if mesh_mod.is_sharded(p))
        out["coords"] = (mesh.get_local_rank("dp"), mesh.get_local_rank("fsdp"))

    def record(tag, metrics):
        out[tag] = {k: (v.detach().float().numpy().copy() if isinstance(v, torch.Tensor)
                        else v) for k, v in metrics.items()}
        out[tag + "/params"] = params_np(tr.state.params["subj_basis"])
        out[tag + "/emb_scales"] = tr.state.params["emb_scales"].detach().numpy().copy()

    def step(tag, fn, batch, draws):
        local, rows = tr._split(batch)
        out[tag + "/rows"] = int(local["z0"].shape[0])
        tr.state, m = fn(tr.state, tr._fp, local, None, draws=draws, **rows)
        record(tag, m)

    out["init/params"] = params_np(tr.state.params["subj_basis"])
    out["init/emb_scales"] = tr.state.params["emb_scales"].detach().numpy().copy()
    recon = tr._get_recon_step(False, True)
    step("recon", recon, tensors(spec["recon_batch"]), tensors(spec["recon_draws"]))
    # HALF_BS of the distillation batch: over a mesh the trainer's own,
    # rounded up to dp; undistributed, the same rows
    dbatch = tensors(spec["distill_batch"])
    if fsdp is not None:
        dbatch = tr._half_batch(dbatch, 3)
    else:
        dbatch = {k: v[:spec["distill_rows"]] if k not in ("skip_weights",) else v
                  for k, v in dbatch.items()}
    out["distill_bs"] = int(dbatch["z0"].shape[0])
    step("distill", tr._distill_step(3), dbatch, tensors(spec["distill_draws"]))
    tr._ensure_compos()
    tr.state, m, x_recon = tr._compos_phase(tr.state, tr._mp_compos(),
                                            tensors(spec["compos_batch"]), None,
                                            draws=tensors(spec["compos_draws"]))
    m.pop("q_bn_stats")
    record("compos", dict(m, x_recon=x_recon))
    out["state_file"] = tr.save_full_state(3)
    tr.load_full_state(out["state_file"])
    step("resumed", recon, tensors(spec["recon_batch2"]), tensors(spec["recon_draws2"]))
    for i in (1, 2):
        m = tr.train_step(i)
        record(f"train_step{i}", {k: v for k, v in m.items() if isinstance(v, torch.Tensor)})
        out[f"train_step{i}/iter_type"] = m["iter_type"]
    out["ema"] = {n: v.numpy() for n, v in tr._whole_ema().items()}
    tr._metrics_file.close()
    return out


def trainer_rank(rank, world, tmp, spec):
    out = run_trainer(spec, os.path.join(tmp, "run"), fsdp=spec["fsdp"])
    dist.barrier()
    out["written"] = sorted(os.listdir(os.path.join(tmp, "run")))
    with open(os.path.join(tmp, "run", "metrics.jsonl")) as f:
        out["metrics_lines"] = len(f.readlines())
    dump(os.path.join(tmp, f"trainer-{rank}.pkl"), out)


# -- the pipeline -------------------------------------------------------------------------


def pipeline_rank(rank, world, tmp, spec):
    from adaprompt_tpu_torch.pipeline import FastConfig, StableDiffusionPipeline
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
    st = torch.load(spec["states"])
    unet_cfg, vae_cfg, text_cfg = spec["cfgs"]
    build = lambda m, k: (m.load_state_dict(st[k]), m.eval())[1]
    pipe = StableDiffusionPipeline(build(tunet.UNet(unet_cfg), "unet"),
                                   build(tvae.VAE(vae_cfg), "vae"),
                                   build(tclip.CLIPTextModel(text_cfg), "text"),
                                   CLIPTokenizer.fallback())
    pipe.distribute()
    out = {"images": pipe.generate(spec["prompts"], **spec["kw"])}
    out["fast"] = pipe.generate(spec["prompts"], **dict(spec["kw"], num_steps=4, seed=6),
                                fast=FastConfig(tome_ratio=0.0, tome_mlp=False, cache_interval=2,
                                                cache_depth=2, cfg_tail_frac=0.5))
    out["dpmpp"] = pipe.generate(spec["prompts"], **dict(spec["kw"], num_steps=3),
                                 sampler="dpmpp")
    try:
        pipe.generate(spec["prompts"][:3], **dict(spec["kw"], num_steps=1))
    except ValueError as e:
        out["error"] = str(e)
    dump(os.path.join(tmp, f"pipeline-{rank}.pkl"), out)


# -- the train CLI ------------------------------------------------------------------------


def run_train_cli(spec, argv, usr1_step=None):
    """cli.train.main(argv) over the test's tiny pipeline (its
    load_pipeline replaced) on the CPU; with `usr1_step`, this process sends
    itself SIGUSR1 as that step starts (the CLI holds it to the step's end)."""
    import signal
    from adaprompt_tpu_torch.cli import common, train
    from adaprompt_tpu_torch.pipeline import StableDiffusionPipeline
    from adaprompt_tpu_torch.train.trainer import AdaPromptTrainer
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
    st = torch.load(spec["states"])
    unet_cfg, text_cfg, vae_cfg = spec["cfgs"]
    build = lambda m, k: (m.load_state_dict(st[k]), m.eval())[1]
    tok = CLIPTokenizer.from_files(os.path.join(spec["vocab"], "vocab.json"),
                                   os.path.join(spec["vocab"], "merges.txt"))
    load, step = common.load_pipeline, AdaPromptTrainer.train_step

    def signalled(self, i):
        if i == usr1_step:
            os.kill(os.getpid(), signal.SIGUSR1)
        return step(self, i)
    common.load_pipeline = lambda args: StableDiffusionPipeline(
        build(tunet.UNet(unet_cfg), "unet"), build(tvae.VAE(vae_cfg), "vae"),
        build(tclip.CLIPTextModel(text_cfg), "text"), tok)
    AdaPromptTrainer.train_step = signalled
    try:
        tr = train.main(argv)
    finally:
        common.load_pipeline, AdaPromptTrainer.train_step = load, step
    tr._metrics_file.close()
    return tr


def cli_rank(rank, world, tmp, spec):
    """A rank of the train CLI as torchrun starts it (RANK, WORLD_SIZE and
    LOCAL_RANK set; the group already joined through the file rendezvous,
    which the CLI keeps); only `usr1_rank` gets the signal."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    tr = run_train_cli(spec, spec["argv"],
                       spec["usr1_step"] if rank == spec["usr1_rank"] else None)
    dist.barrier()
    dump(os.path.join(tmp, f"cli-{rank}.pkl"),
         {"mesh": dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)),
          "sharded": sum(mesh_mod.is_sharded(p) for p in tr.frozen.unet.parameters())
          + sum(mesh_mod.is_sharded(p) for p in tr.state.params["subj_basis"].parameters()),
          "files": sorted(os.listdir(spec["out"]))})
