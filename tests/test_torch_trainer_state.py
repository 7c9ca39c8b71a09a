"""The rest of the port's trainer state against the JAX package (CPU): the
EMA of the trainable parameters, the AdamW path's two learning-rate
schedules and its optimizer chain (clip -> AdamW behind MultiSteps) against
optax; then the full-state resume, port against port: a Stage-2 run with
compositional iterations (one fresh, one reusing its cached x_recon),
recon and distillation steps and grad_accum=2, saved after 4 steps and
resumed in a fresh trainer, takes the same 4 steps as the uninterrupted
run, bit for bit, in fp32 with Prodigy and in bf16 with AdamW and the
EMA."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adaprompt_tpu.adaface import checkpoint as jckpt
from adaprompt_tpu.train import ema as jema, lr_schedules as jsched, trainer as jtrainer
from adaprompt_tpu_torch.adaface import subj_basis_generator as tsbg
from adaprompt_tpu_torch.models import vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.train import ema as tema, lr_schedules as tsched, trainer as ttrainer
from adaprompt_tpu_torch.train import steps as tsteps
from torch_port_helpers import named, port_module, train_env

VAE_CFG = dict(ch=32, ch_mult=(1, 2, 4), num_res_blocks=1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: under the suite's parallel
    workers on a few cores, torch's default pool oversubscribes the CPU and
    these small-tensor steps slow down some fiftyfold (six copies of the
    resume tests: 2250 s with 8 threads each, 54 s with 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _module_and_tensor(seed):
    """A small {name: module or tensor} dict of trainable parameters."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng():          # the layers' own init, seeded too: no test order
        torch.manual_seed(seed)            # or earlier draw changes these parameters
        lin = torch.nn.Sequential(torch.nn.Linear(5, 3), torch.nn.LayerNorm(3))
    reset_parameters(lin, gen)
    with torch.no_grad():
        for p in lin.parameters():
            p.add_(torch.randn(p.shape, generator=gen))
    return {"net": lin, "emb_scales": torch.nn.Parameter(torch.randn(2, generator=gen))}


def _jax_tree(params):
    """The JAX tree of copies of the same values: {name: {parameter name:
    array}} (a copy: JAX may alias a numpy buffer that torch updates)."""
    arr = lambda p: jnp.asarray(p.detach().numpy().copy())
    return {name: ({n: arr(p) for n, p in v.named_parameters()}
                   if isinstance(v, torch.nn.Module) else arr(v))
            for name, v in params.items()}


@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_matches_jax(use_num_updates):
    """Five updates of LitEma's rule on changing parameters: the count
    incremented before the decay min(decay, (1+n)/(10+n)), or the fixed
    decay with the count at -1."""
    params = _module_and_tensor(0)
    state_t = tema.ema_init(params, use_num_updates)
    state_j = jema.ema_init(_jax_tree(params), use_num_updates)
    gen = torch.Generator().manual_seed(1)
    for _ in range(5):
        with torch.no_grad():
            for _, p in tsteps.named_trainable(params):
                p.add_(torch.randn(p.shape, generator=gen))
        tema.ema_update(state_t, params, decay=0.99)
        state_j = jema.ema_update(state_j, _jax_tree(params), decay=0.99)
    assert state_t.num_updates == int(state_j.num_updates) == (5 if use_num_updates else -1)
    shadow_j = {f"net.{n}": a for n, a in state_j.shadow["net"].items()}
    shadow_j["emb_scales"] = state_j.shadow["emb_scales"]
    assert set(state_t.shadow) == set(shadow_j)
    for n, s in tema.ema_copy_to(state_t).items():
        assert s.dtype == torch.float32
        np.testing.assert_allclose(s.numpy(), np.asarray(shadow_j[n]), rtol=0, atol=1e-7,
                                   err_msg=n)
        # the shadow lags the parameters it follows
        p = dict(tsteps.named_trainable(params))[n].detach().numpy()
        assert not np.array_equal(s.numpy(), p)


SCHED_ARGS = (500, 0.01, 1.0, 0.1, 1200)        # warm-up, lr_start, lr_max, lr_min, decay end


@pytest.mark.parametrize("name", ["lambda_warmup_cosine_schedule", "lambda_linear_schedule"])
def test_lr_schedules_match_jax(name):
    """At 0, mid-warm-up, the boundary, mid-decay and past max_decay_steps,
    equal in float32; over every step to 1300, the linear one equal and the
    cosine one within an ulp of the cosine (times the half-amplitude 0.45)
    and an ulp of the result: the port rounds the float64 cosine, where
    XLA's float32 cosine is off by an ulp at some arguments."""
    sched_j, sched_t = getattr(jsched, name)(*SCHED_ARGS), getattr(tsched, name)(*SCHED_ARGS)
    for step in (0, 250, 500, 850, 1200, 1300, 5000):
        got, want = sched_t(step), np.asarray(sched_j(step))
        assert got.dtype == np.float32 and got == want, (step, got, want)
    steps = np.arange(1300)
    got = np.asarray([sched_t(s) for s in steps], np.float32)
    want = np.asarray([np.asarray(sched_j(s)) for s in steps], np.float32)
    cos_ulp = 0.5 * (SCHED_ARGS[2] - SCHED_ARGS[3]) * np.spacing(np.float32(1.0))
    bound = cos_ulp + np.spacing(want) if "cosine" in name else 0.0
    err = np.abs(got - want)
    assert np.all(err <= bound), (steps[err.argmax()], err.max())
    assert got[0] == np.float32(0.01) and got[500] == np.float32(1.0)
    assert abs(got[-1] - 0.1) < 1e-7


def test_adamw_pipeline_matches_optax():
    """MultiSteps(2) over clip_by_global_norm(0.5) -> adamw(base_lr x the
    warm-up + cosine schedule, b2 0.993, weight decay 1e-4), as the JAX
    trainer builds it, over six steps of random gradients from numpy on a
    small tree (a module and a bare tensor); the clip bites on every
    update, and the parameters move only on every second call."""
    cfg = dict(optimizer_type="AdamW", grad_accum=2, grad_clip=0.5, base_lr=1.0, max_steps=900)
    params = _module_and_tensor(2)
    pipe = ttrainer.build_optimizer(ttrainer.TrainerConfig(**cfg),
                                    tsteps.trainable_parameters(params))
    tx = jtrainer.build_optimizer(jtrainer.TrainerConfig(**cfg))
    jp = _jax_tree(params)
    jstate = tx.init(jp)
    rng = np.random.default_rng(3)
    p0 = {n: p.detach().clone() for n, p in tsteps.named_trainable(params)}
    for i in range(6):
        grads = {n: (3.0 * rng.standard_normal(p.shape)).astype(np.float32)
                 for n, p in tsteps.named_trainable(params)}
        for n, p in tsteps.named_trainable(params):
            p.grad = torch.from_numpy(grads[n])
        moved = pipe.step()
        assert moved == (i % 2 == 1)
        jg = {"net": {n[len("net."):]: jnp.asarray(g) for n, g in grads.items() if "." in n},
              "emb_scales": jnp.asarray(grads["emb_scales"])}
        assert float(optax.global_norm(jg)) > 2 * 0.5            # the clip bites
        upd, jstate = tx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        want = {f"net.{n}": a for n, a in jp["net"].items()}
        want["emb_scales"] = jp["emb_scales"]
        for n, p in tsteps.named_trainable(params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]), rtol=1e-6,
                                       atol=0, err_msg=f"step {i} {n}")
    assert pipe.inner.count == 3
    assert min(float((p.detach() - p0[n]).abs().max())
               for n, p in tsteps.named_trainable(params)) > 1e-3


def test_build_optimizer_refuses_other_names():
    with pytest.raises(ValueError, match="SGD") as port:
        ttrainer.build_optimizer(ttrainer.TrainerConfig(optimizer_type="SGD"), [])
    with pytest.raises(ValueError) as ref:
        jtrainer.build_optimizer(jtrainer.TrainerConfig(optimizer_type="SGD"))
    assert str(port.value) == str(ref.value)


# -- full-state resume ----------------------------------------------------------------

STEPS, SAVE_AT = 8, 4              # compositional at 3 (fresh) and 6 (reuse)
RESUME_CFG = dict(max_steps=20, grad_accum=2, warm_up_steps=2, ckpt_every=100,
                  metrics_flush_every=1, composition_regs_iter_gap=3, no_teacher_filter=True,
                  arc2face_distill_iter_prob=0.5, max_num_denoising_steps=3)
CASES = {"fp32-prodigy": dict(compute_dtype="float32", seed=5),
         "bf16-adamw-ema": dict(compute_dtype="bfloat16", seed=5, optimizer_type="AdamW",
                                base_lr=0.05, use_ema=True, ema_decay=0.9)}
TIMING = ("step_time_s", "device_mem_gb", "device_peak_mem_gb")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    e = train_env(tmp_path_factory.mktemp("vocab"))
    e["tvae"] = reset_parameters(tvae.VAE(tvae.VAEConfig(**VAE_CFG)),
                                 torch.Generator().manual_seed(9)).eval()
    return e


def _batches(skip):
    it = ttrainer.synthetic_raw_batches(0, batch_size=2, size=32)
    for _ in range(skip):
        next(it)
    return it


def _trainer(env, out, case, skip=0):
    kw = CASES[case]
    frozen, vae = env["tfrozen"], env["tvae"]
    if kw["compute_dtype"] == "bfloat16":       # the UNets and the VAE in the compute dtype
        bf = lambda m: copy.deepcopy(m).to(torch.bfloat16)
        frozen = tsteps.FrozenSD(bf(frozen.unet), frozen.text, frozen.arc2face_text,
                                 bf(frozen.teacher_unet))
        vae = bf(vae)
    sbg = port_module(tsbg.SubjBasisGenerator(env["tscfg"]), env["jsp"]).train()
    tr = ttrainer.AdaPromptTrainer(frozen, vae, env["ttok"], env["tscfg"], sbg, _batches(skip),
                                   ttrainer.TrainerConfig.stage2(out_dir=str(out), **RESUME_CFG,
                                                                 **kw),
                                   synthetic_faces=True)
    tr._ensure_compos()
    phase, tr.compos_ts = tr._compos_phase, []

    def record(state, mp, batch, gen):
        tr.compos_ts.append(batch["t"].tolist())
        return phase(state, mp, batch, gen)

    tr._compos_phase = record
    return tr


def _rows(tr, steps):
    return [{k: v for k, v in tr.train_step(i).items() if k not in TIMING} for i in steps]


@pytest.fixture(scope="module", params=list(CASES))
def resumed(request, env, tmp_path_factory):
    case, tmp = request.param, tmp_path_factory.mktemp(request.param)
    was = torch.are_deterministic_algorithms_enabled()
    # the CPU's index_put accumulation (the token embeddings' backward) sums
    # in a thread-dependent order otherwise: two uninterrupted runs then
    # differ in the last bit of a few token_embedding entries
    torch.use_deterministic_algorithms(True)
    try:
        full = _trainer(env, tmp / "full", case)
        rows_full = _rows(full, range(STEPS))
        first = _trainer(env, tmp / "first", case)
        rows_first = _rows(first, range(SAVE_AT))
        path = first.save_full_state(SAVE_AT)
        second = _trainer(env, tmp / "second", case, skip=SAVE_AT)
        meta = second.load_full_state(path)
        rows_second = _rows(second, range(SAVE_AT, STEPS))
    finally:
        torch.use_deterministic_algorithms(was)
    return dict(case=case, full=full, first=first, second=second, meta=meta, path=path,
                rows_full=rows_full, rows_resumed=rows_first + rows_second, tmp=tmp)


def test_resume_takes_the_same_steps(resumed):
    """Every metric of every step equal bit for bit (timings aside); the
    iteration types cover recon, distillation and both compositional
    kinds, and step 6 reuses the x_recon that step 3 cached before the
    save, in both runs."""
    full, resumed_rows = resumed["rows_full"], resumed["rows_resumed"]
    assert [r["iter_type"] for r in full] == [r["iter_type"] for r in resumed_rows]
    types = [r["iter_type"] for r in full]
    assert types[3] == types[6] == "compos_distill"
    assert {"recon", "arc2face_distill"} <= set(types), types
    for a, b in zip(full, resumed_rows):
        assert a == b, (a, b)
    for tr in (resumed["full"], resumed["second"]):
        reuse_t = tr.compos_ts[-1]
        assert len(set(reuse_t)) > 1 and all(400 <= x < 700 for x in reuse_t), tr.compos_ts
    fresh_t = resumed["first"].compos_ts[0]
    assert len(set(fresh_t)) == 1 and 800 <= fresh_t[0] < 1000
    assert resumed["meta"]["cached_inits"] == [ttrainer.SUBJECT_NAME]
    assert resumed["meta"]["step"] == SAVE_AT


def test_resume_state_is_bit_exact(resumed):
    """The full state after the last step, of the uninterrupted and the
    resumed trainer: parameters, the optimizer's slots, scalars, count and
    accumulator, the frozen copy, the EMA, both random streams,
    ca_q_bn_stats and the reuse cache, every entry equal bit for bit."""
    a = np.load(resumed["full"].save_full_state(STEPS))
    b = np.load(resumed["second"].save_full_state(STEPS))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    keys = set(a.files)
    opt = ("exp_avg", "exp_avg_sq") + (("s", "p0", "d", "d_max", "d_numerator")
                                        if resumed["case"] == "fp32-prodigy" else ())
    for prefix in ("params.subj_basis/", "params.emb_scales", "optstate/acc/", "frozen_sbg/",
                   "gen_state", "ca_q_bns/") + tuple(f"optstate/{s}" for s in opt):
        assert any(k.startswith(prefix) for k in keys), prefix
    # the reuse at step 6 emptied the cache; the mid-run state held step 3's entry
    assert not any(k.startswith("cached_inits/") for k in keys)
    mid = np.load(resumed["path"])
    assert mid["cached_inits/0/x_start"].shape == (4, 8, 8, 4)       # 32x32 images
    assert mid["cached_inits/0/t"].tolist() == resumed["first"].compos_ts[0]
    assert any(k.startswith("emastate/") for k in keys) == ("ema" in resumed["case"])
    tr = resumed["second"]
    assert sorted(tr.ca_q_bn_stats) == sorted(resumed["full"].ca_q_bn_stats) != []
    for li, ent in tr.ca_q_bn_stats.items():
        for k, v in ent.items():
            w = resumed["full"].ca_q_bn_stats[li][k]
            assert v.dtype == w.dtype and torch.equal(v, w), (li, k)


def test_resume_ema_checkpoint(resumed):
    """Under use_ema the EMA followed every recon and distillation step and
    no compositional one (LitEma's count), and save_checkpoint writes its
    subject generator as ema_subj_basis in the JAX layout, which the JAX
    package reads."""
    tr = resumed["second"]
    if tr.ema is None:
        assert "ema_subj_basis" not in jckpt.load_checkpoint(tr.save_checkpoint(STEPS))[0]
        return
    types = [r["iter_type"] for r in resumed["rows_full"]]
    assert tr.ema.num_updates == sum(ty != "compos_distill" for ty in types) == 6
    trees, _ = jckpt.load_checkpoint(tr.save_checkpoint(STEPS))
    got = named(trees["ema_subj_basis"])
    for n, s in tr.ema.shadow.items():
        if n.startswith("subj_basis."):
            np.testing.assert_array_equal(got[n[len("subj_basis."):]], s.numpy(), err_msg=n)
    moved = [n for n, p in tsteps.named_trainable(tr.state.params)
             if not torch.equal(p.detach().float(), tr.ema.shadow[n])]
    assert moved, "the EMA equals the parameters"
