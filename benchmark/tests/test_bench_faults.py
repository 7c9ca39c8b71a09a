"""A run with the timed path broken underneath comes out not correct: the
tiny configurations in float32 on the CPU (where a sound run reads near 0),
once for each fault a cell can have. One chip, so no exchange between
chips to leave out."""

import numpy as np
import pytest
import torch

from benchmark.tests.tiny import run_tiny, run_tiny_stage1


def _state_unchanged(monkeypatch):
    """The sampler's first DDIM step returns its state unchanged."""
    from adaprompt_tpu_torch.sampling import ddim
    from adaprompt_tpu_torch.sampling.schedule import SD15_SCHEDULE, make_ddim_params

    def faulty(model_fn, x_T, *, num_steps=50, guidance_scale=(4.0, 1.0), sched=SD15_SCHEDULE, **_):
        ts, a, ap, _ = make_ddim_params(sched, num_steps)
        order = np.arange(len(ts))[::-1]
        g = ddim.guidance_schedule(len(ts), guidance_scale)
        x = x_T
        for i, t in enumerate(ts[order]):
            tb = torch.full((x.shape[0],), int(t), dtype=torch.int64)
            e_c, e_u = model_fn(torch.cat([x, x]), torch.cat([tb, tb])).chunk(2)
            if i == 0:
                continue
            e = e_u + float(g[i]) * (e_c - e_u)
            a_t, a_p = float(a[order][i]), float(ap[order][i])
            x = a_p ** 0.5 * (x - (1 - a_t) ** 0.5 * e) / a_t ** 0.5 + (1 - a_p) ** 0.5 * e
        return x
    monkeypatch.setattr(ddim, "ddim_sample", faulty)


def _half_batch(monkeypatch):
    """The UNet leaves out half of each (cond, uncond) half of its batch and
    gives those rows the mean of the rest."""
    from adaprompt_tpu_torch.models.unet import UNet
    orig = UNet.forward

    def faulty(self, x, *a, **kw):
        out = orig(self, x, *a, **kw).clone()
        n = out.shape[0] // 2
        for lo in (0, n):
            keep = out[lo:lo + n // 2]
            out[lo + n // 2:lo + n] = keep.mean(dim=0, keepdim=True)
        return out
    monkeypatch.setattr(UNet, "forward", faulty)


def _image_altered(monkeypatch):
    """One image is altered where the decode makes it."""
    from adaprompt_tpu_torch import pipeline
    orig = pipeline._to_uint8

    def faulty(img):
        out = orig(img).clone()
        out[0] = 255 - out[0]
        return out
    monkeypatch.setattr(pipeline, "_to_uint8", faulty)


def _subject_altered(monkeypatch):
    """The subject vectors are altered where the generator makes them."""
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    orig = AdaFacePipeline._id_to_subj

    def faulty(self, faceid, scale):
        return -orig(self, faceid, scale)
    monkeypatch.setattr(AdaFacePipeline, "_id_to_subj", faulty)


def test_sound_run_is_correct():
    result, _ = run_tiny()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _image_altered, _subject_altered])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, text = run_tiny()
    assert not result["correct"], text


def _optimizer_unchanged(monkeypatch):
    """The optimizer's step leaves the parameters as they were."""
    from adaprompt_tpu_torch.train.prodigy import GradientPipeline

    def faulty(self):
        self.zero_grad()
        return False
    monkeypatch.setattr(GradientPipeline, "step", faulty)


def _optimizer_unchanged_after_setup(monkeypatch):
    """From the second update on (the window's), the optimizer's step leaves
    the parameters as they were: a path that only the window's steps take."""
    from adaprompt_tpu_torch.train.prodigy import GradientPipeline
    orig = GradientPipeline.step

    def faulty(self):
        if self.mini_step == self.every_k - 1 and self.inner.count >= 1:
            self.zero_grad()
            self.mini_step = 0
            for acc in self.acc:
                acc.zero_()
            return False
        return orig(self)
    monkeypatch.setattr(GradientPipeline, "step", faulty)


def _half_training_batch(monkeypatch):
    """The distillation loss leaves out half of the batch's rows and takes
    the mean over the rest."""
    from adaprompt_tpu_torch.train import steps
    orig = steps.DistillStep.loss

    def faulty(self, sbg, fp, batch, draws):
        h = max(batch["z0"].shape[0] // 2, 1)
        cut = {k: v[:h] if isinstance(v, torch.Tensor) and v.ndim and v.shape[0] == batch["z0"].shape[0]
               else v for k, v in batch.items()}
        d = {"t": draws["t"][:h], "noise": draws["noise"][:h], "rels": draws["rels"][:, :h],
             "next_noises": draws["next_noises"][:, :h]}
        return orig(self, sbg, fp, cut, d)
    monkeypatch.setattr(steps.DistillStep, "loss", faulty)


def _prompt_altered(monkeypatch):
    """The generator's prompt embeddings are altered where it makes them."""
    from adaprompt_tpu_torch.adaface.subj_basis_generator import SubjBasisGenerator
    orig = SubjBasisGenerator.forward

    def faulty(self, *a, **kw):
        subj, prompt = orig(self, *a, **kw)
        return subj, None if prompt is None else prompt.flip(1)
    monkeypatch.setattr(SubjBasisGenerator, "forward", faulty)


def test_sound_training_run_is_correct():
    result, _ = run_tiny_stage1()
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("fault", [_optimizer_unchanged, _optimizer_unchanged_after_setup, _half_training_batch,
                                   _prompt_altered])
def test_training_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, text = run_tiny_stage1()
    assert not result["correct"], text
