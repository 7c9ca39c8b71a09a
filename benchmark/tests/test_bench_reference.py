"""The plain reference against the port in float32 at a tiny size, and its
weight layouts against the port's modules at the cell's size."""

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, weights
from benchmark.reference import adaface, arcface, ddim, unet, vae
from benchmark.reference.tokenizer import Tokenizer
from benchmark.tests.tiny import TINY_CONFIG


def _builder():
    return manifest.config_builder("sd15_adaface")


@pytest.mark.parametrize("cfg_name", ["tiny", "full"])
def test_layouts_match_the_port(cfg_name):
    cfg = TINY_CONFIG if cfg_name == "tiny" else manifest.config("sd15_adaface")
    shapes = _builder().param_shapes(cfg)
    meta = {m: {k: torch.empty(s, device="meta", dtype=weights.DTYPES[cfg["dtype"][m]]) for k, s, _ in v}
            for m, v in shapes.items()}
    pipe = _builder().build_program(cfg, meta, torch.device("meta"))
    port = {"unet": pipe.pipe.unet, "vae": pipe.pipe.vae, "arc2face": pipe.arc2face_text,
            "sbg": pipe.subj_basis, "arcface": pipe.face_embedder.arcface}
    for m, module in port.items():
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == \
            {k: tuple(s) for k, s, _ in shapes[m]}, m


def test_reference_matches_the_port_in_float32():
    from adaprompt_tpu_torch.pipeline import eps_model
    cfg, dev = TINY_CONFIG, torch.device("cpu")
    b = _builder()
    w = b.make_weights(cfg, 5, dev)
    pipe = b.build_program(cfg, w, dev)
    photos = [np.random.default_rng(i).integers(0, 256, (70, 90, 3), dtype=np.uint8) for i in range(2)]
    got = pipe.generate_adaface_embeddings(images_np=photos)
    tok = Tokenizer()
    face = adaface.faceid(w["arcface"], cfg["arcface"], photos, dev)
    subj = adaface.subject_vectors(w["arc2face"], w["sbg"], cfg["text"], tok, face)
    torch.testing.assert_close(got, subj, rtol=1e-4, atol=1e-5)
    cond, uncond = pipe.encode_prompt("a photo of z smiling")
    rc, ru = adaface.contexts(w["text"], cfg["text"], tok, subj, "a photo of z smiling", b.DEFAULT_NEGATIVE_PROMPT)
    torch.testing.assert_close(cond, rc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(uncond, ru, rtol=1e-4, atol=1e-5)
    x = torch.randn(2, 8, 8, 4, generator=torch.Generator().manual_seed(0))
    ctx = torch.cat([cond, uncond])
    t = torch.tensor([981, 981])
    with torch.no_grad():
        eps = eps_model(pipe.pipe.unet, ctx[None], torch.float32, pipe.pipe.unet.cfg)(x, t)
        ref = unet.forward(w["unet"], cfg["unet"], x, t, ctx)
        torch.testing.assert_close(eps, ref, rtol=1e-3, atol=1e-4)
        img = pipe.pipe.vae.decode(x[:1])
        torch.testing.assert_close(img, vae.decode(w["vae"], cfg["vae"], x[:1]), rtol=1e-4, atol=1e-4)
        crops = torch.randn(2, 112, 112, 3)
        torch.testing.assert_close(pipe.face_embedder.arcface(crops), arcface.forward(w["arcface"], cfg["arcface"], crops),
                                   rtol=1e-4, atol=1e-4)


def test_tokenizer_matches_the_port():
    from adaprompt_tpu_torch.utils.tokenizer import CLIPTokenizer
    port = CLIPTokenizer.fallback()
    port.add_tokens([f"z_{i}" for i in range(16)])
    tok = Tokenizer()
    for text in ("photo of a id person", "photo of a " + ", " * 16, tok.rewrite("portrait of a z person"),
                 b"flaws, lowres; it's 2 x".decode()):
        for n in (22, 77):
            np.testing.assert_array_equal(port(text, max_length=n), tok(text, max_length=n))


def test_ddim_coefficients_match_the_port():
    from adaprompt_tpu_torch.sampling import ddim as port_ddim
    from adaprompt_tpu_torch.sampling.schedule import SD15_SCHEDULE, make_ddim_params
    ts, a, ap, _ = make_ddim_params(SD15_SCHEDULE, 50)
    t, c_eps, c_x0, c_prev, c_dir, g = ddim.coefficients(50, 4.0)
    np.testing.assert_array_equal(t, ts[::-1])
    np.testing.assert_allclose(c_x0, np.sqrt(a[::-1]), rtol=1e-6)
    np.testing.assert_allclose(c_prev, np.sqrt(ap[::-1]), rtol=1e-6)
    np.testing.assert_allclose(g, port_ddim.guidance_schedule(50, 4.0), rtol=1e-6)
