"""Interactive demo over `AdaFacePipeline`: a Gradio UI where gradio is
installed, else a REPL (`subject <folder>`, `gen <prompt>`, `quit`) that
saves each generation as a PNG.

Port of `adaprompt_tpu/cli/demo.py` (the role of the reference's app.py).
`main` first runs `AdaFacePipeline.warmup` (unless `--no_warmup`), which on
the card builds the CUDA kernels and lets cuDNN and cuBLAS pick their
algorithms for the serving shapes, so that the first request is served at
steady-state latency. Unlike the JAX demo, which calls the UI inside a
`try` that also catches an ImportError raised within it, the port falls
back to the REPL only when `gradio` itself cannot be imported; and each
`gen` of the REPL saves `seed<N>-00000.png` under its own seed N, where the
JAX demo writes every generation to `sample-00000.png`, over the last.
`gradio` is imported only by `run_gradio`. The ArcFace trunk has random
weights (`common.load_arcface`'s seed 2), as in the JAX demo.

    python -m adaprompt_tpu_torch.cli.demo --ckpt v1-5-pruned-emaonly.ckpt \\
        --adaface_ckpt embeddings_gs-1000.pt
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from adaprompt_tpu_torch.cli import common


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    p.add_argument("--adaface_ckpt", type=str, default=None)
    p.add_argument("--subject_string", type=str, default="z")
    p.add_argument("--num_steps", type=int, default=50)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--outdir", type=str, default="outputs/demo")
    p.add_argument("--warmup", action="store_true", default=True,
                   help="run the serving shapes once before the UI comes up "
                        "(AdaFacePipeline.warmup)")
    p.add_argument("--no_warmup", dest="warmup", action="store_false")
    return p.parse_args(argv)


def build_pipeline(args):
    pipe = common.load_pipeline(args)
    sbg, scfg = common.load_subj_basis(args, pipe)
    from adaprompt_tpu_torch.adaface.wrapper import AdaFacePipeline
    from adaprompt_tpu_torch.eval.face_eval import FaceSimilarityEvaluator
    face_embedder = FaceSimilarityEvaluator(common.load_arcface(None, pipe.device))
    return AdaFacePipeline(pipe, sbg, scfg, pipe.text, pipe.text.cfg,
                           face_embedder=face_embedder, subject_string=args.subject_string,
                           num_inference_steps=args.num_steps)


def run_gradio(ada, args):
    import gradio as gr

    def generate(files, prompt, guidance, seed, count):
        images_np = [np.asarray(f) for f in files] if files else None
        embs = ada.generate_adaface_embeddings(images_np=images_np, seed=int(seed))
        if embs is None:
            return []
        return list(ada(prompt, guidance_scale=float(guidance),
                        out_image_count=int(count), seed=int(seed)))

    ui = gr.Interface(
        fn=generate,
        inputs=[gr.Gallery(label="subject photos"), gr.Textbox(value="portrait of a z"),
                gr.Slider(1, 12, value=4), gr.Number(value=42), gr.Slider(1, 8, value=4, step=1)],
        outputs=gr.Gallery(label="generations"),
        title="AdaPrompt zero-shot face personalization")
    ui.launch(server_port=args.port)


def run_repl(ada, args):
    from adaprompt_tpu_torch.eval.face_eval import list_images
    print("demo REPL — commands: subject <folder> | gen <prompt> | quit")
    seed = 42
    while True:
        try:
            line = input("> ").strip()
        except EOFError:
            break
        if not line or line == "quit":
            break
        if line.startswith("subject "):
            folder = line.split(None, 1)[1]
            embs = ada.generate_adaface_embeddings(image_paths=list_images(folder))
            print("subject loaded" if embs is not None else "no face found")
        elif line.startswith("gen "):
            prompt = line.split(None, 1)[1]
            imgs = ada(prompt, out_image_count=1, seed=seed)
            print("saved:", common.save_images(imgs, args.outdir, prefix=f"seed{seed}")[-1])
            seed += 1
        else:
            print("unknown command")


def main(argv=None):
    args = parse_args(argv)
    ada = build_pipeline(args)
    if args.warmup:
        t0 = time.perf_counter()
        print("warmup: running the serving shapes once ...")
        ada.warmup(out_image_counts=(1, 4), num_steps=args.num_steps)
        print(f"warmup done in {time.perf_counter() - t0:.0f}s — first "
              "request serves at steady-state latency")
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio not installed — falling back to the REPL demo")
        run_repl(ada, args)
    else:
        run_gradio(ada, args)


if __name__ == "__main__":
    main()
