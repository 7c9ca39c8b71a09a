"""personalize_ms.infer: median over the traced window's requests of the
benchmark's synchronized span around generate_adaface_embeddings and
encode_prompt (photos to cond/uncond contexts)."""

from benchmark.harness import readings


def read(ctx):
    return readings.span_median_ms(ctx, "personalize")
