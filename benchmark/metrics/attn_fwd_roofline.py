"""attn_fwd_roofline: the least time the chip could take for the
self-attention the flash forward serves (counted from the model's shapes,
each layer max(ops / bf16 peak, bytes / HBM bandwidth)) over the device time
of the kernels attributed to attn_fwd (kernels/attn_fwd.json), in the traced
window."""

from benchmark.harness import readings


def read(ctx):
    return readings.roofline_pct(ctx, "attn_fwd")
