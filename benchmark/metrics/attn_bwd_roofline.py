"""attn_bwd_roofline: the least time the chip could take for the
backward of the self-attention layers the flash backward serves in the
student's passes (counted from the model's shapes) over the device time of
the kernels attributed to attn_bwd (kernels/attn_bwd.json), in the traced
window."""

from benchmark.harness import readings


def read(ctx):
    return readings.roofline_pct(ctx, "attn_bwd")
