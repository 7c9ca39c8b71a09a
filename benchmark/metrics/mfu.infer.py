"""mfu.infer: the model's operations in the window's requests (2 per
multiply-add of every matmul, convolution and attention product of the
personalization chain, the contexts, every UNet pass and the decode, counted
from the configuration's shapes) over the requests' summed time
(img_per_s's) times the bf16 peak."""

from benchmark.harness import readings


def read(ctx):
    return readings.mfu_pct(ctx)
