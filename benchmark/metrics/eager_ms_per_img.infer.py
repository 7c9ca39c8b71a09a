"""eager_ms_per_img.infer: device time of the eager elementwise and
reduction/normalization kernels in the traced window, per image delivered."""

from benchmark.harness import readings


def read(ctx):
    return readings.eager_ms_per_unit(ctx)
