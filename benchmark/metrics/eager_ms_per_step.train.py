"""eager_ms_per_step.train: device time of the eager elementwise and
reduction/normalization kernels in the traced window, per step."""

from benchmark.harness import readings


def read(ctx):
    return readings.eager_ms_per_unit(ctx)
