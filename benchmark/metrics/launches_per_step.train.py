"""launches_per_step.train: device operations (kernels, copies, fills) in the
traced window, per step."""

from benchmark.harness import readings


def read(ctx):
    return readings.launches_per_unit(ctx)
