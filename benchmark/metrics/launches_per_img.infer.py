"""launches_per_img.infer: device operations (kernels, copies, fills) in the
traced window, per image delivered."""

from benchmark.harness import readings


def read(ctx):
    return readings.launches_per_unit(ctx)
