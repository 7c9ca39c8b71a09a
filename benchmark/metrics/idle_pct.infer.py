"""idle_pct.infer: the traced window less the union of the device's busy
intervals, as a share of the window."""

from benchmark.harness import readings


def read(ctx):
    return readings.idle_pct(ctx)
