"""optimizer_ms.train: median over the traced window's update steps of the
benchmark's synchronized span around the gradient pipeline's call that clips
and steps Prodigy."""

from benchmark.harness import readings


def read(ctx):
    return readings.span_median_ms(ctx, "optimizer")
