"""img_per_s: images delivered to the host over the summed time of the
window's completed requests (photos in to uint8 images out)."""

from benchmark.harness import readings


def read(ctx):
    return readings.units_per_busy_second(ctx)
