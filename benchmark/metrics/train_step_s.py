"""train_step_s: the summed time of the window's completed train_step calls
(each ending when the card has finished its work) over their number."""

from benchmark.harness import readings


def read(ctx):
    return readings.seconds_per_unit(ctx)
