"""setup_s: seconds from the process's start to the first timed item
(loading, weights, building, warm-up, and in a first run the kernels' build)."""


def read(ctx):
    return ctx["setup_s"]
