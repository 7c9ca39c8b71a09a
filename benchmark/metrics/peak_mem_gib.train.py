"""peak_mem_gib.train: torch.cuda.max_memory_allocated over the window, after
a reset at its start, in GiB."""

from benchmark.harness import readings


def read(ctx):
    return readings.peak_mem_gib(ctx)
