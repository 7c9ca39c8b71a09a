"""What the per-layer and end-to-end metric readers compute, once for every
cell. A reader (`metrics/<name>.py`) calls one of these on the run's context
(`core.run_cell`'s ctx) and returns its value, or None where it finds
nothing to read: a run off the card, an untraced run for a trace metric, a
window without a completed item or a kernel that never ran. A "unit" is what
an item delivers: an image of a request, or a training step. The window's
items are `ctx["requests"]`; a traced run's items under the profiler, which
the trace metrics read, are `ctx["traced_requests"]`.
"""

from __future__ import annotations

import statistics

from benchmark.harness import flops, trace


def _traced(ctx) -> bool:
    return ctx["on_card"] and ctx["trace"] is not None and bool(ctx["traced_requests"])


def units(ctx, key: str = "requests") -> int:
    return sum(r["units"] for r in ctx[key])


def busy_seconds(ctx) -> float:
    """The summed time of the window's completed items, each from its start
    to the card's end of its work (the benchmark's own making of its inputs
    left out)."""
    return sum(r["end"] - r["start"] for r in ctx["requests"])


def units_per_busy_second(ctx):
    """Units over the summed time of the window's completed items."""
    if not ctx["requests"]:
        return None
    return units(ctx) / busy_seconds(ctx)


def seconds_per_unit(ctx):
    """The summed time of the window's completed items over their units."""
    if not ctx["requests"]:
        return None
    return busy_seconds(ctx) / units(ctx)


def span_median_ms(ctx, name: str):
    """Median over the traced window's items of the benchmark's host span `name`."""
    vals = [s[name] * 1e3 for s in ctx["spans"] if name in s]
    return statistics.median(vals) if vals else None


def eager_ms_per_unit(ctx):
    """Device time of the eager elementwise and reduction/normalization
    kernels (neither a port kernel, nor cuDNN, nor cuBLAS, nor a copy) per unit."""
    if not _traced(ctx):
        return None
    by = trace.time_by(ctx["trace"], ctx["kernels"])
    return (by.get("elementwise", 0.0) + by.get("reduction", 0.0)) * 1e3 / units(ctx, "traced_requests")


def launches_per_unit(ctx):
    """Device operations (kernels, copies, fills) in the traced window per unit."""
    if not _traced(ctx):
        return None
    lo, hi = ctx["trace"].window
    return sum(1 for _, s, e in ctx["trace"].device_ops if e > lo and s < hi) / units(ctx, "traced_requests")


def idle_pct(ctx):
    """The traced window less the union of the device's busy intervals, over the window."""
    if not ctx["on_card"] or ctx["trace"] is None:
        return None
    t = ctx["trace"]
    w = t.window[1] - t.window[0]
    return 100.0 * (w - trace.busy_seconds(t)) / w


def peak_mem_gib(ctx):
    """torch.cuda.max_memory_allocated over the window, after a reset at its start."""
    if not ctx["on_card"] or not ctx["peak_window_bytes"]:
        return None
    return ctx["peak_window_bytes"] / 2 ** 30


def mfu_pct(ctx):
    """The model's operations of the window's completed items (the cell's
    `item_flops`, from the configuration's shapes) over their summed time
    (the end-to-end metric's) times the card's bf16 peak: the untraced
    window's, so that the profiler's cost does not enter it."""
    if not ctx["on_card"] or not ctx["requests"]:
        return None
    cell = ctx["cell"]
    ops = sum(cell.item_flops(r["index"]) for r in ctx["requests"])
    return 100.0 * ops / (busy_seconds(ctx) * flops.peaks(ctx["device_kind"])["bf16_flops"])


def roofline_pct(ctx, kernel: str):
    """The least time the chip could take for the work of `kernel` in the
    traced window's items (the cell's `item_kernel_work`, from the model's
    shapes) over the device time of the kernels attributed to it."""
    if not _traced(ctx):
        return None
    device = trace.time_by(ctx["trace"], ctx["kernels"]).get(kernel, 0.0)
    if device <= 0:
        return None
    peak = flops.peaks(ctx["device_kind"])
    cell = ctx["cell"]
    bound = sum(times * flops.bound_seconds(ops, nbytes, peak)
                for r in ctx["traced_requests"]
                for ops, nbytes, times in cell.item_kernel_work(r["index"]).get(kernel, []))
    return 100.0 * bound / device
