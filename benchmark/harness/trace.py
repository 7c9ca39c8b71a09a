"""The device trace of a run's window, reduced to what the metrics read.

`Trace` runs `torch.profiler` (device activity) over the window and turns
its events into plain tuples: the device's operations (kernels, copies,
fills), beside the benchmark's own host spans from the host clock. The reduction is plain
arithmetic on those tuples, so the CPU tests hold it on synthetic traces:
  * busy time is the union of the device operations' intervals (overlapping
    operations count once), idle time the window less it;
  * each idle gap between busy intervals is named by the benchmark span the
    host was in when the gap began;
  * a device operation is attributed to a kernel function by the patterns of
    `kernels/*.json`, else to a class by its name (the port's
    `profile_step.kernel_class`, copied).
"""

from __future__ import annotations

import collections
import dataclasses

@dataclasses.dataclass
class Summary:
    device_ops: list          # [(name, start_s, end_s)], device operations in the window
    spans: list               # [(name, start_s, end_s)], the benchmark's host spans
    window: tuple             # (start_s, end_s) of the traced window


def kernel_class(name: str) -> str:
    """A non-port kernel's class by its name: cuDNN, cuBLAS, reductions and
    normalizations, or the eager elementwise rest."""
    low = name.lower()
    if "conv" in low or "implicit_gemm" in low or "xmma_fprop" in low or "nhwc" in low:
        return "convolution"
    if "gemm" in low or "cutlass" in low or "nvjet" in low or "sm90_xmma" in low:
        return "matmul"
    if "reduce" in low or "norm" in low:
        return "reduction"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copy"
    return "elementwise"


def attribute(name: str, kernels: dict) -> str:
    """The kernel function whose attribution file names a pattern found in
    `name` (the longest pattern wins), else the name's class."""
    best, fn = 0, None
    for k, spec in kernels.items():
        for pat in spec["patterns"]:
            if pat in name and len(pat) > best:
                best, fn = len(pat), k
    return fn or kernel_class(name)


def union(intervals) -> list:
    """Merged, sorted [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def clip(intervals, lo, hi) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy_seconds(summary: Summary) -> float:
    lo, hi = summary.window
    return sum(e - s for s, e in union(clip([(s, e) for _, s, e in summary.device_ops], lo, hi)))


def idle_gaps(summary: Summary) -> list:
    """[(span name, start, seconds)] of every idle stretch of the window."""
    lo, hi = summary.window
    busy = union(clip([(s, e) for _, s, e in summary.device_ops], lo, hi))
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    spans = sorted(summary.spans, key=lambda x: x[1])

    def where(t0):
        inner = [n for n, s, e in spans if s <= t0 < e]
        return inner[-1] if inner else "between"
    return [(where(s), s, e - s) for s, e in gaps]


def time_by(summary: Summary, kernels: dict) -> dict:
    """{kernel function or class: device seconds}, clipped to the window."""
    lo, hi = summary.window
    out = collections.Counter()
    for name, s, e in summary.device_ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            out[attribute(name, kernels)] += e - s
    return dict(out)


def breakdown(summary: Summary, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by host
    span (the longest single gaps after the totals), each list at most `top`."""
    lo, hi = summary.window
    ops = collections.Counter()
    for name, s, e in summary.device_ops:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            ops[name[:160]] += e - s
    by_span = collections.Counter()
    gaps = idle_gaps(summary)
    for n, _, d in gaps:
        by_span[n] += d
    idle = [[f"total:{n}", d] for n, d in by_span.most_common(top // 2)]
    idle += [[f"longest:{n}", d] for n, _, d in sorted(gaps, key=lambda g: -g[2])[:top - len(idle)]]
    return {"device_ops": [[n, d] for n, d in ops.most_common(top)], "idle_gaps": idle}


class Trace:
    """torch.profiler over the window, device activity only (CUPTI): the
    host's own spans and the window come from the host clock
    (`time.time_ns`, the time base of the profiler's device timestamps), so
    the profiler records no host operator and slows the host less."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch = torch
        self.on_card = torch.cuda.is_available()
        acts = [ProfilerActivity.CUDA] if self.on_card else [ProfilerActivity.CPU]
        self.prof = profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)

    def start(self):
        self.prof.start()

    def stop(self):
        if self.on_card:
            self.torch.cuda.synchronize()
        self.prof.stop()

    def summary(self, spans: list, window: tuple) -> Summary:
        """spans [(name, start_ns, end_ns)] and the window (start_ns, end_ns)
        on the host clock; times in the summary are seconds from the window's start."""
        base = window[0]
        sec = lambda t: (t - base) * 1e-9
        ops = [(n, sec(s), sec(e)) for n, dev, s, e in self._events() if dev]
        return Summary(device_ops=ops, spans=[(n, sec(s), sec(e)) for n, s, e in spans],
                       window=(0.0, sec(window[1])))

    def _events(self):
        """[(name, on_device, start_ns, end_ns)] from the profiler's results."""
        res = getattr(self.prof.profiler, "kineto_results", None)
        out = []
        if res is not None:
            for ev in res.events():
                dev = str(ev.device_type()).endswith("CUDA")
                start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
                dur = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000
                out.append((ev.name(), dev, start, start + dur))
            return out
        for ev in self.prof.events():
            dev = ev.device_type.name == "CUDA"
            out.append((ev.name, dev, ev.time_range.start * 1000, ev.time_range.end * 1000))
        return out
