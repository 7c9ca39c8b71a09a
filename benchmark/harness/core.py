"""One run of one cell: set-up, a measured window, the check, the result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's files name its configuration and traffic (`manifest.py`); the
configuration's builder (`configs/<config>.py`) makes the weights from the
seed, builds the program, runs its items and checks them against the plain
reference. This module times set-up (from the process's start to the first
timed item), with `--trace 1` serves the first `trace_items` items under the
profiler, and serves the traffic's items in the order and at the times its
arrival process gives (`serve`) until `--seconds` have passed. It reads the
metrics through their readers (`metrics/<name>.py`) and prints the result
as the last line of standard output, each compared number beside its limit
as the last lines of standard error and last in the result. The cell asks
for `chips` cards; the run holds cuda:0 up to cuda:<chips - 1>, hands the
builder cuda:0 (a builder of a cell over several cards places its work on
the others itself) and reports the peak memory of the fullest card.
"""

from __future__ import annotations

import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "adaprompt_tpu")


class Spans:
    """The benchmark's host spans of a request. Untraced: nothing. Traced: at
    each boundary a synchronize and a host clock reading, so a span's time is
    the device's too; `times` [{span: seconds}] a request, `marks` [(span,
    start_ns, end_ns)] on the clock of the profiler's device timestamps."""

    def __init__(self, traced: bool, torch):
        self.traced = traced
        self._sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
        self.cur = None
        self.times, self.marks = [], []

    def _now(self):
        self._sync()
        return time.time_ns()

    def enter(self, name):
        if self.traced:
            self.times.append({})
            self.cur = (name, self._now())

    def switch(self, name):
        if self.traced and self.cur is not None:
            t = self._now()
            self._close(t)
            self.cur = (name, t)

    def leave(self):
        if self.traced and self.cur is not None:
            self._close(self._now())
            self.cur = None

    def _close(self, t):
        name, t0 = self.cur
        self.times[-1][name] = self.times[-1].get(name, 0.0) + (t - t0) * 1e-9
        self.marks.append((name, t0, t))


def synced_clock(device) -> float:
    """The host clock once the card has finished what was queued."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import manifest
    man = manifest.manifest()
    wl = manifest.workload(args.workload)
    root = manifest.ROOT
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    out = run_cell(man, wl, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    if out is None:
        return 4
    result, checks_text = out
    print(checks_text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def arrivals(mix: dict) -> dict:
    """The mix's arrival process: {"process": "closed_loop", "clients": n}
    (each client sends its next request once its last one has returned and
    its inputs are made) or {"process": "open_loop"} (each item brings its
    `arrival_s`, from the traffic generator)."""
    arr = mix.get("arrival", "closed_loop")
    arr = {"process": arr} if isinstance(arr, str) else dict(arr)
    if arr["process"] == "closed_loop":
        arr.setdefault("clients", mix.get("clients", 1))
    elif arr["process"] != "open_loop":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    return arr


def serve(cell, stream, arrival: dict, seconds: float, limit, device, least: int = 0) -> tuple:
    """Items of `stream` through `cell`, one at a time in arrival order,
    until `seconds` have passed since the first arrival and at least
    `least` items were attempted, or `limit` items were -> ([{index,
    arrival, start, end, units}], attempted, error). An item's inputs are made (`cell.prepare`) before its arrival;
    its clock runs from its start (its arrival, or the end of the item
    before it if that is later) to the card's end of its work; the cell's
    `after(req)`, where it has one, runs outside that clock."""
    after = getattr(cell, "after", None)
    done, attempted = [], 0
    t0 = time.perf_counter()
    free, base = [], None
    while ((time.perf_counter() - t0 < seconds or attempted < least)
           and (limit is None or attempted < limit)):
        p0 = time.perf_counter()
        req = cell.prepare(next(stream))
        item = req["item"]
        if arrival["process"] == "open_loop":
            base = item["arrival_s"] if base is None else base
            arrive = t0 + item["arrival_s"] - base
        else:
            c = arrival["clients"]
            arrive = (free[attempted - c] if attempted >= c else t0) + time.perf_counter() - p0
        attempted += 1
        wait = arrive - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        start = time.perf_counter()
        try:
            units = cell.run(req)
            end = synced_clock(device)
        except Exception as exc:          # a request that fails ends the window
            return done, attempted, f"{type(exc).__name__}: {exc}"
        if after is not None:
            after(req)
        free.append(time.perf_counter())
        done.append({"index": item["index"], "arrival": arrive, "start": start, "end": end, "units": units})
    return done, attempted, None


def run_cell(man: dict, wl: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
             config_override: dict | None = None, mix_override: dict | None = None):
    """-> (result dict, text of the compared numbers), or None when a
    forbidden module was loaded (named on standard error).

    A traced run first serves the cell's `trace_items` items under the
    profiler, with the benchmark's spans on (the same stream positions in
    every run, so the same work); then every run serves its window, items
    for `seconds` (and at least as many as make up the cell's
    `check_items`, the first items after set-up that its check compares).
    The end-to-end metrics and `mfu.*` read the window; the trace's metrics
    read the traced items."""
    import torch
    from benchmark.harness import hoststat, manifest, traffic
    from benchmark.harness import trace as trace_mod
    cfg = config_override or manifest.config(wl["config"])
    mix = mix_override or manifest.traffic(wl["traffic"])
    on_card = device.type == "cuda"
    devices = [torch.device("cuda", i) for i in range(wl["chips"])] if on_card else [device]
    builder = manifest.config_builder(wl["config"])
    cell = builder.Cell(cfg, mix, wl, seed, device)
    spans = Spans(False, torch)
    stream = traffic.items(mix, seed)
    arrival = arrivals(mix)
    cell.setup(spans, stream)
    pre_peak = 0
    if on_card:
        for d in devices:
            torch.cuda.synchronize(d)
            pre_peak = max(pre_peak, torch.cuda.max_memory_allocated(d))
            torch.cuda.reset_peak_memory_stats(d)
    setup_s = time.perf_counter() - t_start

    summary, traced_requests, attempted, error = None, [], 0, None
    if traced:
        spans.traced = True
        tracer = trace_mod.Trace()
        tracer.start()
        w0 = time.time_ns()
        traced_requests, attempted, error = serve(cell, stream, arrival, 0.0, wl["trace_items"], device,
                                                  wl["trace_items"])
        w1 = time.time_ns()
        tracer.stop()
        spans.traced = False
        summary = tracer.summary(spans.marks, (w0, w1))
    requests, window_s, host = [], 0.0, None
    if error is None:
        host0 = hoststat.sample()
        t0 = time.perf_counter()
        requests, n, error = serve(cell, stream, arrival, seconds, None, device, cell.check_items - attempted)
        window_s = synced_clock(device) - t0
        host = hoststat.since(host0)
        attempted += n
    failed = int(error is not None)
    window_peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0
    found = forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found), file=sys.stderr)
        return None

    readings = cell.check()
    limits = wl["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in readings.items() if k in limits}
    ok = failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()) and len(checks) == len(limits)
    ctx = {"setup_s": setup_s, "window_s": window_s, "requests": requests, "traced_requests": traced_requests,
           "spans": spans.times, "trace": summary, "kernels": manifest.kernels(),
           "peak_window_bytes": window_peak, "cell": cell,
           "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "on_card": on_card}
    metrics = {}
    for m in manifest.cell_metrics(man, wl["name"], traced):
        value = manifest.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": ctx["device_kind"], "count": len(devices),
           "memory_peak_bytes": max(pre_peak, window_peak) if on_card else 0}
    result = {"correct": ok, "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = trace_mod.busy_seconds(summary)
        dev["window_s"] = summary.window[1] - summary.window[0]
        result["breakdown"] = trace_mod.breakdown(summary)
        result["device_s_by_kernel"] = dict(sorted(trace_mod.time_by(summary, ctx["kernels"]).items(),
                                                   key=lambda kv: -kv[1]))
    if on_card:
        result["power_limit"] = power_limit()
    result["setup_parts"] = getattr(cell, "setup_parts", None)
    result["host"] = host
    result["request_s"] = [r["end"] - r["start"] for r in requests]
    result["checks"] = checks
    lines = [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    if error:
        lines.insert(0, f"request failed: {error}")
    return result, "\n".join(lines)


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"

