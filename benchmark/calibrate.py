"""Readings of the correctness check for the limits: the program on many
seeds, and the controls on a few, in one process at the cell's own size.

    python3 benchmark/calibrate.py --workload adaface.ddim50_x4 --seeds 1 2 3 \
        --controls int8 lower --control-seeds 4 5 6 [--out readings.jsonl]

Each (control, seed) builds the cell from the seed, runs its set-up and the
items that the check samples (no measured window), and checks them as a run
does; one JSON line each: the readings, and the seconds of set-up, items and
check. Controls: "int8" the program with its w8a8 path (quant="int8", the
adaface cell); "lower" the reference one precision below the
configuration's in the program's place; "half_batch" (the training cell)
the float32 reference in the program's place with half of each batch left
out.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(wl: dict, seed: int, device, control=None) -> dict:
    """One (control, seed): the readings of the check, and the seconds of
    set-up, the sampled requests and the check."""
    import torch
    from benchmark.harness import core, manifest, traffic
    cfg, mix = manifest.config(wl["config"]), manifest.traffic(wl["traffic"])
    t0 = time.perf_counter()
    cell = manifest.config_builder(wl["config"]).Cell(cfg, mix, wl, seed, device, control=control)
    stream = traffic.items(mix, seed)
    cell.setup(core.Spans(False, torch), stream)
    t1 = time.perf_counter()
    _, _, error = core.serve(cell, stream, core.arrivals(mix), 0.0, None, device, cell.check_items)
    if error:
        raise RuntimeError(error)
    t2 = time.perf_counter()
    read = cell.check()
    del cell
    torch.cuda.empty_cache()
    return {"control": control, "seed": seed, "readings": read,
            "limits": {k: wl["limits"].get(k) for k in read},
            "setup_s": t1 - t0, "items_s": t2 - t1, "check_s": time.perf_counter() - t2}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=[], choices=("int8", "lower", "half_batch"))
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from benchmark.harness import manifest
    wl = manifest.workload(args.workload)
    dev = torch.device("cuda", 0)
    runs = [(None, s) for s in args.seeds] + [(c, s) for c in args.controls for s in args.control_seeds]
    out = open(args.out, "a") if args.out else None
    for control, seed in runs:
        line = json.dumps(readings(wl, seed, dev, control))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()


if __name__ == "__main__":
    main()
