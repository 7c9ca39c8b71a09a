"""The benchmark's data, found by name: `BENCHMARK.json` at the checkout's
root, and beside it under `benchmark/` one file for each cell
(`workloads/<cell>.json`), traffic mix (`traffic/<mix>.json`),
configuration (`configs/<config>.json` and its builder `configs/<config>.py`),
per-layer or end-to-end metric reader (`metrics/<metric>.py`) and kernel
attribution (`kernels/<kernel>.json`). Adding any of them needs no edit of a
file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\r\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, root: Path = ROOT) -> dict:
    """The manifest's entry of cell `name`, merged with its parameters file."""
    entries = {w["name"]: w for w in manifest(root)["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(entries)})")
    return {**load_json(root / "benchmark" / "workloads" / f"{name}.json"), **entries[name]}


def config(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "benchmark" / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(root / "benchmark" / "traffic" / f"{name}.json")


def load_module(path: Path, name: str | None = None):
    """A Python file as a module (names with dots, as metric files have, included)."""
    spec = importlib.util.spec_from_file_location(name or "bench_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def config_builder(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "configs" / f"{name}.py", f"bench_config_{name}")


def metric_reader(name: str, root: Path = ROOT):
    return load_module(root / "benchmark" / "metrics" / f"{name}.py")


def kernels(root: Path = ROOT) -> dict:
    """{kernel function: its attribution file} for every `kernels/*.json`."""
    return {p.stem: load_json(p) for p in sorted((root / "benchmark" / "kernels").glob("*.json"))}


def cell_metrics(man: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` prints: its end-to-end metrics untraced,
    its per-layer metrics traced (an entry without `workloads` belongs to
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def problems(man: dict, root: Path = ROOT) -> list:
    """What in the manifest breaks the naming rules or has no file behind it."""
    bad = []
    names = set()
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in man[section]:
            n = e["name"]
            if not NAME.match(n):
                bad.append(f"{section}: bad name {n!r}")
            if (section, n) in names:
                bad.append(f"{section}: {n!r} twice")
            names.add((section, n))
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]):
            bad.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
            bad.append(f"{m['name']}: better/source")
        if not (root / "benchmark" / "metrics" / f"{m['name']}.py").is_file():
            bad.append(f"{m['name']}: no reader metrics/{m['name']}.py")
    for m in man["per_layer"]:
        if not LINE.match(m["layer"]):
            bad.append(f"{m['name']}: bad layer")
    for c in man["configs"]:
        for key in c["reduced"]:
            if not NAME.match(key):
                bad.append(f"{c['name']}: bad reduced key {key!r}")
        if not (root / c["file"]).is_file() or not (root / "benchmark" / "configs" / f"{c['name']}.py").is_file():
            bad.append(f"{c['name']}: missing file or builder")
    for w in man["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                bad.append(f"{w['name']}: bad {key}")
        if not LINE.match(w["why"]):
            bad.append(f"{w['name']}: bad why")
        for p in (f"workloads/{w['name']}.json", f"traffic/{w['traffic']}.json"):
            if not (root / "benchmark" / p).is_file():
                bad.append(f"{w['name']}: no {p}")
    return bad
