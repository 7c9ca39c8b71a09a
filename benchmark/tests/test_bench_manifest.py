"""The manifest's names and units, and that new cells, metrics and kernel
attributions are found by name without editing a file that exists."""

import json
import shutil

from benchmark.harness import manifest


def test_manifest_keeps_the_rules():
    man = manifest.manifest()
    assert manifest.problems(man) == []
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in man["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert manifest.cell_metrics(man, w["name"], trace=False)
        assert manifest.cell_metrics(man, w["name"], trace=True)


def test_the_named_metrics_are_there():
    man = manifest.manifest()
    assert {m["name"] for m in man["end_to_end"]} == {"img_per_s", "train_step_s", "setup_s"}
    moves = {m["name"]: (m["moves"], m["workloads"]) for m in man["per_layer"]}
    for name in ("personalize_ms", "eager_ms_per_img", "launches_per_img", "idle_pct", "peak_mem_gib", "mfu"):
        assert moves[name + ".infer"] == ("img_per_s", ["adaface.ddim50_x4"])
    for name in ("optimizer_ms", "eager_ms_per_step", "launches_per_step", "idle_pct", "peak_mem_gib", "mfu"):
        assert moves[name + ".train"] == ("train_step_s", ["stage1.distill_bs8"])
    # a kernel's share of its roofline is named <kernel>_roofline
    assert moves["attn_fwd_roofline"] == ("img_per_s", ["adaface.ddim50_x4"])
    assert moves["attn_bwd_roofline"] == ("train_step_s", ["stage1.distill_bs8"])


def test_bad_names_are_found():
    man = json.loads(json.dumps(manifest.manifest()))
    man["per_layer"][0]["name"] = "has space"
    man["end_to_end"][0]["unit"] = "tokens per second"
    found = "\n".join(manifest.problems(man))
    assert "bad name 'has space'" in found and "bad unit" in found


def _copy_tree(tmp_path):
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def test_new_cell_metric_and_kernel_are_picked_up(tmp_path):
    root = _copy_tree(tmp_path)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "adaface.ddim50_x1", "config": "sd15_adaface", "traffic": "ddim50_x1",
                             "chips": 1, "why": "one image a request"})
    man["per_layer"].append({"name": "steps_per_img.infer", "unit": "steps/img", "better": "lower",
                             "source": "host_clock", "layer": "device", "moves": "img_per_s",
                             "workloads": ["adaface.ddim50_x1"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    mix = json.loads((root / "benchmark/traffic/ddim50_x4.json").read_text())
    (root / "benchmark/traffic/ddim50_x1.json").write_text(json.dumps(dict(mix, out_image_count=1)))
    (root / "benchmark/workloads/adaface.ddim50_x1.json").write_text(
        (root / "benchmark/workloads/adaface.ddim50_x4.json").read_text())
    (root / "benchmark/metrics/steps_per_img.infer.py").write_text("def read(ctx):\n    return 50.0\n")
    (root / "benchmark/kernels/new_kernel.json").write_text(json.dumps({"patterns": ["new_kernel_x"]}))

    assert manifest.problems(man, root) == []
    wl = manifest.workload("adaface.ddim50_x1", root)
    assert wl["config"] == "sd15_adaface" and "limits" in wl
    assert manifest.traffic(wl["traffic"], root)["out_image_count"] == 1
    names = [m["name"] for m in manifest.cell_metrics(man, "adaface.ddim50_x1", trace=True)]
    assert names == ["steps_per_img.infer"]
    assert manifest.metric_reader("steps_per_img.infer", root).read({}) == 50.0
    assert "new_kernel" in manifest.kernels(root)
    assert manifest.config_builder("sd15_adaface", root).Cell
    after = {p: p.read_bytes() for p in before}
    assert after == before
