"""A run's result line and its imports: a tiny run on the CPU in a fresh
process loads no module of JAX or of the JAX package, and the command
without a card exits with an error and prints no result."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import core, manifest
from benchmark.tests.conftest import ROOT
from benchmark.tests.tiny import run_tiny, run_tiny_stage1


@pytest.mark.parametrize("cell, run", [("adaface.ddim50_x4", run_tiny), ("stage1.distill_bs8", run_tiny_stage1)])
def test_result_line_keys(cell, run):
    man = manifest.manifest()
    for traced in (False, True):
        result, text = run(traced=traced)
        assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(result)[-1] == "checks"
        assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
        allowed = {m["name"] for m in manifest.cell_metrics(man, cell, traced)}
        assert set(result["metrics"]) <= allowed and result["metrics"]
        for m in result["metrics"].values():
            assert set(m) == {"value", "unit"}
        if traced:
            assert {"busy_s", "window_s"} <= set(result["device"]) and "breakdown" in result
        lines = text.splitlines()
        assert [ln.split()[0] for ln in lines] == list(result["checks"])
        assert all(" limit " in ln for ln in lines)
        json.dumps(result)


def test_tiny_run_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.tests.tiny import run_tiny, run_tiny_stage1\n"
            "run_tiny(); run_tiny_stage1()\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)}, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "adaprompt_tpu_torch" in top and not top & set(core.FORBIDDEN)


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "adaface.ddim50_x4",
                          "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
