#!/usr/bin/env python3
"""How close the fp32 parity tests that set their own torch thread count
come to their bounds at other intra-op thread counts.

tests/test_torch_recon_step.py::test_recon_step_matches_jax and
tests/test_torch_compos_step.py::test_compos_phase_matches_jax hold the
port's step against JAX's in fp32; the order in which the CPU's reductions
sum depends on torch's intra-op thread count, and their modules set
`TORCH_THREADS`. This runs both tests once for each count given, each count
in a process of its own with the modules' `TORCH_THREADS` set to it, and
prints for each case the largest ratio of error to bound over its checks
(every `np.testing.assert_allclose` and the tests' `within`), the check it
came from, and the outcome. A ratio above 1 is a failed check; a failed
case stops at its first failed check, so its ratio is of the checks up to it.

    JAX_PLATFORMS=cpu python3 tools/thread_margins.py [--threads 1 2 8]

The tests import both packages, so this does too (a diagnostic beside them).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = ["tests/test_torch_recon_step.py::test_recon_step_matches_jax",
         "tests/test_torch_compos_step.py::test_compos_phase_matches_jax"]


def _test_line() -> int:
    """The line of the test function that made the current check."""
    frame = sys._getframe(2)
    while frame is not None and not frame.f_code.co_name.startswith("test_"):
        frame = frame.f_back
    return frame.f_lineno if frame is not None else -1


class Margins:
    """pytest plugin: sets each test module's TORCH_THREADS, and keeps each
    case's worst error-to-bound ratio and its outcome."""

    def __init__(self, threads: int):
        self.threads, self.cases = threads, {}

    def pytest_collection_modifyitems(self, items):
        import numpy as np
        for item in items:
            item.module.TORCH_THREADS = self.threads
        original = np.testing.assert_allclose

        def recorded(actual, desired, rtol=1e-7, atol=0, err_msg="", **kw):
            d = np.asarray(desired, np.float64)
            err = np.abs(np.asarray(actual, np.float64) - d)
            bound = np.broadcast_to(atol + rtol * np.abs(d), err.shape).ravel()
            err = err.ravel()
            with np.errstate(divide="ignore", invalid="ignore"):
                k = int(np.nanargmax(np.where(err == 0, 0.0, err / bound)))
            self._keep(err_msg or f"assert_allclose at line {_test_line()}", err[k], bound[k])
            return original(actual, desired, rtol=rtol, atol=atol, err_msg=err_msg, **kw)
        np.testing.assert_allclose = recorded

    def _keep(self, what, err, bound):
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else float("inf"))
        worst = self.current.get("worst")
        if worst is None or ratio > worst[0]:
            self.current["worst"] = (ratio, what, float(err), float(bound))

    def pytest_runtest_setup(self, item):
        self.current = self.cases.setdefault(item.nodeid, {})
        import torch_port_helpers
        torch_port_helpers.MARGINS.clear()

    def pytest_runtest_teardown(self, item):
        import torch_port_helpers
        for what, err, bound in torch_port_helpers.MARGINS:
            self._keep(what, err, bound)
        torch_port_helpers.MARGINS.clear()

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.failed:
            import torch
            case = self.cases.setdefault(report.nodeid, {})
            case.update(outcome=report.outcome, torch_threads=torch.get_num_threads())
            if report.failed:
                case["error"] = report.longreprtext.strip().splitlines()[-1][:300]


def one(threads: int, out: str) -> int:
    import pytest
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    plugin = Margins(threads)
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly", *TESTS],
                     plugins=[plugin])
    with open(out, "w") as f:
        json.dump(plugin.cases, f)
    return int(rc)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 8])
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        sys.exit(one(args.one, args.out) not in (0, 1))
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.threads:
            out = os.path.join(tmp, f"{n}.json")
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", str(n),
                                  "--out", out], cwd=ROOT, capture_output=True, text=True)
            if res.returncode or not os.path.exists(out):
                sys.exit(f"threads {n}: the run failed\n{res.stdout[-3000:]}{res.stderr[-3000:]}")
            with open(out) as f:
                cases = json.load(f)
            for nodeid, c in cases.items():
                line = f"threads {n} (torch {c['torch_threads']}): {nodeid.split('::')[-1]} {c['outcome']}"
                if "worst" in c:
                    ratio, what, err, bound = c["worst"]
                    line += (f"; worst check {what}: error {err:.6g}, bound {bound:.6g}, "
                             f"ratio {ratio:.4f}")
                print(line + (f"; {c['error']}" if "error" in c else ""), flush=True)


if __name__ == "__main__":
    main()
