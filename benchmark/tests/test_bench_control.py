"""The controls of the correctness checks, at the cells' own sizes on the
card: the reference one precision below the configuration's (float32 towers
in bfloat16, the bfloat16 UNets and VAE on float8 e4m3 operands) in the
program's place comes out not correct on three seeds, as does the training
cell's half-batch fault (the float32 reference with half of each batch left
out), and the program itself is correct on one. Run on the card:

    python -m pytest benchmark/tests/test_bench_control.py -q
"""

import pytest

from benchmark import calibrate
from benchmark.harness import manifest

CELLS = ("adaface.ddim50_x4", "stage1.distill_bs8")


def _fails(r, wl):
    return any(r["readings"][k] > wl["limits"][k] for k in wl["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cuda_device, cell):
    wl = manifest.workload(cell)
    r = calibrate.readings(wl, 2**31 + 101, cuda_device)
    assert not _fails(r, wl), r


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 201, 2**31 + 202, 2**31 + 203])
@pytest.mark.parametrize("cell, control", [("adaface.ddim50_x4", "lower"), ("stage1.distill_bs8", "lower"),
                                           ("stage1.distill_bs8", "half_batch")])
def test_control_is_not_correct(cuda_device, cell, control, seed):
    wl = manifest.workload(cell)
    r = calibrate.readings(wl, seed, cuda_device, control=control)
    assert _fails(r, wl), r
