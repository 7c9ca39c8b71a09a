"""The port's training CLI over two gloo ranks on the CPU, as torchrun starts
it (`--fsdp 2`: the frozen models and the generator sharded over the pair),
against the same CLI in one process on the same tiny models and photos:
the mesh it prints, equal metrics rows, the held SIGUSR1 sent to rank 1
alone making both ranks join the full-state save at the end of that step
(rank 0 writing the one file, equal to the single process's), and the
checkpoints."""

import json
import os

import numpy as np
import pytest
import torch

from adaprompt_tpu_torch.models import vae as tvae
from adaprompt_tpu_torch.ops.layers import reset_parameters
from adaprompt_tpu_torch.utils.png import write_png
import torch_dist_workers as workers
from torch_port_helpers import TORCH_VAE, train_env
from torch_port_helpers import torch_threads  # noqa: F401

STEPS, USR1_STEP = 3, 1
ARGS = ["--device", "cpu", "--fp32", "--size", "64", "--bs", "2", "--accum", "1",
        "--synthetic_faces", "--stage", "1", "--num_steps", str(STEPS), "--ckpt_every", "100",
        "--num_workers", "0", "--seed", "7"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    (tmp / "vocab").mkdir()
    env = train_env(tmp / "vocab")
    rng = np.random.default_rng(0)
    root = tmp / "subjects"
    for name in ("alice", "bob"):
        (root / name).mkdir(parents=True)
        for i in range(2):
            write_png(str(root / name / f"{i}.png"), rng.integers(0, 256, (80, 72, 3), np.uint8))
            mask = np.zeros((80, 72, 3), np.uint8)
            mask[16:64, 12 + 8 * i:60] = 255
            write_png(str(root / name / f"{i}_mask.png"), mask)
    f = env["tfrozen"]
    vae = reset_parameters(tvae.VAE(TORCH_VAE), torch.Generator().manual_seed(7))
    torch.save({"unet": f.unet.state_dict(), "text": f.text.state_dict(),
                "vae": vae.state_dict()}, tmp / "states.pt")
    spec = {"states": str(tmp / "states.pt"), "vocab": str(tmp / "vocab"),
            "cfgs": (f.unet.cfg, f.text.cfg, TORCH_VAE)}
    single_out = str(tmp / "single")
    workers.run_train_cli(spec, ARGS + ["--data_roots", str(root), "--out_dir", single_out],
                          USR1_STEP)
    out = str(tmp / "pair")
    pair = dict(spec, out=out, usr1_step=USR1_STEP, usr1_rank=1,
                argv=ARGS + ["--data_roots", str(root), "--out_dir", out, "--fsdp", "2"])
    workers.spawn(workers.cli_rank, 2, tmp, pair)
    return single_out, out, [workers.load(tmp / f"cli-{r}.pkl") for r in range(2)]


def _rows(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_under_torchrun_matches_one_process(runs):
    """The (1, 2) mesh on both ranks with sharded leaves; rank 0's metrics
    rows (one set: rank 1 writes none) those of the single process."""
    single, pair, ranks = runs
    for r in ranks:
        assert r["mesh"] == {"dp": 1, "fsdp": 2} and r["sharded"] > 0
    got, want = _rows(pair), _rows(single)
    assert [r["step"] for r in got] == [r["step"] for r in want] == list(range(STEPS))
    for g, w in zip(got, want):
        assert g["iter_type"] == w["iter_type"]
        assert g.get("num_denoising_steps") == w.get("num_denoising_steps")
        for k in ("loss_arc2face_distill", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4 if k == "grad_norm" else 1e-5,
                                       err_msg=k)


def test_signal_to_one_rank_saves_on_every_rank(runs):
    """SIGUSR1 to rank 1 during step 1: both ranks join the save at the
    step's end (rank 0 writes trainer_state-2.npz, as the single process
    does with the signal to itself) and training goes on to its last step;
    the file's entries are the single process's."""
    single, pair, ranks = runs
    for r in ranks:
        assert "trainer_state-2.npz" in r["files"] and f"embeddings_gs-{STEPS}.npz" in r["files"]
        assert sum(f.startswith("trainer_state-") for f in r["files"]) == 1
    a = np.load(os.path.join(pair, "trainer_state-2.npz"))
    b = np.load(os.path.join(single, "trainer_state-2.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        if b[k].dtype.kind != "f":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-6 * np.abs(b[k]).max()
                                       + 1e-30, err_msg=k)
