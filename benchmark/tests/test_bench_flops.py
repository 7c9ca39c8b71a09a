"""Operation and byte counts against hand counts at small shapes."""

import pytest
import torch

from benchmark.harness import flops, manifest
from benchmark.reference import nn, unet as ref_unet
from benchmark.tests.tiny import TINY_CONFIG, TINY_STAGE1, tiny_mix, tiny_stage1_mix


def test_attention_by_hand():
    # q.k^T and p.v: 2 products of B*H*Sq*Sk*D multiply-adds, 2 operations each
    ops, nbytes = flops.attention(batch=2, heads=3, sq=5, sk=7, head_dim=4)
    assert ops == 2 * 2 * (2 * 3 * 5 * 7 * 4)
    # q and out: B*H*Sq*D each; k and v: B*H*Sk*D each; 2 bytes an element
    assert nbytes == 2 * (2 * 3 * 4) * (5 + 5 + 7 + 7)
    peak = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
    assert flops.bound_seconds(ops, nbytes, peak) == pytest.approx(max(ops / 1e12, nbytes / 1e9))


def test_attention_backward_by_hand():
    # flash's backward: q.k^T again, dV, dP, dQ, dK: 5 products of B*H*Sq*Sk*D
    ops, nbytes = flops.attention_bwd(batch=2, heads=3, sq=5, sk=7, head_dim=4)
    assert ops == 5 * 2 * (2 * 3 * 5 * 7 * 4)
    # q, out, dout, dq: Sq rows each; k, v, dk, dv: Sk rows each; 2 bytes an
    # element; the fp32 logsumexp a query row and the fp32 key bias a key
    assert nbytes == 2 * (2 * 3 * 4) * (4 * 5 + 4 * 7) + 4 * (2 * 3 * 5) + 4 * (2 * 7)


def test_counter_by_hand():
    meta = torch.device("meta")
    x = torch.empty(2, 4, 8, 8, device=meta)

    def fn():
        h = nn.conv(x, torch.empty(6, 4, 3, 3, device=meta))                   # 2*6*8*8 outputs x 4*9 MACs
        t = h.reshape(2, 6, 64).transpose(1, 2)                                 # [2, 64, 6]
        nn.linear(t, torch.empty(5, 6, device=meta))                            # 2*64*5 x 6
        nn.attention(t, t, t, heads=2)                                          # 2 heads of width 3
    conv = 2 * 6 * 8 * 8 * 4 * 9
    lin = 2 * 64 * 5 * 6
    att = 2 * 2 * 64 * 64 * 3 * 2
    assert flops.count_flops(fn) == 2 * (conv + lin + att)


def test_flash_layers_of_a_request():
    wl = manifest.workload("adaface.ddim50_x4")
    cfg = manifest.config(wl["config"])
    builder = manifest.config_builder(wl["config"])
    cell = builder.Cell(cfg, manifest.traffic(wl["traffic"]), wl, 1, torch.device("meta"))
    cell.items[0] = {"out_image_count": 4, "num_steps": 50, "height": 512, "width": 512}
    work = cell.item_kernel_work(0)["attn_fwd"]
    # SD-1.5 at 64x64 latents: 5 self-attention layers at 4096 tokens (320 wide,
    # 8 heads of 40) and 5 at 1024 (640, 8 of 80); batch 8 (4 images, CFG)
    want = [flops.attention(8, 8, 4096, 4096, 40) + (50,)] * 2 + [flops.attention(8, 8, 1024, 1024, 80) + (50,)] * 2
    want += [flops.attention(8, 8, 1024, 1024, 80) + (50,)] * 3 + [flops.attention(8, 8, 4096, 4096, 40) + (50,)] * 3
    assert sorted(work) == sorted(want)


def test_request_flops_follow_the_unet_count():
    wl = manifest.workload("adaface.ddim50_x4")
    builder = manifest.config_builder(wl["config"])
    mix = tiny_mix(manifest.traffic(wl["traffic"]))
    cell = builder.Cell(TINY_CONFIG, mix, wl, 1, torch.device("meta"))
    cell.items[0] = dict(prompt="a photo of z", photos=2, out_image_count=2, num_steps=3, height=64, width=64)
    cell.items[1] = dict(cell.items[0], num_steps=5, prompt="z in a garden")
    one = cell.item_flops(0)
    more = cell.item_flops(1)
    meta = torch.device("meta")
    w = {k: torch.empty(s, device=meta) for k, s, _ in ref_unet.param_shapes(TINY_CONFIG["unet"])}
    per_pass = flops.count_flops(ref_unet.forward, w, TINY_CONFIG["unet"], torch.empty(4, 8, 8, 4, device=meta),
                                 torch.empty(4, device=meta), torch.empty(4, 77, 64, device=meta))
    assert more - one == 2 * per_pass and per_pass > 0


def test_flash_backward_layers_of_a_step():
    wl = manifest.workload("stage1.distill_bs8")
    cfg = manifest.config(wl["config"])
    cell = manifest.config_builder(wl["config"]).Cell(cfg, manifest.traffic(wl["traffic"]), wl, 1,
                                                      torch.device("meta"))
    # the trainer's seed draws ND 1, 3, 5 first: rows 8, 3, 2; student passes 1, 2, 3
    for index, rows, passes in ((0, 8, 1), (1, 3, 2), (2, 2, 3)):
        work = cell.item_kernel_work(index)["attn_bwd"]
        # all but the first transformer block's self-attention need a backward:
        # 4 at 4096 tokens (8 heads of 40), 5 at 1024 (8 of 80)
        want = [flops.attention_bwd(rows, 8, 4096, 4096, 40) + (passes,)] * 4
        want += [flops.attention_bwd(rows, 8, 1024, 1024, 80) + (passes,)] * 5
        assert sorted(work) == sorted(want)


def test_step_flops_count_the_backward():
    wl = manifest.workload("stage1.distill_bs8")
    builder = manifest.config_builder(wl["config"])
    cell = builder.Cell(TINY_STAGE1, tiny_stage1_mix(manifest.traffic(wl["traffic"])), wl, 1, torch.device("meta"))
    nd1 = cell.item_flops(0)                        # ND 1: 8 rows, one student pass
    meta = torch.device("meta")
    w = {k: torch.empty(s, device=meta) for k, s, _ in ref_unet.param_shapes(TINY_STAGE1["unet"])}
    per_pass = flops.count_flops(ref_unet.forward, w, TINY_STAGE1["unet"], torch.empty(8, 8, 8, 4, device=meta),
                                 torch.empty(8, device=meta), torch.empty(8, 77, 64, device=meta))
    # the teacher's pass and the student's forward, and at least the student's
    # input-gradient backward on top
    assert nd1 > 3 * per_pass
