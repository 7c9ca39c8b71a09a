"""Time the block-GEMM kernels of the tree it is run from: B3 (geglu_fwd),
B2 (fused_cross_attention), B6 (geglu_int8) and B5
(fused_cross_attention_int8) at their main-path shapes, through that tree's
own chip_smoke.py cases, with the resource lines that tree logs. Run from
the root of each of two trees in one chip call, in turns, to compare them on
one card:

    python3 tools/gemm_kernel_turns.py                  # this tree
    (cd other_tree && python3 ../tools/gemm_kernel_turns.py)

Prints one line a case: `turn <tree> <label>: kernel_ms=... [kernel_only_ms=...]`,
and one line a B2 shape: `digest <tree> B2 <shape>: <sha256 of the output's
bytes>` on inputs made from a seed, so that two trees' B2 can be held equal
bit for bit. Needs a CUDA card.
"""

import hashlib
import math

import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke  # noqa: E402  (the tree's own)


def main():
    tree = os.path.basename(os.getcwd())
    print(chip_smoke.card_line(), flush=True)
    chip_smoke.geglu_resources()
    chip_smoke.cross_resources()
    if hasattr(chip_smoke, "cross_int8_resources"):
        chip_smoke.cross_int8_resources()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = chip_smoke.UNET_BATCH
    cases = [lambda: chip_smoke._case_geglu(gen, b * 4096, 320),
             lambda: chip_smoke._case_geglu(gen, b * 1024, 640),
             lambda: chip_smoke._case_geglu(gen, b * 2048, 320)]
    cases += [lambda a=a: chip_smoke._case_cross(gen, *a)
              for a in ((4096, 320), (1024, 640), (4096, 320, 2), (1024, 640, 2))]
    cases += [lambda a=a: chip_smoke._case_geglu_int8(gen, *a)
              for a in ((4 * 2048, 320), (2 * 2048, 320), (4 * 1024, 640), (2 * 1024, 640))]
    cases += [lambda a=a: chip_smoke._case_cross_int8(gen, *a)
              for a in ((4096, 320, 4), (1024, 640, 4), (4096, 320, 2), (1024, 640, 2))]
    for case in cases:
        label, err, mag, tol, ok, res, _ = case()
        extra = f" kernel_only_ms={res['kernel_only_ms']:.4f}" if "kernel_only_ms" in res else ""
        print(f"turn {tree} {label}: kernel_ms={res['kernel_ms']:.4f}{extra} "
              f"rel={err / mag:.3e} {'OK' if ok else 'FAIL'}", flush=True)
    b2_digests(tree)


def b2_digests(tree):
    """B2's output at its four main-path shapes and chip_smoke.CROSS_RAGGED,
    each on inputs made from a seed, as a sha256 of its bytes."""
    from adaprompt_tpu_torch.ops import attention as A
    bf = torch.bfloat16
    shapes = [(4, 4096, 320, 8), (4, 1024, 640, 8), (2, 4096, 320, 8), (2, 1024, 640, 8)]
    for b, n, c, h in shapes + list(chip_smoke.CROSS_RAGGED):
        g = torch.Generator(device="cuda").manual_seed(b * 100003 + n * 101 + c + h)
        w = lambda: ((torch.rand(c, c, device="cuda", generator=g) * 2 - 1)
                     / math.sqrt(c)).to(bf)
        x = torch.randn(b, n, c, device="cuda", generator=g).to(bf)
        wq, wo = w(), w()
        k, v = (torch.randn(b, 77, h, c // h, device="cuda", generator=g).to(bf) for _ in "kv")
        bo = (torch.rand(c, device="cuda", generator=g) * 2 - 1) / math.sqrt(c)
        out = A.fused_cross_attention(x, wq, k, v, wo, bo, (c // h) ** -0.5, h)
        digest = hashlib.sha256(out.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
        print(f"digest {tree} B2 B={b} N={n} C={c} H={h}: {digest[:32]}", flush=True)


if __name__ == "__main__":
    main()
