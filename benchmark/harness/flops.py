"""Operations and bytes of the work a cell does, from its shapes, and the
chip's peaks.

  * `count_flops(fn)`: the multiply-adds of a reference function run on the
    meta device, counted by `torch.utils.flop_counter` (2 per multiply-add
    of every matmul, convolution and attention product; elementwise work is
    not counted), so the count follows the shapes and not an implementation;
  * `attention(...)`: one attention layer's operations (q.k^T and p.v, 2
    per multiply-add) and its bytes, each input read once and the output
    written once;
  * `attention_bwd(...)`: its backward as flash computes it (q.k^T again,
    then dV, dP, dQ and dK: 5 products), q, k, v, the output, its gradient
    and the per-row logsumexp read once, a per-key bias too, dQ, dK and dV
    written once;
  * `bound_seconds`: the least time the chip could take for such work,
    max(ops / peak rate, bytes / peak bandwidth).
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peaks(kind: str) -> dict:
    """The published peaks of the card named `kind` (torch.cuda.get_device_name)."""
    for entry in PEAKS["cards"]:
        if entry["match"] in kind:
            return entry
    raise KeyError(f"no peaks for {kind!r} in benchmark/harness/peaks.json")


def count_flops(fn, *args, **kwargs) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return int(fc.get_total_flops())


def attention(batch: int, heads: int, sq: int, sk: int, head_dim: int, elem_bytes: int = 2) -> tuple:
    """(ops, bytes) of softmax(q k^T) v over [batch, heads] of sq queries and
    sk keys of width head_dim: q, k, v read once, the output written once."""
    ops = 2 * 2 * batch * heads * sq * sk * head_dim
    nbytes = elem_bytes * batch * heads * head_dim * (2 * sq + 2 * sk)
    return ops, nbytes


def attention_bwd(batch: int, heads: int, sq: int, sk: int, head_dim: int, elem_bytes: int = 2,
                  key_bias: bool = True) -> tuple:
    """(ops, bytes) of the backward of softmax(q k^T + bias) v."""
    ops = 5 * 2 * batch * heads * sq * sk * head_dim
    nbytes = elem_bytes * batch * heads * head_dim * (4 * sq + 4 * sk) + 4 * batch * heads * sq
    if key_bias:
        nbytes += 4 * batch * sk
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float, peak: dict, rate: str = "bf16_flops") -> float:
    return max(ops / peak[rate], nbytes / peak["hbm_bytes_per_s"])
