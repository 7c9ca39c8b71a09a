"""The trace reduction on synthetic traces: the union of busy intervals, idle
gaps named by host span, attribution of kernels by name."""

import pytest

from benchmark.harness import manifest, trace


def _summary():
    ops = [("flash_fwd_kernel<40>", 1.0, 2.0),
           ("elementwise_kernel", 1.5, 2.5),          # overlaps the first
           ("sm90_xmma_gemm_bf16", 4.0, 4.5),
           ("Memcpy DtoH (Device -> Pageable)", 6.0, 6.25),
           ("vectorized_reduce_kernel", 9.5, 11.0)]   # runs past the window
    spans = [("personalize", 0.5, 3.0), ("generate", 3.0, 8.0)]
    return trace.Summary(device_ops=ops, spans=spans, window=(0.0, 10.0))


def test_union_counts_overlap_once():
    assert trace.union([(3, 4), (1, 2), (1.5, 2.5), (2.5, 2.75)]) == [(1, 2.75), (3, 4)]
    assert trace.busy_seconds(_summary()) == pytest.approx(1.5 + 0.5 + 0.25 + 0.5)


def test_idle_gaps_are_named_by_the_host_span():
    gaps = trace.idle_gaps(_summary())
    assert [(n, s, round(d, 6)) for n, s, d in gaps] == [
        ("between", 0.0, 1.0), ("personalize", 2.5, 1.5), ("generate", 4.5, 1.5),
        ("generate", 6.25, 3.25)]
    idle = 10.0 - trace.busy_seconds(_summary())
    assert sum(d for _, _, d in gaps) == pytest.approx(idle)


def test_attribution_and_classes():
    kernels = manifest.kernels()
    by = trace.time_by(_summary(), kernels)
    assert by == pytest.approx({"attn_fwd": 1.0, "elementwise": 1.0, "matmul": 0.5, "copy": 0.25,
                                "reduction": 0.5})
    assert trace.attribute("void cross_int8_q_attn_kernel<320>", kernels) == "cross_attn_int8"
    assert trace.attribute("void cross_q_attn_kernel<320>", kernels) == "cross_attn"
    assert trace.attribute("flash_bwd_dq_convert_kernel", kernels) == "attn_bwd"
    assert trace.kernel_class("cudnn::nhwc_conv_fprop") == "convolution"


def test_breakdown_lists_at_most_ten():
    ops = [(f"k{i}", float(i), i + 0.5) for i in range(30)]
    s = trace.Summary(device_ops=ops, spans=[("generate", 0.0, 30.0)], window=(0.0, 30.0))
    b = trace.breakdown(s)
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0] == ["total:generate", pytest.approx(15.0)]
