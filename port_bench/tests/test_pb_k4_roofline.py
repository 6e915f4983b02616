"""``k4_roofline.burst`` on a made-up traced window: the K4 kernels that
the prefill calls launched against the bound of their real rows' causal
attention; nothing read where no K4 kernel ran (a program without K4)."""

import pytest

from port_bench import flops, harness
from port_bench.tests.test_pb_readings import CFG, H100, ctx_of

read = harness.metric_reader("k4_roofline.burst")
bound_s = harness.loadgen.module("metrics", "k4_roofline.burst").call_bound_s


def test_k4_roofline_by_hand():
    peak = flops.PEAKS[H100]
    burst = {"lens": [1300, 1344, 1, 1], "starts": [40, 40, -1, -1],
             "offset": 0, "images": True}
    suffix = {"lens": [320, 0], "starts": [2, -1], "offset": 1024,
              "images": True}
    # 28 layers of 12 / 2 heads of 128: the padding rows count nothing
    ops = 28 * 4 * 12 * 128 * (1300 * 1301 // 2 + 1344 * 1345 // 2)
    assert bound_s(CFG, burst, peak) == pytest.approx(
        ops / peak["bf16_flops"])
    ops = 28 * 4 * 12 * 128 * (320 * 1024 + 320 * 321 // 2)
    assert bound_s(CFG, suffix, peak) == pytest.approx(
        ops / peak["bf16_flops"])
    total = bound_s(CFG, burst, peak) + bound_s(CFG, suffix, peak)
    events = [("prefill", 1.0, 2.0, burst), ("prefill", 3.0, 4.0, suffix)]
    k4 = [("void (anonymous namespace)::prefill_attention_kernel<"
           "__nv_bfloat16, 128>(...)", 1.2, 1.2 + total),
          ("void (anonymous namespace)::prefill_attention_kernel<"
           "__nv_bfloat16, 128>(...)", 3.2, 3.2 + 3 * total),
          ("prefill_attention_kernel", 11.0, 11.5)]  # after the window
    assert read(ctx_of(events, k4 + [("gemm", 1.0, 1.9)])) == \
        pytest.approx(25.0)
    # the parent: no K4 kernel; no peak for the device
    assert read(ctx_of(events, [("gemm", 1.0, 1.9)])) is None
    assert read(ctx_of(events, k4, kind="cpu")) is None
    assert read(ctx_of([], k4)) is None
