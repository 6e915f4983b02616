"""The per-layer readings on a made-up traced window: kernels attributed
to the calls that launched them, shares against hand counts, nothing read
where nothing is there."""

import json
import os

import pytest

from port_bench import family, flops, harness, loadgen, readings, trace

PB = os.path.dirname(os.path.dirname(__file__))
CFG = json.load(open(os.path.join(PB, "configs", "fastvlm-1.5b.json")))
H100 = "NVIDIA H100 80GB HBM3"


class Device:
    def __init__(self, kernels):
        self.kernels = sorted(kernels, key=lambda k: k[1])

    def matching(self, pattern):
        import re
        return [k for k in self.kernels if re.search(pattern, k[0])]


def ctx_of(events, kernels, records=(), t0=0.0, t1=10.0, kind=H100):
    spans = trace.Spans()
    spans.events.extend(events)
    return harness.Ctx({"name": "c"}, CFG, {}, list(records), t0, t1, kind,
                       spans, Device(kernels))


def test_inside_takes_the_kernels_a_call_launched():
    spans = [("prefill", 1.0, 2.0, {}), ("prefill", 5.0, 6.0, {})]
    ks = [("a", 0.5, 0.6), ("b", 1.5, 1.7), ("c", 2.5, 2.6), ("d", 5.0, 5.1)]
    assert [k[0] for k in trace.inside(ks, spans)] == ["b", "d"]


def test_k1_roofline_by_hand():
    peak = flops.PEAKS[H100]
    bound = flops.k1_encode_bound_s(CFG, 2, peak)
    events = [("prefill", 1.0, 2.0, {"lens": [400, 400], "starts": [47, 47],
                                     "offset": 0, "images": True}),
              ("encode", 1.1, 1.1, {"images": 2}),
              ("prefill", 11.0, 12.0, {"lens": [400], "starts": [47],
                                       "offset": 0, "images": True}),
              ("encode", 11.1, 11.1, {"images": 1})]
    k1 = [("void ffn_fused_kernel<96>(x)", 1.2, 1.2 + 2 * bound),
          ("ffn_gemm_kernel", 11.2, 11.3)]  # after the window
    c = ctx_of(events, k1 + [("gemm", 1.0, 1.9)])
    assert readings.k1_roofline(c) == pytest.approx(50.0)
    # the prefill's model work over its 1 s wall
    work = 2 * (flops.tower_flops(CFG) + flops.projector_flops(CFG)
                + family.of(CFG).flops(CFG, 400))
    assert readings.prefill_mfu(c) == pytest.approx(
        100 * work / peak["bf16_flops"])
    assert readings.k1_roofline(ctx_of(events, k1, kind="cpu")) is None
    assert readings.k1_roofline(ctx_of(events, [])) is None


def test_burst_idle_time_between_due_and_first_tokens():
    # two bursts: due at 1 and 5; first tokens at 1.5 / 1.8 and 5.4
    recs = []
    for i, (due, first, group) in enumerate(
            [(1.0, 1.5, 0), (1.0, 1.8, 0), (5.0, 5.4, 1)]):
        rec = loadgen.Record(loadgen.Request(i, "p", 0, 2, due=due,
                                             group=group), due, due)
        rec.updates = [(first, {"text": "1", "stats": {}})]
        recs.append(rec)
    ks = [("k", 1.1, 1.3), ("k", 1.2, 1.4), ("k", 5.3, 5.6), ("k", 7, 8)]
    c = ctx_of([], ks, recs)
    # burst 0: 0.8 s, busy 1.1-1.4; burst 1: 0.4 s, busy 5.3-5.4
    assert readings.burst_idle_ms(c) == pytest.approx(
        1000 * ((0.8 - 0.3) + (0.4 - 0.1)) / 2)
    assert readings.busy_s(c) == pytest.approx(0.3 + 0.3 + 1.0)
    assert readings.burst_idle_ms(ctx_of([], ks, [])) is None


def test_cached_share_from_updates():
    req = loadgen.Request(0, loadgen.render("s", "q"), 0, 5)
    rec = loadgen.Record(req, 0.0, 0.0)
    rec.updates = [(1.0, {"text": "1", "stats": {}}),
                   (1.4, {"text": "1,2,3,4,5",
                          "stats": {"cached_tokens": 64}})]
    c = ctx_of([], [], [rec])
    n = len(loadgen.prompt_ids(req.prompt, 256)[0])
    assert readings.cached_share(c) == pytest.approx(100 * 64 / n)
