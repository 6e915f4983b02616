"""The readings of the program's own timeline on hand-built traced windows:
each gives the number worked out by hand, and None where the run holds
nothing to read (no traced window, no timeline, no span, no peak)."""

import pytest

from fastvlm_tpu_torch.timeline import Timeline
from port_bench import flops, harness, loadgen, program_timeline
from port_bench.tests.test_pb_readings import CFG, H100, Device, ctx_of

IMAGE = flops.tower_flops(CFG) + flops.projector_flops(CFG)


def span(tl, name, t0, t1, device=None, parent=None, **attrs):
    sp = tl.open(name, **attrs)
    tl.close(sp)
    sp.t0, sp.t1, sp.device, sp.parent = t0, t1, device, parent
    return sp


def burst_records(bursts):
    """Records of requests due at each burst's start whose first tokens
    come at its end."""
    recs = []
    for g, (due, first) in enumerate(bursts):
        rec = loadgen.Record(loadgen.Request(g, "p", 0, 2, due=due, group=g),
                             due, due)
        rec.updates = [(first, {"text": "1", "stats": {}})]
        recs.append(rec)
    return recs


def window(kernels=(), records=(), kind=H100):
    """Two bursts (due 1.0 and 5.0) and their spans: gathered batches of 4
    real rows padded to 4 and of 3 padded to 4, an admission; a burst
    after the window (t1 = 10)."""
    tl = Timeline()
    span(tl, "sched.prepare", 1.02, 1.03)
    p1 = span(tl, "sched.prefill", 1.03, 1.2, (1.04, 1.19), kind="batch",
              images=4)
    span(tl, "vlm.encode", 1.03, 1.05, (1.04, 1.08), parent=p1.id, images=4)
    span(tl, "sched.prepare", 5.02, 5.05)
    p2 = span(tl, "sched.prefill", 5.05, 5.2, (5.06, 5.16), kind="batch",
              images=3)
    span(tl, "vlm.encode", 5.05, 5.06, (5.06, 5.1), parent=p2.id, images=4)
    p3 = span(tl, "sched.prefill", 6.0, 6.1, (6.0, 6.05), kind="admit",
              images=1)
    span(tl, "vlm.encode", 6.0, 6.01, (6.0, 6.01), parent=p3.id, images=1)
    span(tl, "sched.prepare", 11.0, 11.5)
    span(tl, "sched.prefill", 11.5, 12.0, (11.5, 11.9), kind="batch",
         images=1)
    c = ctx_of([], list(kernels), records, kind=kind)
    c.program_timeline = tl
    return c


def test_prep_ms_is_the_mean_host_time_in_the_window():
    assert program_timeline.prep_ms(window()) == pytest.approx(
        1000 * (0.01 + 0.03) / 2)


def test_prefill_launches_counts_kernels_started_in_each_batch_prefill():
    ks = [("gemm", 1.05, 1.06), ("gemm", 1.1, 1.2),    # 2 in the first
          ("Memcpy HtoD (Pageable -> Device)", 1.07, 1.08),  # a copy
          ("gemm", 1.03, 1.045),                       # started before
          ("gemm", 5.07, 5.08), ("gemm", 5.09, 5.1), ("gemm", 5.15, 5.16),
          ("gemm", 6.01, 6.02),                        # the admission's
          ("gemm", 11.6, 11.7)]                        # after the window
    assert program_timeline.prefill_launches(window(ks)) == \
        pytest.approx((2 + 3) / 2)


def test_burst_idle_launch_ms_inside_the_batch_prefills():
    # first prefill (1.04, 1.19): busy 1.04-1.15 -> idle 0.04 s; second
    # (5.06, 5.16) cut at its burst's first token 5.12: busy 5.06-5.1 ->
    # idle 0.02 s; the third burst has no gathered prefill
    ks = [("k", 1.0, 1.1), ("k", 1.1, 1.15), ("k", 5.0, 5.1),
          ("Memcpy HtoD", 5.2, 5.3)]
    recs = burst_records([(1.0, 1.3), (5.0, 5.12), (8.0, 8.2)])
    c = window(ks, recs)
    assert program_timeline.burst_idle_launch_ms(c) == pytest.approx(
        1000 * (0.04 + 0.02) / 3)


def test_encode_mfu_counts_real_images_only():
    # the padding row of the second batch adds nothing; the admission's
    # image counts; the batch after the window does not
    work = (4 + 3 + 1) * IMAGE
    seconds = 0.04 + 0.04 + 0.01
    got = program_timeline.encode_mfu(window())
    assert got == pytest.approx(
        100 * work / (seconds * flops.PEAKS[H100]["bf16_flops"]))
    assert 0 < got < 100


def test_nothing_to_read_gives_none(monkeypatch):
    readers = (program_timeline.prep_ms, program_timeline.prefill_launches,
               program_timeline.burst_idle_launch_ms,
               program_timeline.encode_mfu)
    recs = burst_records([(1.0, 1.3)])
    # no traced window
    c = window(records=recs)
    c.device = None
    assert all(f(c) is None for f in readers)
    # a traced window without the program's timeline
    c = harness.Ctx({"name": "c"}, CFG, {}, recs, 0.0, 10.0, H100, None,
                    Device([]))
    c.program_timeline = None
    assert all(f(c) is None for f in readers)
    # a device trace with no records
    c = window([], recs)
    assert program_timeline.prefill_launches(c) is None
    assert program_timeline.burst_idle_launch_ms(c) is None
    # a timeline with nothing in the window
    c = window(records=recs)
    c.t0, c.t1 = 20.0, 30.0
    assert all(f(c) is None for f in readers)
    # no peak for the device
    assert program_timeline.encode_mfu(window(kind="cpu")) is None
    # no profiled timeline in the process
    monkeypatch.setattr("fastvlm_tpu_torch.timeline._PROFILED", [])
    c = harness.Ctx({"name": "c"}, CFG, {}, recs, 0.0, 10.0, H100, None,
                    Device([]))
    assert program_timeline.timeline(c) is None
    assert c.program_timeline is None


def test_the_latest_profiled_timeline_is_resolved_once(monkeypatch):
    class Profiled(Timeline):
        resolved = 0

        def resolve(self):
            self.resolved += 1

    old, new = Profiled(), Profiled()
    monkeypatch.setattr("fastvlm_tpu_torch.timeline._PROFILED", [old, new])
    c = harness.Ctx({"name": "c"}, CFG, {}, [], 0.0, 10.0, H100, None,
                    Device([]))
    assert program_timeline.timeline(c) is new
    assert program_timeline.timeline(c) is new
    assert (old.resolved, new.resolved) == (0, 1)
