"""The serving path's timeline (fastvlm_tpu_torch/timeline.py) on the CPU:

  * a gathered burst records sched.gather -> sched.prepare (one
    engine.prepare a request) -> sched.prefill (vlm.encode, vlm.decoder)
    -> sched.first_token, with the right parents and request ids, each
    child inside its parent's host interval;
  * an admission and an admission chunk record their own sched.prefill;
  * off, the scheduler records nothing, makes no span and no timing event,
    and serves the same tokens as with the timeline on;
  * device intervals resolved through the two anchors follow the host's
    clock under a drifting device clock;
  * a scheduler whose trace is off keeps a timeline while torch.profiler
    records, and drops it after.

A tiny random f32 engine, a tokenizer whose text is the token ids, EOS
unreachable (answers run to their caps)."""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from fastvlm_tpu_torch import engine, timeline
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.serve.batcher import BatchScheduler

JOIN_S = 120
TOP = ("sched.gather", "sched.prepare", "sched.prefill", "sched.first_token")


class IdTokenizer(preprocessing.ByteTokenizer):
    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def eng():
    torch.manual_seed(0)
    e = engine.build_engine(random_tiny=True, device="cpu", dtype="float32",
                            eos_ids=(-1,))
    e.tokenizer = IdTokenizer()
    return e


def _image(seed):
    s = engine.tiny_config().vision.image_size
    return np.random.RandomState(seed).randint(0, 256, (s, s, 3),
                                               dtype=np.uint8)


class Client:
    """One request on its own thread; ``decoding`` is set once its second
    update (a decode chunk) has landed."""

    def __init__(self, sched, eng, prompt, seed, cap):
        self.updates = []
        self.decoding = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(
            sched, eng.build_prompt(prompt), _image(seed), cap))
        self.thread.start()

    def _run(self, sched, prompt, image, cap):
        for u in sched.submit(prompt, image, max_new_tokens=cap):
            self.updates.append(u)
            if len(self.updates) >= 2:
                self.decoding.set()
        self.decoding.set()

    def result(self):
        self.thread.join(timeout=JOIN_S)
        assert not self.thread.is_alive(), "request did not finish"
        assert self.updates and "error" not in self.updates[-1], self.updates
        return self.updates[-1]["text"]


def _burst(eng, trace, n=3):
    """``n`` requests gathered into one batch; their texts."""
    sched = BatchScheduler(eng, window_ms=300, page_size=16)
    sched.trace = trace
    try:
        clients = [Client(sched, eng, f"question {i}", i, 3)
                   for i in range(n)]
        return [c.result() for c in clients]
    finally:
        sched.shutdown()


class FakeDevice:
    """A device clock that runs ``drift`` faster than the host's, ``lag``
    seconds behind the launches recorded on it."""

    def __init__(self, drift=0.0, lag=0.0):
        self.drift, self.lag = drift, lag
        self.h0 = time.perf_counter()
        self.made = 0

    def event(self):
        self.made += 1
        return FakeEvent(self)


class FakeEvent:
    def __init__(self, dev):
        self.dev, self.t = dev, None

    def record(self):
        dev = self.dev
        self.t = (time.perf_counter() + dev.lag - dev.h0) * (1 + dev.drift)

    def synchronize(self):
        pass

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _batch_ended(tl):
    """Wait until the batch has ended: the next request meets a gather,
    not an admission."""
    deadline = time.time() + JOIN_S
    while "batch_end" not in [e[1] for e in tl]:
        assert time.time() < deadline
        time.sleep(0.005)


def _inside(child, parent):
    return parent.t0 <= child.t0 and child.t1 <= parent.t1


def test_gathered_burst_spans_in_order(eng):
    tl = timeline.Timeline()
    _burst(eng, tl)
    top = [s for s in tl.spans if s.parent is None]
    assert [s.name for s in top] == list(TOP)
    gather, prep, prefill, first = top
    ids = gather.requests
    assert sorted(ids) == [0, 1, 2]
    assert prep.requests == prefill.requests == first.requests == ids
    for a, b in zip(top, top[1:]):
        assert a.t1 <= b.t0
    kids = {s.id: [c for c in tl.spans if c.parent == s.id] for s in top}
    assert [c.name for c in kids[prep.id]] == ["engine.prepare"] * 3
    assert sorted(c.requests for c in kids[prep.id]) == [(0,), (1,), (2,)]
    assert [c.name for c in kids[prefill.id]] == ["vlm.encode", "vlm.decoder"]
    assert not kids[gather.id] and not kids[first.id]
    for s in top:
        assert all(_inside(c, s) for c in kids[s.id])
    assert prep.attrs == {"rows": 3, "padded": 4}
    prompts = [eng.prepare(eng.build_prompt(f"question {i}"),
                           _image(i))["prompt_tokens"] for i in range(3)]
    assert prefill.attrs == {"kind": "batch", "rows": 3, "padded": 4,
                             "tokens": sum(prompts), "cached": 0,
                             "images": 3}
    assert kids[prefill.id][0].attrs == {"images": 4}  # the padding row too
    # a CPU timeline has no timing events: no device interval
    assert all(s.events is None and s.device is None for s in tl.spans)
    assert [e[1] for e in tl][0] == "batch_start"


@pytest.mark.parametrize("kind,chunk", [("admit", 0), ("chunk", 8)])
def test_admission_records_its_own_prefill(eng, kind, chunk):
    sched = BatchScheduler(eng, window_ms=5, page_size=16,
                           prefill_chunk=chunk)
    tl = sched.trace = timeline.Timeline()
    try:
        anchor = Client(sched, eng, "the anchor row", 1, 256)
        assert anchor.decoding.wait(JOIN_S)
        Client(sched, eng, "a late question about the image", 2, 2).result()
        anchor.result()
    finally:
        sched.shutdown()
    late = [s for s in tl.of("sched.prefill") if s.attrs["kind"] == kind]
    assert late and all(s.requests == (1,) and s.parent is None
                        for s in late)
    assert sum(s.attrs["images"] for s in late) == 1
    if kind == "chunk":
        assert len(late) >= 2
        assert [s.attrs["cached"] for s in late] == sorted(
            s.attrs["cached"] for s in late)
    for s in late:
        kids = [c.name for c in tl.spans if c.parent == s.id]
        assert kids[-1] == "vlm.decoder" and kids.count("vlm.encode") \
            == s.attrs["images"]


def test_off_records_nothing_and_serves_the_same_tokens(eng, monkeypatch):
    dev = FakeDevice()
    on = timeline.Timeline(timer=dev.event)
    want = _burst(eng, on)
    assert dev.made > 0 and all(s.events for s in on.of("sched.prefill"))
    on.resolve()
    assert all(s.device is not None for s in on.spans if s.events)

    spans = collections.Counter()

    class Counted(timeline.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            spans[a[0]] += 1
            super().__init__(*a, **kw)

    def no_event(*a, **kw):
        raise AssertionError("a timing event was made with tracing off")

    monkeypatch.setattr(timeline, "Span", Counted)
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    assert _burst(eng, None) == want
    assert not spans
    assert _burst(eng, timeline.Timeline()) == want
    assert spans["sched.prefill"] == 1


def test_resolved_intervals_follow_the_host_clock():
    lag = 0.004
    dev = FakeDevice(drift=0.05)  # an anchor meets an idle device
    tl = timeline.Timeline(timer=dev.event)
    dev.lag = lag
    for i in range(6):
        sp = tl.open("work", device=True)
        time.sleep(0.01)
        tl.close(sp)
        time.sleep(0.005)
    dev.lag = 0.0
    time.sleep(0.01)
    tl.resolve()
    spans = tl.of("work")
    eps = 1e-6
    for sp in spans:
        s, e = sp.device
        assert sp.t0 - eps <= s <= e <= sp.t1 + lag + eps
    starts = [sp.device[0] for sp in spans]
    assert starts == sorted(starts)
    assert tl.drift_s == pytest.approx(0.05 * tl.anchor_span_s, rel=1e-2)
    # a second resolve reads the same anchors
    before = [sp.device for sp in spans]
    tl.resolve()
    assert [sp.device for sp in spans] == before


def test_a_scheduler_keeps_a_timeline_while_a_profiler_records(
        eng, monkeypatch):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert timeline.profiler_on()
    assert not timeline.profiler_on()

    recording = [True]
    monkeypatch.setattr(timeline, "profiler_on", lambda: recording[0])
    monkeypatch.setattr(timeline, "_PROFILED", collections.deque(maxlen=4))
    sched = BatchScheduler(eng, window_ms=5, page_size=16)
    try:
        Client(sched, eng, "while profiled", 3, 2).result()
        tl = sched.trace
        assert tl is not None and tl.follows_profiler
        assert timeline.profiled() == [tl]
        assert [s.name for s in tl.spans if s.parent is None] == list(TOP)
        _batch_ended(tl)
        recording[0] = False
        Client(sched, eng, "after the profile", 4, 2).result()
        assert sched.trace is None
        assert len(tl.of("sched.prefill")) == 1
    finally:
        sched.shutdown()
    # a trace set by hand is kept whatever the profiler does
    recording[0] = True
    sched = BatchScheduler(eng, window_ms=5, page_size=16)
    mine = sched.trace = timeline.Timeline()
    try:
        Client(sched, eng, "traced by hand", 5, 2).result()
        _batch_ended(mine)
        recording[0] = False
        Client(sched, eng, "still traced", 6, 2).result()
    finally:
        sched.shutdown()
    assert sched.trace is mine and len(mine.of("sched.prefill")) == 2
    assert timeline.profiled() == [tl]
