"""The port's scheduler with the JAX scheduler's dense views of the pool
(fastvlm_tpu_torch/serve/batcher.py: ``chunk_view``, ``persist_view``,
``pipeline_depth``) on the CPU, mirroring the ``persist`` cases of
tests/test_batcher.py, tests/test_chunked_prefill.py and
tests/test_serving.py: the same traffic goes through the port's scheduler
and the JAX scheduler with the same knobs, and the greedy ids must be equal
(and, where the JAX test says so, the serial engine's); the view counters
show the views ran, and every page comes back.

The persist cases run at JAX's default ``pipeline_depth=2``. The tiny f32
engines share one numpy-drawn tree (tests/torch_tiny.py), EOS is
unreachable so every request runs to its cap, and each request carries a
128 px image. Caps are cut from the JAX tests' 256-384 to 96-160 tokens;
each case still decodes several chunks after its late request joins."""

import threading

import pytest

from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.serve import batcher as jbatcher
from fastvlm_tpu_torch.models import vlm
from fastvlm_tpu_torch.serve import worker as tworker
from fastvlm_tpu_torch.serve.batcher import BatchScheduler

import torch_tiny as tt

JOIN_S = 180
MODES = {"persist": dict(persist_view=True, pipeline_depth=2),
         "chunkview": dict(chunk_view=True, persist_view=False)}
MODE_IDS = list(MODES)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine), EOS unreachable."""
    return tt.engines(tt.draw_weights(), eos_ids=(-1,))


class Client:
    """One request on its own thread; ``decoding`` is set once a decode
    chunk has landed (its second update)."""

    def __init__(self, sched, eng, prompt, seed, cap):
        self.updates = []
        self.decoding = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(
            sched, eng.build_prompt(prompt), tt.image(seed), cap))
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
        assert self.updates, "stream closed with no update"
        return self.updates[-1]

    def text(self):
        last = self.result()
        assert "error" not in last, last
        return last["text"]


def _pool_clean(sched):
    """Every page free once the loop thread has stopped, the prefix
    registry's pins released first."""
    sched.shutdown()
    if sched.prefix is not None:
        sched.prefix.clear()
    return sched.pool.free_pages == sched.pool.num_pages


def _both(engines, scenario, **knobs):
    """``scenario(sched, eng)`` through the port's scheduler and the JAX
    scheduler built with ``knobs``: {"port" / "jax": (its result, its
    counters)}; each pool must come back whole."""
    je, te = engines
    out = {}
    for name, eng, make in (("port", te, BatchScheduler),
                            ("jax", je, jbatcher.BatchScheduler)):
        sched = make(eng, paged=True, **knobs)
        try:
            got = scenario(sched, eng)
            assert _pool_clean(sched), name
        finally:
            sched.shutdown()
        out[name] = (got, dict(sched.counters))
    assert out["port"][0] == out["jax"][0], (out["port"][0], out["jax"][0])
    return out


def _serial(eng, prompt, seed, cap):
    return eng.chat(prompt, tt.image(seed), max_new_tokens=cap)[0]


def _views_ran(counters, mode):
    if mode == "persist":
        assert counters["view_gathers"] >= 1, counters
    assert counters["chunks"] >= 1, counters


@pytest.mark.parametrize("mode", MODE_IDS)
def test_continuous_admission_into_free_slot(engines, mode):
    """A request arriving after the batch started joins at a chunk boundary
    (a free slot of the b=4 bucket), gives the serial ids and finishes
    first."""
    def scenario(sched, eng):
        longs = [Client(sched, eng, p, i, 160)
                 for i, p in enumerate(["alpha", "beta gamma", "delta"])]
        assert longs[0].decoding.wait(JOIN_S)
        late = Client(sched, eng, "quick question", 9, 4)
        last = late.result()
        assert last["stats"]["batch_size"] >= 2
        assert all(c.thread.is_alive() for c in longs)
        return [last["text"]] + [c.text() for c in longs]

    out = _both(engines, scenario, window_ms=300, page_size=16,
                **MODES[mode])
    texts, counters = out["port"]
    assert texts[0] == _serial(engines[1], "quick question", 9, 4)
    assert counters["admitted"] == 1
    _views_ran(counters, mode)


@pytest.mark.parametrize("mode", MODE_IDS)
def test_admission_into_slot_freed_by_finished_row(engines, mode):
    """A row that finishes returns its slot; a queued request admits into
    it mid-batch, gives the serial ids and finishes before the long row."""
    def scenario(sched, eng):
        long = Client(sched, eng, "the long one", 6, 160)
        Client(sched, eng, "m", 7, 3).result()
        s = Client(sched, eng, "short follow-up", 5, 5).text()
        assert long.thread.is_alive()
        return [s, long.text()]

    out = _both(engines, scenario, window_ms=300, page_size=16,
                **MODES[mode])
    assert out["port"][0][0] == _serial(engines[1], "short follow-up", 5, 5)
    _views_ran(out["port"][1], mode)


def test_admission_retains_persistent_view(engines):
    """An admission into a free slot of a live persistent view refreshes
    that row only (``view_row_updates``) and regathers at most once (the
    long rows' own growth), as in the JAX scheduler."""
    def scenario(sched, eng):
        longs = [Client(sched, eng, p, i, 96)
                 for i, p in enumerate(["alpha", "beta gamma", "delta"])]
        assert longs[0].decoding.wait(JOIN_S)
        before = sched.counters["view_gathers"]
        late = Client(sched, eng, "quick", 9, 4).text()
        texts = [late] + [c.text() for c in longs]
        assert sched.counters["view_row_updates"] >= 1, sched.counters
        assert sched.counters["view_gathers"] - before <= 1, sched.counters
        return texts

    out = _both(engines, scenario, window_ms=300, page_size=16,
                **MODES["persist"])
    c = out["port"][1]
    assert c["view_syncs"] >= 1 and not c.get("view_dropped_stale"), c


@pytest.mark.parametrize("mode", MODE_IDS)
def test_batch_grows_for_late_request(engines, mode):
    """One long request owns a b=1 bucket; a late arrival grows the batch
    (1 -> 2) and joins, and the shrink back to b=1 afterwards flushes the
    persistent view before it compacts the rows."""
    def scenario(sched, eng):
        long = Client(sched, eng, "the epic", 10, 160)
        assert long.decoding.wait(JOIN_S)
        late = Client(sched, eng, "but why", 8, 4).text()
        assert long.thread.is_alive()
        assert sched.counters["grown"] >= 1, sched.counters
        return [late, long.text()]

    out = _both(engines, scenario, window_ms=20, page_size=16,
                **MODES[mode])
    texts, counters = out["port"]
    assert texts[0] == _serial(engines[1], "but why", 8, 4)
    assert counters["admitted"] >= 1 and counters["shrunk"] >= 1, counters


@pytest.mark.parametrize("mode", MODE_IDS)
def test_batch_shrinks_after_rows_finish(engines, mode):
    """When most rows finish, the batch re-buckets down and the long row's
    ids stay the serial ones."""
    def scenario(sched, eng):
        clients = [Client(sched, eng, p, s, cap) for p, s, cap in
                   [("endless story", 11, 96), ("a", 12, 3), ("bb", 13, 3),
                    ("ccc", 14, 3)]]
        return [c.text() for c in clients]

    out = _both(engines, scenario, window_ms=300, page_size=16,
                **MODES[mode])
    texts, counters = out["port"]
    assert texts[0] == _serial(engines[1], "endless story", 11, 96)
    assert counters["shrunk"] >= 1, counters


@pytest.mark.parametrize("mode", MODE_IDS)
def test_prefix_cache_admission_matches_serial(engines, mode):
    """A request admitted after one with the same long template hits the
    prefix cache (its suffix prefilled over the shared pages, which the
    view was synced before) and gives the serial ids."""
    base = "please describe the picture in great detail " * 4
    p1, p2 = base + "first", base + "and also the second one"

    def scenario(sched, eng):
        a = Client(sched, eng, p1, 1, 48)
        assert a.decoding.wait(JOIN_S)
        b = Client(sched, eng, p2, 2, 6).text()
        return [a.text(), b]

    out = _both(engines, scenario, window_ms=20, page_size=16,
                prefix_cache=True, **MODES[mode])
    texts, counters = out["port"]
    assert texts == [_serial(engines[1], p1, 1, 48),
                     _serial(engines[1], p2, 2, 6)]
    assert counters["prefix_hits"] >= 1, counters
    assert counters["prefix_hit_tokens"] >= 16, counters


@pytest.mark.parametrize("mode", MODE_IDS)
def test_paged_pool_recovers_after_batch_failure(engines, monkeypatch, mode):
    """A failed decode dispatch (the mode's own: ``decode_chunk`` on the
    persistent view, ``decode_chunk_paged`` for the chunk view) fails the
    batch, drops the pool and returns every page, in both schedulers; the
    next request is served with the serial ids and JAX's."""
    name = "decode_chunk" if mode == "persist" else "decode_chunk_paged"
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("injected decode failure")

    def scenario(sched, eng):
        module = vlm if isinstance(sched, BatchScheduler) else jvlm
        with monkeypatch.context() as m:
            m.setattr(module, name, boom)
            updates = list(sched.submit(eng.build_prompt("fail me"),
                                        tt.image(0), max_new_tokens=8))
        assert any("error" in u for u in updates), updates
        assert sched._pool_kv is None  # dropped, not reused
        assert sched.pool.free_pages == sched.pool.num_pages
        updates = list(sched.submit(eng.build_prompt("recover"), tt.image(1),
                                    max_new_tokens=6))
        return [updates[-1]["text"]]

    out = _both(engines, scenario, window_ms=5, page_size=16,
                pool_tokens=4096, **MODES[mode])
    assert calls["n"] == 2  # once in each scheduler
    assert out["port"][0] == [_serial(engines[1], "recover", 1, 6)]


def test_pipelined_steady_groups_match_serial(engines):
    """With nothing waiting, the persistent view dispatches 2 chunks a
    host read; the ids stay the serial ones and the groups engage."""
    def scenario(sched, eng):
        return [Client(sched, eng, "a very long story", 3, 96).text()]

    out = _both(engines, scenario, window_ms=10, page_size=16,
                **MODES["persist"])
    assert out["port"][0] == [_serial(engines[1], "a very long story", 3,
                                      96)]
    assert out["port"][1]["pipelined_groups"] >= 2, out["port"][1]
    assert out["jax"][1]["pipelined_groups"] >= 2, out["jax"][1]


def test_pipelined_depth_collapses_when_request_waits(engines):
    """A request arriving mid-generation still admits at a chunk boundary:
    depth collapses to 1 while it waits."""
    def scenario(sched, eng):
        long = Client(sched, eng, "the saga", 4, 160)
        assert long.decoding.wait(JOIN_S)
        late = Client(sched, eng, "quick", 9, 4).text()
        assert sched.counters["admitted"] >= 1, sched.counters
        return [late, long.text()]

    out = _both(engines, scenario, window_ms=10, page_size=16,
                **MODES["persist"])
    assert out["port"][0][0] == _serial(engines[1], "quick", 9, 4)
    assert out["port"][1]["pipelined_groups"] >= 1, out["port"][1]


@pytest.mark.parametrize("mode", MODE_IDS)
def test_chunked_admission_matches_serial(engines, mode):
    """Two late long-prompt requests admit in 8-token chunks while a long
    row decodes (the second also grows the batch while the first may still
    be mid-prefill); the activation flushes the view first. The ids are the
    serial ones."""
    long_prompt = ("please describe every detail of the scene in front of "
                   "you and then summarize it in one sentence")
    late2 = "and what about the weather tomorrow in the mountains?"

    def scenario(sched, eng):
        anchor = Client(sched, eng, "the anchor row", 0, 160)
        assert anchor.decoding.wait(JOIN_S)
        c1 = Client(sched, eng, long_prompt, 1, 5)
        c2 = Client(sched, eng, late2, 2, 4)
        return [c1.text(), c2.text(), anchor.text()]

    out = _both(engines, scenario, window_ms=100, page_size=16,
                prefill_chunk=8, max_pending=2, **MODES[mode])
    texts, counters = out["port"]
    assert texts[:2] == [_serial(engines[1], long_prompt, 1, 5),
                         _serial(engines[1], late2, 2, 4)]
    assert counters["chunked_admissions"] >= 1, counters
    assert counters["prefill_chunks"] >= 2, counters


def test_soak_concurrent_mixed_requests_persist_view(engines):
    """tests/test_serving.py's soak at the JAX worker's default view: 16
    concurrent mixed-length requests through ``ModelWorker(persist_view=
    True)`` and a pool small enough that exhaustion truncation fires. Every
    stream ends cleanly, every output is a prefix of (when not truncated,
    equal to) the serial engine's, the pool comes back whole."""
    _, te = engines
    prompts = [f"describe item {i}" for i in range(8)]
    page = 8
    ln = te.prepare(te.build_prompt(prompts[0]),
                    tt.image(100))["prompt_tokens"]
    pool_pages = 8 * (-(-ln // page)) + 6
    w = tworker.ModelWorker(te, "tiny", continuous_batching=True,
                            page_size=page, pool_tokens=pool_pages * page,
                            persist_view=True)
    sched = w.scheduler
    assert sched.persist_view and sched.pipeline_depth == 1
    plans = [(i % 8, (16, 64)[i % 2]) for i in range(16)]
    results = [None] * len(plans)

    def run(n, i, cap):
        last = None
        for last in sched.submit(te.build_prompt(prompts[i]),
                                 tt.image(100 + i), max_new_tokens=cap):
            pass
        results[n] = last

    threads = [threading.Thread(target=run, args=(n, *p))
               for n, p in enumerate(plans)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sched.shutdown()
    truncated = 0
    for (i, cap), last in zip(plans, results):
        assert last is not None and "error" not in last, last
        want = _serial(te, prompts[i], 100 + i, cap)
        assert want.startswith(last["text"]), (i, cap, last, want)
        if last["stats"]["finish_reason"] == "truncated":
            truncated += 1
        else:
            assert last["text"] == want, (i, cap, last, want)
    assert sched.pool.free_pages == sched.pool.num_pages
    assert sched.pool.min_free <= pool_pages // 6, sched.pool.min_free
    assert sched.counters["view_gathers"] >= 1, dict(sched.counters)
