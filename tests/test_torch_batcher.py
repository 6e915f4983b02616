"""The port's continuous-batching scheduler (fastvlm_tpu_torch/serve/
batcher.py) on the CPU, mirroring tests/test_batcher.py's names for what is
ported: batched greedy ids equal the port's serial ``Engine.chat`` and the
JAX engine's; concurrent requests share one decode loop over the paged pool
(kernel K3's plain version here); admission, grow, shrink, pool exhaustion,
cancellation, page accounting; speculative chunks (``spec=True``) give the
greedy ids, switch off when a second row joins and are banned at low
acceptance; anyres and multi-image requests take the serial path, the
fairness drain serves a deferred one under a steady stream, and window
batching (``continuous=False``) admits nothing and gives the JAX
scheduler's ids; the view knobs give the JAX scheduler's ids with the
same knobs (tests/test_torch_batcher_views.py has the views' own cases);
a batch whose prompts the pool cannot hold runs on a dense cache of its
own, as in the JAX scheduler; per-row sampling masks agree with the JAX
package's.

Tiny f32 engines built from the same numpy-drawn weights (utils/convert.py),
a tokenizer whose text is the token ids, and 128 px images (4 image
tokens), so every request carries an image. Waits are on events and bounded
joins; the window sleeps of the JAX tests are replaced by a wide gather
window."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import sampling as jsampling
from fastvlm_tpu.serve import batcher as jbatcher
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.ops import sampling
from fastvlm_tpu_torch.serve.batcher import BatchScheduler, PagePool
from fastvlm_tpu_torch.timeline import Timeline
from fastvlm_tpu_torch.utils.convert import from_jax_params

JOIN_S = 120


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def _tiny(pkg, **extra):
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=128, attn_head_dim=16,
                               **extra.get("vision", {}))
    decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              intermediate_size=128,
                              **extra.get("decoder", {}))
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=64))


@pytest.fixture(scope="module")
def weights():
    """Numpy-drawn weights of the JAX init's shapes (as
    tests/test_torch_engine.py): norm scales near 1, the decoder's matrices
    and embeddings N(0, 0.2) so the tiny decoder does not just echo."""
    jc = _tiny(jcfg, vision={"ffn_backend": "pallas"},
               decoder={"attn_backend": "pallas"})
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if path[0].key == "decoder" and leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    return jc, jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def eng(weights):
    tok = IdTokenizer()
    tc = _tiny(tcfg)
    return engine.Engine(tc, from_jax_params(weights[1], tc), tok,
                         eos_ids=(tok.eos_token_id,))


@pytest.fixture(scope="module")
def eng_noeos(weights):
    """EOS unreachable: generation always runs to its cap, so batch
    lifetimes are deterministic."""
    tc = _tiny(tcfg)
    return engine.Engine(tc, from_jax_params(weights[1], tc), IdTokenizer(),
                         eos_ids=(-1,))


@pytest.fixture(scope="module")
def eng_anyres(weights):
    """The tiny engine under an anyres spatial_unpad config (128 px tiles,
    grids up to 2 x 2), with a numpy-drawn ``image_newline``."""
    tok = IdTokenizer()
    tc = dataclasses.replace(
        _tiny(tcfg), image_aspect_ratio="anyres",
        image_grid_pinpoints=((256, 128), (128, 256), (256, 256)),
        mm_patch_merge_type="spatial_unpad")
    params = from_jax_params(weights[1], tc)
    params["image_newline"] = torch.from_numpy(
        np.random.RandomState(1).randn(64).astype(np.float32) / 8)
    return engine.Engine(tc, params, tok, eos_ids=(tok.eos_token_id,))


def _image(seed):
    return np.random.RandomState(seed).randint(0, 256, (128, 128, 3),
                                               dtype=np.uint8)


def _ids(text):
    return [int(x) for x in text.split(",") if x]


class Client:
    """One request on its own thread; ``first`` is set at its first update,
    ``decoding`` once a decode chunk has landed (its second update)."""

    def __init__(self, sched, eng, prompt, seed, cap, **kw):
        self.updates = []
        self.first = threading.Event()
        self.decoding = threading.Event()
        self.thread = threading.Thread(
            target=self._run,
            args=(sched, eng.build_prompt(prompt), _image(seed), cap, kw))
        self.thread.start()

    def _run(self, sched, prompt, image, cap, kw):
        for u in sched.submit(prompt, image, max_new_tokens=cap, **kw):
            self.updates.append(u)
            self.first.set()
            if len(self.updates) >= 2:
                self.decoding.set()
        self.first.set()
        self.decoding.set()

    def result(self):
        self.thread.join(timeout=JOIN_S)
        assert not self.thread.is_alive(), "request did not finish"
        assert self.updates, "stream closed with no update"
        last = self.updates[-1]
        assert "error" not in last, last
        return last


class Request:
    """One request with any image (a PIL image, an array, a list) on its own
    thread."""

    def __init__(self, sched, prompt, image, cap):
        self.updates = []
        self.thread = threading.Thread(target=self._run,
                                       args=(sched, prompt, image, cap))
        self.thread.start()

    def _run(self, sched, prompt, image, cap):
        for u in sched.submit(prompt, image, max_new_tokens=cap):
            self.updates.append(u)

    def result(self):
        self.thread.join(timeout=JOIN_S)
        assert not self.thread.is_alive(), "request did not finish"
        assert self.updates and "error" not in self.updates[-1], self.updates
        return self.updates[-1]


def _pool_clean(sched):
    """Every page back once the batch drained (the loop thread releases the
    rest after closing the last stream)."""
    sched.shutdown()
    assert not sched.thread.is_alive()
    return sched.pool.free_pages == sched.pool.num_pages


def test_single_request_matches_engine(eng):
    sched = BatchScheduler(eng, window_ms=5)
    try:
        want, _ = eng.chat("hello there", _image(0), max_new_tokens=5)
        last = Client(sched, eng, "hello there", 0, 5).result()
        assert last["text"] == want
        assert last["stats"]["ttft_ms"] > 0
    finally:
        sched.shutdown()


def test_concurrent_requests_batched_and_correct(weights, eng):
    """Three requests in one gather window share one batch; their ids equal
    the port's serial engine's and the JAX engine's."""
    prompts = ["alpha", "beta gamma", "delta"]
    je = jengine.Engine(weights[0], jax.tree.map(jnp.asarray, weights[1]),
                        IdTokenizer(), eos_ids=(IdTokenizer.eos_token_id,))
    want = [eng.chat(p, _image(i), max_new_tokens=6)[0]
            for i, p in enumerate(prompts)]
    want_jax = [je.chat(p, _image(i), max_new_tokens=6)[0]
                for i, p in enumerate(prompts)]
    assert want == want_jax
    sched = BatchScheduler(eng, window_ms=300)
    try:
        clients = [Client(sched, eng, p, i, 6) for i, p in enumerate(prompts)]
        last = [c.result() for c in clients]
        assert [u["text"] for u in last] == want
        assert len(set(want)) == 3 and all(len(_ids(w)) >= 3 for w in want)
        peak = max(u["stats"]["batch_size"] for c in clients for u in c.updates)
        assert peak >= 2
        assert sched.counters["prefills"] == 1  # one batched prefill
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_mixed_sampling_shares_one_batch(eng):
    sched = BatchScheduler(eng, window_ms=300)
    try:
        want, _ = eng.chat("x", _image(1), max_new_tokens=3)
        greedy = Client(sched, eng, "x", 1, 3)
        sampled = Client(sched, eng, "x", 1, 3,
                         sampling=sampling.SamplingParams(temperature=1.0))
        g, s = greedy.result(), sampled.result()
        assert max(u["stats"]["batch_size"] for u in greedy.updates) == 2
        assert max(u["stats"]["batch_size"] for u in sampled.updates) == 2
        assert g["text"] == want
        assert s["stats"]["finish_reason"] in ("stop", "length")
    finally:
        sched.shutdown()


def test_page_pool_accounting():
    pool = PagePool(4)
    a = pool.alloc(3)
    assert len(a) == 3 and pool.free_pages == 1 and pool.min_free == 1
    assert pool.alloc(2) is None  # refuses, state unchanged
    assert pool.free_pages == 1
    assert pool.alloc(0) == []
    pool.release(a)
    assert pool.free_pages == 4
    assert pool.min_free == 1  # low-water mark sticks


def test_page_pool_sharing_refcounts():
    pool = PagePool(4)
    a = pool.alloc(2)
    pool.share(a)             # second reference
    pool.release(a)           # first owner gone
    assert pool.free_pages == 2   # still pinned by the second ref
    pool.release(a)
    assert pool.free_pages == 4   # last ref frees


def test_paged_bounded_pool_matches_serial(eng):
    """A pool sized to exactly the tokens in flight (smaller than the dense
    worst case) serves the batch and returns every page."""
    prompts = ["alpha", "beta gamma", "delta"]
    page = 16
    lens = [eng.prepare(eng.build_prompt(p), _image(i))["prompt_tokens"]
            for i, p in enumerate(prompts)]
    need = sum(-(-(ln + 4) // page) for ln in lens)
    sched = BatchScheduler(eng, window_ms=300, page_size=page,
                           pool_tokens=need * page)
    try:
        want = [eng.chat(p, _image(i), max_new_tokens=4)[0]
                for i, p in enumerate(prompts)]
        clients = [Client(sched, eng, p, i, 4) for i, p in enumerate(prompts)]
        assert [c.result()["text"] for c in clients] == want
        assert sched.pool.min_free < sched.pool.num_pages  # ...and used
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_paged_pool_exhaustion_truncates_not_crashes(eng_noeos):
    """Two rows grow into a pool that holds their prompts and 2 more pages:
    the row that finds it dry is truncated (its stream ends early with a
    prefix of its answer, reason "truncated") and its pages let the other
    row finish intact, instead of stalling or corrupting either."""
    page = 8
    prompts = ["tell me everything", "and more"]
    lens = [eng_noeos.prepare(eng_noeos.build_prompt(p),
                              _image(i))["prompt_tokens"]
            for i, p in enumerate(prompts)]
    pool_pages = sum(-(-ln // page) for ln in lens) + 2
    assert pool_pages * page >= lens[0] + 64 and pool_pages * page >= \
        lens[1] + 64  # either row alone fits once the other's pages return
    sched = BatchScheduler(eng_noeos, window_ms=300, page_size=page,
                           pool_tokens=pool_pages * page)
    try:
        want = [_ids(eng_noeos.chat(p, _image(i), max_new_tokens=64)[0])
                for i, p in enumerate(prompts)]
        last = [c.result() for c in [Client(sched, eng_noeos, p, i, 64)
                                     for i, p in enumerate(prompts)]]
        reasons = [u["stats"]["finish_reason"] for u in last]
        assert sorted(reasons) == ["length", "truncated"], reasons
        for u, w in zip(last, want):
            got = _ids(u["text"])
            if u["stats"]["finish_reason"] == "truncated":
                assert 0 < len(got) < 64 and got == w[:len(got)]
            else:
                assert got == w
        assert sched.counters["truncated"] == 1
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_stream_closes_on_row_finish_not_batch_end(eng_noeos):
    """A short request batched with a long one completes its stream as soon
    as ITS row finishes."""
    sched = BatchScheduler(eng_noeos, window_ms=300, page_size=16)
    try:
        long = Client(sched, eng_noeos, "tell me all", 3, 96)
        short = Client(sched, eng_noeos, "hi", 4, 4)
        short.result()
        assert long.thread.is_alive() or len(long.updates) > len(short.updates)
        assert long.result()["stats"]["decode_tokens"] == 96
    finally:
        sched.shutdown()


def test_continuous_admission_into_free_slot(eng_noeos):
    """A request arriving after the batch started joins at a chunk boundary
    (free pad slot of the b=4 bucket) instead of waiting for the batch to
    drain: ids equal to serial, and it finishes first."""
    sched = BatchScheduler(eng_noeos, window_ms=300, page_size=16)
    try:
        want_late = eng_noeos.chat("quick question", _image(9),
                                   max_new_tokens=4)[0]
        longs = [Client(sched, eng_noeos, p, i, 160)
                 for i, p in enumerate(["alpha", "beta gamma", "delta"])]
        assert longs[0].decoding.wait(JOIN_S)
        late = Client(sched, eng_noeos, "quick question", 9, 4)
        last = late.result()
        assert last["text"] == want_late
        assert last["stats"]["batch_size"] >= 2
        assert all(c.thread.is_alive() for c in longs)
        assert all(c.result()["stats"]["decode_tokens"] == 160 for c in longs)
        assert sched.counters["admitted"] == 1
        assert sched.counters["grown"] == 0
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_admission_into_slot_freed_by_finished_row(eng_noeos):
    """A row that finishes returns its slot; a queued request admits into it
    mid-batch and its ids match serial."""
    sched = BatchScheduler(eng_noeos, window_ms=300, page_size=16)
    try:
        want_s = eng_noeos.chat("short follow-up", _image(5),
                                max_new_tokens=5)[0]
        long = Client(sched, eng_noeos, "the long one", 6, 256)
        mid = Client(sched, eng_noeos, "m", 7, 3)
        mid.result()  # 'mid' closed -> its slot is free
        s = Client(sched, eng_noeos, "short follow-up", 5, 5).result()
        assert s["text"] == want_s
        assert long.thread.is_alive()
        long.result()
        # (the freed slot may have been shrunk away before the request
        # arrived; then it admits by growing the batch again)
        assert sched.counters["admitted"] == 1
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_batch_grows_for_late_request(eng_noeos):
    """One long request owns a b=1 bucket; a late arrival GROWS the batch
    (1 -> 2) and joins, instead of waiting out the whole generation."""
    sched = BatchScheduler(eng_noeos, window_ms=20, page_size=16)
    try:
        want_late = eng_noeos.chat("but why", _image(8), max_new_tokens=4)[0]
        long = Client(sched, eng_noeos, "the epic", 10, 256)
        assert long.decoding.wait(JOIN_S)
        last = Client(sched, eng_noeos, "but why", 8, 4).result()
        assert last["text"] == want_late
        assert long.thread.is_alive()
        long.result()
        assert sched.counters["grown"] >= 1, dict(sched.counters)
        assert sched.counters["admitted"] >= 1, dict(sched.counters)
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_batch_shrinks_after_rows_finish(eng_noeos):
    """When most rows finish, the batch re-buckets down (after two
    under-occupied boundaries) and the long row's ids stay correct."""
    sched = BatchScheduler(eng_noeos, window_ms=300, page_size=16)
    try:
        want_long = eng_noeos.chat("endless story", _image(11),
                                   max_new_tokens=96)[0]
        clients = [Client(sched, eng_noeos, p, s, cap) for p, s, cap in
                   [("endless story", 11, 96), ("a", 12, 3), ("bb", 13, 3),
                    ("ccc", 14, 3)]]
        assert clients[0].result()["text"] == want_long
        for c in clients[1:]:
            c.result()
        assert sched.counters["shrunk"] >= 1, dict(sched.counters)
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_cancel_mid_generation_releases_row_and_pages(eng_noeos):
    """A cancelled request's row aborts at the next chunk boundary: its
    stream closes with "cancelled", the other row's ids are unchanged, and
    the pool returns to fully free."""
    sched = BatchScheduler(eng_noeos, window_ms=300, page_size=16)
    try:
        want = eng_noeos.chat("the surviving row", _image(15),
                              max_new_tokens=40)[0]
        cancel = threading.Event()
        victim = Client(sched, eng_noeos, "the victim row", 16, 4096,
                        cancel=cancel)
        survivor = Client(sched, eng_noeos, "the surviving row", 15, 40)
        assert victim.first.wait(JOIN_S)
        cancel.set()
        last = victim.result()  # closes despite the 4096 cap
        assert last["stats"]["finish_reason"] == "cancelled"
        assert survivor.result()["text"] == want
        assert sched.counters["cancelled"] == 1
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_cancel_while_queued_never_prefills(eng):
    sched = BatchScheduler(eng, window_ms=200, page_size=16)
    try:
        cancel = threading.Event()
        cancel.set()  # dead on arrival
        out = list(sched.submit(eng.build_prompt("never runs"), _image(0),
                                max_new_tokens=8, cancel=cancel))
        assert out == []  # closed with no updates
        assert sched.counters["cancelled"] == 1
        assert sched.counters["prefills"] == 0
        assert sched.pool.free_pages == sched.pool.num_pages
    finally:
        sched.shutdown()


def test_sampled_request_admitted_into_greedy_batch(eng_noeos):
    """A temperature > 0 request arriving while a greedy batch is mid-flight
    is admitted at a chunk boundary, and the greedy row's ids are
    unchanged."""
    sched = BatchScheduler(eng_noeos, window_ms=20, page_size=16)
    try:
        want_long = eng_noeos.chat("steady stream", _image(17),
                                   max_new_tokens=96)[0]
        long = Client(sched, eng_noeos, "steady stream", 17, 96)
        assert long.decoding.wait(JOIN_S)
        samp = Client(sched, eng_noeos, "surprise me", 18, 8,
                      sampling=sampling.SamplingParams(temperature=1.0,
                                                       top_k=8))
        assert samp.result()["stats"]["decode_tokens"] == 8
        assert long.result()["text"] == want_long
        assert sched.counters["admitted"] >= 1
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def _prompt_pages(eng, prompts, page):
    return [-(-eng.prepare(eng.build_prompt(p), _image(i))["prompt_tokens"]
              // page) for i, p in enumerate(prompts)]


def _jax_engine(weights, eos):
    tok = IdTokenizer()
    return jengine.Engine(weights[0], jax.tree.map(jnp.asarray, weights[1]),
                          tok, eos_ids=(tok.eos_token_id,) if eos else (-1,))


def _served_by_both(weights, eng, eos, jobs, pool_tokens, page, **knobs):
    """``jobs`` ((prompt, image seed, cap), gathered together) through the
    port's scheduler and the JAX scheduler, each over a pool of
    ``pool_tokens`` with ``knobs``: {"port" / "jax": (texts, counters)},
    every page back."""
    je = _jax_engine(weights, eos)
    out = {}
    for name, e, make in (("port", eng, BatchScheduler),
                          ("jax", je, jbatcher.BatchScheduler)):
        sched = make(e, window_ms=300, paged=True, page_size=page,
                     pool_tokens=pool_tokens, **knobs)
        try:
            clients = [Client(sched, e, *job) for job in jobs]
            texts = [c.result()["text"] for c in clients]
            assert _pool_clean(sched)
        finally:
            sched.shutdown()
        out[name] = (texts, dict(sched.counters))
    return out


def test_batch_prompts_past_pool_wait_for_admission(weights, eng_noeos):
    """Two requests gathered together whose prompts the pool cannot hold at
    once: as in the JAX scheduler, the whole batch runs on a dense cache of
    its own (one batched prefill, no page mapped; the name is kept from
    when the second one waited for pages). Both give the serial ids and
    the JAX scheduler's."""
    page = 8
    prompts = ["tell me everything", "and more"]
    pages = _prompt_pages(eng_noeos, prompts, page)
    out = _served_by_both(weights, eng_noeos, False,
                          [(p, i, 4) for i, p in enumerate(prompts)],
                          (sum(pages) - 1) * page, page)
    texts, counters = out["port"]
    assert texts == [eng_noeos.chat(p, _image(i), max_new_tokens=4)[0]
                     for i, p in enumerate(prompts)]
    assert texts == out["jax"][0]
    assert counters["dense_fallbacks"] == 1 and counters["prefills"] == 1
    assert counters["chunks"] >= 1 and not counters.get("admitted")


def test_prompt_larger_than_pool_fails_alone(weights, eng):
    """A prompt with more pages than the whole pool, gathered with a small
    one: the JAX scheduler serves both through a dense cache of their own,
    and so does the port (the name is kept from when the port failed the
    large one alone). Both get the serial ids and JAX's texts."""
    page = 8
    prompts = ["hi", "describe every single detail of this picture at length"]
    pages = _prompt_pages(eng, prompts, page)
    pool_pages = pages[0] + 1
    assert pages[1] > pool_pages
    out = _served_by_both(weights, eng, True,
                          [(p, i, 4) for i, p in enumerate(prompts)],
                          pool_pages * page, page)
    texts, counters = out["port"]
    assert texts == [eng.chat(p, _image(i), max_new_tokens=4)[0]
                     for i, p in enumerate(prompts)]
    assert texts == out["jax"][0]
    assert counters["dense_fallbacks"] == 1 and counters["prefills"] == 1


@pytest.mark.parametrize("fixture", ["eng", "eng_noeos"])
def test_spec_single_request_matches_engine(request, fixture):
    """One greedy request through BatchScheduler(spec=True): the engine's
    greedy ids (with and without a reachable EOS), verify-pass chunks ran
    (the rate tuner probes spec first), and every page comes back."""
    eng = request.getfixturevalue(fixture)
    sched = BatchScheduler(eng, window_ms=5, page_size=16, spec=True)
    try:
        want = eng.chat("tell me more", _image(20), max_new_tokens=40)[0]
        last = Client(sched, eng, "tell me more", 20, 40).result()
        assert last["text"] == want
        assert sched.counters["disp_spec@1"] >= 1
        assert sched.counters["decode_steps"] == \
            eng.chunk * sched.counters["disp_plain@1"]
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


@pytest.mark.parametrize("late_sampling", [
    None, sampling.SamplingParams(temperature=1.0, top_k=8)])
def test_spec_switches_off_when_a_row_joins(eng_noeos, late_sampling):
    """A greedy request decodes in spec chunks alone; a second request
    (greedy or sampled) admitted at a boundary grows the batch, after which
    plain chunks serve both: no spec chunk runs with two live rows. Both
    give the serial engine's ids, and every page comes back."""
    sched = BatchScheduler(eng_noeos, window_ms=20, page_size=16, spec=True)
    sched.trace = Timeline()
    try:
        want_long = eng_noeos.chat("steady stream", _image(17),
                                   max_new_tokens=96)[0]
        long = Client(sched, eng_noeos, "steady stream", 17, 96)
        assert long.decoding.wait(JOIN_S)  # a spec chunk landed
        late = Client(sched, eng_noeos, "but why", 8, 8,
                      sampling=late_sampling).result()
        assert long.result()["text"] == want_long
        if late_sampling is None:
            assert late["text"] == eng_noeos.chat("but why", _image(8),
                                                  max_new_tokens=8)[0]
        assert late["stats"]["decode_tokens"] == 8
        events = [e[1] for e in sched.trace]
        admit = events.index("admit")
        assert "spec" in events[:admit]
        assert "disp" in events[admit:]
        assert all(e[3] == 1 for e in sched.trace if e[1] == "spec")
        assert sched.counters["grown"] >= 1
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_spec_low_acceptance_bans_spec(eng_noeos):
    """An acceptance EMA below spec_min_accept after 3 spec chunks bans
    spec for the rest of the batch (re-probing every chunk keeps the rate
    tuner from stopping it first); the ids stay the greedy ones."""
    sched = BatchScheduler(eng_noeos, window_ms=5, page_size=16, spec=True,
                           spec_min_accept=2.0)
    sched.spec_reprobe_every = 1
    try:
        want = eng_noeos.chat("steady stream", _image(17),
                              max_new_tokens=96)[0]
        last = Client(sched, eng_noeos, "steady stream", 17, 96).result()
        assert last["text"] == want
        assert sched.counters["spec_banned_low_accept"] == 1
        assert sched.counters["disp_spec@1"] == 3
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_anyres_and_multi_image_served_serially(eng_anyres):
    """A gathered batch holding an anyres PIL request or a multi-image one
    is served one request at a time through engine.stream: each gets the
    engine's ids, no batched prefill runs, the pool is untouched."""
    from PIL import Image

    eng = eng_anyres
    wide = Image.fromarray(np.random.RandomState(21).randint(
        0, 256, (100, 230, 3), dtype=np.uint8))
    jobs = [(eng.build_prompt("describe the wide one"), wide, 6),
            (eng.build_prompt("compare <image> with it"),
             [_image(22), _image(23)], 6),
            (eng.build_prompt("just one array"), _image(24), 6)]
    want = [eng.generate(p, im, max_new_tokens=cap)[0] for p, im, cap in jobs]
    assert eng.prepare(*jobs[0][:2])["prompt_tokens"] > \
        eng.prepare(*jobs[2][:2])["prompt_tokens"]  # the tiles' tokens
    sched = BatchScheduler(eng, window_ms=300, page_size=16)
    sched.trace = Timeline()
    try:
        reqs = [Request(sched, *job) for job in jobs]
        assert [r.result()["text"] for r in reqs] == want
        assert sched.counters["prefills"] == 0
        starts = [e for e in sched.trace if e[1] == "batch_start"]
        assert starts[0][2] == 3  # one gathered batch, served serially
        assert sched.pool.min_free == sched.pool.num_pages
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_serial_path_cancellation(eng_noeos):
    """A serial request cancelled mid-stream closes at its next update and
    counts as cancelled; the next request is served."""
    sched = BatchScheduler(eng_noeos, window_ms=5, page_size=16)
    try:
        prompt = eng_noeos.build_prompt("compare <image> with it")
        cancel = threading.Event()
        got = []
        for u in sched.submit(prompt, [_image(25), _image(26)],
                              max_new_tokens=4096, cancel=cancel):
            got.append(u)
            cancel.set()
        # the stream closed at the first update after the cancel
        assert sched.counters["cancelled"] == 1
        assert len(got) < 8 and got[-1]["stats"]["decode_tokens"] < 128
        want = eng_noeos.generate(prompt, [_image(25), _image(26)],
                                  max_new_tokens=5)[0]
        last = Request(sched, prompt, [_image(25), _image(26)], 5).result()
        assert last["text"] == want
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_fairness_drain_serves_deferred_request(eng_noeos):
    """A steady stream of batchable requests keeps the batch alive through
    admission; a multi-image request arriving meanwhile is deferred, and
    once it has waited fairness_s admission stops, the batch drains and the
    request is served first, with the engine's ids."""
    eng = eng_noeos
    prompt = eng.build_prompt("compare <image> with it")
    imgs = [_image(30), _image(31)]
    want = eng.generate(prompt, imgs, max_new_tokens=4)[0]
    sched = BatchScheduler(eng, window_ms=10, page_size=16, fairness_s=0.3)
    sched.trace = Timeline()
    stop = threading.Event()
    fillers = []

    def feeder():
        while not stop.is_set():
            fillers.append(Client(sched, eng, f"filler {len(fillers)}",
                                  40 + len(fillers) % 4, 24))
            time.sleep(0.05)

    try:
        long = Client(sched, eng, "the long one", 6, 160)
        assert long.decoding.wait(JOIN_S)
        feed = threading.Thread(target=feeder)
        feed.start()
        try:
            late = Request(sched, prompt, imgs, 4).result()
        finally:
            stop.set()
            feed.join(timeout=JOIN_S)
        assert late["text"] == want
        long.result()
        for c in fillers:
            c.result()
        assert sched.counters["drained_for_fairness"] >= 1, \
            dict(sched.counters)
        events = [e[1:] for e in sched.trace]
        assert ("defer", "shape") in events
        assert any(e[0] == "drain" for e in events)
        assert _pool_clean(sched)
    finally:
        stop.set()
        sched.shutdown()


def test_window_batching_matches_jax_scheduler(weights, eng_noeos):
    """continuous=False: a gathered batch runs to its end and requests that
    arrive meanwhile wait for the next gather (no admission). The same
    traffic through the JAX scheduler with continuous=False gives the same
    ids, which are the serial engine's; every page comes back."""
    je = jengine.Engine(weights[0], jax.tree.map(jnp.asarray, weights[1]),
                        IdTokenizer(), eos_ids=(-1,))
    first = [("alpha", 0, 24), ("beta gamma", 1, 16)]
    late = [("delta", 2, 8), ("epsilon", 3, 8)]
    results = {}
    for name, eng, make in (
            ("port", eng_noeos, lambda: BatchScheduler(
                eng_noeos, window_ms=200, page_size=16, continuous=False)),
            ("jax", je, lambda: jbatcher.BatchScheduler(
                je, window_ms=200, paged=True, page_size=16,
                pool_tokens=4096, continuous=False))):
        sched = make()
        try:
            clients = [Client(sched, eng, *u) for u in first]
            assert clients[0].decoding.wait(JOIN_S)
            clients += [Client(sched, eng, *u) for u in late]
            results[name] = [c.result()["text"] for c in clients]
            assert sched.counters["admitted"] == 0, dict(sched.counters)
            assert _pool_clean(sched)
        finally:
            sched.shutdown()
    assert results["port"] == results["jax"]
    assert results["port"] == [eng_noeos.chat(p, _image(i),
                                              max_new_tokens=cap)[0]
                               for p, i, cap in first + late]


@pytest.mark.parametrize("knob", [
    {"prefill_chunk": 256, "persist_view": True},
    {"chunk_view": True}, {"persist_view": True}, {"pipeline_depth": 2}])
def test_unported_knobs_raise(weights, eng_noeos, knob):
    """The knobs that raised before the dense views were ported (the name
    is kept for its history): each builds, resolves as the JAX scheduler's
    (persist_view needs chunk_view, which follows it unless given;
    pipeline_depth needs persist_view), and two gathered requests and one
    admitted give the JAX scheduler's ids with the same resolved knobs,
    with the views' counters where a view runs."""
    sched = BatchScheduler(eng_noeos, **knob)
    sched.shutdown()
    resolved = {"chunk_view": sched.chunk_view,
                "persist_view": sched.persist_view,
                "pipeline_depth": sched.pipeline_depth}
    persist = knob.get("persist_view", False)
    assert resolved == {"chunk_view": persist or "chunk_view" in knob,
                        "persist_view": persist, "pipeline_depth": 1}
    knobs = {**resolved, "prefill_chunk": knob.get("prefill_chunk", 0)}
    je = _jax_engine(weights, eos=False)
    out = {}
    for name, e, make in (("port", eng_noeos, BatchScheduler),
                          ("jax", je, jbatcher.BatchScheduler)):
        sched = make(e, window_ms=300, paged=True, page_size=16,
                     pool_tokens=4096, **knobs)
        try:
            first = [Client(sched, e, p, i, 40)
                     for i, p in enumerate(["alpha", "beta gamma"])]
            assert first[0].decoding.wait(JOIN_S)
            late = Client(sched, e, "quick question", 9, 6)
            texts = [c.result()["text"] for c in first + [late]]
            assert _pool_clean(sched)
        finally:
            sched.shutdown()
        out[name] = (texts, dict(sched.counters))
    texts, counters = out["port"]
    assert texts == out["jax"][0]
    assert counters["admitted"] == 1
    if resolved["persist_view"]:
        assert counters["view_gathers"] >= 1 and counters["view_syncs"] >= 1
    elif not resolved["chunk_view"]:
        assert not counters.get("view_gathers")


def test_warmup_is_not_ported(eng):
    """Named for the stub that raised, which warmup() replaced (the name is
    kept so the test keeps its history): it now runs its dummy dispatches
    (4 decode chunks, 2 admission prefills, the serial step; the count
    against the JAX scheduler's is in tests/test_torch_serving.py), maps no
    page, counts nothing, and a request served after it gets the serial
    engine's ids."""
    sched = BatchScheduler(eng, prefix_cache=None, prefill_chunk=0,
                           page_size=16)
    try:
        assert sched.warmup(prompt_len=40, max_new_tokens=16) == 7
        assert sched.pool.free_pages == sched.pool.num_pages
        assert not sched.counters
        prompt = eng.build_prompt("Describe the image.")
        got = list(sched.submit(prompt, _image(0), max_new_tokens=8))
        assert got[-1]["text"] == eng.generate(prompt, _image(0),
                                               max_new_tokens=8)[0]
    finally:
        sched.shutdown()


ROWS = [jsampling.SamplingParams(),  # greedy
        jsampling.SamplingParams(temperature=5.0, top_k=5),
        jsampling.SamplingParams(temperature=5.0, top_p=0.6),
        jsampling.SamplingParams(temperature=5.0, top_p=0.5, top_k=8)]


def test_row_sampling_masks_match_jax():
    """Per-row knobs: the port's kept set (row_filter) is exactly the set
    JAX's sample_rows draws from (1024 seeded draws a row over near-uniform
    kept tokens), greedy rows take the argmax, and the port's own draws stay
    inside the kept set."""
    logits = np.random.RandomState(3).randn(4, 50).astype(np.float32)
    jrows = jsampling.RowSampling.build(ROWS, 4)
    trows = sampling.RowSampling.build(
        [sampling.SamplingParams(*r) for r in ROWS], 4)
    for j, t in zip(jrows, trows):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert trows.any_sampled
    kept = sampling.row_filter(torch.from_numpy(logits), trows).numpy() > -1e29
    keys = jax.random.split(jax.random.PRNGKey(0), 1024)
    draws = np.asarray(jax.vmap(
        lambda k: jsampling.sample_rows(k, jnp.asarray(logits), jrows))(keys))
    for i in range(1, 4):
        assert set(draws[:, i]) == set(np.flatnonzero(kept[i])), i
    assert (draws[:, 0] == logits[0].argmax()).all()
    gen = torch.Generator().manual_seed(0)
    for _ in range(64):
        got = sampling.sample_rows(gen, torch.from_numpy(logits), trows).numpy()
        assert got[0] == logits[0].argmax()
        assert all(kept[i, got[i]] for i in range(4))
    # top-k 5 keeps 5, top-p keeps the head only
    assert kept[1].sum() == 5 and 1 <= kept[3].sum() <= 8


def test_all_greedy_rows_draw_nothing():
    logits = torch.from_numpy(np.random.RandomState(4).randn(3, 20)
                              .astype(np.float32))
    rows = sampling.RowSampling.build([sampling.SamplingParams(), None], 3)
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    got = sampling.sample_rows(gen, logits, rows)
    torch.testing.assert_close(got, sampling.greedy(logits))
    assert not rows.any_sampled and torch.equal(gen.get_state(), state)
