"""The port scheduler's prefix cache and chunked admission prefill
(fastvlm_tpu_torch/serve/batcher.py) on the CPU, mirroring
tests/test_batcher.py's prefix-cache tests (the persist_view=False cases)
and tests/test_chunked_prefill.py (chunk bounds, chunked admission, the
image chunk; its warmup tests wait with ``warmup()``):

  * ``PrefixCache`` and ``_prefill_chunk_bounds`` behave as the JAX
    package's on the same operations;
  * the scale-aware defaults resolve as the JAX scheduler's;
  * admissions that hit the prefix cache, a gathered burst that reuses one
    prefix, eviction under pool pressure, chunked admissions (text and
    image), a row mid-prefill across a batch resize or cancelled, and a
    failed batch:
    greedy ids equal the port's serial engine's and the JAX engine's, the
    counters show the hits and chunks, and every page comes back once the
    registry lets go;
  * one traffic with both features on gives the JAX scheduler's ids.

Tiny f32 engines over the same numpy-drawn weights (utils/convert.py),
128 px images (4 image tokens) on every request, a tokenizer whose text is
the token ids, EOS unreachable (answers run to their caps), 16-token pages.
Ids are compared for equality."""

import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.serve import batcher as jbatcher
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.serve import batcher
from fastvlm_tpu_torch.serve.batcher import (
    BatchScheduler, PagePool, PrefixCache, _prefill_chunk_bounds)
from fastvlm_tpu_torch.timeline import Timeline
from fastvlm_tpu_torch.utils.convert import from_jax_params

JOIN_S = 180
PAGE = 16
# a system prompt that puts 7 full pages before the image slot
SYSTEM = "<|im_start|>system\n" + "You are a careful, patient assistant. " * 3


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
def engines():
    """(JAX engine, port engine): the same numpy-drawn weights (decoder
    matrices N(0, 0.2) so the tiny decoder does not echo), EOS
    unreachable."""
    jc = _tiny(jcfg, vision={"ffn_backend": "pallas"},
               decoder={"attn_backend": "pallas"})
    tc = _tiny(tcfg)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if path[0].key == "decoder" and leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tok = IdTokenizer()
    je = jengine.Engine(jc, jax.tree.map(jnp.asarray, params), tok,
                        eos_ids=(-1,))
    te = engine.Engine(tc, from_jax_params(params, tc), tok, eos_ids=(-1,))
    return je, te


def _image(seed):
    return np.random.RandomState(seed).randint(0, 256, (128, 128, 3),
                                               dtype=np.uint8)


def _prompt(eng, user):
    return eng.build_prompt(user, system=SYSTEM)


def _serial(eng, user, seed, cap):
    return eng.generate(_prompt(eng, user), _image(seed),
                        max_new_tokens=cap)[0]


class Client:
    """One request on its own thread; ``decoding`` is set once a decode
    chunk has landed (its second update)."""

    def __init__(self, sched, eng, user, seed, cap):
        self.updates = []
        self.decoding = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(
            sched, _prompt(eng, user), _image(seed), cap))
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
        last = self.updates[-1]
        assert "error" not in last, last
        return last


def _pool_clean(sched):
    """After the batch drained every page is free but those the registry
    pins alone; clearing the registry frees those too."""
    sched.shutdown()
    assert not sched.thread.is_alive()
    pinned = set()
    if sched.prefix is not None:
        for pages in sched.prefix.entries.values():
            pinned.update(pages)
    ok = sched.pool.free_pages + len(pinned) == sched.pool.num_pages
    if sched.prefix is not None:
        sched.prefix.clear()
    return ok and sched.pool.free_pages == sched.pool.num_pages


def test_prefix_cache_unit():
    """The JAX test's operations, on the port's and the JAX package's
    PrefixCache side by side: the same hits, pages and free counts."""
    outs = []
    for pool_cls, cache_cls in ((PagePool, PrefixCache),
                                (jbatcher.PagePool, jbatcher.PrefixCache)):
        pool = pool_cls(8)
        pc = cache_cls(pool, page_size=4)
        ids = np.arange(10, dtype=np.int32)   # 2 full pages + partial
        pages = pool.alloc(3)
        pc.publish(ids, pages)
        assert len(pc.entries) == 2           # 1-page and 2-page prefixes
        assert pc.peek(np.arange(9, dtype=np.int32)) == 8
        n, shared = pc.lookup(np.arange(9, dtype=np.int32))
        assert n == 8 and shared == pages[:2]
        pool.release(shared)
        # a diverging second page falls back to the 1-page prefix
        other = np.concatenate([np.arange(6), [99, 98, 97]]).astype(np.int32)
        n, shared = pc.lookup(other)
        assert n == 4 and shared == pages[:1]
        pool.release(shared)
        assert pc.lookup(np.asarray([7, 7, 7, 7, 7], np.int32)) == (0, [])
        # the row is done; the registry still pins its 2 full-prefix pages
        pool.release(pages)
        assert pool.free_pages == 6
        # eviction under pressure frees registry-only pages
        assert pc.evict_for(8)
        assert pool.free_pages == 8 and not pc.entries
        pc.publish(ids, pool.alloc(3))
        pc.clear()
        outs.append((pc.hits, pc.misses, pool.free_pages))
    assert outs[0] == outs[1] == (2, 1, 5)


def test_chunk_bounds():
    assert _prefill_chunk_bounds(0, 10, 4, -1, -1) == [0, 4, 8, 10]
    assert _prefill_chunk_bounds(0, 12, 4, 5, 9) == [0, 4, 5, 9, 12]
    assert _prefill_chunk_bounds(0, 8, 4, 2, 6) == [0, 2, 6, 8]
    assert _prefill_chunk_bounds(0, 20, 8, 0, 16) == [0, 16, 20]
    assert _prefill_chunk_bounds(6, 14, 4, -1, -1) == [6, 10, 14]
    assert _prefill_chunk_bounds(0, 40, 30, 5, 21) == [0, 5, 21, 40]
    rng = np.random.RandomState(0)
    for _ in range(200):
        lo = int(rng.randint(0, 40))
        hi = lo + int(rng.randint(1, 300))
        w = int(rng.randint(1, 70))
        # the span starts at or after lo (a cached prefix ends before it)
        s = int(rng.randint(lo, hi)) if rng.rand() < 0.8 else -1
        e = s + int(rng.randint(1, 60)) if s >= 0 else -1
        bs = _prefill_chunk_bounds(lo, hi, w, s, e)
        assert bs == jbatcher._prefill_chunk_bounds(lo, hi, w, s, e)
        assert bs[0] == lo and bs[-1] == hi
        assert all(b2 > b1 for b1, b2 in zip(bs, bs[1:]))
        assert not any(s < x < e for x in bs[1:-1] if s >= 0)


@pytest.mark.parametrize("make", [jcfg.qwen2_0_5b, jcfg.qwen2_1_5b,
                                  jcfg.qwen2_7b])
def test_scale_aware_defaults_match_jax(make):
    """``prefix_cache=None`` / ``prefill_chunk=None`` resolve as the JAX
    scheduler's: on (256-token chunks) from 1e9 decoder parameters."""
    jdec = make()
    dec = getattr(tcfg, make.__name__)()
    count = batcher._decoder_param_count(dec)
    assert count == jbatcher._decoder_param_count(jdec)
    eng = types.SimpleNamespace(cfg=types.SimpleNamespace(decoder=dec),
                                device=torch.device("cpu"))
    sched = BatchScheduler(eng)
    try:
        large = count >= 1e9
        assert (sched.prefix is not None) == large
        assert sched.prefill_chunk == (256 if large else 0)
        assert sched.max_pending == 2
    finally:
        sched.shutdown()
    forced = BatchScheduler(eng, prefix_cache=not large,
                            prefill_chunk=0 if large else 32)
    try:
        assert (forced.prefix is not None) == (not large)
        assert forced.prefill_chunk == (0 if large else 32)
    finally:
        forced.shutdown()


def test_prefix_cache_admission_matches_serial(engines):
    """A request admitted after one that shares its system prompt hits the
    prefix cache (suffix-only prefill over shared pages) and still gives
    the serial greedy ids."""
    je, te = engines
    sched = BatchScheduler(te, window_ms=20, page_size=PAGE,
                           prefix_cache=True, prefill_chunk=0)
    try:
        want1 = _serial(te, "first, a long answer", 1, 48)
        want2 = _serial(te, "and also the second one", 2, 6)
        assert want2 == _serial(je, "and also the second one", 2, 6)
        c1 = Client(sched, te, "first, a long answer", 1, 48)
        assert c1.decoding.wait(JOIN_S)  # c1's pages are published
        last2 = Client(sched, te, "and also the second one", 2, 6).result()
        assert last2["text"] == want2
        assert c1.result()["text"] == want1
        assert sched.counters["prefix_hits"] >= 1, dict(sched.counters)
        assert sched.counters["prefix_hit_tokens"] >= 6 * PAGE
        assert last2["stats"]["cached_tokens"] >= 6 * PAGE
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_prefix_cache_batch_burst_matches_serial(engines):
    """A gathered burst of prompts sharing the cached prefix reuses it as a
    batch (one shared offset, a suffix-only batched prefill) and still
    gives the serial ids."""
    _, te = engines
    sched = BatchScheduler(te, window_ms=300, page_size=PAGE,
                           prefix_cache=True, prefill_chunk=0)
    try:
        seed = Client(sched, te, "zero", 0, 4).result()
        assert seed["text"] == _serial(te, "zero", 0, 4)
        hits_before = sched.counters["prefix_hits"]
        users = ["one", "two two", "three three three"]
        want = [_serial(te, u, i + 3, 6) for i, u in enumerate(users)]
        clients = [Client(sched, te, u, i + 3, 6)
                   for i, u in enumerate(users)]
        last = [c.result() for c in clients]
        assert [u["text"] for u in last] == want
        assert sched.counters["prefix_hits"] >= hits_before + 3
        assert all(u["stats"]["cached_tokens"] >= 6 * PAGE for u in last)
        assert sched.counters["prefills"] == 2  # the seed's, the burst's
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_prefix_cache_eviction_under_pressure(engines):
    """With a pool barely larger than one request, pages the registry pins
    are evicted for live rows instead of deferring or truncating."""
    _, te = engines
    users = ["warm the cache", "now a different one entirely"]
    ln = max(te.prepare(_prompt(te, u), _image(i))["prompt_tokens"]
             for i, u in enumerate(users))
    pool_pages = -(-(ln + 48) // PAGE) + 1
    sched = BatchScheduler(te, window_ms=5, page_size=PAGE,
                           pool_tokens=pool_pages * PAGE, prefix_cache=True,
                           prefill_chunk=0)
    try:
        for i, u in enumerate(users):
            last = Client(sched, te, u, i + 10, 8).result()
            assert last["text"] == _serial(te, u, i + 10, 8)
            assert last["stats"]["finish_reason"] == "length"
        assert sched.counters["prefix_evicted_for_rows"] >= 1, \
            dict(sched.counters)
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_chunked_admission_matches_serial(engines):
    """Two late long-prompt requests admit in chunks while an anchor row
    keeps decoding (the second also grows the batch while the first may
    be mid-prefill): ids equal serial, and the anchor's too."""
    je, te = engines
    long_user = ("please describe every detail of the scene in front of "
                 "you and then summarize it in one sentence")
    late2 = "and what about the weather tomorrow in the mountains?"
    sched = BatchScheduler(te, window_ms=100, page_size=PAGE,
                           prefix_cache=False, prefill_chunk=8, max_pending=2)
    sched.trace = Timeline()
    try:
        want1 = _serial(te, long_user, 21, 5)
        want2 = _serial(te, late2, 22, 4)
        assert want1 == _serial(je, long_user, 21, 5)
        anchor = Client(sched, te, "the anchor row", 20, 384)
        assert anchor.decoding.wait(JOIN_S)
        c1 = Client(sched, te, long_user, 21, 5)
        c2 = Client(sched, te, late2, 22, 4)
        assert c1.result()["text"] == want1
        assert c2.result()["text"] == want2
        assert anchor.result()["text"] == _serial(te, "the anchor row", 20,
                                                  384)
        assert sched.counters["chunked_admissions"] >= 1, dict(sched.counters)
        assert sched.counters["prefill_chunks"] >= 2, dict(sched.counters)
        # decode chunks ran while a row was mid-prefill
        assert any(e[1] == "disp" and e[6] > 0 for e in sched.trace)
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_chunked_admission_image_prompt(engines):
    """An image admission chunks too (8-token chunks; the image chunk is
    the whole 4-token span): ids equal serial, and no chunk splits the
    span."""
    _, te = engines
    user = "what objects are on the table and how are they arranged?"
    sched = BatchScheduler(te, window_ms=100, page_size=PAGE,
                           prefix_cache=False, prefill_chunk=8)
    sched.trace = Timeline()
    try:
        want = _serial(te, user, 31, 5)
        anchor = Client(sched, te, "anchor", 30, 256)
        assert anchor.decoding.wait(JOIN_S)
        last = Client(sched, te, user, 31, 5).result()
        assert last["text"] == want
        assert last["stats"]["prefill_chunks"] >= 2
        anchor.result()
        assert sched.counters["chunked_admissions"] >= 1, dict(sched.counters)
        start = te.prepare(_prompt(te, user), _image(31))["starts"][0].item()
        spans = [(e[3], e[4]) for e in sched.trace if e[1] == "pchunk"]
        assert (start, start + te.cfg.num_image_tokens) in spans
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_pending_row_survives_batch_resize(engines):
    """A row mid-prefill keeps its slot, pages and chunk state while the
    batch grows around it (the late arrival joins while it is pending),
    and both answer as serial."""
    _, te = engines
    long_user = "tell me about the picture in as much detail as you can"
    sched = BatchScheduler(te, window_ms=20, page_size=PAGE,
                           prefix_cache=False, prefill_chunk=4)
    sched.trace = Timeline()
    try:
        anchor = Client(sched, te, "the anchor row", 40, 512)
        assert anchor.decoding.wait(JOIN_S)
        c1 = Client(sched, te, long_user, 41, 6)
        # wait until the long one is mid-prefill, then send a short one
        deadline = time.time() + JOIN_S
        while not any(e[1] == "padmit" for e in list(sched.trace)):
            assert time.time() < deadline
            time.sleep(0.005)
        c2 = Client(sched, te, "short", 42, 3)
        assert c2.result()["text"] == _serial(te, "short", 42, 3)
        assert c1.result()["text"] == _serial(te, long_user, 41, 6)
        anchor.result()
        events = [e[1] for e in sched.trace]
        first_pchunk = events.index("pchunk")
        activate = events.index("activate")
        assert "grow" in events[first_pchunk:activate], events
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_cancel_mid_prefill_releases_pages(engines):
    """A request cancelled while its admission is mid-prefill closes its
    stream at the next boundary, hands back its reserved pages, and the
    live row's ids are unchanged."""
    _, te = engines
    sched = BatchScheduler(te, window_ms=20, page_size=PAGE,
                           prefix_cache=False, prefill_chunk=4)
    sched.trace = Timeline()
    try:
        anchor = Client(sched, te, "the anchor row", 70, 256)
        assert anchor.decoding.wait(JOIN_S)
        cancel = threading.Event()
        out = []
        victim = threading.Thread(target=lambda: out.extend(sched.submit(
            _prompt(te, "a long prompt that will never finish its prefill"),
            _image(71), max_new_tokens=8, cancel=cancel)))
        victim.start()
        deadline = time.time() + JOIN_S
        while not any(e[1] == "pchunk" for e in list(sched.trace)):
            assert time.time() < deadline
            time.sleep(0.005)
        cancel.set()
        victim.join(timeout=JOIN_S)
        assert not victim.is_alive() and out == []
        assert anchor.result()["text"] == _serial(te, "the anchor row", 70,
                                                  256)
        assert sched.counters["cancelled"] == 1
        assert "activate" not in [e[1] for e in sched.trace]
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_failed_batch_clears_prefix_registry(engines, monkeypatch):
    """A failed decode drops the pool's tensors, so the registry, whose KV
    lived there, is cleared too: every page comes back and the next request
    prefills from scratch with the serial ids."""
    _, te = engines
    sched = BatchScheduler(te, window_ms=5, page_size=PAGE,
                           prefix_cache=True, prefill_chunk=0)
    try:
        def boom(*a, **k):
            raise RuntimeError("injected decode failure")

        with monkeypatch.context() as m:
            m.setattr(batcher.vlm, "decode_chunk", boom)
            updates = list(sched.submit(_prompt(te, "fail me"), _image(50),
                                        max_new_tokens=8))
        assert "error" in updates[-1]
        deadline = time.time() + JOIN_S
        while sched.prefix.entries or \
                sched.pool.free_pages != sched.pool.num_pages:
            assert time.time() < deadline
            time.sleep(0.01)
        last = Client(sched, te, "fail me", 50, 8).result()
        assert last["text"] == _serial(te, "fail me", 50, 8)
        assert last["stats"]["cached_tokens"] == 0
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_prefix_and_chunked_traffic_matches_jax_scheduler(engines):
    """The same traffic through the port's scheduler and the JAX
    scheduler (persist_view=False), both with the prefix cache and 8-token
    chunked admission on: an anchor, then two late requests sharing its
    system prompt. Equal ids, and both count prefix hits and chunks."""
    je, te = engines
    users = [("the anchor row", 60, 96), ("a late question about it", 61, 5),
             ("another late question, a longer one", 62, 4)]
    results = {}
    for name, eng, make in (
            ("port", te, lambda: BatchScheduler(
                te, window_ms=50, page_size=PAGE, prefix_cache=True,
                prefill_chunk=8)),
            ("jax", je, lambda: jbatcher.BatchScheduler(
                je, window_ms=50, paged=True, page_size=PAGE,
                pool_tokens=4096, persist_view=False, prefix_cache=True,
                prefill_chunk=8))):
        sched = make()
        try:
            anchor = Client(sched, eng, *users[0])
            assert anchor.decoding.wait(JOIN_S)
            late = [Client(sched, eng, *u) for u in users[1:]]
            results[name] = ([c.result()["text"] for c in late]
                             + [anchor.result()["text"]])
            assert sched.counters["prefix_hits"] >= 2, dict(sched.counters)
            assert sched.counters["prefill_chunks"] >= 2, \
                dict(sched.counters)
        finally:
            sched.shutdown()
    assert results["port"] == results["jax"]
    assert results["port"][:2] == [_serial(te, *u) for u in users[1:]]
