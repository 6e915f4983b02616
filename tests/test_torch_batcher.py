"""The port's continuous-batching scheduler (fastvlm_tpu_torch/serve/
batcher.py) on the CPU, mirroring tests/test_batcher.py's names for what is
ported: batched greedy ids equal the port's serial ``Engine.chat`` and the
JAX engine's; concurrent requests share one decode loop over the paged pool
(kernel K3's plain version here); admission, grow, shrink, pool exhaustion,
cancellation, page accounting; the held-back knobs raise; per-row sampling
masks agree with the JAX package's.

Tiny f32 engines built from the same numpy-drawn weights (utils/convert.py),
a tokenizer whose text is the token ids, and 128 px images (4 image
tokens), so every request carries an image. Waits are on events and bounded
joins; the window sleeps of the JAX tests are replaced by a wide gather
window."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import sampling as jsampling
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.ops import sampling
from fastvlm_tpu_torch.serve.batcher import BatchScheduler, PagePool
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


def test_batch_prompts_past_pool_wait_for_admission(eng_noeos):
    """Two requests gathered together whose prompts the pool cannot hold at
    once: the first prefills, the second waits (deferred) until pages
    return, then runs; both give the serial ids and every page returns."""
    page = 8
    prompts = ["tell me everything", "and more"]
    pages = _prompt_pages(eng_noeos, prompts, page)
    sched = BatchScheduler(eng_noeos, window_ms=300, page_size=page,
                           pool_tokens=(sum(pages) - 1) * page)
    sched.trace = []
    try:
        want = [eng_noeos.chat(p, _image(i), max_new_tokens=4)[0]
                for i, p in enumerate(prompts)]
        clients = [Client(sched, eng_noeos, p, i, 4)
                   for i, p in enumerate(prompts)]
        assert [c.result()["text"] for c in clients] == want
        assert sched.counters["prefills"] == 2
        assert (sched.trace[0][1], sched.trace[1][1:]) == (
            "batch_start", ("defer", "pool"))
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


def test_prompt_larger_than_pool_fails_alone(eng):
    """A prompt with more pages than the whole pool fails with an error; a
    request gathered with it is served as if alone."""
    page = 8
    prompts = ["hi", "describe every single detail of this picture at length"]
    pages = _prompt_pages(eng, prompts, page)
    pool_pages = pages[0] + 1
    assert pages[1] > pool_pages
    sched = BatchScheduler(eng, window_ms=300, page_size=page,
                           pool_tokens=pool_pages * page)
    try:
        want = eng.chat(prompts[0], _image(0), max_new_tokens=4)[0]
        ok, big = [Client(sched, eng, p, i, 4) for i, p in enumerate(prompts)]
        assert ok.result()["text"] == want
        big.thread.join(timeout=JOIN_S)
        assert len(big.updates) == 1
        assert "exceeds the page pool" in big.updates[0]["error"]
        assert sched.counters["prefills"] == 1
        assert _pool_clean(sched)
    finally:
        sched.shutdown()


@pytest.mark.parametrize("knob", [
    {"prefix_cache": True}, {"prefill_chunk": 256}, {"spec": True},
    {"chunk_view": True}, {"persist_view": True}, {"pipeline_depth": 2}])
def test_unported_knobs_raise(eng, knob):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        BatchScheduler(eng, **knob)


def test_warmup_is_not_ported(eng):
    sched = BatchScheduler(eng, prefix_cache=None, prefill_chunk=0)
    try:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            sched.warmup()
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
