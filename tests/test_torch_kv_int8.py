"""The port's int8 KV cache (fastvlm_tpu_torch/ops/kv_cache.py int8 layout,
qwen2._attend_quant, the int8 carry of vlm / engine / beam / video, and the
scheduler's dense per-batch path) against the JAX package's, mirroring
tests/test_kv_int8.py:

* ``quantize_tokens`` bitwise; ``dequantize_view`` and ``_attend_quant``
  within 1e-5 (f32; the softmax is taken in another order);
* an int8-KV engine's ``generate``, ``generate_beam`` (W = 2),
  ``generate_spec`` and video QA give the JAX engine's ids;
* ``BatchScheduler`` over an int8-KV engine (dense path) and with
  ``paged=False`` gives the JAX scheduler's texts and finish reasons, and
  a continuous-batching ``ModelWorker`` over an int8-KV engine streams the
  engine's text and reports the JAX worker's status keys (no pool).

The int8 path runs no kernel in either package (JAX's Pallas route requires
a float cache), so nothing here is card-only.
"""

import base64
import io
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu.serve import batcher as jbatcher
from fastvlm_tpu.serve import worker as jworker
from fastvlm_tpu import video as jvideo
from fastvlm_tpu_torch.models import qwen2 as tqwen2
from fastvlm_tpu_torch.ops import kv_cache as tkv
from fastvlm_tpu_torch.serve.batcher import BatchScheduler
from fastvlm_tpu_torch.serve.protocol import iter_chunks
from fastvlm_tpu_torch.serve.worker import ModelWorker
from fastvlm_tpu_torch.video import VideoQA

import torch_tiny

JOIN_S = 120


@pytest.fixture(scope="module")
def weights():
    return torch_tiny.draw_weights(0)


@pytest.fixture(scope="module")
def int8_engines(weights):
    return torch_tiny.engines(weights, "int8", chunk=4)


@pytest.mark.parametrize("shape", [(3, 5, 2, 8), (1, 7, 2, 16)])
def test_quantize_tokens_bitwise(shape):
    x = (np.random.RandomState(0).randn(*shape) * 4).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector takes scale 1
    jq, js = jkv.quantize_tokens(jnp.asarray(x))
    tq, ts = tkv.quantize_tokens(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = np.asarray(jkv.dequantize_view(jq, js, jnp.float32))
    got = tkv.dequantize_view(tq, ts, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_init_cache_int8_layout():
    c = tkv.init_cache(2, 3, 8, 2, 4, dtype=torch.int8)
    assert c.k.dtype == torch.int8 and c.k_scale.shape == (2, 3, 8, 2)
    assert bool((c.k_scale == 1).all()) and bool((c.v_scale == 1).all())
    # two allocations: an in-place write to one leaves the other
    assert c.k_scale.data_ptr() != c.v_scale.data_ptr()
    assert tkv.init_cache(2, 3, 8, 2, 4, dtype=torch.float32).k_scale is None


@pytest.mark.parametrize("t", [1, 3])
def test_attend_quant_matches_jax(t):
    """Scale-on-scores attention over int8 keys and values (T = 1 a decode
    step, T = 3 a verify pass), within 1e-5 of JAX's in f32."""
    rng = np.random.RandomState(t)
    b, s, hq, hkv, d = 2, 9, 4, 2, 8
    q = rng.randn(b, t, hq, d).astype(np.float32)
    kf = rng.randn(b, s, hkv, d).astype(np.float32)
    vf = rng.randn(b, s, hkv, d).astype(np.float32)
    k8, ks = jkv.quantize_tokens(jnp.asarray(kf))
    v8, vs = jkv.quantize_tokens(jnp.asarray(vf))
    lengths = np.array([4, 6], np.int32)
    mask = (np.arange(s)[None, None, :]
            <= lengths[:, None, None] + np.arange(t)[None, :, None])
    want = np.asarray(jqwen2._attend_quant(
        jnp.asarray(q), k8, ks, v8, vs, jnp.asarray(mask)[:, None]))
    to = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    got = tqwen2._attend_quant(to(q), to(k8), to(ks), to(v8), to(vs),
                               to(mask)[:, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_int8_kv_write_token_t_wide_matches_jax():
    """A T-wide decode write (a verify pass) quantizes each token and moves
    its scales to the same rows as JAX's vmapped update."""
    rng = np.random.RandomState(5)
    new = rng.randn(2, 3, 2, 4).astype(np.float32)
    lengths = np.array([1, 4], np.int32)
    jk = jnp.zeros((2, 8, 2, 4), jnp.int8)
    js = jnp.ones((2, 8, 2), jnp.float32)
    jk, _, js, _ = jkv.write_token(jk, jk, jnp.asarray(new), jnp.asarray(new),
                                   jnp.asarray(lengths), js, js)
    tk = torch.zeros((2, 8, 2, 4), dtype=torch.int8)
    tv = torch.zeros_like(tk)
    ts, tvs = torch.ones((2, 8, 2)), torch.ones((2, 8, 2))
    tkv.write_token(tk, tv, torch.from_numpy(new), torch.from_numpy(new),
                    torch.from_numpy(lengths), ts, tvs)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("prompt", ["Describe the image.", "What is it?"])
def test_int8_kv_engine_generate_matches_jax(int8_engines, prompt):
    je, te = int8_engines
    assert te._kv_dtype == torch.int8
    img = torch_tiny.image(1)
    want, _ = je.chat(prompt, img, max_new_tokens=10)
    got, stats = te.chat(prompt, img, max_new_tokens=10)
    assert got == want and stats["ttft_ms"] > 0


def test_int8_kv_engine_beam_and_spec_match_jax(int8_engines):
    je, te = int8_engines
    prompt = te.build_prompt("a b a b a b a b")
    img = torch_tiny.image(2)
    want, _ = je.generate_beam(prompt, img, num_beams=2, max_new_tokens=8)
    got, _ = te.generate_beam(prompt, img, num_beams=2, max_new_tokens=8)
    assert got == want
    want, _ = je.generate_spec(prompt, img, max_new_tokens=10, draft_k=4)
    got, stats = te.generate_spec(prompt, img, max_new_tokens=10, draft_k=4)
    assert got == want and stats["spec_steps"] >= 1
    # the streaming spec path carries the same cache
    last = list(te.stream(prompt, img, max_new_tokens=10, spec=True,
                          draft_k=4))[-1]
    assert last["text"] == want


def test_int8_kv_video_qa_matches_jax(int8_engines):
    """The prefix prefilled once into the int8 cache; each frame's suffix
    prefill continues after it (``prefill_continue`` over
    ``dequantize_view``)."""
    je, te = int8_engines
    jq = jvideo.VideoQA(je, "What happens?", max_new_tokens=6)
    tq = VideoQA(te, "What happens?", max_new_tokens=6)
    assert tq.cache.k.dtype == torch.int8
    for seed in (3, 4, 3):
        frame = torch_tiny.image(seed)
        assert tq.ask(frame)[0] == jq.ask(frame)[0]


def _serve(sched, prompts, max_new):
    """Submit every prompt (with an image) at once; each stream's last
    update."""
    out = [None] * len(prompts)

    def run(i, p):
        for u in sched.submit(p, torch_tiny.image(10 + i),
                              max_new_tokens=max_new):
            out[i] = u

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(prompts)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
        assert not th.is_alive()
    return out


PROMPTS = ["alpha", "beta gamma", "delta"]


@pytest.mark.parametrize("kv,paged", [("int8", True), (None, False)])
def test_dense_batch_matches_jax_scheduler(weights, kv, paged):
    """The JAX scheduler serves an int8-KV engine, or any engine with
    paged=False, from a dense per-batch cache; so does the port's. Three
    requests in one gather window: equal texts and finish reasons."""
    je, te = torch_tiny.engines(weights, kv)
    prompts = [te.build_prompt(p) for p in PROMPTS]
    js = jbatcher.BatchScheduler(je, window_ms=300, paged=paged)
    try:
        want = _serve(js, prompts, 6)
    finally:
        js.shutdown()
    assert not js.paged
    ts = BatchScheduler(te, window_ms=300, paged=paged)
    try:
        assert not ts.paged and ts.pool is None and ts.warmup() == 0
        got = _serve(ts, prompts, 6)
        assert ts.counters["prefills"] == 1  # one batched prefill
        assert ts.counters["admitted"] == 0
    finally:
        ts.shutdown()
    assert [u["text"] for u in got] == [u["text"] for u in want]
    assert [u["stats"]["finish_reason"] for u in got] == \
        [u["stats"]["finish_reason"] for u in want]
    # the serial engine gives each request the same ids
    assert [u["text"] for u in got] == [
        te.generate(p, torch_tiny.image(10 + i), max_new_tokens=6)[0]
        for i, p in enumerate(prompts)]


def test_worker_over_int8_kv_engine_matches_jax_status(int8_engines):
    """The worker's scheduler serves an int8-KV engine from the dense path:
    its status has no kv_pool entry, as the JAX worker's, and a request
    streams the serial engine's text."""
    je, te = int8_engines
    jw = jworker.ModelWorker(je, "tiny", continuous_batching=True)
    tw = ModelWorker(te, "tiny", continuous_batching=True)
    try:
        assert tw.scheduler.pool is None and jw.scheduler.pool is None
        prompt = te.build_prompt("hello")
        buf = io.BytesIO()
        Image.fromarray(torch_tiny.image(7)).save(buf, format="PNG")
        msgs = list(iter_chunks(tw.generate_stream(
            {"prompt": prompt, "temperature": 0.0, "max_new_tokens": 5,
             "images": [base64.b64encode(buf.getvalue()).decode()]})))
        want = te.generate(prompt, Image.open(buf).convert("RGB"),
                           max_new_tokens=5)[0]
        assert msgs[-1]["text"] == want and want
        got, want = tw.status(), jw.status()
        assert sorted(got) == sorted(want) and "kv_pool" not in got
        assert got["batching"]["prefills"] == 1
    finally:
        tw.scheduler.shutdown()
        jw.scheduler.shutdown()
