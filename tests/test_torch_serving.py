"""The port's serving tier (fastvlm_tpu_torch/serve/{worker,controller,
proxy_worker,web,protocol}.py) on the CPU: every case of
tests/test_serving.py against the port, with the port's tiny engine on
device="cpu", and the port's own cases:

* the port worker streams the JAX worker's text for the same converted
  weights and payload (f32, greedy), and renders an OpenAI body into the
  same payload;
* ``ProxyWorker`` streams a backend worker's chunks through ``build_app``
  (which passes ``cancel``) and closes the backend stream once cancelled;
* ``ModelWorker(continuous_batching=True)`` builds the port's scheduler
  without the JAX view flags (their keyword is inert);
* an out-of-memory error maps to ``OUT_OF_MEMORY``; ``main`` and the CLI
  refuse to start without a card unless asked for the CPU;
* ``BatchScheduler.warmup`` counts the JAX scheduler's decode dispatches
  and leaves the pool and counters as they were;
* a request whose prompt + cap exceeds the pool blocks admission through
  the worker exactly as through the JAX worker (ROADMAP Queue 3).

Image-bearing traffic carries images: a text-only row in a gathered batch
gets a zero image where the serial engine uses text (ROADMAP Queue 3).
"""

import asyncio
import base64
import io
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp import web as aioweb
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.serve import batcher as jbatcher
from fastvlm_tpu.serve import worker as jworker
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.serve import cli, worker
from fastvlm_tpu_torch.serve.batcher import BatchScheduler
from fastvlm_tpu_torch.serve.controller import (
    Controller, build_app as build_controller_app)
from fastvlm_tpu_torch.serve.protocol import ErrorCode, chunk, iter_chunks
from fastvlm_tpu_torch.serve.proxy_worker import ProxyWorker
from fastvlm_tpu_torch.serve.worker import ModelWorker, build_app
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
    tests/test_torch_batcher.py): the decoder's matrices and embeddings
    N(0, 0.2) so the tiny decoder does not just echo."""
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


def _engines(weights, eos):
    jc, tree = weights
    tc = _tiny(tcfg)
    tok = IdTokenizer()
    eos_ids = (tok.eos_token_id,) if eos else (-1,)
    return (jengine.Engine(jc, jax.tree.map(jnp.asarray, tree), tok,
                           eos_ids=eos_ids),
            tengine.Engine(tc, from_jax_params(tree, tc), tok,
                           eos_ids=eos_ids))


@pytest.fixture(scope="module")
def engines(weights):
    return _engines(weights, eos=True)


@pytest.fixture(scope="module")
def tiny():
    """The port's ``build_engine(random_tiny=True)`` on the CPU, the engine
    tests/test_serving.py drives in JAX."""
    return tengine.build_engine(random_tiny=True, device="cpu")


def _png(seed, size=(128, 128)):
    arr = np.random.RandomState(seed).randint(0, 256, size[::-1] + (3,),
                                              dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _pil(b64):
    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def _serve(app, body):
    """Run ``body(client)`` against ``app`` on a test server."""
    async def run():
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await body(client)
        finally:
            await client.close()

    return asyncio.run(run())


def _stream(gen):
    return list(iter_chunks(gen))


# ---------------------------------------------------------------------------
# the cases of tests/test_serving.py
# ---------------------------------------------------------------------------


def test_chunk_roundtrip():
    raw = chunk("hello", 0, stats={"ttft_ms": 1.5}) + chunk("hello world", 0)
    msgs = list(iter_chunks([raw]))
    assert [m["text"] for m in msgs] == ["hello", "hello world"]
    assert msgs[0]["stats"]["ttft_ms"] == 1.5
    # split across arbitrary byte boundaries
    msgs2 = list(iter_chunks([raw[:7], raw[7:20], raw[20:]]))
    assert msgs2 == msgs


def test_controller_dispatch_shortest_queue():
    c = Controller("shortest_queue")
    c.register_worker("http://w1", True,
                      {"model_names": ["m"], "speed": 1.0, "queue_length": 5})
    c.register_worker("http://w2", True,
                      {"model_names": ["m"], "speed": 1.0, "queue_length": 0})
    assert c.get_worker_address("m") == "http://w2"
    # w2's queue was bumped; repeated dispatch alternates as queues grow
    addrs = {c.get_worker_address("m") for _ in range(10)}
    assert addrs == {"http://w1", "http://w2"}
    assert c.get_worker_address("unknown-model") == ""
    with pytest.raises(ValueError):
        Controller("round_robin")


def test_controller_lottery_respects_models():
    c = Controller("lottery")
    c.register_worker("http://a", True,
                      {"model_names": ["x"], "speed": 1.0, "queue_length": 0})
    c.register_worker("http://b", True,
                      {"model_names": ["y"], "speed": 1.0, "queue_length": 0})
    for _ in range(10):
        assert c.get_worker_address("x") == "http://a"
    assert sorted(c.list_models()) == ["x", "y"]
    assert not c.register_worker("http://c", True, None)


def test_controller_heartbeat_expiry():
    c = Controller()
    c.register_worker("http://w", True,
                      {"model_names": ["m"], "speed": 1.0, "queue_length": 0})
    assert c.receive_heart_beat("http://w", 3)
    assert c.workers["http://w"].queue_length == 3
    assert not c.receive_heart_beat("http://ghost", 0)
    # age the heartbeat past expiry
    c.workers["http://w"].last_heart_beat -= 1000
    c.remove_stale_workers()
    assert c.workers == {}


def test_controller_http_endpoints():
    c = Controller()

    async def body(client):
        resp = await client.post("/register_worker", json={
            "worker_name": "http://w1",
            "check_heart_beat": True,
            "worker_status": {"model_names": ["m"], "speed": 1.0,
                              "queue_length": 0},
        })
        assert (await resp.json())["exist"]
        resp = await client.post("/list_models", json={})
        assert (await resp.json())["models"] == ["m"]
        resp = await client.post("/get_worker_address", json={"model": "m"})
        assert (await resp.json())["address"] == "http://w1"
        resp = await client.post("/receive_heart_beat", json={
            "worker_name": "http://w1", "queue_length": 2})
        assert (await resp.json())["exist"]
        resp = await client.post("/refresh_all_workers", json={})
        assert resp.status == 200
        # the proxy route without a worker for the model: an error chunk
        resp = await client.post("/worker_generate_stream",
                                 json={"model": "nope", "prompt": "x"})
        msgs = list(iter_chunks([await resp.read()]))
        assert msgs[-1]["error_code"] == ErrorCode.SERVER_ERROR
        return True

    assert _serve(build_controller_app(c), body)


def test_worker_http_stream_roundtrip(tiny):
    """The tiny random engine behind the real aiohttp app; stream a
    generation."""
    w = ModelWorker(tiny, "tiny")

    async def body(client):
        resp = await client.post("/worker_get_status", json={})
        status = await resp.json()
        assert status["model_names"] == ["tiny"]
        assert status["queue_length"] == 0
        resp = await client.post("/worker_get_conv_template", json={})
        assert (await resp.json())["conv"] == "qwen_2"
        resp = await client.post("/worker_generate_stream", json={
            "prompt": "hello world", "temperature": 0.0,
            "max_new_tokens": 6})
        return list(iter_chunks([await resp.read()]))

    msgs = _serve(build_app(w), body)
    assert msgs, "no stream chunks received"
    assert all(m["error_code"] == ErrorCode.OK for m in msgs)
    assert "ttft_ms" in msgs[0]["stats"]
    # the cumulative text protocol: each chunk extends the previous
    for a, b in zip(msgs, msgs[1:]):
        assert b["text"].startswith(a["text"])
    assert msgs[-1]["stats"]["decode_tokens"] >= 0
    assert w.queue_length == 0


def test_worker_spec_decode_matches_dense(tiny):
    """A --spec-decode worker streams the same greedy text as a dense one;
    a sampled request with the spec default decodes plainly; spec +
    temperature asked for is a client error; spec requests report
    spec_steps in their final stats."""
    w = ModelWorker(tiny, "tiny", spec_decode=True, spec_draft_k=4)

    async def body(client):
        req = {"prompt": "the cat sat on the mat the cat",
               "temperature": 0.0, "max_new_tokens": 12}
        out = []
        for extra in ({}, {"spec": False}, {"temperature": 0.7},
                      {"spec": True, "temperature": 0.7}):
            resp = await client.post("/worker_generate_stream",
                                     json={**req, **extra})
            out.append(list(iter_chunks([await resp.read()])))
        return out

    spec_msgs, dense_msgs, sampled_msgs, err_msgs = _serve(build_app(w), body)
    assert spec_msgs and dense_msgs
    assert all(m["error_code"] == ErrorCode.OK for m in spec_msgs)
    assert spec_msgs[-1]["text"] == dense_msgs[-1]["text"]
    assert spec_msgs[-1]["stats"].get("spec_steps", 0) > 0
    assert "spec_steps" not in dense_msgs[-1]["stats"]
    assert all(m["error_code"] == ErrorCode.OK for m in sampled_msgs)
    assert "spec_steps" not in sampled_msgs[-1]["stats"]
    assert err_msgs[-1]["error_code"] == ErrorCode.CLIENT_ERROR


def test_openai_compatible_endpoint(tiny):
    w = ModelWorker(tiny, "tiny")

    async def body(client):
        resp = await client.post("/v1/chat/completions", json={
            "model": "tiny",
            "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 4})
        reply = await resp.json()
        assert reply["object"] == "chat.completion"
        assert reply["choices"][0]["message"]["role"] == "assistant"

        resp = await client.post("/v1/chat/completions", json={
            "model": "tiny", "stream": True,
            "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 4})
        raw = (await resp.read()).decode()
        assert raw.strip().endswith("data: [DONE]")
        events = [json.loads(line[6:]) for line in raw.splitlines()
                  if line.startswith("data: ") and line != "data: [DONE]"]
        assert events[-1]["choices"][0]["finish_reason"] == "stop"
        streamed = "".join(e["choices"][0]["delta"].get("content", "")
                           for e in events)
        assert streamed == reply["choices"][0]["message"]["content"]
        return True

    assert _serve(build_app(w), body)


def test_soak_32_concurrent_mixed_requests_paged_pool(weights):
    """32 concurrent mixed-length image requests through the worker's HTTP
    app, the scheduler and a pool small enough that exhaustion truncation
    fires. Every stream ends cleanly, every output is a prefix of (when not
    truncated, equal to) the serial engine's, and the pool comes back
    whole. The JAX test runs this once for each scheduler view; the port's
    scheduler has none (it reads the pool in place)."""
    _, eng = _engines(weights, eos=True)
    prompts = [f"describe item {i}" for i in range(8)]
    images = [_png(100 + i) for i in range(8)]
    # 8 concurrent prompts just fit, 128-token decodes exhaust the pool
    page = 8
    ln = eng.prepare(eng.build_prompt(prompts[0]),
                     _pil(images[0]))["prompt_tokens"]
    pool_pages = 8 * (-(-ln // page)) + 10
    w = ModelWorker(eng, "tiny", continuous_batching=True, page_size=page,
                    pool_tokens=pool_pages * page)
    plans = [(i % 8, (16, 64, 128)[i % 3]) for i in range(32)]
    serial = {(i, mx): eng.chat(prompts[i], _pil(images[i]),
                                max_new_tokens=mx)[0]
              for i, mx in sorted(set(plans))}

    async def one(client, i, mx):
        resp = await client.post("/worker_generate_stream", json={
            "prompt": eng.build_prompt(prompts[i]), "images": [images[i]],
            "temperature": 0.0, "max_new_tokens": mx})
        return list(iter_chunks([await resp.read()]))

    async def body(client):
        return await asyncio.gather(*[one(client, i, mx) for i, mx in plans])

    try:
        results = _serve(build_app(w), body)
    finally:
        w.scheduler.shutdown()
    assert len(results) == 32
    for (i, mx), msgs in zip(plans, results):
        assert msgs, f"no chunks for request {i}"
        assert all(m["error_code"] == ErrorCode.OK for m in msgs), msgs[-1]
        text, want = msgs[-1]["text"], serial[(i, mx)]
        # exhaustion may truncate, but the output is a prefix of serial
        assert want.startswith(text), (i, mx, text, want)
        reason = msgs[-1]["stats"].get("finish_reason")
        assert reason in ("stop", "length", "truncated"), msgs[-1]
        if reason != "truncated":
            assert text == want, (i, mx, reason, text, want)
    sched = w.scheduler
    assert sched.pool.free_pages == sched.pool.num_pages
    # the pool was driven into its bottom region
    assert sched.pool.min_free <= pool_pages // 6, \
        f"pool never stressed (min_free={sched.pool.min_free}/{pool_pages})"
    status = w.status()
    assert status["kv_pool"]["free_pages"] == sched.pool.num_pages
    assert status["batching"]["prefills"] >= 1


def _b64_of(size, colour=(200, 10, 10)):
    buf = io.BytesIO()
    Image.new("RGB", size, colour).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _size_of(b64):
    return Image.open(io.BytesIO(base64.b64decode(b64))).size


def test_web_image_process_modes(tmp_path):
    """Per-message image modes: the web layer transforms the upload before
    it reaches /worker_generate_stream. Pad squares it, Resize forces
    336x336, Default passes it through, a bad mode is a 400."""
    from fastvlm_tpu.serve.web import process_image_mode as jprocess
    from fastvlm_tpu_torch.serve.web import WebServer, process_image_mode

    assert _size_of(process_image_mode(_b64_of((100, 40)), "Pad")) == (100, 100)
    assert _size_of(process_image_mode(_b64_of((100, 40)), "Resize")) == \
        (336, 336)
    assert _size_of(process_image_mode(_b64_of((100, 40)), "Default")) == \
        (100, 40)
    w, h = _size_of(process_image_mode(_b64_of((2000, 500)), "Default"))
    assert max(w, h) <= 1344 and abs(w / h - 4.0) < 0.1, (w, h)
    with pytest.raises(ValueError):
        process_image_mode(_b64_of((8, 8)), "Zoom")
    # the same pixels as the JAX package's, mode by mode
    src = _png(7, (100, 40))
    for mode in ("Pad", "Resize", "Default", "Crop"):
        assert np.array_equal(np.asarray(_pil(process_image_mode(src, mode))),
                              np.asarray(_pil(jprocess(src, mode))))

    seen = {}

    async def run():
        worker_routes = aioweb.RouteTableDef()

        @worker_routes.post("/worker_generate_stream")
        async def gen(request):
            seen.update(await request.json())
            resp = aioweb.StreamResponse()
            await resp.prepare(request)
            await resp.write(chunk("ok"))
            return resp

        wapp = aioweb.Application()
        wapp.add_routes(worker_routes)
        wsrv = TestServer(wapp)
        await wsrv.start_server()
        waddr = f"http://{wsrv.host}:{wsrv.port}"

        ctrl_routes = aioweb.RouteTableDef()

        @ctrl_routes.post("/get_worker_address")
        async def get_addr(request):
            return aioweb.json_response({"address": waddr})

        capp = aioweb.Application()
        capp.add_routes(ctrl_routes)
        csrv = TestServer(capp)
        await csrv.start_server()

        ws = WebServer(f"http://{csrv.host}:{csrv.port}",
                       log_dir=str(tmp_path))
        client = TestClient(TestServer(ws.build_app()))
        await client.start_server()
        try:
            resp = await client.get("/")
            assert "FastVLM" in await resp.text()
            resp = await client.post("/api/generate", json={
                "model": "tiny", "prompt": "what is this?",
                "images": [_b64_of((100, 40))],
                "image_process_mode": "Pad", "max_new_tokens": 4})
            assert resp.status == 200
            msgs = list(iter_chunks([await resp.read()]))
            assert msgs[-1]["text"] == "ok"
            resp = await client.post("/api/generate", json={
                "model": "tiny", "prompt": "x", "images": [_b64_of((8, 8))],
                "image_process_mode": "Zoom"})
            assert resp.status == 400
        finally:
            await client.close()
            await wsrv.close()
            await csrv.close()

    asyncio.run(run())
    assert seen.get("images"), "the worker never saw the image"
    assert _size_of(seen["images"][0]) == (100, 100)  # padded square
    assert seen["prompt"].count("<image>") == 1
    logged = [json.loads(line) for p in tmp_path.glob("*-conv.json")
              for line in p.read_text().splitlines()]
    assert logged and logged[0]["had_image"]


def test_web_vote_logging(tmp_path):
    """/api/vote appends upvote / downvote / flag records to the dated log;
    other types are rejected."""
    from fastvlm_tpu_torch.serve.web import WebServer

    ws = WebServer("http://localhost:9", log_dir=str(tmp_path))

    async def body(client):
        r1 = await client.post("/api/vote", json={
            "type": "upvote", "model": "m", "prompt": "p", "response": "r"})
        r2 = await client.post("/api/vote", json={"type": "nonsense"})
        return r1.status, r2.status

    s1, s2 = _serve(ws.build_app(), body)
    assert s1 == 200 and s2 == 400
    logs = list(tmp_path.glob("*-conv.json"))
    assert len(logs) == 1
    rec = json.loads(logs[0].read_text().splitlines()[0])
    assert rec["type"] == "upvote" and rec["response"] == "r"
    assert "tstamp" in rec


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompt", ["Describe the image.", "What is it?"])
def test_worker_stream_matches_jax_worker(engines, prompt):
    """The same converted weights and payload (a base64 PNG, greedy, f32):
    the port worker's chunks carry the JAX worker's texts, chunk by
    chunk."""
    je, te = engines
    payload = {"prompt": te.build_prompt(prompt), "images": [_png(3)],
               "temperature": 0.0, "max_new_tokens": 40}
    want = _stream(jworker.ModelWorker(je, "tiny").generate_stream(payload))
    got = _stream(ModelWorker(te, "tiny").generate_stream(payload))
    assert [m["text"] for m in got] == [m["text"] for m in want]
    assert all(m["error_code"] == ErrorCode.OK for m in got)
    assert len(set(got[-1]["text"].split(","))) >= 3
    assert got[-1]["stats"]["decode_tokens"] == \
        want[-1]["stats"]["decode_tokens"]


def test_openai_payload_matches_jax(engines):
    """An OpenAI chat body (system turn, a data: URI image part, a raw
    base64 part, an assistant turn) renders the JAX worker's payload, and
    its stream the native payload's text."""
    je, te = engines
    body = {"messages": [
        {"role": "system", "content": "Be brief."},
        {"role": "user", "content": [
            {"type": "text", "text": "What is here?"},
            {"type": "image_url",
             "image_url": {"url": "data:image/png;base64," + _png(4)}}]},
        {"role": "assistant", "content": "A picture."},
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": _png(5)}},
            {"type": "text", "text": "And this?"}]}],
        "max_tokens": 12, "temperature": 0}
    jw, tw = jworker.ModelWorker(je, "tiny"), ModelWorker(te, "tiny")
    got = worker._openai_to_worker_payload(body, tw)
    assert got == jworker._openai_to_worker_payload(body, jw)
    assert got["images"] == [_png(4), _png(5)]
    single = {"messages": [{"role": "user", "content": [
        {"type": "image_url",
         "image_url": {"url": "data:image/png;base64," + _png(6)}},
        {"type": "text", "text": "Describe it."}]}], "max_tokens": 12}
    payload = worker._openai_to_worker_payload(single, tw)
    native = {"prompt": te.build_prompt("Describe it."), "images": [_png(6)],
              "temperature": 0.0, "max_new_tokens": 12}
    assert payload["prompt"] == native["prompt"]
    assert _stream(tw.generate_stream(payload))[-1]["text"] == \
        _stream(tw.generate_stream(native))[-1]["text"]


def test_proxy_worker_streams_backend_through_build_app(tiny):
    """The proxy in front of a port worker: the proxy's own app (whose
    routes call generate_stream(payload, cancel=...)) streams the backend's
    chunks unchanged."""
    backend = ModelWorker(tiny, "tiny")
    payload = {"prompt": "hello world", "temperature": 0.0,
               "max_new_tokens": 8}

    async def run():
        bsrv = TestServer(build_app(backend))
        await bsrv.start_server()
        proxy = ProxyWorker(f"http://{bsrv.host}:{bsrv.port}/", "tiny")
        client = TestClient(TestServer(build_app(proxy)))
        await client.start_server()
        try:
            resp = await client.post("/worker_generate_stream", json=payload)
            via_proxy = list(iter_chunks([await resp.read()]))
            resp = await client.post("/worker_get_status", json={})
            status = await resp.json()
        finally:
            await client.close()
            await bsrv.close()
        return via_proxy, status

    via_proxy, status = asyncio.run(run())
    direct = _stream(backend.generate_stream(payload))
    assert [m["text"] for m in via_proxy] == [m["text"] for m in direct]
    assert all(m["error_code"] == ErrorCode.OK for m in via_proxy)
    assert status["model_names"] == ["tiny"]


def test_proxy_worker_cancel_closes_backend_stream():
    """A backend that streams a chunk every 20 ms for 10 s: once ``cancel``
    is set, the proxy's generator ends at the next piece and the backend
    sees its client go away within a second; an unreachable backend gives
    one error chunk."""
    seen = {"sent": 0, "gone": None}

    async def slow(request):
        resp = aioweb.StreamResponse()
        await resp.prepare(request)
        try:
            for i in range(500):
                await resp.write(chunk(f"piece {i}"))
                seen["sent"] += 1
                await asyncio.sleep(0.02)
        except (ConnectionError, asyncio.CancelledError):
            seen["gone"] = time.perf_counter()
            raise
        return resp

    async def run():
        app = aioweb.Application()
        app.router.add_post("/worker_generate_stream", slow)
        srv = TestServer(app)
        await srv.start_server()
        proxy = ProxyWorker(f"http://{srv.host}:{srv.port}", "slow")
        cancel = threading.Event()

        def consume():
            got = []
            for piece in proxy.generate_stream({"prompt": "x"}, cancel=cancel):
                got.extend(iter_chunks([piece]))
                if len(got) == 3:
                    cancel.set()
                    t_cancel[0] = time.perf_counter()
            return got

        t_cancel = [None]
        loop = asyncio.get_running_loop()
        try:
            got = await loop.run_in_executor(None, consume)
            for _ in range(100):  # the backend notices the closed socket
                if seen["gone"] is not None:
                    break
                await asyncio.sleep(0.02)
        finally:
            await srv.close()
        return got, t_cancel[0]

    got, t_cancel = asyncio.run(run())
    assert 3 <= len(got) <= 4, got
    assert seen["gone"] is not None, "the backend never saw the disconnect"
    assert seen["gone"] - t_cancel < 1.0
    assert seen["sent"] < 100
    down = ProxyWorker("http://127.0.0.1:9", "none")
    msgs = _stream(down.generate_stream({"prompt": "x"}))
    assert len(msgs) == 1 and msgs[0]["error_code"] == ErrorCode.SERVER_ERROR


def test_continuous_batching_builds_scheduler_without_view_flags(engines):
    """The worker builds its scheduler from the page size, pool, spec,
    draft k, admission chunk and ``persist_view``, as the JAX worker does
    (the name is kept from when the port's worker took no view flag):
    ``persist_view=True`` reaches the scheduler as the persistent view, and
    the port's default leaves the pool in place, where the JAX worker's
    default is the view."""
    _, te = engines
    w = ModelWorker(te, "tiny", continuous_batching=True, persist_view=True)
    try:
        s = w.scheduler
        assert s.persist_view and s.chunk_view and s.pipeline_depth == 1
    finally:
        s.shutdown()
    w = ModelWorker(te, "tiny", continuous_batching=True, page_size=16,
                    pool_tokens=1024, spec_decode=True, spec_draft_k=4,
                    prefill_chunk=0)
    try:
        s = w.scheduler
        assert isinstance(s, BatchScheduler)
        assert not s.persist_view and not s.chunk_view
        assert (s.page_size, s.pool.num_pages) == (16, 64)
        assert s.spec and s.spec_draft_k == 4 and s.prefill_chunk == 0
        assert not w.spec_decode  # the scheduler runs the spec chunks
        assert w.semaphore._value == 64
        assert w.status()["kv_pool"] == {"free_pages": 64, "num_pages": 64,
                                         "min_free": 64}
    finally:
        w.scheduler.shutdown()


class _Failing:
    conv_mode = "qwen_2"

    def __init__(self, exc):
        self.exc = exc

    def stream(self, *args, **kwargs):
        raise self.exc
        yield  # a generator, as Engine.stream is


@pytest.mark.parametrize("exc,code", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"),
     ErrorCode.OUT_OF_MEMORY),
    (RuntimeError("RESOURCE_EXHAUSTED is a TPU word"), ErrorCode.SERVER_ERROR),
])
def test_out_of_memory_maps_to_its_error_code(exc, code):
    w = ModelWorker(_Failing(exc), "x")
    msgs = _stream(w.generate_stream({"prompt": "p", "max_new_tokens": 4}))
    assert len(msgs) == 1 and msgs[0]["error_code"] == code
    assert str(exc) in msgs[0]["text"]


@pytest.mark.parametrize("argv,rc", [
    (["--random-weights"], 1), (["--random-weights", "--device", "cuda"], 1),
    (["--random-weights", "--tp", "2"], 2)])
def test_worker_main_refuses_without_a_card(monkeypatch, capsys, argv, rc):
    """Without a card the worker exits 1 and names --device cpu; ``--tp 2``
    outside a world of 2 processes exits 2 and names torchrun."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert worker.main(argv) == rc
    err = capsys.readouterr().err
    assert ("--device cpu" in err) if rc == 1 else (
        "torchrun --nproc-per-node 2 -m fastvlm_tpu_torch.serve.worker" in err)


def test_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--random-weights"]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_cli_chats_on_the_cpu(monkeypatch, capsys):
    answers = iter(["hello", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert cli.main(["--random-weights", "--device", "cpu", "--temperature",
                     "0", "--max-new-tokens", "4", "--timing"]) == 0
    captured = capsys.readouterr()
    assert "ASSISTANT: " in captured.out and "ttft_ms" in captured.err


def test_warmup_count_matches_jax_scheduler(engines):
    """With admission prefill off, the port's warmup and the JAX
    scheduler's (plain chunk views, one view bucket) both count a decode
    dispatch per batch bucket {1, 2, 4, 8}; spec adds one at batch 1. The
    port's maps no page, counts nothing and leaves the generator alone."""
    je, te = engines
    k = te.chunk
    js = jbatcher.BatchScheduler(je, paged=True, page_size=16,
                                 pool_tokens=1024, chunk_view=True,
                                 persist_view=False)
    try:
        want = js.warmup(prompt_len=40, max_new_tokens=k,
                         admission_prefill=False, images=False)
    finally:
        js.shutdown()
    for spec, extra in ((False, 0), (True, 1)):
        s = BatchScheduler(te, page_size=16, pool_tokens=1024, spec=spec)
        try:
            state = s._gen.get_state()
            got = s.warmup(prompt_len=40, max_new_tokens=k,
                           admission_prefill=False, images=False)
            assert got == want + extra == 4 + extra
            assert s.pool.free_pages == s.pool.num_pages == 64
            assert s.pool.min_free == 64
            assert not s.counters
            assert torch.equal(s._gen.get_state(), state)
        finally:
            s.shutdown()


def test_prompt_plus_cap_beyond_pool_blocks_admission_like_jax(weights):
    """ROADMAP Queue 3: a request whose prompt + cap exceeds the pool (a
    1000-token cap, under the worker's 1024) is re-deferred at every
    boundary, so a small request behind it is not admitted while the live
    batch decodes; both are gathered once it drains, where the big one
    decodes to its cap with its later writes dropped. Through the port
    worker and the JAX worker: equal texts, finish reasons and admission
    counts, and the small request's first update after the live one's
    close. Past the pool's capacity the big request decodes on a cut
    context, which the two packages drop their own way (the JAX dense view,
    the port's sink page; ROADMAP Queue 3, the lone row), so its tokens
    are compared while its context fits the pool."""
    je, te = _engines(weights, eos=False)
    img = _png(11)
    out = {}
    for name, make in (
            ("port", lambda: ModelWorker(te, "tiny", continuous_batching=True,
                                         page_size=16, pool_tokens=512)),
            ("jax", lambda: jworker.ModelWorker(
                je, "tiny", continuous_batching=True, page_size=16,
                pool_tokens=512))):
        w = make()
        times, finals = {}, {}

        def run(tag, prompt, cap, decoding=None):
            payload = {"prompt": te.build_prompt(prompt), "images": [img],
                       "temperature": 0.0, "max_new_tokens": cap}
            for n, piece in enumerate(w.generate_stream(payload)):
                msg = next(iter_chunks([piece]))
                times.setdefault(tag, time.perf_counter())
                finals[tag] = msg
                if n == 1 and decoding is not None:
                    decoding.set()
            times[tag + "_closed"] = time.perf_counter()

        try:
            live = threading.Event()
            ta = threading.Thread(target=run, args=("a", "the live one", 200,
                                                    live))
            ta.start()
            assert live.wait(JOIN_S)
            tb = threading.Thread(target=run, args=("b", "the big one", 1000))
            tb.start()
            time.sleep(0.2)
            tc = threading.Thread(target=run, args=("c", "a small one", 8))
            tc.start()
            for t in (ta, tb, tc):
                t.join(JOIN_S * 2)
                assert not t.is_alive()
            counters = dict(w.scheduler.counters)
        finally:
            w.scheduler.shutdown()
        assert times["c"] > times["a_closed"], (name, times)
        out[name] = ({t: (m["text"], m["stats"].get("finish_reason"),
                          m["stats"]["decode_tokens"])
                      for t, m in finals.items()},
                     counters.get("admitted", 0))
    (port, admitted), (want, jax_admitted) = out["port"], out["jax"]
    assert admitted == jax_admitted == 0
    assert {t: port[t] for t in "ac"} == {t: want[t] for t in "ac"}
    assert port["b"][1:] == want["b"][1:] == ("length", 1000)
    plen = te.prepare(te.build_prompt("the big one"), _pil(img))[
        "prompt_tokens"]
    fits = 512 - plen
    assert port["b"][0].split(",")[:fits] == want["b"][0].split(",")[:fits]
    assert port["c"][1:] == ("length", 8)


@pytest.fixture
def log_dir(tmp_path, monkeypatch):
    """utils/logging's LOGDIR in tmp_path with no shared handler yet; the
    handler build_logger makes is taken off every logger afterwards."""
    import logging

    from fastvlm_tpu_torch.utils import logging as tlog

    monkeypatch.setattr(tlog, "LOGDIR", str(tmp_path))
    monkeypatch.setattr(tlog, "_handler", None)
    yield tmp_path
    handler = tlog._handler
    if handler is not None:
        for item in [logging.getLogger()] + list(
                logging.root.manager.loggerDict.values()):
            if isinstance(item, logging.Logger):
                item.removeHandler(handler)
        handler.close()


def test_build_logger_writes_the_file_and_redirects_lines(log_dir):
    """utils/logging.build_logger: a named logger whose records (and a
    StreamToLogger's lines, a partial line on flush) reach the rotating
    file under LOGDIR."""
    from fastvlm_tpu_torch.utils import logging as tlog

    logger = tlog.build_logger("fastvlm_torch_test", "serve.log")
    logger.info("worker %d up", 7)
    stream = tlog.StreamToLogger(logger)
    stream.write("a whole line\na part")
    stream.flush()
    tlog._handler.flush()
    text = (log_dir / "serve.log").read_text()
    assert "worker 7 up" in text and "a whole line" in text
    assert "a part" in text and " | INFO | fastvlm_torch_test | " in text


@pytest.mark.parametrize("module,argv,logfile", [
    ("controller", [], "controller.log"),
    ("web", [], "web_server.log"),
    ("proxy_worker", ["--backend-address", "http://127.0.0.1:9",
                      "--model-name", "x"], "proxy_worker_41000.log"),
    ("worker", ["--random-weights", "--device", "cpu"],
     "model_worker_40000.log")])
def test_server_mains_log_through_build_logger(log_dir, monkeypatch, module,
                                               argv, logfile):
    """Each server's main logs through build_logger (its file under
    LOGDIR), then serves its aiohttp app."""
    import importlib

    from fastvlm_tpu_torch.utils import logging as tlog

    mod = importlib.import_module(f"fastvlm_tpu_torch.serve.{module}")
    served = []
    monkeypatch.setattr(aioweb, "run_app",
                        lambda app, **kw: served.append(app))
    assert mod.main(argv) == 0
    assert len(served) == 1 and isinstance(served[0], aioweb.Application)
    mod.logger.info("serving %s", module)
    tlog._handler.flush()
    text = (log_dir / logfile).read_text()
    assert f" | INFO | {mod.logger.name} | serving {module}" in text


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """utils/logging.profile_trace: a torch.profiler trace of the block
    (CPU activity here) as Chrome-trace JSON under log_dir."""
    from fastvlm_tpu_torch.utils.logging import profile_trace

    with profile_trace(str(tmp_path / "traces")) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads(open(path).read())["traceEvents"]
    assert path.startswith(str(tmp_path / "traces"))
    assert any("mm" in e.get("name", "") for e in events)


def test_register_worker_and_test_message_clients(tiny, capsys):
    """The two small clients against a controller and a worker on test
    servers: register_worker posts the worker's status to the controller,
    test_message finds the worker through it and prints the stream."""
    from fastvlm_tpu_torch.serve import register_worker, test_message

    async def run():
        csrv = TestServer(build_controller_app(Controller()))
        wsrv = TestServer(build_app(ModelWorker(tiny, "tiny")))
        await csrv.start_server()
        await wsrv.start_server()
        ctrl = f"http://{csrv.host}:{csrv.port}"
        waddr = f"http://{wsrv.host}:{wsrv.port}"
        loop = asyncio.get_running_loop()
        try:
            rc_reg = await loop.run_in_executor(None, register_worker.main, [
                "--controller-address", ctrl, "--worker-name", waddr])
            rc_msg = await loop.run_in_executor(None, test_message.main, [
                "--controller-address", ctrl, "--model-name", "tiny",
                "--message", "hello", "--max-new-tokens", "4"])
            rc_none = await loop.run_in_executor(None, test_message.main, [
                "--controller-address", ctrl, "--model-name", "other"])
        finally:
            await csrv.close()
            await wsrv.close()
        return rc_reg, rc_msg, rc_none, waddr

    rc_reg, rc_msg, rc_none, waddr = asyncio.run(run())
    out = capsys.readouterr().out
    assert (rc_reg, rc_msg, rc_none) == (0, 0, 1)
    assert "Models: ['tiny']" in out and f"worker_addr: {waddr}" in out
    assert "No available workers" in out


def test_worker_runs_in_process_without_aiohttp():
    """With aiohttp absent (the card's machine), ModelWorker, its
    scheduler and generate_stream, the controller's registry and the
    protocol import and run; only the HTTP entry points need it."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "sys.modules['aiohttp'] = None\n"
        "from fastvlm_tpu_torch.engine import build_engine\n"
        "from fastvlm_tpu_torch.serve import controller, protocol, worker\n"
        "w = worker.ModelWorker(build_engine(random_tiny=True, device='cpu'),"
        " 'tiny', continuous_batching=True)\n"
        "msgs = list(protocol.iter_chunks(w.generate_stream(\n"
        "    {'prompt': 'hi', 'max_new_tokens': 2})))\n"
        "w.scheduler.shutdown()\n"
        "assert msgs and msgs[-1]['error_code'] == 0, msgs\n"
        "c = controller.Controller()\n"
        "c.register_worker('w', True, w.status())\n"
        "assert c.get_worker_address('tiny') == 'w'\n"
        "for build in (lambda: worker.build_app(w),\n"
        "              lambda: controller.build_app(c)):\n"
        "    try:\n"
        "        build()\n"
        "    except ImportError:\n"
        "        continue\n"
        "    raise AssertionError('an HTTP entry point ran without aiohttp')\n"
        "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
