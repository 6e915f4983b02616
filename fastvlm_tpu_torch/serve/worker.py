"""Model worker: an engine behind the streaming generation API.

Counterpart of ``fastvlm_tpu/serve/worker.py`` (the reference's
llava/serve/model_worker.py):

  POST /worker_generate_stream   {prompt, images(b64)?, temperature, top_p,
                                  max_new_tokens, stop, spec?}
                                 -> \\0-delimited JSON chunks
  POST /worker_get_status        {model_names, speed, queue_length, ...}
  POST /worker_get_conv_template
  POST /v1/chat/completions      OpenAI-style, SSE when stream=true

It registers with a controller at start-up and re-registers when a
heartbeat finds it forgotten, bounds concurrency with a semaphore, and
wraps failures in the protocol's error envelopes. Every route pumps
``ModelWorker.generate_stream``, a sync generator, from a thread pool.

``aiohttp`` is imported only where HTTP is spoken (``register``,
``heartbeat_loop``, ``build_app``, ``main``), so ``ModelWorker`` and its
generator run in-process on a machine without it.

With ``continuous_batching`` the requests share the port's
``BatchScheduler`` (paged pool, K3 decode; an int8-KV engine's batches
take its dense path, and ``status()`` then reports no pool, as the JAX
worker's); otherwise each streams alone through ``Engine.stream`` (dense
cache, K2). The scheduler is built with
the page size, pool size, speculative chunks, the admission chunk and
``persist_view``, as the JAX worker builds it. ``persist_view`` defaults to
False here, where JAX's defaults to True: the port's scheduler serves from
the pool in place (kernel K3) unless asked for the persistent view
(serve/batcher.py), and which one a deployment should run is for a
benchmark cell to decide.

``--tp N`` serves a tensor-parallel engine (``Engine(mesh=)``) from N
processes started by ``torchrun --nproc-per-node N -m
fastvlm_tpu_torch.serve.worker --tp N ...``: rank 0 serves HTTP (and runs
the scheduler), the other ranks follow its device calls. ``--tp`` must
equal torchrun's ``WORLD_SIZE``, else ``main`` exits with 2.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import io
import json
import logging
import sys
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch

from fastvlm_tpu_torch.data.constants import (
    DEFAULT_IMAGE_TOKEN, WORKER_HEART_BEAT_INTERVAL)
from fastvlm_tpu_torch.data.conversation import conv_templates
from fastvlm_tpu_torch.ops.sampling import SamplingParams
from fastvlm_tpu_torch.serve.protocol import (
    ErrorCode, SERVER_ERROR_MSG, chunk, iter_chunks)
from fastvlm_tpu_torch.utils.logging import build_logger

logger = logging.getLogger("fastvlm_tpu_torch.worker")

# the most tokens one request may ask for (the JAX worker's cap)
MAX_NEW_TOKENS_CAP = 1024


class ModelWorker:
    def __init__(
        self,
        engine,
        model_name: str,
        *,
        worker_addr: str = "",
        controller_addr: Optional[str] = None,
        limit_concurrency: int = 5,
        continuous_batching: bool = False,
        page_size: int = 64,
        pool_tokens: int = 16384,
        spec_decode: bool = False,
        spec_draft_k: int = 8,
        warmup_tokens: int = 0,
        persist_view: bool = False,
        prefill_chunk: Optional[int] = None,
    ):
        """``spec_decode``: greedy requests default to speculative
        streaming (serial path) or the scheduler's speculative chunks
        (continuous batching). ``warmup_tokens`` > 0 runs
        ``BatchScheduler.warmup(prompt_len=warmup_tokens)`` at start-up.
        ``persist_view``: the scheduler decodes on a persistent dense view
        of the pool (module docstring)."""
        self.engine = engine
        self.model_name = model_name
        # the serial path's default; the scheduler runs its own spec chunks
        self.spec_decode = spec_decode and not continuous_batching
        self.spec_draft_k = spec_draft_k
        self.worker_id = uuid.uuid4().hex[:8]
        self.worker_addr = worker_addr
        self.controller_addr = controller_addr
        # the scheduler shares one decode loop, so admission can be wider
        self.semaphore = asyncio.Semaphore(
            max(limit_concurrency, 64) if continuous_batching
            else limit_concurrency)
        self.queue_length = 0
        self.scheduler = None
        # stream-pumping threads, one per admitted request (asyncio's
        # default executor would cap concurrent streams at cpus + 4)
        self.executor = ThreadPoolExecutor(
            max_workers=self.semaphore._value,
            thread_name_prefix="fastvlm-stream")
        if continuous_batching and engine is not None:
            from fastvlm_tpu_torch.serve.batcher import BatchScheduler

            self.scheduler = BatchScheduler(
                engine, page_size=page_size, pool_tokens=pool_tokens,
                spec=spec_decode, spec_draft_k=spec_draft_k,
                persist_view=persist_view, prefill_chunk=prefill_chunk)
            if warmup_tokens > 0:
                n = self.scheduler.warmup(prompt_len=warmup_tokens)
                logger.info("scheduler warmup: %d dummy dispatches", n)

    # ---------------- status / heartbeat ----------------

    def status(self) -> dict:
        out = {
            "model_names": [self.model_name],
            "speed": 1.0,
            "queue_length": self.queue_length,
        }
        if self.scheduler is not None:
            out["batching"] = dict(self.scheduler.counters)
            pool = self.scheduler.pool
            if pool is not None:  # the dense path (int8 KV) has no pool
                out["kv_pool"] = {"free_pages": pool.free_pages,
                                  "num_pages": pool.num_pages,
                                  "min_free": pool.min_free}
            if self.scheduler.prefix is not None:
                out["prefix_cache"] = {
                    "entries": len(self.scheduler.prefix.entries),
                    "hits": self.scheduler.prefix.hits,
                    "misses": self.scheduler.prefix.misses,
                }
        return out

    async def register(self, session) -> None:
        """POST this worker's status to the controller (an
        ``aiohttp.ClientSession``)."""
        await session.post(self.controller_addr + "/register_worker", json={
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status(),
        })

    async def heartbeat_loop(self) -> None:
        """Register (retrying until the controller is up), then beat every
        WORKER_HEART_BEAT_INTERVAL s with the queue length, re-registering
        when the controller has forgotten this worker."""
        import aiohttp

        # a refused or dropped connection, a timeout, a body that is not JSON
        unreachable = (aiohttp.ClientError, OSError, asyncio.TimeoutError,
                        ValueError)
        async with aiohttp.ClientSession() as session:
            while True:
                try:
                    await self.register(session)
                    break
                except unreachable as e:
                    logger.warning("controller not reachable yet: %s", e)
                    await asyncio.sleep(5)
            while True:
                await asyncio.sleep(WORKER_HEART_BEAT_INTERVAL)
                try:
                    async with session.post(
                        self.controller_addr + "/receive_heart_beat",
                        json={"worker_name": self.worker_addr,
                              "queue_length": self.queue_length},
                    ) as resp:
                        exist = (await resp.json()).get("exist", False)
                    if not exist:
                        await self.register(session)
                except unreachable as e:  # controller down: keep trying
                    logger.warning("heartbeat error: %s", e)

    # ---------------- generation ----------------

    def _decode_images(self, images_b64):
        from PIL import Image

        return [Image.open(io.BytesIO(base64.b64decode(b))).convert("RGB")
                for b in images_b64]

    def generate_stream(self, payload: dict, cancel=None):
        """Sync generator of \\0-delimited JSON chunk bytes.

        ``cancel`` (threading.Event): set by the HTTP layer when the client
        disconnects. The scheduler aborts the row at the next chunk
        boundary (its pages and slot released); the serial path closes its
        stream, which stops decode at the next chunk. An out-of-memory
        error on the card gives ``OUT_OF_MEMORY``, any other failure
        ``SERVER_ERROR``."""
        try:
            prompt = payload["prompt"]
            images_b64 = payload.get("images") or []
            image = None
            if images_b64:
                decoded = self._decode_images(images_b64)
                image = decoded if len(decoded) > 1 else decoded[0]
            temperature = float(payload.get("temperature", 0.0))
            sampling = SamplingParams(
                temperature=temperature,
                top_p=float(payload.get("top_p", 1.0)),
            )
            stop = payload.get("stop")
            stop_strings = [stop] if isinstance(stop, str) else list(stop or [])
            max_new = min(int(payload.get("max_new_tokens", 256)),
                          MAX_NEW_TOKENS_CAP)

            # a request's "spec" overrides the worker default; spec decode
            # is greedy-only, so a sampled request decodes plainly (asking
            # for both is a client error)
            spec = bool(payload.get("spec", self.spec_decode))
            if spec and temperature > 0:
                if "spec" in payload:
                    yield chunk("spec decoding is greedy-only; "
                                "set temperature 0", ErrorCode.CLIENT_ERROR)
                    return
                spec = False

            if self.scheduler is not None:
                stream = self.scheduler.submit(
                    prompt, image, max_new_tokens=max_new, sampling=sampling,
                    stop_strings=tuple(stop_strings), cancel=cancel)
            else:
                stream = self.engine.stream(
                    prompt, image, max_new_tokens=max_new, sampling=sampling,
                    stop_strings=stop_strings, spec=spec,
                    draft_k=self.spec_draft_k)
            for update in stream:
                if cancel is not None and cancel.is_set():
                    # the scheduler already aborts the row; returning closes
                    # the serial stream
                    return
                if "error" in update:
                    yield chunk(update["error"], ErrorCode.SERVER_ERROR)
                    return
                yield chunk(update["text"], ErrorCode.OK,
                            stats=update.get("stats", {}))
        except torch.cuda.OutOfMemoryError as e:
            logger.exception("generation ran out of device memory")
            yield chunk(f"{SERVER_ERROR_MSG} ({e})", ErrorCode.OUT_OF_MEMORY)
        except Exception as e:  # the error envelope
            logger.exception("generation error")
            yield chunk(f"{SERVER_ERROR_MSG} ({e})", ErrorCode.SERVER_ERROR)


def _openai_to_worker_payload(body: dict, worker: ModelWorker) -> dict:
    """OpenAI chat body -> the worker payload: the engine's template
    rendered over the messages, image parts (data: URIs or raw base64) as
    base64 images with an ``<image>`` in their place."""
    conv = conv_templates[getattr(worker.engine, "conv_mode", "qwen_2")].copy()
    images = []
    for m in body.get("messages", []):
        role = m.get("role", "user")
        content = m.get("content", "")
        text_parts = []
        if isinstance(content, list):
            for part in content:
                if part.get("type") == "text":
                    text_parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    url = part.get("image_url", {}).get("url", "")
                    b64 = url.split(",", 1)[1] if url.startswith("data:") else url
                    images.append(b64)
                    text_parts.append(DEFAULT_IMAGE_TOKEN)
        else:
            text_parts.append(str(content))
        text = "\n".join(t for t in text_parts if t)
        if role == "system":
            conv.system = "<|im_start|>system\n" + text
        elif role == "assistant":
            conv.append_message(conv.roles[1], text)
        else:
            conv.append_message(conv.roles[0], text)
    conv.append_message(conv.roles[1], None)
    return {
        "prompt": conv.get_prompt(),
        "images": images,
        "temperature": float(body.get("temperature", 0.0) or 0.0),
        "top_p": float(body.get("top_p", 1.0) or 1.0),
        "max_new_tokens": int(body.get("max_tokens") or 256),
        "stop": body.get("stop"),
    }


def build_app(worker: ModelWorker):
    """The worker's aiohttp application (with the heartbeat task when a
    controller address is set)."""
    from aiohttp import web

    routes = web.RouteTableDef()

    async def pump(gen):
        """The generator's chunks, each pulled in the worker's executor."""
        loop = asyncio.get_running_loop()
        while True:
            piece = await loop.run_in_executor(worker.executor, next, gen,
                                               None)
            if piece is None:
                return
            yield piece

    @routes.post("/worker_generate_stream")
    async def generate_stream(request: web.Request):
        payload = await request.json()
        resp = web.StreamResponse()
        await resp.prepare(request)
        worker.queue_length += 1
        # set on client disconnect (aiohttp cancels this handler, or a write
        # raises): the finally aborts the in-flight row, a no-op once done
        cancel = threading.Event()
        try:
            async with worker.semaphore:
                async for piece in pump(
                        worker.generate_stream(payload, cancel=cancel)):
                    await resp.write(piece)
        finally:
            cancel.set()
            worker.queue_length -= 1
        return resp

    @routes.post("/worker_get_status")
    async def get_status(request: web.Request):
        return web.json_response(worker.status())

    @routes.post("/v1/chat/completions")
    async def openai_chat(request: web.Request):
        body = await request.json()
        payload = _openai_to_worker_payload(body, worker)
        created = int(time.time())
        rid = "chatcmpl-" + uuid.uuid4().hex[:12]
        model = body.get("model", worker.model_name)

        def event(delta, finish_reason=None):
            return b"data: " + json.dumps({
                "id": rid, "object": "chat.completion.chunk",
                "created": created, "model": model,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish_reason}],
            }).encode() + b"\n\n"

        worker.queue_length += 1
        cancel = threading.Event()  # set on client disconnect (finally)
        try:
            async with worker.semaphore:
                gen = worker.generate_stream(payload, cancel=cancel)
                if not body.get("stream", False):
                    last = {"text": "", "error_code": 0}
                    async for piece in pump(gen):
                        for msg in iter_chunks([piece]):
                            last = msg
                    if last.get("error_code"):
                        return web.json_response(
                            {"error": {"message": last["text"]}}, status=500)
                    return web.json_response({
                        "id": rid, "object": "chat.completion",
                        "created": created, "model": model,
                        "choices": [{"index": 0, "finish_reason": "stop",
                                     "message": {"role": "assistant",
                                                 "content": last["text"]}}],
                    })

                resp = web.StreamResponse(
                    headers={"Content-Type": "text/event-stream"})
                await resp.prepare(request)
                sent = 0
                async for piece in pump(gen):
                    for msg in iter_chunks([piece]):
                        delta = msg["text"][sent:]
                        sent = len(msg["text"])
                        if delta or msg.get("error_code"):
                            await resp.write(event({"content": delta}))
                await resp.write(event({}, "stop"))
                await resp.write(b"data: [DONE]\n\n")
                return resp
        finally:
            cancel.set()
            worker.queue_length -= 1

    @routes.post("/worker_get_conv_template")
    async def get_conv(request: web.Request):
        return web.json_response(
            {"conv": getattr(worker.engine, "conv_mode", "qwen_2")})

    app = web.Application()
    app.add_routes(routes)

    if worker.controller_addr:
        async def heartbeat(app):
            task = asyncio.create_task(worker.heartbeat_loop())
            yield
            task.cancel()

        app.cleanup_ctx.append(heartbeat)
    return app


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=40000)
    parser.add_argument("--worker-address", default=None)
    parser.add_argument("--controller-address", default=None)
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--random-weights", action="store_true",
                        help="the tiny random model and byte tokenizer")
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--kv-page-size", type=int, default=64,
                        help="paged-KV page size (tokens) for the batcher")
    parser.add_argument("--kv-pool-tokens", type=int, default=16384,
                        help="paged-KV pool capacity in tokens")
    parser.add_argument("--continuous-batching", action="store_true",
                        help="batch concurrent requests into one decode loop")
    parser.add_argument("--spec-decode", action="store_true",
                        help="default greedy requests to prompt-lookup "
                             "speculative decoding (the same tokens, fewer "
                             "decoder passes)")
    parser.add_argument("--spec-draft-k", type=int, default=8,
                        help="speculative draft length per verify pass")
    parser.add_argument("--warmup-tokens", type=int, default=0,
                        help="run the scheduler's dummy dispatches at start-up "
                             "for prompts up to this many tokens (0 = off); "
                             "continuous batching only")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="chunked admission prefill width in tokens (0 = "
                             "off; default: 256 from 1e9 decoder parameters, "
                             "off below)")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: the decoder sharded "
                             "over a (1, tp) mesh of tp processes (torchrun "
                             "--nproc-per-node tp); rank 0 serves HTTP")
    args = parser.parse_args(argv)
    from fastvlm_tpu_torch.parallel.distributed import tp_world_error

    world_error = tp_world_error(args.tp, "fastvlm_tpu_torch.serve.worker")
    if args.tp > 1 and world_error:
        print(world_error, file=sys.stderr)
        return 2
    if not args.random_weights and not args.model_path:
        parser.error("--model-path required (or use --random-weights)")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 1
    build_logger(logger.name, f"model_worker_{args.port}.log")

    from fastvlm_tpu_torch.engine import build_engine

    mesh = None
    if args.tp > 1:
        from fastvlm_tpu_torch.parallel import distributed, make_mesh

        distributed.initialize(device=args.device)
        mesh = make_mesh(dp=1, tp=args.tp)
    try:
        if args.random_weights:
            engine = build_engine(random_tiny=True, device=args.device,
                                  mesh=mesh)
        else:
            engine = build_engine(args.model_path, dtype=args.dtype,
                                  device=args.device, mesh=mesh)
        if not engine.is_leader:
            engine.follow()
            return 0
        try:
            return _serve(args, engine)
        finally:
            engine.close()
    finally:
        if mesh is not None:
            distributed.shutdown()


def _serve(args, engine) -> int:
    from aiohttp import web

    logger.info("engine ready (%s) on %s", args.model_name or args.model_path,
                args.device)
    name = args.model_name or (args.model_path or "fastvlm-tiny").split("/")[-1]
    addr = args.worker_address or f"http://localhost:{args.port}"
    worker = ModelWorker(engine, name, worker_addr=addr,
                         controller_addr=args.controller_address,
                         limit_concurrency=args.limit_model_concurrency,
                         continuous_batching=args.continuous_batching,
                         page_size=args.kv_page_size,
                         pool_tokens=args.kv_pool_tokens,
                         spec_decode=args.spec_decode,
                         spec_draft_k=args.spec_draft_k,
                         warmup_tokens=args.warmup_tokens,
                         prefill_chunk=args.prefill_chunk)
    web.run_app(build_app(worker), host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
