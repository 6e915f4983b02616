"""Serving controller: the worker registry, dispatch and heartbeat expiry.

Counterpart of ``fastvlm_tpu/serve/controller.py`` (the reference's
llava/serve/controller.py), on aiohttp with the same JSON bodies:

  POST /register_worker      {worker_name, check_heart_beat, worker_status}
  POST /receive_heart_beat   {worker_name, queue_length} -> {"exist": bool}
  POST /refresh_all_workers
  POST /list_models
  POST /get_worker_address   {model} -> {"address": url}
  POST /worker_generate_stream  (proxied to a dispatched worker)

Dispatch is ``lottery`` (speed-weighted random) or ``shortest_queue``
(queue / speed argmin, the winner's queue bumped). Workers whose last
heartbeat is older than CONTROLLER_HEART_BEAT_EXPIRATION s expire.
``aiohttp`` is imported by ``build_app`` and ``main`` only; the registry
and dispatch are plain Python.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging
import random
import sys
import time
from typing import Dict, List, Optional

from fastvlm_tpu_torch.data.constants import CONTROLLER_HEART_BEAT_EXPIRATION
from fastvlm_tpu_torch.serve.protocol import ErrorCode, chunk
from fastvlm_tpu_torch.utils.logging import build_logger

logger = logging.getLogger("fastvlm_tpu_torch.controller")

DISPATCH_METHODS = ("lottery", "shortest_queue")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        if dispatch_method not in DISPATCH_METHODS:
            raise ValueError(f"dispatch_method must be one of "
                             f"{DISPATCH_METHODS}, got {dispatch_method!r}")
        self.dispatch_method = dispatch_method
        self.workers: Dict[str, WorkerInfo] = {}

    # ---------------- registry ----------------

    def register_worker(self, name: str, check_heart_beat: bool,
                        status: Optional[dict]) -> bool:
        if status is None:
            return False
        self.workers[name] = WorkerInfo(
            model_names=status["model_names"],
            speed=status.get("speed", 1.0),
            queue_length=status.get("queue_length", 0),
            check_heart_beat=check_heart_beat,
            last_heart_beat=time.time(),
        )
        logger.info("registered worker %s: %s", name, status)
        return True

    def receive_heart_beat(self, name: str, queue_length: int) -> bool:
        w = self.workers.get(name)
        if w is None:
            return False
        w.queue_length = queue_length
        w.last_heart_beat = time.time()
        return True

    def remove_stale_workers(self) -> None:
        deadline = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        stale = [n for n, w in self.workers.items()
                 if w.check_heart_beat and w.last_heart_beat < deadline]
        for n in stale:
            logger.info("expiring stale worker %s", n)
            del self.workers[n]

    def list_models(self) -> List[str]:
        models = set()
        for w in self.workers.values():
            models.update(w.model_names)
        return sorted(models)

    # ---------------- dispatch ----------------

    def get_worker_address(self, model: str) -> str:
        """A worker serving ``model``, or "" when none does."""
        candidates = [(n, w) for n, w in self.workers.items()
                      if model in w.model_names]
        if not candidates:
            return ""
        if self.dispatch_method == "lottery":
            speeds = [w.speed for _, w in candidates]
            if sum(speeds) <= 0:
                return ""
            return random.choices([n for n, _ in candidates],
                                  weights=speeds, k=1)[0]
        name, w = min(candidates,
                      key=lambda kv: kv[1].queue_length / kv[1].speed)
        w.queue_length += 1
        return name


def build_app(controller: Controller):
    """The controller's aiohttp application, with the expiry task."""
    import aiohttp
    from aiohttp import web

    routes = web.RouteTableDef()

    @routes.post("/register_worker")
    async def register_worker(request: web.Request):
        data = await request.json()
        ok = controller.register_worker(
            data["worker_name"], data.get("check_heart_beat", True),
            data.get("worker_status"))
        return web.json_response({"exist": ok})

    @routes.post("/receive_heart_beat")
    async def receive_heart_beat(request: web.Request):
        data = await request.json()
        exist = controller.receive_heart_beat(
            data["worker_name"], data.get("queue_length", 0))
        return web.json_response({"exist": exist})

    @routes.post("/refresh_all_workers")
    async def refresh_all_workers(request: web.Request):
        controller.remove_stale_workers()
        return web.json_response({})

    @routes.post("/list_models")
    async def list_models(request: web.Request):
        return web.json_response({"models": controller.list_models()})

    @routes.post("/get_worker_address")
    async def get_worker_address(request: web.Request):
        data = await request.json()
        return web.json_response(
            {"address": controller.get_worker_address(data["model"])})

    @routes.post("/worker_generate_stream")
    async def proxy_stream(request: web.Request):
        # the controller as a proxy: stream a dispatched worker's chunks
        data = await request.json()
        addr = controller.get_worker_address(data.get("model", ""))
        resp = web.StreamResponse()
        await resp.prepare(request)
        if not addr:
            await resp.write(chunk("no available worker",
                                   ErrorCode.SERVER_ERROR))
            return resp
        async with aiohttp.ClientSession() as session:
            async with session.post(addr + "/worker_generate_stream",
                                    json=data) as upstream:
                async for piece, _ in upstream.content.iter_chunks():
                    await resp.write(piece)
        return resp

    async def expiry(app):
        async def loop():
            while True:
                await asyncio.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
                controller.remove_stale_workers()

        task = asyncio.create_task(loop())
        yield
        task.cancel()

    app = web.Application()
    app.add_routes(routes)
    app.cleanup_ctx.append(expiry)
    return app


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=10000)
    parser.add_argument("--dispatch-method", default="shortest_queue",
                        choices=DISPATCH_METHODS)
    args = parser.parse_args(argv)
    build_logger(logger.name, "controller.log")
    from aiohttp import web

    web.run_app(build_app(Controller(args.dispatch_method)), host=args.host,
                port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
