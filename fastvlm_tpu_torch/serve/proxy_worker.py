"""Delegating model worker (the reference's sglang_worker equivalent): the
standard worker API (register, heartbeat, status, generate stream) in front
of another runtime's HTTP endpoint.

Counterpart of ``fastvlm_tpu/serve/proxy_worker.py``, with one fix: its
``generate_stream`` takes the ``cancel`` event that ``serve/worker.py``'s
routes pass, and closes the backend stream once it is set (the JAX
override takes no ``cancel``, so every proxied request raises TypeError
before its first chunk).
"""

from __future__ import annotations

import argparse
import logging
import sys

from fastvlm_tpu_torch.serve.protocol import DELIMITER, ErrorCode, chunk
from fastvlm_tpu_torch.serve.worker import ModelWorker, build_app
from fastvlm_tpu_torch.utils.logging import build_logger

logger = logging.getLogger("fastvlm_tpu_torch.proxy_worker")


class ProxyWorker(ModelWorker):
    """A ModelWorker whose generation POSTs to ``backend_addr``: a backend
    speaking the \\0-chunk protocol is streamed through as it is; a plain
    JSON {"text": ...} response becomes one chunk."""

    def __init__(self, backend_addr: str, model_name: str, **kw):
        super().__init__(engine=None, model_name=model_name, **kw)
        self.backend_addr = backend_addr.rstrip("/")

    def generate_stream(self, payload: dict, cancel=None):
        """Sync generator of the backend's chunk bytes. Once ``cancel`` is
        set, it stops at the next piece and closes the backend connection,
        so the backend sees the client go away; closing the generator does
        the same."""
        import requests

        resp = None
        try:
            resp = requests.post(
                self.backend_addr + "/worker_generate_stream",
                json=payload, stream=True, timeout=600)
            if resp.status_code != 200:
                yield chunk(f"backend error {resp.status_code}",
                            ErrorCode.SERVER_ERROR)
                return
            ctype = resp.headers.get("Content-Type", "")
            if "json" in ctype and DELIMITER not in resp.content[:1]:
                data = resp.json()  # a non-streaming JSON backend
                yield chunk(data.get("text", ""), data.get("error_code", 0))
                return
            for piece in resp.iter_content(chunk_size=None):
                if cancel is not None and cancel.is_set():
                    return
                if piece:
                    yield piece
        except (requests.RequestException, ValueError) as e:
            logger.exception("proxy error")
            yield chunk(f"proxy failure: {e}", ErrorCode.SERVER_ERROR)
        finally:
            if resp is not None:
                resp.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=41000)
    parser.add_argument("--worker-address", default=None)
    parser.add_argument("--controller-address", default=None)
    parser.add_argument("--backend-address", required=True)
    parser.add_argument("--model-name", required=True)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    args = parser.parse_args(argv)
    build_logger(logger.name, f"proxy_worker_{args.port}.log")
    from aiohttp import web

    addr = args.worker_address or f"http://localhost:{args.port}"
    worker = ProxyWorker(args.backend_address, args.model_name,
                         worker_addr=addr,
                         controller_addr=args.controller_address,
                         limit_concurrency=args.limit_model_concurrency)
    web.run_app(build_app(worker), host=args.host, port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
