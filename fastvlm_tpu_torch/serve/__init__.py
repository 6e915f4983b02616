"""Serving: the continuous-batching scheduler over a paged KV pool
(``batcher.py``) and the HTTP tier over it: the model worker
(``worker.py``), the controller that registers and dispatches workers
(``controller.py``), a delegating worker (``proxy_worker.py``), the web chat
page (``web.py``), the in-process chat REPL (``cli.py``) and two small
clients (``register_worker.py``, ``test_message.py``). The HTTP modules
import ``aiohttp`` only where they speak HTTP."""
