"""Serving: the continuous-batching scheduler over a paged KV pool
(``batcher.py``). The JAX package's HTTP tier (worker, controller, web) is
not ported yet."""
