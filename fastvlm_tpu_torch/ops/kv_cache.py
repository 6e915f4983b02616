"""Dense KV cache for autoregressive decode.

Same layout as ``fastvlm_tpu/ops/kv_cache.py``: a pair of dense
``(L, B, S_max, H_kv, D)`` tensors allocated once, written compactly per row.
Row b fills positions [0, len_b); decode writes the token of row b at index
``lengths[b]``, and attention masks keys at ``k >= lengths[b] + 1``.

Unlike the JAX arrays, these tensors are updated IN PLACE: ``write_prompt``
and ``write_token`` write into the cache they are given and return it, so a
decode step allocates no new cache. The paged and int8 layouts are not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    k: torch.Tensor        # (L, B, S_max, H_kv, D)
    v: torch.Tensor        # (L, B, S_max, H_kv, D)
    lengths: torch.Tensor  # (B,) int32: tokens currently stored per row

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(num_layers, batch, max_len, num_kv_heads, head_dim,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def write_prompt(layer_k, layer_v, new_k, new_v, offset=0):
    """Prefill write, in place: (B, T, H, D) keys/values go to positions
    [offset, offset+T) of the (B, S_max, H, D) layer cache."""
    t = new_k.shape[1]
    layer_k[:, offset:offset + t] = new_k.to(layer_k.dtype)
    layer_v[:, offset:offset + t] = new_v.to(layer_v.dtype)
    return layer_k, layer_v


def write_token(layer_k, layer_v, new_k, new_v, lengths):
    """Decode write, in place: row b's (1, H, D) key/value goes to index
    lengths[b]. Indices stay on the device (no host sync)."""
    rows = torch.arange(layer_k.shape[0], device=layer_k.device)
    idx = lengths.long()
    layer_k[rows, idx] = new_k[:, 0].to(layer_k.dtype)
    layer_v[rows, idx] = new_v[:, 0].to(layer_v.dtype)
    return layer_k, layer_v
