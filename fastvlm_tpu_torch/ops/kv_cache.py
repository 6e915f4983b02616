"""KV caches for autoregressive decode: dense, and paged (the serving layout).

Same layouts as ``fastvlm_tpu/ops/kv_cache.py``:

* dense: a pair of ``(L, B, S_max, H_kv, D)`` tensors allocated once, written
  compactly per row. Row b fills positions [0, len_b); decode writes the
  token of row b at index ``lengths[b]``, and attention masks keys at
  ``k >= lengths[b] + 1``.
* paged: one pool of fixed-size pages shared by every row, ``(L, P, page,
  H_kv, D)``, and a ``(B, pages_per_seq)`` int32 block table per batch that
  maps virtual position t of row b to pool page ``block_tables[b, t //
  page]``, slot ``t % page`` (-1 = unmapped).

Unlike the JAX arrays, these tensors are updated IN PLACE: the writes fill
the cache they are given and return it, so a decode step allocates no new
cache.

int8 (``init_cache(dtype=torch.int8)``, a decoder with
``kv_cache_dtype="int8"``): the dense cache stores int8 keys and values
with one f32 scale per token and KV head, ``k_scale`` / ``v_scale`` of
shape (L, B, S_max, H_kv), quantized at each write (``quantize_tokens``:
absmax / 127, round half to even). The paged pool has no int8 layout, as
in JAX: a scheduler over an int8-KV engine serves from a dense cache.

Dropped writes. JAX drops a paged write whose page is unmapped (-1) or
whose position is past the table's capacity by scattering it out of bounds
with ``mode="drop"``. Torch has no such mode: a negative index wraps, an
out-of-range one raises on the CPU and is a device-side assert on CUDA, and
a boolean mask syncs the host. So the port's pool carries one extra page
past the P that ``serve/batcher.PagePool`` hands out, the *sink*: dropped
writes land there, and no block table ever maps it. ``k_pages`` is
``(L, P + 1, page, H_kv, D)``; ``PagedKVCache.num_pages`` is P.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class KVCache:
    k: torch.Tensor        # (L, B, S_max, H_kv, D): float, or int8
    v: torch.Tensor        # (L, B, S_max, H_kv, D)
    lengths: torch.Tensor  # (B,) int32: tokens currently stored per row
    # int8 layout only: per-token-per-head scales, (L, B, S_max, H_kv) f32
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache(num_layers, batch, max_len, num_kv_heads, head_dim,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    """dtype=torch.int8 allocates the quantized layout: two separate scale
    tensors, initialised to ones."""
    shape = (num_layers, batch, max_len, num_kv_heads, head_dim)
    ks = vs = None
    if dtype == torch.int8:
        ks = torch.ones(shape[:-1], dtype=torch.float32, device=device)
        vs = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
        k_scale=ks, v_scale=vs,
    )


def quantize_tokens(x: torch.Tensor):
    """(..., H, D) float -> (int8 values, (..., H) f32 scale per token and
    head): absmax / 127 (1 for an all-zero vector), round half to even."""
    xf = x.float()
    m = xf.abs().amax(dim=-1)
    scale = torch.where(m == 0, torch.ones_like(m), m / 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_view(x: torch.Tensor, scale: Optional[torch.Tensor], dtype):
    """int8 (..., H, D) and scale (..., H) -> dtype, the product in dtype;
    a float cache (scale None) is only cast."""
    if scale is None:
        return x.to(dtype)
    return x.to(dtype) * scale[..., None].to(dtype)


def write_prompt(layer_k, layer_v, new_k, new_v, offset=0, layer_ks=None,
                 layer_vs=None):
    """Prefill write, in place: (B, T, H, D) keys/values go to positions
    [offset, offset+T) of the (B, S_max, H, D) layer cache; an int8 cache
    quantizes them and writes their scales to ``layer_ks`` / ``layer_vs``
    (B, S_max, H)."""
    t = new_k.shape[1]
    if layer_k.dtype == torch.int8:
        new_k, ks = quantize_tokens(new_k)
        new_v, vs = quantize_tokens(new_v)
        layer_ks[:, offset:offset + t] = ks
        layer_vs[:, offset:offset + t] = vs
    layer_k[:, offset:offset + t] = new_k.to(layer_k.dtype)
    layer_v[:, offset:offset + t] = new_v.to(layer_v.dtype)
    return layer_k, layer_v


def write_token(layer_k, layer_v, new_k, new_v, lengths, layer_ks=None,
                layer_vs=None):
    """Decode write, in place: row b's (T, H, D) keys/values go to indices
    [lengths[b], lengths[b] + T) (T = 1 a decode step, k + 1 a speculative
    verify pass); an int8 cache quantizes them and writes their scales at
    the same indices. Indices stay on the device (no host sync). JAX's
    ``dynamic_update_slice`` clamps a window that runs past S_max to end at
    S_max; here it raises, so callers size the cache to hold every write
    (``vlm.spec_cache_len``)."""
    t = new_k.shape[1]
    rows = torch.arange(layer_k.shape[0], device=layer_k.device)[:, None]
    idx = lengths.long()[:, None] + torch.arange(t, device=layer_k.device)
    if layer_k.dtype == torch.int8:
        new_k, ks = quantize_tokens(new_k)
        new_v, vs = quantize_tokens(new_v)
        layer_ks[rows, idx] = ks
        layer_vs[rows, idx] = vs
    layer_k[rows, idx] = new_k.to(layer_k.dtype)
    layer_v[rows, idx] = new_v.to(layer_v.dtype)
    return layer_k, layer_v


# ---------------------------------------------------------------------------
# paged (block-table) cache
# ---------------------------------------------------------------------------


@dataclass
class PagedKVCache:
    k_pages: torch.Tensor       # (L, P + 1, page, H_kv, D): P pages + the sink
    v_pages: torch.Tensor       # (L, P + 1, page, H_kv, D)
    block_tables: torch.Tensor  # (B, pages_per_seq) int32, -1 = unmapped
    lengths: torch.Tensor       # (B,) int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_pages(self) -> int:
        """Pages a table may map (the sink excluded)."""
        return self.k_pages.shape[1] - 1

    @property
    def max_len(self) -> int:
        """Virtual per-sequence capacity (pages_per_seq * page_size)."""
        return self.block_tables.shape[1] * self.k_pages.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k_pages.shape[0]


def init_paged_cache(num_layers, batch, num_pages, page_size, pages_per_seq,
                     num_kv_heads, head_dim, dtype=torch.bfloat16,
                     device="cpu") -> PagedKVCache:
    """Pool of ``num_pages`` pages plus the sink; every row starts with an
    empty table."""
    shape = (num_layers, num_pages + 1, page_size, num_kv_heads, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((batch, pages_per_seq), -1, dtype=torch.int32,
                                device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _flat_dest(block_tables, positions, page_size, sink_page):
    """Virtual positions (B, T) -> flat pool rows (B, T) into
    ((P + 1) * page). A position whose page is unmapped (-1) or past the
    table's capacity goes to the sink page instead (JAX sends it out of
    bounds and drops it); the gather clamps the column so it never reads
    past the table."""
    n = block_tables.shape[1]
    slots = positions // page_size
    page_ids = torch.gather(block_tables, 1, slots.clamp(max=n - 1).long())
    within = positions % page_size
    dropped = (page_ids < 0) | (slots >= n)
    return torch.where(dropped, sink_page * page_size + within,
                       page_ids * page_size + within).long()


def prompt_dest(block_tables, t, offset, page_size, sink_page):
    """Flat pool rows (B * T,) of a prefill write of T tokens at virtual
    rows [offset, offset+T) of each sequence. The same for every layer, so
    a forward computes it once."""
    b = block_tables.shape[0]
    pos = offset + torch.arange(t, dtype=torch.int32,
                                device=block_tables.device)[None, :]
    return _flat_dest(block_tables, pos.expand(b, t), page_size,
                      sink_page).reshape(-1)


def token_dest(block_tables, lengths, page_size, sink_page, t=1):
    """Flat pool rows (B * T,) of a decode write of T tokens at virtual
    positions [lengths[b], lengths[b] + T) of each row (T = 1 a decode
    step, k + 1 a speculative verify pass); a position past the mapped
    pages goes to the sink. The same for every layer."""
    pos = lengths[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=lengths.device)[None, :]
    return _flat_dest(block_tables, pos, page_size, sink_page).reshape(-1)


def write_paged(layer_k, layer_v, new_k, new_v, dest):
    """Paged write, in place: (B, T, H, D) keys/values to the flat pool
    rows ``dest`` (B * T,) of one layer's (P + 1, page, H, D) slices. Rows
    sent to the sink may repeat; which one lands there does not matter."""
    h, d = layer_k.shape[2:]
    for pages, new in ((layer_k, new_k), (layer_v, new_v)):
        pages.view(-1, h, d).index_copy_(
            0, dest, new.to(pages.dtype).reshape(-1, h, d))
    return layer_k, layer_v


def write_prompt_paged(layer_k, layer_v, new_k, new_v, block_tables,
                       offset=0):
    """Prefill write, in place: (B, T, H, D) keys/values to virtual rows
    [offset, offset+T) of each sequence. layer_k/v: (P + 1, page, H, D) pool
    slices of one layer."""
    dest = prompt_dest(block_tables, new_k.shape[1], offset,
                       layer_k.shape[1], layer_k.shape[0] - 1)
    return write_paged(layer_k, layer_v, new_k, new_v, dest)


def write_token_paged(layer_k, layer_v, new_k, new_v, block_tables, lengths):
    """Decode write, in place: row b's (T, H, D) keys/values to virtual
    positions [lengths[b], lengths[b] + T), each row at its own offset (JAX
    ``write_token_paged`` for T = 1, ``write_tokens_paged_rows`` for any
    T). layer_k/v: (P + 1, page, H, D); new_k/v: (B, T, H, D)."""
    dest = token_dest(block_tables, lengths, layer_k.shape[1],
                      layer_k.shape[0] - 1, new_k.shape[1])
    return write_paged(layer_k, layer_v, new_k, new_v, dest)


def gather_pages(layer_pages, block_tables):
    """Dense (B, pages_per_seq * page, H, D) copy of one layer's pool in
    each row's virtual order: the plain attention path's keys (kernel K3
    reads the pages in place instead). Unmapped entries (-1) clamp to page
    0; callers mask by length."""
    b, n = block_tables.shape
    _, page, h, d = layer_pages.shape
    idx = block_tables.clamp(min=0).reshape(-1).long()
    return layer_pages.index_select(0, idx).reshape(b, n * page, h, d)
