"""Kernel K3: decode attention of one query token against a paged KV pool.

The port of ``fastvlm_tpu/ops/pallas/decode_attention.py::
paged_decode_attention``. The kernel is hand-written CUDA C++ for sm_90a
(``csrc/paged_decode_attention.cu``): K2's one-launch flash-decoding body
(``csrc/decode_body.cuh``: a split is a cluster of 8 blocks merged through
distributed shared memory, and where a row has several splits the last
block to finish merges them) with each warp's keys located through the
block table once a tile, ahead of the copies. Like K2 it is bound by
device-memory bytes in principle and by latency in practice (a serving
call reads ~2 MB); one launch and one table trip ahead of the first copies
are what the design spends. It is built at first use by ``_build.py`` and
called through ctypes.
``paged_decode_attention_reference`` is the same function in plain PyTorch:
``gather_pages`` (-1 clamped to page 0) followed by K2's formula. It is the
CPU path and the oracle the kernel is held against on the card.

Routing is by device only: a CPU tensor takes the reference; a CUDA tensor
launches the kernel or raises. ``paged_decode_attention.launches`` counts
kernel launches (one per call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fastvlm_tpu_torch.ops.cuda import _build
from fastvlm_tpu_torch.ops.cuda.decode_attention import (
    _DTYPE_CODES, decode_attention_reference, stream_buffers)
from fastvlm_tpu_torch.ops.kv_cache import gather_pages

PAGE_SIZES = (8, 16, 32, 64, 128)


def paged_decode_attention_reference(q, k_pages, v_pages, block_tables,
                                     lengths):
    """Plain version of the kernel. q: (B, Hq, D); k/v_pages: (P, page,
    Hkv, D); block_tables: (B, pages_per_seq) int32, -1 unmapped; lengths:
    (B,) valid key counts (past the table's capacity they count as the
    capacity). Returns (B, Hq, D) in q's dtype."""
    return decode_attention_reference(q, gather_pages(k_pages, block_tables),
                                      gather_pages(v_pages, block_tables),
                                      lengths)


def _check_cuda_args(q, k_pages, v_pages, block_tables, lengths):
    b, hq, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape[3] != d:
        raise ValueError(f"paged_decode_attention: k_pages shape "
                         f"{tuple(k_pages.shape)} does not match q "
                         f"{tuple(q.shape)}")
    page, hkv = k_pages.shape[1], k_pages.shape[2]
    if v_pages.shape != k_pages.shape:
        raise ValueError("paged_decode_attention: v_pages and k_pages shapes "
                         "differ")
    if page not in PAGE_SIZES:
        raise ValueError(f"paged_decode_attention: page size {page} not in "
                         f"{PAGE_SIZES}")
    if hq % hkv or hq // hkv > 16:
        raise ValueError(f"paged_decode_attention: needs Hq % Hkv == 0 and "
                         f"Hq / Hkv <= 16, got {hq}/{hkv}")
    if d not in (16, 64, 128):
        raise ValueError(f"paged_decode_attention: head_dim {d} not in "
                         f"(16, 64, 128)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged_decode_attention: unsupported dtype {q.dtype}")
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"paged_decode_attention: {name} is {x.dtype} on "
                             f"{x.device}, expected {q.dtype} on {q.device}")
    if (block_tables.dtype != torch.int32 or block_tables.device != q.device
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.shape[1] < 1):
        raise ValueError("paged_decode_attention: block_tables must be "
                         "(B, pages_per_seq) int32 on q's device")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) \
            or lengths.device != q.device:
        raise ValueError("paged_decode_attention: lengths must be (B,) int32 "
                         "on q's device")
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not x.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"contiguous")
    # K and V rows are read with 16-byte loads
    for name, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.data_ptr() % 16:
            raise ValueError(f"paged_decode_attention: {name} must be "
                             f"16-byte aligned")


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D) single-step queries; k/v_pages: (P, page, Hkv, D) one
    layer's pool; block_tables: (B, pages_per_seq) int32 pool page ids (-1 =
    unmapped); lengths: (B,) int32 valid key counts, each >= 1 (they include
    the token just written). Returns (B, Hq, D) in q's dtype. On a CUDA
    device the kernel runs on the current stream, unsynchronised; its grid
    spans pages_per_seq * page positions, so callers pass tables cut to the
    pages in flight. Its workspace and arrival counters are kept per
    (device, stream), as K2's are."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages,
                                                block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda_args(q, k_pages, v_pages, block_tables, lengths)
    b, hq, d = q.shape
    num_pages, page, hkv = k_pages.shape[:3]
    pps = block_tables.shape[1]
    lib = _load()
    dtype = _DTYPE_CODES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _workspace(lib, q.device, stream, b, hq, hkv, d, pps * page,
                              dtype)
    out = torch.empty_like(q)
    err = lib.fvlm_paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), ws, counters,
        out.data_ptr(), b, hq, hkv, d, page, pps, num_pages, dtype, stream)
    _build.check(lib, err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

# (device, stream) -> [f32 workspace, int32 arrival counters], as K2 keeps
# its own; the counters are zeroed when made and each call leaves them zero.
_BUFFERS: dict = {}
_WS_ELEMS: dict = {}


def _workspace(lib, device, stream, b, hq, hkv, d, s_cap, dtype):
    """(workspace address, counters address) for a call of this shape on
    this stream; s_cap = pages_per_seq * page."""
    key = (b, hq, hkv, d, s_cap, dtype)
    elems = _WS_ELEMS.get(key)
    if elems is None:
        elems = _WS_ELEMS[key] = lib.fvlm_paged_decode_workspace(*key)
    return stream_buffers(_BUFFERS, device, stream, elems, b * hkv)


@functools.cache
def _load():
    lib = _build.load("paged_decode_attention")
    lib.fvlm_paged_decode_attention.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.fvlm_paged_decode_attention.restype = ctypes.c_int
    lib.fvlm_paged_decode_workspace.argtypes = [ctypes.c_int] * 6
    lib.fvlm_paged_decode_workspace.restype = ctypes.c_longlong
    lib.fvlm_paged_decode_split.argtypes = [ctypes.c_int] * 5
    lib.fvlm_paged_decode_split.restype = ctypes.c_int
    return lib


def split_size(b: int, hkv: int, d: int, s_cap: int, dtype: torch.dtype) -> int:
    """Keys per split the kernel uses for this shape, s_cap = pages_per_seq
    * page (card only)."""
    return _load().fvlm_paged_decode_split(b, hkv, d, s_cap, _DTYPE_CODES[dtype])
