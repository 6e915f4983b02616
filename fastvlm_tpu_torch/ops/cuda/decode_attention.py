"""Kernel K2: decode attention of one query token against a dense KV cache.

The port of ``fastvlm_tpu/ops/pallas/decode_attention.py::decode_attention``.
The kernel is hand-written CUDA C++ for sm_90a
(``csrc/decode_attention.cu``: split-sequence flash decoding on mma.sync in
one launch; a split is a cluster of 8 blocks merged through distributed
shared memory, and where a row has several splits the last block to finish
merges them), built at first use by ``_build.py`` and called through
ctypes.
``decode_attention_reference`` is the same formula in plain PyTorch: the CPU
path and the oracle the kernel is held against on the card.

Routing is by device only: a CPU tensor takes the reference; a CUDA tensor
launches the kernel or raises. ``decode_attention.launches`` counts kernel
launches (one per call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fastvlm_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_reference(q, k, v, lengths, window=None):
    """Plain version of the kernel. q: (B, Hq, D); k/v: (B, S_max, Hkv, D);
    lengths: (B,) valid key counts. q is scaled by D^-0.5 in its own dtype,
    keys >= lengths[b] (and, with a ``window`` W, keys < lengths[b] - W: K3's
    windowed route) are masked with -1e30, softmax and P.V in f32, the
    denominator floored at 1e-30; returns (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = torch.tensor(d ** -0.5, dtype=q.dtype).item()  # rounded to q's dtype
    qs = (q * scale).float()
    qs = qs.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qs, k.float())
    k_pos = torch.arange(s_max, device=q.device)[None, :]
    valid = k_pos < lengths.to(q.device)[:, None]                # (B, S)
    if window is not None:
        valid = valid & (k_pos >= lengths.to(q.device)[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    den = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / den
    return out.reshape(b, hq, d).to(q.dtype)


def _check_cuda_args(q, k, v, lengths):
    b, hq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"decode_attention: k shape {tuple(k.shape)} does "
                         f"not match q {tuple(q.shape)}")
    hkv = k.shape[2]
    if v.shape != k.shape:
        raise ValueError("decode_attention: v and k shapes differ")
    if hq % hkv or hq // hkv > 16:
        raise ValueError(f"decode_attention: needs Hq % Hkv == 0 and "
                         f"Hq / Hkv <= 16, got {hq}/{hkv}")
    if d not in (16, 64, 128):
        raise ValueError(f"decode_attention: head_dim {d} not in (16, 64, 128)")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention: unsupported dtype {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"decode_attention: {name} is {x.dtype} on "
                             f"{x.device}, expected {q.dtype} on {q.device}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,) \
            or lengths.device != q.device:
        raise ValueError("decode_attention: lengths must be (B,) int32 on "
                         "q's device")
    for name, x in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             f"and 16-byte aligned")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D) single-step queries; k/v: (B, S_max, Hkv, D) cache;
    lengths: (B,) int32 valid key counts, each >= 1 (they include the token
    just written). Returns (B, Hq, D) in q's dtype. On a CUDA device the
    kernel runs on the current stream, unsynchronised. Its workspace and
    arrival counters are kept per (device, stream): calls on one stream run
    in order and share them, calls on two streams never do."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _check_cuda_args(q, k, v, lengths)
    b, hq, d = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    lib = _load()
    dtype = _DTYPE_CODES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _workspace(lib, q.device, stream, b, hq, hkv, d, s_max,
                              dtype)
    out = torch.empty_like(q)
    err = lib.fvlm_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), ws,
        counters, out.data_ptr(), b, hq, hkv, d, s_max, dtype, stream)
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

# (device, stream) -> [f32 workspace, int32 arrival counters], grown on
# demand and reused by every call on that stream, which runs them in order.
# The counters are zeroed when made and each call leaves them at zero.
_BUFFERS: dict = {}
_WS_ELEMS: dict = {}


def _workspace(lib, device, stream, b, hq, hkv, d, s_max, dtype):
    """(workspace address, counters address) for a call of this shape on
    this stream."""
    key = (b, hq, hkv, d, s_max, dtype)
    elems = _WS_ELEMS.get(key)
    if elems is None:
        elems = _WS_ELEMS[key] = lib.fvlm_decode_workspace(*key)
    return stream_buffers(_BUFFERS, device, stream, elems, b * hkv)


def stream_buffers(buffers: dict, device, stream, elems: int, groups: int):
    """(workspace address, counters address) from ``buffers``, a map of
    (device, stream) -> [f32 workspace, int32 arrival counters], each grown
    to at least ``elems`` and ``groups`` elements (K2's and K3's layout)."""
    bufs = buffers.get((device, stream))
    if bufs is None:
        bufs = buffers[(device, stream)] = [None, None]
    if bufs[0] is None or bufs[0].numel() < elems:
        bufs[0] = torch.empty(elems, dtype=torch.float32, device=device)
    if bufs[1] is None or bufs[1].numel() < groups:
        bufs[1] = torch.zeros(groups, dtype=torch.int32, device=device)
    return bufs[0].data_ptr(), bufs[1].data_ptr()


@functools.cache
def _load():
    lib = _build.load("decode_attention")
    lib.fvlm_decode_attention.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.fvlm_decode_attention.restype = ctypes.c_int
    lib.fvlm_decode_workspace.argtypes = [ctypes.c_int] * 6
    lib.fvlm_decode_workspace.restype = ctypes.c_longlong
    lib.fvlm_decode_split.argtypes = [ctypes.c_int] * 5
    lib.fvlm_decode_split.restype = ctypes.c_int
    return lib


def split_size(b: int, hkv: int, d: int, s_max: int, dtype: torch.dtype) -> int:
    """Keys per split block the kernel uses for this shape (card only)."""
    return _load().fvlm_decode_split(b, hkv, d, s_max, _DTYPE_CODES[dtype])
