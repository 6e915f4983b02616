"""Kernel K2: decode attention of one query token against a dense KV cache.

The port of ``fastvlm_tpu/ops/pallas/decode_attention.py::decode_attention``.
The kernel is hand-written CUDA C++ for sm_90a
(``csrc/decode_attention.cu``: split-sequence flash decoding plus a merge
pass), built at first use by ``_build.py`` and called through ctypes.
``decode_attention_reference`` is the same formula in plain PyTorch: the CPU
path and the oracle the kernel is held against on the card.

Routing is by device only: a CPU tensor takes the reference; a CUDA tensor
launches the kernel or raises. ``decode_attention.launches`` counts kernel
launches (one per call: the split pass and its merge).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fastvlm_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_reference(q, k, v, lengths):
    """Plain version of the kernel. q: (B, Hq, D); k/v: (B, S_max, Hkv, D);
    lengths: (B,) valid key counts. q is scaled by D^-0.5 in its own dtype,
    keys >= lengths[b] are masked with -1e30, softmax and P.V in f32, the
    denominator floored at 1e-30; returns (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = torch.tensor(d ** -0.5, dtype=q.dtype).item()  # rounded to q's dtype
    qs = (q * scale).float()
    qs = qs.reshape(b, hkv, g, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qs, k.float())
    valid = (torch.arange(s_max, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])                    # (B, S)
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
    kernel runs on the current stream, unsynchronised."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    _check_cuda_args(q, k, v, lengths)
    b, hq, d = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    lib, split = _load()
    n_split = -(-s_max // split)
    # one f32 workspace: the splits' partial P.V (B, Hq, n_split, D), then
    # their (max, sum) pairs (B, Hq, n_split, 2)
    n_acc = b * hq * n_split * d
    ws = torch.empty(n_acc + b * hq * n_split * 2, dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    err = lib.fvlm_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        ws.data_ptr(), ws.data_ptr() + 4 * n_acc, out.data_ptr(),
        b, hq, hkv, d, s_max, n_split, _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


@functools.cache
def _load():
    """(library, keys per split block)."""
    lib = _build.load("decode_attention")
    lib.fvlm_decode_attention.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.fvlm_decode_attention.restype = ctypes.c_int
    lib.fvlm_decode_split.argtypes = []
    lib.fvlm_decode_split.restype = ctypes.c_int
    return lib, lib.fvlm_decode_split()
