"""Kernel K4: causal GQA attention of a prefill over the prompt's own keys
or over a cache.

No Pallas kernel stands behind it: the JAX package computes the prefill's
attention in XLA, as the port did in plain PyTorch (``attend``, which
``models/qwen2.py`` runs off this route). The kernel is hand-written CUDA C++
for sm_90a (``csrc/prefill_attention.cu``: a flash-attention forward on
wgmma, the score square kept in registers), built at first use by
``_build.py`` and called through ctypes.

The mask is given by its structure, not as a tensor: query i of row b
attends key k where k <= offset + i and k < kv_lens[b] (no such limit where
``kv_lens`` is None). That is ``qwen2.prefill_mask(seq_lens, T, T)`` with
kv_lens = seq_lens and offset 0, and ``vlm.prefill_continue``'s mask with
kv_lens None and its cached offset. A window W (a sliding-window layer)
adds offset + i - k < W, and the kernel walks only the key tiles inside
it. ``prefill_attention_reference``
materialises that mask and runs ``attend``: the CPU path and the oracle the
kernel is held against on the card.

Routing is by device only: a CPU tensor takes the reference; a CUDA tensor
launches the kernel or raises. ``prefill_attention.launches`` counts kernel
launches (one per call), ``prefill_attention.window_launches`` those with a
window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fastvlm_tpu_torch.ops.cuda import _build

NEG_INF = -1e30
# what the kernel takes; ``qwen2._layer`` routes a prefill here only then
DTYPES = (torch.bfloat16, torch.float16)
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}


def attend(q, k, v, mask, bias=None):
    """Plain GQA attention. q: (B,T,Hq,D); k,v: (B,S,Hkv,D); mask:
    (B,1,T,S) bool; bias: optional (B,Hq,T,S). Scores and softmax in f32,
    probabilities rounded to v's dtype before P.V -> (B, T, Hq*D)."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) \
        * (d ** -0.5)
    if bias is not None:
        scores = scores + bias.reshape(b, hkv, g, t, -1)
    scores = torch.where(mask[:, :, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v.float())
    return out.to(v.dtype).reshape(b, t, hq * d)


def prefill_attention_reference(q, k, v, offset: int = 0,
                                kv_lens: Optional[torch.Tensor] = None,
                                window: Optional[int] = None):
    """Plain version of the kernel: the structured mask materialised as a
    (B, 1, T, S) tensor, then ``attend``. Arguments as
    ``prefill_attention``'s."""
    b, t = q.shape[:2]
    s = k.shape[1]
    dev = q.device
    q_pos = offset + torch.arange(t, device=dev)[:, None]
    k_pos = torch.arange(s, device=dev)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    mask = mask[None]
    if kv_lens is not None:
        mask = mask & (k_pos[None] < kv_lens.to(dev)[:, None, None])
    return attend(q, k, v, mask.expand(b, t, s)[:, None])


def _check_cuda_args(q, k, v, offset, kv_lens):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"prefill_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need (B, T, "
                         f"Hq, D) and two (B, S, Hkv, D)")
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"prefill_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"prefill_attention: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"prefill_attention: unsupported dtype {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"prefill_attention: {name} is {x.dtype} on "
                             f"{x.device}, expected {q.dtype} on {q.device}")
    if offset < 0:
        raise ValueError(f"prefill_attention: offset {offset} < 0")
    if kv_lens is not None and (kv_lens.shape != (b,)
                                or kv_lens.device != q.device):
        raise ValueError("prefill_attention: kv_lens must be (B,) on q's "
                         "device")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(-1) != 1 or x.data_ptr() % 16 or \
                any(st % 8 for st in x.stride()[:-1]):
            raise ValueError(f"prefill_attention: {name} needs D contiguous "
                             f"and 16-byte aligned rows, got strides "
                             f"{x.stride()}")


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      offset: int = 0,
                      kv_lens: Optional[torch.Tensor] = None,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (B, T, Hq, D) queries after RoPE; k / v: (B, S, Hkv, D) keys and
    values (views with any strides whose rows are 16-byte aligned, D
    contiguous: the qkv projection's slices); query i attends key k
    where k <= offset + i and k < kv_lens[b] ((B,) int, each >= 1; None: no
    such limit) and, with a ``window`` W, offset + i - k < W. Returns (B, T, Hq * D) in q's dtype. On a CUDA device the
    kernel runs on the current stream, unsynchronised."""
    if q.device.type == "cpu":
        return prefill_attention_reference(q, k, v, offset, kv_lens, window)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda_args(q, k, v, offset, kv_lens)
    if window is not None and window < 1:
        raise ValueError(f"prefill_attention: window {window} < 1")
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    lens = None if kv_lens is None else \
        kv_lens.to(torch.int32).contiguous()
    out = torch.empty((b, t, hq * d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    lib = _load()
    err = lib.fvlm_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lens is None else lens.data_ptr(), out.data_ptr(), b, t, s,
        hq, hkv, d, int(offset), int(window or 0), strides,
        _DTYPE_CODES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, err, "prefill_attention")
    prefill_attention.launches += 1
    if window is not None:
        prefill_attention.window_launches += 1
    return out


prefill_attention.launches = 0
prefill_attention.window_launches = 0


@functools.cache
def _load():
    lib = _build.load("prefill_attention")
    lib.fvlm_prefill_attention.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p])
    lib.fvlm_prefill_attention.restype = ctypes.c_int
    return lib
