"""Kernel K1: fused ConvFFN pointwise half, out = residual + ls * (gelu(t@W1+b1)@W2+b2).

The port of ``fastvlm_tpu/ops/pallas/ffn.py``. The kernel is hand-written
CUDA C++ for sm_90a (``csrc/ffn.cu``: wgmma for bf16, fc1 -> GELU -> fc2 in
registers up to C = 192 and two passes through an L2-resident bf16 hidden
above; plain f32 FMA tiles for f32), built at first use by ``_build.py`` and
called through ctypes. ``ffn_reference`` is the same formula in plain
PyTorch: the CPU path and the oracle the kernel is held against on the
card.

Routing is by device only: a CPU tensor takes ``ffn_reference``; a CUDA
tensor launches the kernel or raises. ``fused_ffn.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fastvlm_tpu_torch.ops.cuda import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BF16_WIDTHS = (96, 192, 384, 768, 1536)  # FastViTHD's stage widths


def _gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def ffn_reference(t, residual, w1, b1, w2, b2, ls=None):
    """Plain version of the kernel: f32 products, exact erf GELU whose
    output is rounded to t's dtype before fc2, f32 epilogue, output in
    residual's dtype. ls=None skips the layer-scale multiply."""
    h = torch.matmul(t.float(), w1.float()) + b1.float()
    h = _gelu_erf(h).to(t.dtype)
    o = torch.matmul(h.float(), w2.float()) + b2.float()
    if ls is not None:
        o = ls.float() * o
    return (residual.float() + o).to(residual.dtype)


def _check_cuda_args(t, residual, w1, b1, w2, b2, ls):
    n, c = t.shape
    ch = w1.shape[1]
    expect = {"residual": (residual, (n, c)), "w1": (w1, (c, ch)),
              "b1": (b1, (ch,)), "w2": (w2, (ch, c)), "b2": (b2, (c,))}
    if ls is not None:
        expect["ls"] = (ls, (c,))
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_ffn: unsupported dtype {t.dtype}")
    if t.dtype == torch.bfloat16 and (c not in BF16_WIDTHS or ch != 4 * c):
        raise ValueError(f"fused_ffn: the bf16 kernel needs C % 96 == 0, C in "
                         f"{BF16_WIDTHS} and Ch == 4C, got C={c}, Ch={ch}")
    for name, (x, shape) in {"t": (t, (n, c)), **expect}.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"fused_ffn: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if x.device != t.device or x.dtype != t.dtype:
            raise ValueError(f"fused_ffn: {name} is {x.dtype} on {x.device}, "
                             f"expected {t.dtype} on {t.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"fused_ffn: {name} must be contiguous and "
                             f"16-byte aligned")


def fused_ffn(t: torch.Tensor, residual: torch.Tensor, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
              ls: Optional[torch.Tensor] = None) -> torch.Tensor:
    """t, residual: (N, C); w1: (C, Ch); w2: (Ch, C); b1: (Ch,); b2, ls: (C,).

    Returns residual + ls * fc2(gelu(fc1(t))) as (N, C) in t's dtype; any N.
    On a CUDA device the kernel runs on the current stream, unsynchronised.
    The two-pass route's workspace is kept per (device, stream): calls on
    one stream run in order and share it, calls on two streams never do."""
    if t.device.type == "cpu":
        return ffn_reference(t, residual, w1, b1, w2, b2, ls)
    if t.device.type != "cuda":
        raise ValueError(f"fused_ffn: no kernel for device {t.device}")
    _check_cuda_args(t, residual, w1, b1, w2, b2, ls)
    n, c = t.shape
    out = torch.empty_like(residual)
    if n == 0:
        return out
    lib = _load()
    ch, dtype = w1.shape[1], _DTYPE_CODES[t.dtype]
    key = (n, c, ch, dtype)
    ws_bytes = _WS_BYTES.get(key)
    if ws_bytes is None:
        ws_bytes = _WS_BYTES[key] = lib.fvlm_ffn_workspace(*key)
    if ws_bytes < 0:
        raise ValueError(f"fused_ffn: no bf16 kernel for C={c}, Ch={ch}")
    stream = torch.cuda.current_stream(t.device).cuda_stream
    ws = _workspace(t.device, stream, ws_bytes) if ws_bytes else None
    err = lib.fvlm_fused_ffn(
        t.data_ptr(), residual.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), None if ls is None else ls.data_ptr(),
        out.data_ptr(), ws, n, c, ch, dtype, stream)
    _build.check(lib, err, "fused_ffn")
    fused_ffn.launches += 1
    return out


fused_ffn.launches = 0

_WORKSPACES: dict = {}  # (device, stream) -> uint8 buffer
_WS_BYTES: dict = {}  # (n, c, ch, dtype) -> the library's answer


def _workspace(device: torch.device, stream: int, nbytes: int) -> int:
    """Address of a device buffer of at least ``nbytes`` for calls on this
    stream, grown on demand: the two-pass route's hidden and partial sums."""
    buf = _WORKSPACES.get((device, stream))
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        _WORKSPACES[(device, stream)] = buf
    return buf.data_ptr()


@functools.cache
def _load():
    lib = _build.load("ffn")
    lib.fvlm_fused_ffn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.fvlm_fused_ffn.restype = ctypes.c_int
    lib.fvlm_ffn_workspace.argtypes = [ctypes.c_int] * 4
    lib.fvlm_ffn_workspace.restype = ctypes.c_longlong
    return lib


def ffn_block_apply(t_grid, residual_grid, ffn_params, ls=None):
    """NHWC wrapper: t/residual (B, H, W, C) -> (B, H, W, C).

    ffn_params: {"fc1": {"w": (C, Ch), "b"}, "fc2": {"w": (Ch, C), "b"}} as
    the port stores the ConvFFN's 1x1 convs (matmul layout), cast to the
    activations' dtype (a no-op when they match). The (N, C) row views are
    free for contiguous NHWC tensors."""
    b, h, w, c = t_grid.shape
    n = b * h * w
    dt = t_grid.dtype
    fc1, fc2 = ffn_params["fc1"], ffn_params["fc2"]
    out = fused_ffn(
        t_grid.reshape(n, c), residual_grid.reshape(n, c),
        fc1["w"].to(dt), fc1["b"].to(dt), fc2["w"].to(dt), fc2["b"].to(dt),
        None if ls is None else ls.to(dt))
    return out.reshape(b, h, w, c)
