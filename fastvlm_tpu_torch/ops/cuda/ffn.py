"""Kernel K1: fused ConvFFN pointwise half, out = residual + ls * (gelu(t@W1+b1)@W2+b2).

The port of ``fastvlm_tpu/ops/pallas/ffn.py``. The kernel is hand-written
CUDA C++ for sm_90a (``csrc/ffn.cu``), built at first use by ``_build.py``
and called through ctypes. ``ffn_reference`` is the same formula in plain
PyTorch: the CPU path and the oracle the kernel is held against on the
card.

Routing: a CPU tensor takes ``ffn_reference``; a CUDA tensor launches the
kernel or raises. ``fused_ffn.launches`` counts kernel launches. The kernel
picks its route by (C, Ch) alone, as ``kernel_route`` mirrors: "fused" (C =
96 / 192, Ch = 4C: fc1 -> GELU -> fc2 without the hidden leaving the chip),
"two-pass" (C % 128 == 0, Ch = 4C: the hidden through the workspace), or
"general" (any other shape; f32 only, bf16 refuses it). bf16 runs on wgmma;
f32 on the tensor cores in 3xTF32 (f32 accuracy) on the fused and two-pass
routes and in plain f32 FMA tiles on the general one.

Training: the ctypes launch writes a fresh tensor that autograd cannot see,
so ``fused_ffn`` raises on a CUDA input that requires grad (with grad
enabled) instead of cutting the graph. ``FusedFFNFunction`` wraps it: its
forward is ``fused_ffn`` (the kernel on the card), its backward
differentiates ``ffn_reference`` in plain PyTorch. The JAX package has no
backward kernel either: it trains through XLA's FFN. ``ffn_block_apply``
takes the Function whenever grad is enabled and an input requires it.

``torch.ops.fastvlm.fused_ffn`` is the same function registered as a
PyTorch custom op with a fake (shape-only) implementation, so that
``torch.export`` can trace an encoder through it: the ctypes launch cannot
be traced, and the exported program holds one such op per FFN, which
launches the kernel when it runs on the card. ``ffn_block_apply`` calls it
while tracing and ``fused_ffn`` directly otherwise (the op's dispatcher
adds host time to every call). A program exported with it loads only where
this module has been imported (``export.load_exported_encoder`` does).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fastvlm_tpu_torch.ops.cuda import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BF16_WIDTHS = (96, 192, 384, 768, 1536)  # FastViTHD's stage widths
ROUTES = ("general", "fused", "two-pass")  # csrc/ffn.cu's Route codes


def kernel_route(c: int, ch: int) -> str:
    """The route the kernel takes for width C and hidden width Ch, in
    either dtype (``csrc/ffn.cu::ffn_route``; ``fvlm_ffn_route`` answers
    the same on the card)."""
    if ch == 4 * c and c in (96, 192):
        return "fused"
    if ch == 4 * c and c % 128 == 0:
        return "two-pass"
    return "general"


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
    The two-pass route's workspace (the hidden: bf16, or f32 for f32 inputs)
    is kept per (device, stream): calls on one stream run in order and
    share it, calls on two streams never do."""
    if t.device.type == "cpu":
        return ffn_reference(t, residual, w1, b1, w2, b2, ls)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (t, residual, w1, b1, w2, b2, ls)):
        raise RuntimeError("fused_ffn: an input requires grad, and the "
                           "kernel's output would carry no graph; call "
                           "FusedFFNFunction.apply (ffn_block_apply does)")
    if t.device.type != "cuda":
        raise ValueError(f"fused_ffn: no kernel for device {t.device}")
    _check_cuda_args(t, residual, w1, b1, w2, b2, ls)
    n, c = t.shape
    out = torch.empty_like(residual)
    if n == 0:
        return out
    lib = _load()
    ch, dtype = w1.shape[1], _DTYPE_CODES[t.dtype]
    stream = torch.cuda.current_stream(t.device).cuda_stream
    ws = _kernel_workspace(lib, n, c, ch, dtype, t.device, stream)
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


def _kernel_workspace(lib, n, c, ch, dtype, device, stream):
    """The workspace address for one call (None where the route needs
    none), its size as the library gives it for the shape."""
    key = (n, c, ch, dtype)
    ws_bytes = _WS_BYTES.get(key)
    if ws_bytes is None:
        ws_bytes = _WS_BYTES[key] = lib.fvlm_ffn_workspace(*key)
    if ws_bytes < 0:
        raise ValueError(f"fused_ffn: no bf16 kernel for C={c}, Ch={ch}")
    return _workspace(device, stream, ws_bytes) if ws_bytes else None


def _workspace(device: torch.device, stream: int, nbytes: int) -> int:
    """Address of a device buffer of at least ``nbytes`` for calls on this
    stream, grown on demand: the two-pass route's hidden and partial sums
    (one buffer for both dtypes)."""
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
    lib.fvlm_ffn_route.argtypes = [ctypes.c_int] * 2
    lib.fvlm_ffn_route.restype = ctypes.c_int
    return lib


class FusedFFNFunction(torch.autograd.Function):
    """``fused_ffn`` under autograd, same arguments. Forward: the kernel on
    CUDA, ``ffn_reference`` on the CPU. Backward: autograd through
    ``ffn_reference`` recomputed from the saved inputs (the residual enters
    additively, so its gradient is the output's and it is not saved)."""

    @staticmethod
    def forward(ctx, t, residual, w1, b1, w2, b2, ls=None):
        ctx.save_for_backward(t, w1, b1, w2, b2, ls)
        return fused_ffn(t, residual, w1, b1, w2, b2, ls)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = [ctx.needs_input_grad[i] for i in (0, 2, 3, 4, 5, 6)]
        grads = [None] * 6
        if any(need):
            with torch.enable_grad():
                ins = [None if x is None else x.detach().requires_grad_(n)
                       for x, n in zip(saved, need)]
                t, w1, b1, w2, b2, ls = ins
                out = ffn_reference(t, grad.new_zeros(()), w1, b1, w2, b2, ls)
                wanted = [x for x, n in zip(ins, need) if n]
                got = iter(torch.autograd.grad(out, wanted, grad))
            grads = [next(got) if n else None for n in need]
        g_t, g_w1, g_b1, g_w2, g_b2, g_ls = grads
        g_res = grad if ctx.needs_input_grad[1] else None
        return g_t, g_res, g_w1, g_b1, g_w2, g_b2, g_ls


@torch.library.custom_op("fastvlm::fused_ffn", mutates_args=())
def fused_ffn_op(t: torch.Tensor, residual: torch.Tensor, w1: torch.Tensor,
                 b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                 ls: Optional[torch.Tensor] = None) -> torch.Tensor:
    return fused_ffn(t, residual, w1, b1, w2, b2, ls)


@fused_ffn_op.register_fake
def _(t, residual, w1, b1, w2, b2, ls=None):
    return torch.empty_like(residual)


def ffn_block_apply(t_grid, residual_grid, ffn_params, ls=None):
    """NHWC wrapper: t/residual (B, H, W, C) -> (B, H, W, C).

    ffn_params: {"fc1": {"w": (C, Ch), "b"}, "fc2": {"w": (Ch, C), "b"}} as
    the port stores the ConvFFN's 1x1 convs (matmul layout), cast to the
    activations' dtype (a no-op when they match). The (N, C) row views are
    free for contiguous NHWC tensors. Under autograd (grad enabled and an
    input requiring it) the call goes through ``FusedFFNFunction``."""
    b, h, w, c = t_grid.shape
    n = b * h * w
    dt = t_grid.dtype
    fc1, fc2 = ffn_params["fc1"], ffn_params["fc2"]
    args = (t_grid.reshape(n, c), residual_grid.reshape(n, c),
            fc1["w"].to(dt), fc1["b"].to(dt), fc2["w"].to(dt),
            fc2["b"].to(dt), None if ls is None else ls.to(dt))
    if torch.compiler.is_compiling():
        out = fused_ffn_op(*args)
    elif torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in args):
        out = FusedFFNFunction.apply(*args)
    else:
        out = fused_ffn(*args)
    return out.reshape(b, h, w, c)
