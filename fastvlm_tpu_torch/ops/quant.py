"""Weight-only and W8A8 quantization: int8 and packed int4, per-output-channel
scales.

Counterpart of ``fastvlm_tpu/ops/quant.py``, with its tree format: a
quantized linear is ``{"w_q": int8 (..., cin', cout), "scale": f32 (...,
cout), "a8"?: int8 (..., 1), "b"?: float}``. int4 packs two values a byte
along cin (odd cin padded by one zero row), so the format is read from the
shapes at the call site (w_q's cin == x's cin: int8; half: int4). ``a8``
marks the linear for W8A8: dynamic per-token int8 activations and an int8 x
int8 -> int32 product.

The JAX package computes the products outside any Pallas kernel (an
``einsum``); so does the port: ``torch._int_mm`` for W8A8 and a float
matmul over the int8 weight cast to the activations' dtype for weight-only,
on the card as on the CPU. ``quantized_matmul_reference`` is the plain
version beside it: the int32 accumulator in float64, exact while |acc| <
2**53 (an int8 x int8 product of depth K is at most 127 * 127 * K).

Rounding of the weight-only product. JAX runs one f32-accumulated einsum,
multiplies by ``scale``, adds ``b`` and rounds once to the activations'
dtype. A bf16 ``F.linear`` would round its output before the scale, a
second rounding; so on the card the product is ``torch.mm(x, w,
out_dtype=torch.float32)`` (bf16 operands, an f32 result, one rounding as
in JAX). That overload has no CPU kernel; the CPU path runs in float32,
where the question does not arise.

Layout. ``torch._int_mm`` on the card is several times faster with its
int8 weight operand K-major (``chip_smoke.py`` phase quant times both
layouts at 7B's widths). So the port keeps an 8-bit ``w_q`` as the
transpose of a contiguous (cout, cin) tensor (``card_layout``): the same
(cin, cout) shape and values as the JAX leaf, other strides.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# torch._int_mm on CUDA needs more than 16 rows and K, N multiples of 8
_INT_MM_MIN_ROWS = 17


def _quantize_array(w: torch.Tensor, bits: int):
    """w (..., cin, cout) -> (w_q int8 (..., cin', cout), scale f32 (...,
    cout)): absmax / 127 (8 bits) or / 7 (4 bits) per output channel, round
    half to even, clip to the signed range; 4 bits pack along cin."""
    qmax = 127.0 if bits == 8 else 7.0
    w = w.float()
    scale = w.abs().amax(dim=-2) / qmax
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale[..., None, :]), -qmax - 1, qmax)
    q = q.to(torch.int8)
    if bits == 8:
        return card_layout(q), scale
    if q.shape[-2] % 2:
        q = F.pad(q, (0, 0, 0, 1))
    low = q[..., 0::2, :] & 0x0F
    high = (q[..., 1::2, :] & 0x0F) << 4
    return (low | high).to(torch.int8), scale


def card_layout(w_q: torch.Tensor) -> torch.Tensor:
    """An int8 (..., cin, cout) weight as the transpose of a contiguous
    (..., cout, cin) tensor: K-major for ``torch._int_mm``. Same shape and
    values."""
    return w_q.transpose(-1, -2).contiguous().transpose(-1, -2)


def quantize_linear(p: Params, bits: int = 8, act_quant: bool = False) -> Params:
    """{"w": (..., cin, cout), "b"?} -> {"w_q", "scale", "a8"?, "b"?}.
    ``act_quant`` adds the W8A8 marker, shaped ``scale.shape[:-1] + (1,)``
    as in JAX; LoRA leaves pass through (QLoRA adapters on the frozen
    base)."""
    w_q, scale = _quantize_array(p["w"], bits)
    out: Params = {"w_q": w_q, "scale": scale}
    if act_quant:
        out["a8"] = torch.ones(scale.shape[:-1] + (1,), dtype=torch.int8,
                               device=scale.device)
    if "b" in p:
        out["b"] = p["b"]
    for k in ("lora_a", "lora_b", "lora_scale"):
        if k in p:
            out[k] = p[k]
    return out


def is_quantized(p: Any) -> bool:
    return isinstance(p, dict) and "w_q" in p


def _unpack_int4(w_q: torch.Tensor, cin: int) -> torch.Tensor:
    """(..., cin'/2, cout) packed -> (..., cin, cout) int8 in [-8, 7]. Shifts
    on int8 sign-extend as JAX's do: the low nibble by a left then an
    arithmetic right shift, the high one by an arithmetic right shift."""
    low = (w_q << 4) >> 4
    high = w_q >> 4
    stacked = torch.stack([low, high], dim=-2)          # (..., half, 2, cout)
    shape = w_q.shape[:-2] + (w_q.shape[-2] * 2, w_q.shape[-1])
    return stacked.reshape(shape)[..., :cin, :]


def unpacked_weight(p: Params, cin: int) -> torch.Tensor:
    """The int8 weight matrix (..., cin, cout), int4 unpacked."""
    w_q = p["w_q"]
    if w_q.shape[-2] == cin:
        return w_q
    return _unpack_int4(w_q, cin)


def dequantize(p: Params, cin: int) -> torch.Tensor:
    return unpacked_weight(p, cin).float() * p["scale"][..., None, :]


def quantize_activations(x: torch.Tensor):
    """Dynamic per-token symmetric int8: x (..., cin) -> (x_q int8, x_scale
    f32 (..., 1)), absmax / 127 a row (1 for an all-zero row)."""
    xf = x.float()
    x_scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    x_scale = torch.where(x_scale == 0, torch.ones_like(x_scale), x_scale)
    x_q = torch.clamp(torch.round(xf / x_scale), -127, 127).to(torch.int8)
    return x_q, x_scale


def int8_matmul_reference(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain int8 x int8 -> int32 product of (M, K) and (K, N), exact in
    float64."""
    return torch.matmul(x_q.double(), w.double()).to(torch.int32)


def int8_matmul(x_q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32 through ``torch._int_mm``;
    on CUDA the rows are zero-padded to the 17 it needs (decode has M = B)."""
    m = x_q.shape[0]
    if x_q.device.type == "cuda" and m < _INT_MM_MIN_ROWS:
        x_q = F.pad(x_q, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    return torch._int_mm(x_q, w)[:m]


def _float_matmul(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) float @ int8 (K, N) -> (M, N) float32 products: the weight
    cast to x's dtype (exact for int8 values), f32 accumulation. The f32-
    output overload of ``torch.mm`` has no derivative, so where autograd
    needs x's gradient (QLoRA training) the product runs on f32 copies."""
    wx = w.to(x2.dtype)
    if x2.device.type == "cuda" and not (torch.is_grad_enabled()
                                         and x2.requires_grad):
        return torch.mm(x2, wx, out_dtype=torch.float32)
    return torch.mm(x2.float(), wx.float())


def _apply(x: torch.Tensor, p: Params, int_mm, float_mm) -> torch.Tensor:
    lead, cin = x.shape[:-1], x.shape[-1]
    w = unpacked_weight(p, cin)
    x2 = x.reshape(-1, cin)
    if "a8" in p:
        x_q, x_scale = quantize_activations(x2)
        out = int_mm(x_q, w).float() * x_scale * p["scale"]
    else:
        out = float_mm(x2, w) * p["scale"]
    if "b" in p:
        out = out + p["b"].float()
    return out.to(x.dtype).reshape(lead + (out.shape[-1],))


def quantized_matmul(x: torch.Tensor, p: Params) -> torch.Tensor:
    """x (..., cin) @ dequant(w) (+ b) -> (..., cout) in x's dtype: f32
    accumulation with the per-channel scale on the output (exact for
    per-channel weight-only quantization), or with the ``a8`` marker int8
    activations per token, an int32 accumulator (``torch._int_mm``) and
    out = acc * x_scale * w_scale."""
    return _apply(x, p, int8_matmul, _float_matmul)


def quantized_matmul_reference(x: torch.Tensor, p: Params) -> torch.Tensor:
    """Plain version of ``quantized_matmul``: the same formula with the
    int32 accumulator in float64 and the weight-only product in float32."""
    return _apply(x, p, int8_matmul_reference,
                  lambda x2, w: torch.mm(x2.float(), w.float()))


def quantize_decoder(params: Params, bits: int = 8, skip: tuple = (),
                     act_quant: bool = False) -> Params:
    """Quantize every linear of a decoder tree (the port's list of layers):
    q/k/v/o, gate/up/down, or the fused qkv / gateup, and an untied
    ``lm_head``. Embeddings and norms stay as they are (the embedding is
    also the tied LM head). Returns a new tree sharing the other leaves.
    A tree with routed experts is refused."""
    if any("experts" in lp for lp in params["layers"]):
        raise NotImplementedError("quantizing routed experts")
    layers = []
    for lp in params["layers"]:
        q = {}
        for name, sub in lp.items():
            if name.startswith("ln") or name in skip or not (
                    isinstance(sub, dict) and "w" in sub):
                q[name] = sub
            else:
                q[name] = quantize_linear(sub, bits, act_quant=act_quant)
        layers.append(q)
    out = {**params, "layers": layers}
    if "lm_head" in params and "lm_head" not in skip:
        out["lm_head"] = quantize_linear(params["lm_head"], bits,
                                         act_quant=act_quant)
    return out
