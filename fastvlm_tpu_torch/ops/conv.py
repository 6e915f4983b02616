"""Core conv / norm ops for the encoder and decoder.

Public layout is the JAX package's: activations are NHWC ``(B, H, W, C)``.
Kernels are stored OIHW (PyTorch's layout). Inside, a convolution runs on the
NCHW view of the NHWC tensor, which is NCHW in ``torch.channels_last`` memory,
so neither the input nor the output is copied. Padding is explicit and
symmetric (k//2 per side), as in ``fastvlm_tpu/ops/conv.py``, including the
stride-2 even-input cases.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU with the JAX package's dtype dispatch: the tanh form for bf16,
    the exact erf form otherwise."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def conv2d(x, w, b=None, *, stride=1, padding=None, groups=1):
    """NHWC conv. ``w`` is OIHW with I = C_in // groups; padding defaults to
    k//2 per side. Returns NHWC in x's dtype."""
    k = w.shape[-1]
    if padding is None:
        padding = k // 2
    out = F.conv2d(
        x.permute(0, 3, 1, 2), w.to(x.dtype),
        None if b is None else b.to(x.dtype),
        stride=stride, padding=padding, groups=groups)
    return out.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def conv_block(x, p, *, stride=1, groups=1, act=True, se=None):
    """Fused conv(+bias) -> optional SE gate -> optional GELU: the inference
    form of every reparameterized FastViTHD block."""
    out = conv2d(x, p["w"], p.get("b"), stride=stride, groups=groups)
    if se is not None:
        out = se_gate(out, se)
    if act:
        out = gelu(out)
    return out


def se_gate(x, p):
    """Squeeze-excite: global mean -> 1x1 reduce -> relu -> 1x1 expand ->
    sigmoid gate, the mean and sigmoid in float32."""
    pooled = x.float().mean(dim=(1, 2), keepdim=True)
    z = conv2d(pooled.to(x.dtype), p["reduce_w"], p["reduce_b"], padding=0)
    z = torch.relu(z)
    z = conv2d(z, p["expand_w"], p["expand_b"], padding=0)
    return x * torch.sigmoid(z.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the trailing (channel) axis in float32: in NHWC this is
    the reference's LayerNormChannel."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def rms_norm(x, scale, eps=1e-6):
    """RMSNorm over the trailing axis in float32 (Qwen2 decoder norm)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)
