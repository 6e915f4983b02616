"""FastViTHD hybrid vision encoder in PyTorch (reparameterized inference form).

Counterpart of ``fastvlm_tpu/models/fastvit.py``, same function names and the
same public layout: ``apply`` takes NHWC ``(B, H, W, 3)`` and returns
``(B, N, C_out)`` tokens in row-major (H, W) order. Inside, activations stay
NHWC-contiguous tensors (NCHW in ``torch.channels_last`` memory to the conv
ops), so the ``(N, C)`` row view that kernel K1 takes costs no copy.

Parameters are a plain dict. Convolution kernels are OIHW; the ConvFFN's two
1x1 convs (fc1, fc2) and the attention projections are stored as (in, out)
matrices, the layout K1 and ``x @ w`` take. Blocks are a Python list per
stage (the JAX package stacks them for ``lax.scan``).

Structure at 1024 px: stem (x4) -> 5 stages of 2/12/24/4/2 blocks with
downsamplers between them -> conv_exp (dw3x3 1536 -> 3072, SE, GELU)
-> 16x16x3072.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from fastvlm_tpu_torch.config import FastViTConfig, resolve_dtype
from fastvlm_tpu_torch.ops.conv import conv2d, conv_block, layer_norm
from fastvlm_tpu_torch.ops.cuda.ffn import ffn_block_apply

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Parameter initialization (random, checkpoint-shaped)
# ---------------------------------------------------------------------------


def _normal(gen, shape, dtype, device, std=0.02):
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _conv_init(gen, cout, cin_per_group, k, dtype, device):
    return {"w": _normal(gen, (cout, cin_per_group, k, k), dtype, device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def _linear_init(gen, cin, cout, dtype, device, bias=True):
    p = {"w": _normal(gen, (cin, cout), dtype, device)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=device)
    return p


def _ffn_init(gen, c, hidden, k, dtype, device):
    return {
        "dw": _conv_init(gen, c, 1, k, dtype, device),
        "fc1": _linear_init(gen, c, hidden, dtype, device),
        "fc2": _linear_init(gen, hidden, c, dtype, device),
    }


def _block_init(gen, mixer, c, cfg: FastViTConfig, dtype, device):
    hidden = c * cfg.mlp_ratios[0]
    if mixer == "repmixer":
        return {
            "mixer": _conv_init(gen, c, 1, cfg.repmixer_kernel, dtype, device),
            "ffn": _ffn_init(gen, c, hidden, cfg.ffn_kernel, dtype, device),
            "ls": torch.full((c,), 1e-5, dtype=dtype, device=device),
        }
    return {
        "norm_scale": torch.ones((c,), dtype=dtype, device=device),
        "norm_bias": torch.zeros((c,), dtype=dtype, device=device),
        "qkv": _linear_init(gen, c, 3 * c, dtype, device, bias=False),
        "proj": _linear_init(gen, c, c, dtype, device),
        "ffn": _ffn_init(gen, c, hidden, cfg.ffn_kernel, dtype, device),
        "ls1": torch.full((c,), 1e-5, dtype=dtype, device=device),
        "ls2": torch.full((c,), 1e-5, dtype=dtype, device=device),
    }


def init(gen: torch.Generator, cfg: FastViTConfig, device="cpu") -> Params:
    """Random params with checkpoint-correct shapes, drawn from ``gen``
    (a generator on ``device``)."""
    dtype = resolve_dtype(cfg.param_dtype)
    c0 = cfg.embed_dims[0]
    stem = [
        _conv_init(gen, c0, 3, 3, dtype, device),
        _conv_init(gen, c0, 1, 3, dtype, device),
        _conv_init(gen, c0, c0, 1, dtype, device),
    ]
    stages: List[Params] = []
    for i, (n_blocks, c) in enumerate(zip(cfg.layers, cfg.embed_dims)):
        stage: Params = {}
        if cfg.pos_embs[i]:
            stage["cpe"] = _conv_init(gen, c, 1, cfg.pos_emb_kernel, dtype,
                                      device)
        stage["blocks"] = [
            _block_init(gen, cfg.token_mixers[i], c, cfg, dtype, device)
            for _ in range(n_blocks)]
        if i + 1 < len(cfg.layers):
            c_next = cfg.embed_dims[i + 1]
            stage["down"] = {
                "lk": _conv_init(gen, c_next, 1, cfg.down_patch_size, dtype,
                                 device),
                "pw": _conv_init(gen, c_next, c_next, 1, dtype, device),
            }
        stages.append(stage)
    c_out = cfg.out_channels
    rd = int(c_out * cfg.se_rd_ratio)
    conv_exp = _conv_init(gen, c_out, 1, 3, dtype, device)
    conv_exp["se"] = {
        "reduce_w": _normal(gen, (rd, c_out, 1, 1), dtype, device),
        "reduce_b": torch.zeros((rd,), dtype=dtype, device=device),
        "expand_w": _normal(gen, (c_out, rd, 1, 1), dtype, device),
        "expand_b": torch.zeros((c_out,), dtype=dtype, device=device),
    }
    return {"stem": stem, "stages": stages, "conv_exp": conv_exp}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _ffn_residual(x, p, ls: Optional[torch.Tensor]):
    """x + ls * ConvFFN(x): the depthwise 7x7 conv here, then the pointwise
    half (fc1, GELU, fc2, layer-scaled residual) in kernel K1. ls is None
    when fold_layer_scale folded it into fc2."""
    t = conv2d(x, p["dw"]["w"], p["dw"]["b"], groups=x.shape[-1])
    return ffn_block_apply(t, x, p, ls)


def _repmixer_block(x, p):
    """Inference RepMixerBlock: fused dw-conv token mixer, then the
    layer-scaled ConvFFN residual."""
    x = conv2d(x, p["mixer"]["w"], p["mixer"]["b"], groups=x.shape[-1])
    return _ffn_residual(x, p["ffn"], p.get("ls"))


def _mhsa(x, p, head_dim: int):
    """Plain softmax MHSA on (B, N, C) tokens; q scaled before the product,
    softmax in f32 (head_dim 32, bias-free qkv, proj with bias)."""
    b, n, c = x.shape
    nh = c // head_dim
    qkv = torch.matmul(x, p["qkv"]["w"].to(x.dtype)).reshape(b, n, 3, nh,
                                                            head_dim)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (b, nh, n, hd)
    # the scale rounded to x's dtype on the host (as JAX's weak-typed scalar
    # is), so the product needs no device tensor and no host-device copy
    scale = torch.tensor(head_dim ** -0.5, dtype=x.dtype).item()
    attn = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
    out = torch.matmul(out.float(), p["proj"]["w"].float()) \
        + p["proj"]["b"].float()
    return out.to(x.dtype)


def _attention_block(x, p, cfg: FastViTConfig):
    """Inference AttentionBlock: x += ls1 * MHSA(LNChannel(x));
    x += ls2 * ConvFFN(x)."""
    b, h, w, c = x.shape
    y = layer_norm(x, p["norm_scale"], p["norm_bias"], cfg.ln_eps)
    y = _mhsa(y.reshape(b, h * w, c), p, cfg.attn_head_dim).reshape(b, h, w, c)
    if "ls1" in p:  # absent when folded into proj (fold_layer_scale)
        y = p["ls1"].to(x.dtype) * y
    x = x + y
    return _ffn_residual(x, p["ffn"], p.get("ls2"))


def _run_stage(x, stage: Params, mixer_type: str, cfg: FastViTConfig):
    if "cpe" in stage:
        x = conv2d(x, stage["cpe"]["w"], stage["cpe"]["b"], groups=x.shape[-1])
    for bp in stage["blocks"]:
        if mixer_type == "repmixer":
            x = _repmixer_block(x, bp)
        else:
            x = _attention_block(x, bp, cfg)
    if "down" in stage:
        # PatchEmbed: fused RepLK dw7x7 s2 -> GELU, then pw1x1 -> GELU.
        x = conv_block(x, stage["down"]["lk"], stride=cfg.down_stride,
                       groups=x.shape[-1])
        x = conv_block(x, stage["down"]["pw"])
    return x


def apply(params: Params, x: torch.Tensor, cfg: FastViTConfig) -> torch.Tensor:
    """Encode images. x: (B, H, W, 3) -> (B, N, out_channels) tokens."""
    x = x.to(resolve_dtype(cfg.compute_dtype)).contiguous()
    c0 = cfg.embed_dims[0]
    x = conv_block(x, params["stem"][0], stride=2)
    x = conv_block(x, params["stem"][1], stride=2, groups=c0)
    x = conv_block(x, params["stem"][2])
    for i, stage in enumerate(params["stages"]):
        x = _run_stage(x, stage, cfg.token_mixers[i], cfg)
    x = conv_block(x, params["conv_exp"], groups=cfg.embed_dims[-1],
                   se=params["conv_exp"]["se"])
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c)


def fold_layer_scale(params: Params) -> Params:
    """Fold per-channel layer scales into the adjacent projection weights
    (exact: ls * (W h + b) == (ls * W) h + ls * b) and drop the ls leaves:

      * RepMixerBlock ls   -> ffn.fc2 (w, b)
      * AttentionBlock ls1 -> proj (w, b);  ls2 -> ffn.fc2 (w, b)

    Returns a new tree; the input is not modified."""

    def scale_into(p, ls):
        out = dict(p)
        out["w"] = (p["w"].float() * ls.float()).to(p["w"].dtype)
        if "b" in p:
            out["b"] = (p["b"].float() * ls.float()).to(p["b"].dtype)
        return out

    stages = []
    for stage in params["stages"]:
        blocks = []
        for bp in stage["blocks"]:
            bp = dict(bp)
            ffn = dict(bp["ffn"])
            if "ls" in bp:
                ffn["fc2"] = scale_into(ffn["fc2"], bp.pop("ls"))
            if "ls1" in bp:
                bp["proj"] = scale_into(bp["proj"], bp.pop("ls1"))
            if "ls2" in bp:
                ffn["fc2"] = scale_into(ffn["fc2"], bp.pop("ls2"))
            bp["ffn"] = ffn
            blocks.append(bp)
        stages.append({**stage, "blocks": blocks})
    return {**params, "stages": stages}


def features_grid(params: Params, x: torch.Tensor, cfg: FastViTConfig) -> torch.Tensor:
    """Encode but keep the (B, h, w, C) spatial grid."""
    tokens = apply(params, x, cfg)
    g = cfg.image_size // cfg.total_stride
    return tokens.reshape(x.shape[0], g, g, -1)
