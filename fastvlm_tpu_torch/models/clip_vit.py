"""CLIP ViT vision tower (the alternative to FastViTHD) and its S2 wrapper.

Counterpart of ``fastvlm_tpu/models/clip_vit.py``, with its names and
numerics: a pre-LN ViT with HF ``CLIPVisionModel`` semantics (quick_gelu
MLP, CLS token, learned position embeddings), its features taken at a
hidden layer (default -2, the penultimate) as 'patch' (CLS dropped) or
'cls_patch', and an S2 variant that concatenates the features of several
input scales channel-wise.

Parameters are a plain dict; the layers are a Python list (the JAX package
stacks them for ``lax.scan``). Linear weights are (in, out) matrices and
the patch embedding is an OIHW conv kernel (JAX: HWIO). The tower computes
in its input's dtype, which the engine sets to the decoder's compute dtype.
Each matmul accumulates in f32 with its bias added before the one rounding
to the activation dtype (``F.linear`` with the bias fused, the bias in the
activation dtype); LayerNorm, attention scores, softmax and quick_gelu run
in f32, and the softmax probabilities are cast to v's dtype before P.V.
In f32 this is the JAX tower's arithmetic; the parameters may be stored in
the compute dtype (one cast at load, where JAX casts the weights at each
call). Attention is plain torch ops: the JAX tower has no Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastvlm_tpu_torch.ops.conv import layer_norm
from fastvlm_tpu_torch.ops.image_ops import resize_bicubic

Params = Dict[str, Any]


@dataclass(frozen=True)
class CLIPViTConfig:
    """Defaults are CLIP ViT-L/14 at 336 px (LLaVA-1.5's tower)."""

    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    ln_eps: float = 1e-5
    select_layer: int = -2          # hidden_states index (HF convention)
    select_feature: str = "patch"   # 'patch' | 'cls_patch'
    s2_scales: Tuple[int, ...] = ()  # e.g. (336, 672, 1008) for S2

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def out_hidden_size(self) -> int:
        return self.hidden_size * max(len(self.s2_scales), 1)

    # interface aliases shared with FastViTConfig (vlm / anyres plumbing)
    @property
    def num_tokens(self) -> int:
        n = self.num_patches
        return n + 1 if self.select_feature == "cls_patch" else n

    @property
    def grid_size(self) -> int:
        return self.grid

    @property
    def out_channels(self) -> int:
        return self.out_hidden_size


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), computed in f32."""
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameter initialization (random, checkpoint-shaped)
# ---------------------------------------------------------------------------


def _normal(gen, shape, dtype, device):
    return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)


def _linear_init(gen, cin, cout, dtype, device):
    return {"w": _normal(gen, (cin, cout), dtype, device),
            "b": torch.zeros((cout,), dtype=dtype, device=device)}


def init(gen: torch.Generator, cfg: CLIPViTConfig, device="cpu",
         dtype: torch.dtype = torch.float32) -> Params:
    """Random params in ``dtype``: N(0, 0.02) weights and embeddings, zero
    biases, unit LayerNorm scales (the JAX init's distributions), drawn
    from ``gen`` (a generator on ``device``)."""
    d = cfg.hidden_size

    def ones():
        return torch.ones((d,), dtype=dtype, device=device)

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=device)

    params = {
        "patch_embed": _normal(gen, (d, 3, cfg.patch_size, cfg.patch_size),
                               dtype, device),
        "class_embed": _normal(gen, (d,), dtype, device),
        "pos_embed": _normal(gen, (cfg.num_patches + 1, d), dtype, device),
        "pre_ln_s": ones(), "pre_ln_b": zeros(),
    }
    params["layers"] = [{
        "ln1_s": ones(), "ln1_b": zeros(),
        "qkv": _linear_init(gen, d, 3 * d, dtype, device),
        "proj": _linear_init(gen, d, d, dtype, device),
        "ln2_s": ones(), "ln2_b": zeros(),
        "fc1": _linear_init(gen, d, cfg.intermediate_size, dtype, device),
        "fc2": _linear_init(gen, cfg.intermediate_size, d, dtype, device),
    } for _ in range(cfg.num_layers)]
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _linear(x, p):
    """x @ w + b with f32 accumulation and the bias added before the
    output rounding."""
    return F.linear(x, p["w"].to(x.dtype).t(), p["b"].to(x.dtype))


def _attn(x, p, num_heads: int, eps: float):
    """x + proj(MHSA(LN1(x))): fused qkv, q scaled by hd^-0.5 (rounded to
    x's dtype, as JAX's weak-typed scalar is), scores and softmax in f32,
    probabilities in v's dtype."""
    b, n, d = x.shape
    hd = d // num_heads
    h = layer_norm(x, p["ln1_s"], p["ln1_b"], eps)
    qkv = _linear(h, p["qkv"]).reshape(b, n, 3, num_heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)              # each (b, nh, n, hd)
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype).item()
    scores = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, d)
    return x + _linear(out, p["proj"])


def _mlp(x, p, eps: float):
    h = layer_norm(x, p["ln2_s"], p["ln2_b"], eps)
    h = quick_gelu(_linear(h, p["fc1"]))
    return x + _linear(h, p["fc2"])


def _embed(params, x, cfg: CLIPViTConfig):
    """(B, S, S, 3) -> (B, 1 + N, D): the stride-``patch`` conv with no
    padding, the CLS token in front, the position embeddings added."""
    b = x.shape[0]
    patches = F.conv2d(x.permute(0, 3, 1, 2),
                       params["patch_embed"].to(x.dtype),
                       stride=cfg.patch_size)
    patches = patches.permute(0, 2, 3, 1).reshape(b, -1, cfg.hidden_size)
    cls = params["class_embed"].to(x.dtype).expand(b, 1, cfg.hidden_size)
    tokens = torch.cat([cls, patches], dim=1)
    return tokens + params["pos_embed"].to(x.dtype)[None]


def hidden_at_layer(params, x, cfg: CLIPViTConfig) -> torch.Tensor:
    """x (B, S, S, 3) -> hidden states at cfg.select_layer (HF indexing:
    -1 = the last layer's output, -2 = the penultimate; no post-LN)."""
    tokens = _embed(params, x, cfg)
    tokens = layer_norm(tokens, params["pre_ln_s"], params["pre_ln_b"],
                        cfg.ln_eps)
    n_run = (cfg.num_layers + 1 + cfg.select_layer if cfg.select_layer < 0
             else cfg.select_layer)
    n_run = max(0, min(n_run, cfg.num_layers))
    for lp in params["layers"][:n_run]:
        tokens = _attn(tokens, lp, cfg.num_heads, cfg.ln_eps)
        tokens = _mlp(tokens, lp, cfg.ln_eps)
    return tokens


def features(params, x, cfg: CLIPViTConfig) -> torch.Tensor:
    """Tower features after the selection: (B, N, hidden), the CLS token
    dropped for 'patch'."""
    h = hidden_at_layer(params, x, cfg)
    if cfg.select_feature == "patch":
        return h[:, 1:]
    if cfg.select_feature == "cls_patch":
        return h
    raise ValueError(cfg.select_feature)


def features_s2(params, x, cfg: CLIPViTConfig) -> torch.Tensor:
    """S2 multi-scale features: for each scale, resize (Keys' bicubic, a =
    -0.5), cut into base-size crops in row-major order, encode, stitch the
    crops' grids, pool back to the base grid (bilinear with the triangle
    widened by the factor, jax.image.resize's antialiased default); the
    scales' features concatenated channel-wise -> (B, N, hidden * scales)."""
    if not cfg.s2_scales:
        raise ValueError("features_s2: configure s2_scales")
    base = cfg.s2_scales[0]
    if base != cfg.image_size:
        raise ValueError(f"features_s2: the first scale {base} must be the "
                         f"image size {cfg.image_size}")
    g = cfg.grid
    outs = []
    for s in cfg.s2_scales:
        t = s // base
        xi = x if s == x.shape[1] else resize_bicubic(x, s, s).to(x.dtype)
        b = xi.shape[0]
        tiles = xi.reshape(b, t, base, t, base, 3).permute(0, 1, 3, 2, 4, 5)
        tiles = tiles.reshape(b * t * t, base, base, 3)
        f = features(params, tiles, cfg)              # (B*t*t, g*g, C)
        f = f.reshape(b, t, t, g, g, -1).permute(0, 1, 3, 2, 4, 5)
        f = f.reshape(b, t * g, t * g, -1)            # the stitched map
        if t > 1:
            pooled = F.interpolate(f.float().permute(0, 3, 1, 2), size=(g, g),
                                   mode="bilinear", align_corners=False,
                                   antialias=True)
            f = pooled.permute(0, 2, 3, 1).to(f.dtype)
        outs.append(f.reshape(b, g * g, -1))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# HF CLIPVisionModel checkpoint conversion
# ---------------------------------------------------------------------------


def convert_from_hf(sd: Dict[str, Any], cfg: CLIPViTConfig,
                    dtype: torch.dtype = torch.float32,
                    prefix: str = "vision_model.") -> Params:
    """A HF ``CLIPVisionModel`` state dict (numpy arrays or tensors) -> the
    port's tree in ``dtype``: q/k/v fused into one (d, 3d) matrix, linears
    transposed to (in, out); every tensor read in f32 and cast once."""

    def g(name):
        v = sd[prefix + name]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        return np.asarray(v, np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)

    def lin(name):
        return {"w": t(g(name + ".weight").T), "b": t(g(name + ".bias"))}

    layers = []
    for i in range(cfg.num_layers):
        base = f"encoder.layers.{i}."
        qkv_w = np.concatenate([g(base + f"self_attn.{n}_proj.weight")
                                for n in "qkv"], 0)
        qkv_b = np.concatenate([g(base + f"self_attn.{n}_proj.bias")
                                for n in "qkv"], 0)
        layers.append({
            "ln1_s": t(g(base + "layer_norm1.weight")),
            "ln1_b": t(g(base + "layer_norm1.bias")),
            "qkv": {"w": t(qkv_w.T), "b": t(qkv_b)},
            "proj": lin(base + "self_attn.out_proj"),
            "ln2_s": t(g(base + "layer_norm2.weight")),
            "ln2_b": t(g(base + "layer_norm2.bias")),
            "fc1": lin(base + "mlp.fc1"),
            "fc2": lin(base + "mlp.fc2"),
        })
    return {
        "patch_embed": t(g("embeddings.patch_embedding.weight")),
        "class_embed": t(g("embeddings.class_embedding")),
        "pos_embed": t(g("embeddings.position_embedding.weight")),
        "pre_ln_s": t(g("pre_layrnorm.weight")),
        "pre_ln_b": t(g("pre_layrnorm.bias")),
        "layers": layers,
    }
