"""A plain float32 Mellum2 decoder (JetBrains Mellum2-12B-A2.5B's
config.json, ``model_type`` mellum), for the tests: written from the
published description, importing nothing of the port or of JAX. It is the
repository's copy beside the benchmark's (``port_bench/decoders/
mellum2.py``).

  * pre-norm layers: RMSNorm (``rms_norm_eps``), GQA attention with no q /
    k / v biases and no QK norm, RoPE on GPT-NeoX halves;
  * ``layer_types``: a "sliding_attention" layer's query at i sees the key
    at j where 0 <= i - j < ``sliding_window``, a "full_attention" layer
    every j <= i;
  * ``rope_parameters`` by layer kind: default (theta^(-2i/d)) or YaRN as
    transformers' ``_compute_yarn_parameters`` computes it, cos and sin
    scaled by the attention factor;
  * every sparse layer's FFN: softmax over the router's E logits, the top
    k, their weights renormalised to sum 1 where ``norm_topk_prob``, and
    the weighted sum of those experts' SwiGLU outputs.

Parameters are a dict in the layout of the port's unfused decoder tree:
``embed`` (V, D), ``layers`` [{``ln1``, ``q``, ``k``, ``v``, ``o``,
``ln2``, ``router``, ``experts``: {``gateup`` (E, D, 2I), ``down`` (E, I,
D)}}], ``final_norm``, ``lm_head``; linears as {"w": (in, out)}.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def default_inv_freq(head_dim: int, theta: float):
    return 1.0 / theta ** (torch.arange(0, head_dim, 2,
                                        dtype=torch.float32) / head_dim), 1.0


def yarn_inv_freq(head_dim: int, theta: float, factor: float,
                  original_max: int, beta_fast: float = 32.0,
                  beta_slow: float = 1.0, attention_factor=None,
                  truncate: bool = True):
    """(inverse frequencies (head_dim / 2,), cos / sin scale) of YaRN."""
    pos = theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                    / head_dim)
    if attention_factor is None:
        attention_factor = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0

    def dim_of(turns):
        return head_dim * math.log(original_max / (turns * 2 * math.pi)) \
            / (2 * math.log(theta))
    low, high = dim_of(beta_fast), dim_of(beta_slow)
    if truncate:
        low, high = math.floor(low), math.ceil(high)
    low, high = max(low, 0), min(high, head_dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(head_dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    extrapolated = 1 - ramp
    inv = (1.0 / (factor * pos)) * (1 - extrapolated) \
        + (1.0 / pos) * extrapolated
    return inv, float(attention_factor)


def inv_freq(cfg: dict, kind: str):
    p = cfg["rope_parameters"][kind]
    d = cfg["head_dim"]
    if p.get("rope_type", "default") == "default":
        return default_inv_freq(d, p["rope_theta"])
    return yarn_inv_freq(d, p["rope_theta"], p["factor"],
                         p.get("original_max_position_embeddings")
                         or cfg["max_position_embeddings"],
                         p.get("beta_fast") or 32, p.get("beta_slow") or 1,
                         p.get("attention_factor"), p.get("truncate", True))


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def moe(y, router_w, gateup, down, top_k: int, norm_topk: bool = True):
    """The routed experts over (T, D) ``y``: each expert on the tokens
    routed to it."""
    probs = torch.softmax(y @ router_w.float(), dim=-1)
    wts, ids = probs.topk(top_k, dim=-1)
    if norm_topk:
        wts = wts / wts.sum(-1, keepdim=True)
    inter = gateup.shape[-1] // 2
    out = torch.zeros_like(y)
    for e in range(gateup.shape[0]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = y[tok] @ gateup[e].float()
        h = F.silu(gu[:, :inter]) * gu[:, inter:]
        out.index_add_(0, tok, (h @ down[e].float()) * wts[tok, slot, None])
    return out


def hidden(params: dict, cfg: dict, embeds: torch.Tensor) -> torch.Tensor:
    """(T, D) input embeddings -> final-normed hidden states, float32."""
    t = embeds.shape[0]
    hq, hkv, d = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["head_dim"])
    half = d // 2
    pos = torch.arange(t, dtype=torch.float32)[:, None]
    i = torch.arange(t)
    back = i[:, None] - i[None, :]
    x = embeds.float()
    for n, lp in enumerate(params["layers"]):
        kind = cfg["layer_types"][n]
        inv, scale = inv_freq(cfg, kind)
        ang = pos * inv[None]
        cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None] * scale
        sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None] * scale

        def rope(z):
            return z * cos + torch.cat([-z[..., half:], z[..., :half]],
                                       -1) * sin
        seen = back >= 0
        if kind == "sliding_attention":
            seen = seen & (back < cfg["sliding_window"])
        y = rms(x, lp["ln1"], cfg["rms_norm_eps"])
        q = rope((y @ lp["q"]["w"].float()).view(t, hq, d))
        k = rope((y @ lp["k"]["w"].float()).view(t, hkv, d))
        v = (y @ lp["v"]["w"].float()).view(t, hkv, d)
        k = k.repeat_interleave(hq // hkv, dim=1)
        v = v.repeat_interleave(hq // hkv, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(d)
        s = s.masked_fill(~seen, float("-inf"))
        o = torch.einsum("hts,shd->thd", torch.softmax(s, -1), v)
        x = x + o.reshape(t, hq * d) @ lp["o"]["w"].float()
        y = rms(x, lp["ln2"], cfg["rms_norm_eps"])
        x = x + moe(y, lp["router"]["w"], lp["experts"]["gateup"],
                    lp["experts"]["down"], cfg["num_experts_per_tok"],
                    cfg["norm_topk_prob"])
    return rms(x, params["final_norm"], cfg["rms_norm_eps"])


def logits(params: dict, cfg: dict, embeds: torch.Tensor) -> torch.Tensor:
    """(T, D) input embeddings -> (T, V) float32 logits."""
    return hidden(params, cfg, embeds) @ params["lm_head"]["w"].float()
