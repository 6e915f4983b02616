"""Qwen2 decoder family in PyTorch (HF ``Qwen2ForCausalLM`` numerics).

Counterpart of ``fastvlm_tpu/models/qwen2.py``: RMSNorm, GPT-NeoX RoPE,
GQA with QKV bias and a bias-free o_proj, SwiGLU, optional tied embeddings.
Parameters are a plain dict; per-layer params are a Python list (the JAX
package stacks them for ``lax.scan``); linears are (in, out) matrices.
``forward`` takes embeddings, not ids, so the VLM splice and plain LM share
one path.

Attention routes, over a dense ``KVCache`` or a paged ``PagedKVCache``:
  * prefill over an empty cache attends the prompt's own keys under a
    (B, T, T) mask, with a plain f32 softmax (``_attend``);
  * a T=1 decode step calls kernel K2 (``ops/cuda/decode_attention.py``) on
    the dense cache, or kernel K3 (``ops/cuda/paged_decode_attention.py``)
    on the pool in place, when the decoder has no ALiBi bias and no sliding
    window, as the JAX package's Pallas routes do;
  * otherwise ``_attend`` over the whole cache with ``decode_mask`` (the
    paged cache gathered into each row's virtual order first).
The cache is updated in place (``ops/kv_cache.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from fastvlm_tpu_torch.config import Qwen2Config, resolve_dtype
from fastvlm_tpu_torch.ops.conv import rms_norm
from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
    paged_decode_attention)
from fastvlm_tpu_torch.ops.kv_cache import (
    KVCache, PagedKVCache, gather_pages, prompt_dest, token_dest, write_paged,
    write_prompt, write_token)

Params = Dict[str, Any]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dense(gen, cin, cout, dtype, device, bias, std=0.02):
    p = {"w": (torch.randn((cin, cout), generator=gen, device=device)
               * std).to(dtype)}
    if bias:
        p["b"] = torch.zeros((cout,), dtype=dtype, device=device)
    return p


def _layer_init(gen, cfg: Qwen2Config, dtype, device):
    d = cfg.hidden_size
    p = {
        "ln1": torch.ones((d,), dtype=dtype, device=device),
        "q": _dense(gen, d, cfg.q_dim, dtype, device, cfg.qkv_bias),
        "k": _dense(gen, d, cfg.kv_dim, dtype, device, cfg.qkv_bias),
        "v": _dense(gen, d, cfg.kv_dim, dtype, device, cfg.qkv_bias),
        "o": _dense(gen, cfg.q_dim, d, dtype, device, bias=False),
        "ln2": torch.ones((d,), dtype=dtype, device=device),
    }
    if cfg.mlp_type == "swiglu":
        p["gate"] = _dense(gen, d, cfg.intermediate_size, dtype, device, False)
    p["up"] = _dense(gen, d, cfg.intermediate_size, dtype, device, False)
    p["down"] = _dense(gen, cfg.intermediate_size, d, dtype, device, False)
    return p


def init(gen: torch.Generator, cfg: Qwen2Config, device="cpu") -> Params:
    """Random params drawn from ``gen`` (a generator on ``device``)."""
    dtype = resolve_dtype(cfg.param_dtype)
    params: Params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen,
                              device=device) * 0.02).to(dtype),
        "layers": [_layer_init(gen, cfg, dtype, device)
                   for _ in range(cfg.num_layers)],
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype,
                                 device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _dense(gen, cfg.hidden_size, cfg.vocab_size,
                                   dtype, device, bias=False)
    return params


def fuse_decoder_params(params: Params, cfg: Qwen2Config) -> Params:
    """Concatenate q/k/v -> qkv and gate/up -> gateup in every layer: one
    product instead of three / two per layer at decode. Returns a new tree."""
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        qkv = {"w": torch.cat([lp["q"]["w"], lp["k"]["w"], lp["v"]["w"]], -1)}
        if "b" in lp["q"]:
            qkv["b"] = torch.cat([lp["q"]["b"], lp["k"]["b"], lp["v"]["b"]], -1)
        lp["qkv"] = qkv
        for k in ("q", "k", "v"):
            del lp[k]
        if "gate" in lp:
            lp["gateup"] = {"w": torch.cat([lp.pop("gate")["w"],
                                            lp.pop("up")["w"]], -1)}
        layers.append(lp)
    return {**params, "layers": layers}


# ---------------------------------------------------------------------------
# RoPE / norms / projections
# ---------------------------------------------------------------------------


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., head_dim) f32, GPT-NeoX halves."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                             device=positions.device) / half))
    angles = positions[..., None].float() * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, T, H, D); cos/sin: (B, T, D) -> rotated x (same dtype)."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    out = x.float() * cos[:, :, None, :] + rotated.float() * sin[:, :, None, :]
    return out.to(x.dtype)


def _norm(x, w, cfg: Qwen2Config):
    """Pre-norm: RMSNorm, or bias-free LayerNorm (MPT)."""
    if cfg.norm_type == "layernorm":
        y = F.layer_norm(x.float(), (x.shape[-1],), eps=cfg.rms_eps)
        return y.to(x.dtype) * w.to(x.dtype)
    return rms_norm(x, w, cfg.rms_eps)


def _project(x, p):
    """x @ w (+ b): f32 accumulation, bias added before the output rounding
    (``F.linear`` with the bias fused)."""
    return F.linear(x, p["w"].to(x.dtype).t(),
                    None if "b" not in p else p["b"].to(x.dtype))


def _mlp(h, lp):
    """SwiGLU (gate * up) or plain up -> GELU -> down (MPT)."""
    if "gateup" in lp:
        gate, up = _project(h, lp["gateup"]).chunk(2, dim=-1)
        gated = F.silu(gate.float()).to(h.dtype) * up
    elif "gate" in lp:
        gated = F.silu(_project(h, lp["gate"]).float()).to(h.dtype) \
            * _project(h, lp["up"])
    else:
        gated = F.gelu(_project(h, lp["up"]).float()).to(h.dtype)
    return _project(gated, lp["down"])


def alibi_slopes(num_heads: int, device="cpu") -> torch.Tensor:
    """Standard ALiBi head slopes (geometric sequence)."""

    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = pow2_slopes(closest) + \
            pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


def pos_terms(cfg: Qwen2Config, positions, mask):
    """(cos, sin, alibi_bias, (B, 1, T, S) mask) for one forward."""
    cos = sin = None
    if cfg.pos_emb == "rope":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    bias = None
    if cfg.pos_emb == "alibi":
        s = mask.shape[-1]
        k_pos = torch.arange(s, device=positions.device)[None, None, :]
        dist = (positions[:, :, None] - k_pos).float()          # (B, T, S)
        slopes = alibi_slopes(cfg.num_heads, positions.device)
        bias = -slopes[None, :, None, None] * dist[:, None]
    return cos, sin, bias, mask[:, None]


def _attend(q, k, v, mask, bias=None):
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


def _layer(x, lp, cfg: Qwen2Config, cos, sin, cache_k, cache_v, mask,
           lengths, prefill, bias=None, prefill_offset=0, block_tables=None,
           dest=None, kv_lens=None):
    """One decoder layer. cache_k/v: (B, S_max, Hkv, D) views of the dense
    cache, (P + 1, page, Hkv, D) pool slices when ``block_tables`` is given
    (the paged serving layout; ``dest`` holds the flat pool rows of this
    forward's writes), both written in place; or None (no cache: plain
    causal attention). kv_lens: lengths + 1, the valid keys of a decode
    step once its token is written (computed once per forward)."""
    b, t, d = x.shape
    h = _norm(x, lp["ln1"], cfg)
    if "qkv" in lp:
        q, k, v = _project(h, lp["qkv"]).split(
            [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        q, k, v = (_project(h, lp[n]) for n in ("q", "k", "v"))
    q = q.reshape(b, t, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    attn = None
    use_kernel = t == 1 and bias is None and cfg.attn_window is None
    if cache_k is None:
        keys, values = k, v
    elif prefill:
        if block_tables is None:
            write_prompt(cache_k, cache_v, k, v, prefill_offset)
        else:
            write_paged(cache_k, cache_v, k, v, dest)
        if mask.shape[-1] == t:
            # empty-cache prefill: the prompt's own keys are the whole
            # valid cache, so attend them instead of the S_max-wide cache
            keys, values = k, v
        elif block_tables is None:
            keys, values = cache_k, cache_v
        else:
            keys = gather_pages(cache_k, block_tables)
            values = gather_pages(cache_v, block_tables)
    elif block_tables is None:  # dense decode step
        write_token(cache_k, cache_v, k, v, lengths)
        keys, values = cache_k, cache_v
        if use_kernel:
            out = decode_attention(q[:, 0].contiguous(), cache_k.to(q.dtype),
                                   cache_v.to(q.dtype), kv_lens)
            attn = out.reshape(b, 1, -1)
    else:  # paged decode step
        write_paged(cache_k, cache_v, k, v, dest)
        if use_kernel:
            out = paged_decode_attention(
                q[:, 0].contiguous(), cache_k.to(q.dtype), cache_v.to(q.dtype),
                block_tables, kv_lens)
            attn = out.reshape(b, 1, -1)
        else:
            keys = gather_pages(cache_k, block_tables)
            values = gather_pages(cache_v, block_tables)
    if attn is None:
        attn = _attend(q, keys.to(q.dtype), values.to(q.dtype), mask, bias)
    x = x + _project(attn, lp["o"])
    h = _norm(x, lp["ln2"], cfg)
    return x + _mlp(h, lp)


# ---------------------------------------------------------------------------
# public forward
# ---------------------------------------------------------------------------


def embed(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][ids.long()]


def logits_from_hidden(params: Params, hidden: torch.Tensor,
                       cfg: Qwen2Config) -> torch.Tensor:
    """(B, T, D) -> (B, T, V) f32 logits (tied embeddings or lm_head). The
    product accumulates in f32; its output is rounded to the hidden dtype
    before the f32 cast."""
    if cfg.tie_word_embeddings:
        w = params["embed"].to(hidden.dtype)
        return F.linear(hidden, w).float()
    return torch.matmul(hidden, params["lm_head"]["w"].to(hidden.dtype)).float()


def forward(
    params: Params,
    cfg: Qwen2Config,
    inputs_embeds: torch.Tensor,          # (B, T, D)
    positions: torch.Tensor,              # (B, T) int RoPE positions
    cache: Optional[Union[KVCache, PagedKVCache]] = None,
    mask: Optional[torch.Tensor] = None,  # (B, T, S) bool, True = attend
    prefill: bool = True,
    prefill_offset: int = 0,
) -> Tuple[torch.Tensor, Optional[Union[KVCache, PagedKVCache]]]:
    """Run the decoder stack over embeddings; returns (hidden, cache).

    With a cache (dense, or paged with S = its virtual capacity): prefill
    writes rows [offset, offset+T), decode writes at cache.lengths; the
    returned cache shares the (updated) tensors and carries the advanced
    lengths. Without a cache: causal self-attention."""
    x = inputs_embeds
    b, t, _ = x.shape
    if mask is None:
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=x.device))
        mask = causal.expand(b, t, t)
    cos, sin, bias, mask = pos_terms(cfg, positions, mask)
    lengths = None if cache is None else cache.lengths
    # the lengths after this forward's writes: a decode step's attention
    # counts its own token, and the returned cache carries them
    new_lengths = None if cache is None else lengths + (t if prefill else 1)
    paged = isinstance(cache, PagedKVCache)
    tables = dest = None
    if paged:
        # the writes' pool rows are the same in every layer
        tables = cache.block_tables
        dest = (prompt_dest(tables, t, prefill_offset, cache.page_size,
                            cache.num_pages) if prefill else
                token_dest(tables, lengths, cache.page_size, cache.num_pages))
    for i, lp in enumerate(params["layers"]):
        ck = cv = None
        if paged:
            ck, cv = cache.k_pages[i], cache.v_pages[i]
        elif cache is not None:
            ck, cv = cache.k[i], cache.v[i]
        x = _layer(x, lp, cfg, cos, sin, ck, cv, mask, lengths, prefill, bias,
                   prefill_offset, tables, dest, new_lengths)
    new_cache = None
    if cache is not None:
        new_cache = dataclasses.replace(cache, lengths=new_lengths)
    return _norm(x, params["final_norm"], cfg), new_cache


def prefill_mask(seq_lens: torch.Tensor, t: int, s_max: int,
                 window: Optional[int] = None) -> torch.Tensor:
    """(B, T, S_max) mask for right-padded prefill: causal AND k < seq_len,
    optionally within a sliding window."""
    dev = seq_lens.device
    q_pos = torch.arange(t, device=dev)[:, None]
    k_pos = torch.arange(s_max, device=dev)[None, :]
    causal = k_pos <= q_pos
    if window is not None:
        causal = causal & (q_pos - k_pos < window)
    valid = k_pos[None] < seq_lens[:, None, None]
    return causal[None] & valid


def decode_mask(lengths: torch.Tensor, s_max: int,
                window: Optional[int] = None) -> torch.Tensor:
    """(B, 1, S_max) mask for one decode step: attend k <= lengths[b] (the
    new token is written at index lengths[b] before attending)."""
    k_pos = torch.arange(s_max, device=lengths.device)[None, None, :]
    m = k_pos <= lengths[:, None, None]
    if window is not None:
        m = m & (lengths[:, None, None] - k_pos < window)
    return m
