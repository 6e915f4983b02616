"""Qwen2 decoder family in PyTorch (HF ``Qwen2ForCausalLM`` numerics).

Counterpart of ``fastvlm_tpu/models/qwen2.py``: RMSNorm, GPT-NeoX RoPE,
GQA with QKV bias and a bias-free o_proj, SwiGLU, optional tied embeddings.
Parameters are a plain dict; per-layer params are a Python list (the JAX
package stacks them for ``lax.scan``); linears are (in, out) matrices.
``forward`` takes embeddings, not ids, so the VLM splice and plain LM share
one path.

Attention routes, over a dense ``KVCache`` or a paged ``PagedKVCache``:
  * prefill over an empty cache attends the prompt's own keys under a
    (B, T, T) mask, with a plain f32 softmax (``_attend``); a prefill that
    continues after ``prefill_offset`` cached tokens (``vlm.
    prefill_continue``) attends the whole cache the same way, the paged
    one gathered into each row's order first;
  * a T=1 decode step calls kernel K2 (``ops/cuda/decode_attention.py``) on
    the dense cache, or kernel K3 (``ops/cuda/paged_decode_attention.py``)
    on the pool in place, when the decoder has no ALiBi bias and no sliding
    window, as the JAX package's Pallas routes do;
  * a paged decode step of ``vlm.decode_chunk_pool`` (``pool_inplace``)
    attends the whole pool under an ownership mask (``_attend_pool``, plain
    torch, as JAX computes it in XLA);
  * otherwise ``_attend`` over the whole cache with ``decode_mask``, or
    with ``ops/speculative.spec_mask`` for a speculative verify pass (T =
    k + 1 tokens written at each row's own offset; the kernels take T = 1
    only, as the JAX Pallas routes do), the paged cache gathered into each
    row's virtual order first;
  * an int8 dense cache (``kv_cache_dtype="int8"``) runs no kernel, as in
    JAX (its Pallas route requires a float cache): a decode step or verify
    pass attends through ``_attend_quant`` (the per-token scales applied to
    the scores and the probabilities, no dequantized copy), a continued
    prefill over ``dequantize_view``.
The cache is updated in place (``ops/kv_cache.py``).

Quantized linears (``ops/quant.py``: ``w_q`` / ``scale`` / ``a8`` leaves)
run through ``quantized_matmul`` in ``_project`` and in an untied LM head.
LoRA adapters (``train/lora.py``: ``lora_a`` / ``lora_b`` / ``lora_scale``)
add their delta to a dense or a quantized linear in ``_project``. Training
runs ``forward`` without a cache, ``remat=True`` recomputing each layer in
the backward pass.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from fastvlm_tpu_torch.config import Qwen2Config, resolve_dtype
from fastvlm_tpu_torch.ops.conv import rms_norm
from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
    paged_decode_attention)
from fastvlm_tpu_torch.ops.kv_cache import (
    KVCache, PagedKVCache, dequantize_view, gather_pages, pool_ownership,
    prompt_dest, token_dest, write_paged, write_prompt, write_token)
from fastvlm_tpu_torch.ops.quant import card_layout, quantized_matmul
from fastvlm_tpu_torch.parallel import collectives as coll
from fastvlm_tpu_torch.parallel.sharding import kv_heads

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


def _cat_linears(parts) -> Params:
    """One linear from several along cout: "w" and "b" concatenate, as the
    JAX fusion does, and so do a quantized linear's "w_q" (kept K-major,
    ``ops/quant.card_layout``) and "scale": the scales are per output
    channel, so fusing then quantizing equals quantizing then fusing. The
    W8A8 marker is kept once."""
    out: Params = {}
    for key in ("w", "w_q", "scale", "b"):
        if key in parts[0]:
            out[key] = torch.cat([p[key] for p in parts], -1)
    if "w_q" in out:
        out["w_q"] = card_layout(out["w_q"])
    if "a8" in parts[0]:
        out["a8"] = parts[0]["a8"]
    return out


def fuse_decoder_params(params: Params, cfg: Qwen2Config) -> Params:
    """Concatenate q/k/v -> qkv and gate/up -> gateup in every layer: one
    product instead of three / two per layer at decode. Float and quantized
    linears alike (``_cat_linears``). Returns a new tree."""
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        lp["qkv"] = _cat_linears([lp.pop(k) for k in ("q", "k", "v")])
        if "gate" in lp:
            lp["gateup"] = _cat_linears([lp.pop("gate"), lp.pop("up")])
        layers.append(lp)
    return {**params, "layers": layers}


def split_fused_layer(layer: Params, cfg: Qwen2Config) -> Params:
    """Undo ``fuse_decoder_params`` (qkv / gateup concats) in one float
    layer."""
    out = dict(layer)
    if "qkv" in out:
        qkv = out.pop("qkv")
        qd, kvd = cfg.q_dim, cfg.kv_dim
        for name, sl in (("q", slice(0, qd)),
                         ("k", slice(qd, qd + kvd)),
                         ("v", slice(qd + kvd, qd + 2 * kvd))):
            p = {"w": qkv["w"][..., sl]}
            if "b" in qkv:
                p["b"] = qkv["b"][..., sl]
            out[name] = p
    if "gateup" in out:
        gu = out.pop("gateup")
        half = gu["w"].shape[-1] // 2
        out["gate"] = {"w": gu["w"][..., :half]}
        out["up"] = {"w": gu["w"][..., half:]}
    return out


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


def _lora_delta(x, p):
    """scale * (x @ A) @ B in f32: a low-rank adapter's contribution. A and
    B are rounded to x's dtype first and the inner product rounded to it,
    as in JAX (an f32 adapter on bf16 activations: QLoRA)."""
    a = p["lora_a"].to(x.dtype).float()
    low = torch.matmul(x.float(), a).to(x.dtype)
    delta = torch.matmul(low.float(), p["lora_b"].to(x.dtype).float())
    return p["lora_scale"].float() * delta


def _project(x, p):
    """x @ w (+ b): f32 accumulation, bias added before the output rounding
    (``F.linear`` with the bias fused). A linear with LoRA adapters
    (``train/lora.py``) adds the adapter's delta to the f32 product, then
    the bias, and rounds once, as in JAX (the f32 product is taken on
    f32 copies of the operands: ``torch.mm``'s f32-output overload has no
    derivative, and training differentiates this path). A quantized linear
    goes through ``quantized_matmul`` (scale and bias inside, one rounding),
    then a QLoRA adapter adds its delta in f32 and rounds again, as in
    JAX."""
    if "w_q" in p:
        out = quantized_matmul(x, p)
        if "lora_a" in p:
            out = (out.float() + _lora_delta(x, p)).to(x.dtype)
        return out
    if "lora_a" in p:
        out = torch.matmul(x.float(), p["w"].to(x.dtype).float()) \
            + _lora_delta(x, p)
        if "b" in p:
            out = out + p["b"].float()
        return out.to(x.dtype)
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


def _attend_pool(q, k_pool, v_pool, owner, base, lengths, window=None):
    """Decode attention over the whole page pool in place, JAX's
    ``_attend_pool``: every row's query scores every pool token in one
    product, and token (p, slot) counts for row b where ``owner[p] == b``
    and ``base[p] + slot <= lengths[b]``. A row with no valid token (its
    pages freed) gets zeros, not NaN. q: (B, 1, Hq, D); k/v_pool: (P, page,
    Hkv, D); owner / base: (P,) (``ops/kv_cache.pool_ownership``); lengths:
    (B,) before this step's write."""
    b, t, hq, d = q.shape
    p, page, hkv, _ = k_pool.shape
    kf = k_pool.reshape(p * page, hkv, d).to(q.dtype)
    vf = v_pool.reshape(p * page, hkv, d)
    qq = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthgd,shd->bhgts", qq.float(),
                          kf.float()) * (d ** -0.5)
    slot = torch.arange(page, dtype=torch.int32, device=q.device)
    pos = (base[:, None] + slot[None, :]).reshape(-1)
    own = owner.repeat_interleave(page)
    rows = torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
    valid = (own[None, :] == rows) & (pos[None, :] <= lengths[:, None])
    if window is not None:
        valid = valid & (lengths[:, None] - pos[None, :] < window)
    scores = torch.where(valid[:, None, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(-1)[:, None, None, None, None], probs,
                        torch.zeros_like(probs)).to(vf.dtype)
    out = torch.einsum("bhgts,shd->bthgd", probs.float(),
                       vf.float()).to(q.dtype)
    return out.reshape(b, t, hq * d)


def _attend_quant(q, k8, ks, v8, vs, mask):
    """Attention over an int8 dense cache without a dequantized copy: the
    per-token scales come out of the products, scores[s] = (q . k8[s]) *
    k_scale[s], and the value scale folds into the probabilities (p * v_scale)
    before P.V (JAX ``_attend_quant``). q: (B,T,Hq,D); k8/v8: (B,S,Hkv,D)
    int8; ks/vs: (B,S,Hkv) f32; mask: (B,1,T,S) bool -> (B, T, Hq*D)."""
    b, t, hq, d = q.shape
    hkv = k8.shape[2]
    g = hq // hkv
    qg = q.reshape(b, t, hkv, g, d)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k8.float()) \
        * (d ** -0.5)
    scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    scores = torch.where(mask[:, :, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * vs.permute(0, 2, 1)[:, :, None, None, :]).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v8.float())
    return out.to(q.dtype).reshape(b, t, hq * d)


def _enter(h, sharded: bool, seq: bool, group):
    """Into a block: the column-parallel input. Split blocks get Megatron's
    f (SP: an all-gather over T whose backward reduce-scatters); a block
    that stayed whole computes alike on every rank (SP: gathered, its
    gradient sliced back)."""
    if seq:
        return coll.all_gather(h, 1, group) if sharded else \
            coll.gather_from(h, 1, group)
    return coll.copy_to(h, group) if sharded else h


def _exit(o, sharded: bool, seq: bool, group):
    """Out of a block: a row-parallel product's partial sums are summed (g;
    SP: reduce-scattered over T)."""
    if seq:
        return coll.reduce_scatter(o, 1, group) if sharded else \
            coll.split_to(o, 1, group)
    return coll.reduce_from(o, group) if sharded else o


def _split(p, whole: int, dim: int) -> bool:
    """A float linear holds a piece of a dim that is ``whole`` long."""
    return "w" in p and p["w"].shape[dim] != whole


def _take_heads(x, heads):
    """Heads ``heads`` of (B, T, H, D) ``x``: a slice where they run in
    order, else a gather."""
    lo = heads[0]
    if heads == list(range(lo, lo + len(heads))):
        return x[:, :, lo:lo + len(heads)]
    return x[:, :, torch.tensor(heads, device=x.device)]


def _layer(x, lp, cfg: Qwen2Config, cos, sin, cache_k, cache_v, mask,
           lengths, prefill, bias=None, prefill_offset=0, block_tables=None,
           dest=None, kv_lens=None, cache_ks=None, cache_vs=None, group=None,
           seq=False, pool_owner=None, pool_base=None):
    """One decoder layer. cache_k/v: (B, S_max, Hkv, D) views of the dense
    cache, (P + 1, page, Hkv, D) pool slices when ``block_tables`` is given
    (the paged serving layout; ``dest`` holds the flat pool rows of this
    forward's writes), both written in place; or None (no cache: plain
    causal attention). kv_lens: lengths + 1, the valid keys of a decode
    step once its token is written (computed once per forward).
    cache_ks/vs: (B, S_max, Hkv) scales when the dense cache is int8.

    ``group``: the mesh's "model" process group of a tensor-parallel
    forward, training (no cache) or serving (either cache). A block whose
    leaves are pieces of the config's dims (``parallel/sharding.py``)
    computes on this rank's heads or MLP columns, between Megatron's f and
    g; where the k / v projections stay whole, the rank keeps the kv heads
    its q heads read (``sharding.kv_heads``), and the caches hold those
    heads only. ``seq``: sequence parallelism, where ``x`` holds this
    rank's T/tp tokens. ``pool_owner`` / ``pool_base``: a paged decode
    step attends the pool's first len(pool_owner) pages in place under
    their ownership mask (``_attend_pool``)."""
    attn_tp = mlp_tp = whole_kv = False
    ln1, ln2 = lp["ln1"], lp["ln2"]
    if group is not None:
        attn_tp = _split(lp["o"], cfg.q_dim, 0)
        mlp_tp = _split(lp["down"], cfg.intermediate_size, 0)
        # whole k/v under split heads: used by this rank's heads only
        whole_kv = attn_tp and not _split(lp["k"], cfg.kv_dim, 1)
        if seq:  # the norms see this rank's tokens only: sum their grads
            ln1, ln2 = coll.copy_to(ln1, group), coll.copy_to(ln2, group)
    h = _enter(_norm(x, ln1, cfg), attn_tp, seq, group)
    b, t, _ = h.shape
    if "qkv" in lp:
        q, k, v = _project(h, lp["qkv"]).split(
            [cfg.q_dim, cfg.kv_dim, cfg.kv_dim], dim=-1)
    else:
        kp, vp = lp["k"], lp["v"]
        if whole_kv:
            kp, vp = ({n: coll.copy_to(w, group) for n, w in p.items()}
                      for p in (kp, vp))
        q, k, v = _project(h, lp["q"]), _project(h, kp), _project(h, vp)
    hd = cfg.head_dim
    q = q.reshape(b, t, -1, hd)
    k = k.reshape(b, t, -1, hd)
    v = v.reshape(b, t, -1, hd)
    if cfg.pos_emb == "rope":
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if attn_tp:
        hq, r = q.shape[2], coll.rank(group)
        if whole_kv:
            heads = kv_heads(cfg, coll.size(group), r)
            k, v = _take_heads(k, heads), _take_heads(v, heads)
        if bias is not None:
            bias = bias[:, r * hq:(r + 1) * hq]

    attn = None
    quant_kv = cache_k is not None and cache_k.dtype == torch.int8
    use_kernel = t == 1 and bias is None and cfg.attn_window is None
    if cache_k is None:
        keys, values = k, v
    elif prefill:
        if block_tables is None:
            write_prompt(cache_k, cache_v, k, v, prefill_offset, cache_ks,
                         cache_vs)
        else:
            write_paged(cache_k, cache_v, k, v, dest)
        if mask.shape[-1] == t and prefill_offset == 0:
            # empty-cache prefill: the prompt's own keys are the whole
            # valid cache, so attend them instead of the S_max-wide cache
            # (a continuation whose suffix is as wide as the cache attends
            # the cache: its prefix lies there)
            keys, values = k, v
        elif block_tables is None:
            keys = dequantize_view(cache_k, cache_ks, q.dtype)
            values = dequantize_view(cache_v, cache_vs, q.dtype)
        else:
            keys = gather_pages(cache_k, block_tables)
            values = gather_pages(cache_v, block_tables)
    elif block_tables is None and quant_kv:  # dense int8 decode step
        write_token(cache_k, cache_v, k, v, lengths, cache_ks, cache_vs)
        if bias is None:
            attn = _attend_quant(q, cache_k, cache_ks, cache_v, cache_vs, mask)
        else:
            keys = dequantize_view(cache_k, cache_ks, q.dtype)
            values = dequantize_view(cache_v, cache_vs, q.dtype)
    elif block_tables is None:  # dense decode step
        write_token(cache_k, cache_v, k, v, lengths)
        keys, values = cache_k, cache_v
        if use_kernel:
            out = decode_attention(q[:, 0].contiguous(), cache_k.to(q.dtype),
                                   cache_v.to(q.dtype), kv_lens)
            attn = out.reshape(b, 1, -1)
    elif pool_owner is not None:  # paged decode step over the whole pool
        write_paged(cache_k, cache_v, k, v, dest)
        n = pool_owner.shape[0]
        attn = _attend_pool(q, cache_k[:n], cache_v[:n], pool_owner,
                            pool_base, lengths, cfg.attn_window)
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
    x = x + _exit(_project(attn, lp["o"]), attn_tp, seq, group)
    h = _enter(_norm(x, ln2, cfg), mlp_tp, seq, group)
    return x + _exit(_mlp(h, lp), mlp_tp, seq, group)


def _train_layer(x, lp, cfg: Qwen2Config, cos, sin, mask, bias, group, seq,
                 gather):
    """``_layer`` without a cache; ``gather`` materializes the layer's FSDP
    leaves inside it, so a rematerialized layer gathers them again."""
    if gather is not None:
        lp = gather(lp)
    return _layer(x, lp, cfg, cos, sin, None, None, mask, None, True, bias,
                  group=group, seq=seq)


# ---------------------------------------------------------------------------
# public forward
# ---------------------------------------------------------------------------


def embed(params: Params, ids: torch.Tensor, cfg: Optional[Qwen2Config] = None,
          group=None) -> torch.Tensor:
    """The ids' rows of the embedding table. ``group``: the mesh's "model"
    group of a table split over the vocab (``cfg`` gives its whole size):
    each rank looks up the ids in its range (others give 0), then the
    ranks' rows are summed."""
    w = params["embed"]
    if group is None or w.shape[0] == cfg.vocab_size:
        return w[ids.long()]
    lo = coll.rank(group) * w.shape[0]
    local = ids.long() - lo
    inside = (local >= 0) & (local < w.shape[0])
    rows = w[local.clamp(0, w.shape[0] - 1)] * inside[..., None].to(w.dtype)
    return coll.reduce_from(rows, group)


def logits_from_hidden(params: Params, hidden: torch.Tensor,
                       cfg: Qwen2Config, group=None) -> torch.Tensor:
    """(B, T, D) -> (B, T, V) f32 logits (tied embeddings or lm_head). The
    product accumulates in f32; its output is rounded to the hidden dtype
    before the f32 cast. ``group``: the mesh's "model" group of a head
    split over the vocab: each rank computes its columns and the logits
    are all-gathered over the vocab (every rank then holds all (B, T, V) of
    them in f32, as GSPMD gives a replicated cross entropy)."""
    tied = cfg.tie_word_embeddings
    w = params["embed"] if tied else params["lm_head"].get("w")
    split = group is not None and w is not None and \
        w.shape[0 if tied else 1] != cfg.vocab_size
    if split:
        hidden = coll.copy_to(hidden, group)
    if tied:
        out = F.linear(hidden, w.to(hidden.dtype)).float()
    elif "w_q" in params["lm_head"]:
        out = quantized_matmul(hidden, params["lm_head"]).float()
    else:
        out = torch.matmul(hidden, w.to(hidden.dtype)).float()
    return coll.gather_from(out, -1, group) if split else out


def forward(
    params: Params,
    cfg: Qwen2Config,
    inputs_embeds: torch.Tensor,          # (B, T, D)
    positions: torch.Tensor,              # (B, T) int RoPE positions
    cache: Optional[Union[KVCache, PagedKVCache]] = None,
    mask: Optional[torch.Tensor] = None,  # (B, T, S) bool, True = attend
    prefill: bool = True,
    prefill_offset: int = 0,
    remat: bool = False,
    group=None,
    seq: bool = False,
    gather=None,
    pool_inplace: bool = False,
    pool_bucket: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Union[KVCache, PagedKVCache]]]:
    """Run the decoder stack over embeddings; returns (hidden, cache).

    With a cache (dense, or paged with S = its virtual capacity): prefill
    writes rows [offset, offset+T), decode writes at cache.lengths; the
    returned cache shares the (updated) tensors and carries the advanced
    lengths. Without a cache: causal self-attention (the training path),
    where ``remat`` recomputes each layer in the backward pass instead of
    keeping its activations (``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint`` around the scanned layer).

    Both paths also run on tensor-parallel pieces (``_layer``'s ``group``;
    a cache then holds this rank's kv heads). Training adds ``seq``: each
    rank holds T/tp tokens
    between blocks (T must divide), all-gathered before attention and the
    MLP and reduce-scattered after; the final hidden states come back
    whole on every rank. ``gather(i, lp)`` materializes layer i's FSDP
    leaves inside the (rematerialized) layer.

    ``pool_inplace`` (a paged decode step; ``vlm.decode_chunk_pool``):
    attend the whole pool under an ownership mask (``_attend_pool``), or
    its first ``pool_bucket`` pages, instead of kernel K3."""
    x = inputs_embeds
    b, t, _ = x.shape
    if mask is None:
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=x.device))
        mask = causal.expand(b, t, t)
    cos, sin, bias, mask = pos_terms(cfg, positions, mask)
    if seq:
        x = coll.split_to(x, 1, group)
    lengths = None if cache is None else cache.lengths
    # the lengths after this forward's writes: a decode step's attention
    # counts its own token, and the returned cache carries them. A decode
    # forward over T > 1 tokens (a speculative verify pass) also returns
    # lengths + 1, as the JAX forward does: its caller commits 0..T of
    # them and sets the lengths itself (vlm._spec_verify_pass)
    new_lengths = None if cache is None else lengths + (t if prefill else 1)
    paged = isinstance(cache, PagedKVCache)
    tables = dest = owner = basep = None
    if paged:
        # the writes' pool rows are the same in every layer
        tables = cache.block_tables
        dest = (prompt_dest(tables, t, prefill_offset, cache.page_size,
                            cache.num_pages) if prefill else
                token_dest(tables, lengths, cache.page_size, cache.num_pages,
                           t))
        if pool_inplace and not prefill:
            owner, basep = pool_ownership(tables, cache.num_pages,
                                          cache.page_size)
            if pool_bucket is not None:
                owner, basep = owner[:pool_bucket], basep[:pool_bucket]
    elif cache is not None and cache.pool_view and not prefill:
        # a decode write past S_max lands at S_max - t, as JAX's
        # dynamic_update_slice clamps it: a pool view's finished rows run
        # on past its width (positions and masks keep the true lengths)
        lengths = lengths.clamp(max=cache.max_len - t)
    quant_kv = not paged and cache is not None and cache.k_scale is not None
    for i, lp in enumerate(params["layers"]):
        ck = cv = cks = cvs = None
        if paged:
            ck, cv = cache.k_pages[i], cache.v_pages[i]
        elif cache is not None:
            ck, cv = cache.k[i], cache.v[i]
            if quant_kv:
                cks, cvs = cache.k_scale[i], cache.v_scale[i]
        if cache is None:  # the training path
            args = (x, lp, cfg, cos, sin, mask, bias, group, seq,
                    None if gather is None else functools.partial(gather, i))
            if remat and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(_train_layer, *args,
                                                      use_reentrant=False)
            else:
                x = _train_layer(*args)
            continue
        x = _layer(x, lp, cfg, cos, sin, ck, cv, mask, lengths, prefill, bias,
                   prefill_offset, tables, dest, new_lengths, cks, cvs,
                   group=group, pool_owner=owner, pool_base=basep)
    new_cache = None
    if cache is not None:
        new_cache = dataclasses.replace(cache, lengths=new_lengths)
    w = params["final_norm"]
    if seq:
        w = coll.copy_to(w, group)
    h = _norm(x, w, cfg)
    return (coll.gather_from(h, 1, group) if seq else h), new_cache


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
