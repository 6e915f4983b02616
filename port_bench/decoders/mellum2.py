"""The Mellum2 decoder family (JetBrains Mellum2-12B-A2.5B's config.json,
``model_type`` mellum): pre-norm layers of RMSNorm, GQA attention with no
q / k / v biases and no QK norm, and routed experts in place of the FFN; a
final RMSNorm and an LM head of its own. Its contract is
``port_bench/family.py``'s. Written from the published description:

  * ``layer_types`` gives each layer's attention: a "sliding_attention"
    layer's query at position i sees the key at j where 0 <= i - j <
    ``sliding_window``; a "full_attention" layer sees every earlier key;
  * RoPE (GPT-NeoX halves) from ``rope_parameters`` by layer kind: the
    default frequencies theta^(-2i/d), or YaRN's (transformers'
    ``_compute_yarn_parameters``: interpolated by ``factor`` and
    extrapolated, blended over the dims between the correction range of
    ``beta_fast`` and ``beta_slow`` rotations at
    ``original_max_position_embeddings``), with cos and sin scaled by
    ``attention_factor``;
  * every "sparse" layer of ``mlp_layer_types``: a softmax router over
    ``num_experts`` logits, the top ``num_experts_per_tok``, their weights
    renormalised to sum 1 (``norm_topk_prob``, the Qwen2-MoE / Qwen3-MoE
    convention), and the output the weighted sum of those experts, each a
    SwiGLU of width ``moe_intermediate_size``; no shared expert.

The reference computes each expert on the tokens routed to it, and casts
an expert's weights to float32 at use without keeping them: float32 copies
of all of them would not fit beside the served tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from port_bench import flops as counts
from port_bench import reference, weights


def dims(cfg: dict):
    """(hidden, query heads, kv heads, head size, experts, experts a token,
    expert width, layers)."""
    h, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    return (h, hq, cfg["num_key_value_heads"], cfg.get("head_dim") or h // hq,
            cfg["num_experts"], cfg["num_experts_per_tok"],
            cfg["moe_intermediate_size"], cfg["num_hidden_layers"])


def window_of(cfg: dict, i: int):
    """Layer i's window, or None for full causal attention."""
    kind = cfg["layer_types"][i]
    return cfg["sliding_window"] if kind == "sliding_attention" else None


def sparse(cfg: dict, i: int) -> bool:
    return cfg["mlp_layer_types"][i] == "sparse"


# ---------------------------------------------------------------- weights


def draw(plan, cfg: dict) -> dict:
    """The decoder's leaves; a sparse layer's router (H, E) under
    ``"router"`` and its experts' gate | up (E, H, 2I) and down (E, I, H)
    under ``"experts"``, the layout the port's decoder takes."""
    h, hq, hkv, d, e, _, inter, layers = dims(cfg)
    s = cfg["initializer_range"]
    qk = weights.qk_gain(h, s)
    tree: Dict[str, Any] = {}
    plan.add(tree, "embed", (cfg["vocab_size"], h), "normal", s)
    tree["layers"] = []
    for i in range(layers):
        lp: Dict[str, Any] = {}
        plan.add(lp, "ln1", (h,), "one", s)
        weights.linear(plan, lp, "q", h, hq * d, s, bias=False, gain=qk)
        weights.linear(plan, lp, "k", h, hkv * d, s, bias=False, gain=qk)
        weights.linear(plan, lp, "v", h, hkv * d, s, bias=False)
        weights.linear(plan, lp, "o", hq * d, h, s, bias=False)
        plan.add(lp, "ln2", (h,), "one", s)
        if not sparse(cfg, i):
            raise NotImplementedError("a dense layer in a Mellum2 file")
        weights.linear(plan, lp, "router", h, e, s, bias=False)
        ex: Dict[str, Any] = {}
        plan.add(ex, "gateup", (e, h, 2 * inter), "normal", s)
        plan.add(ex, "down", (e, inter, h), "normal", s)
        lp["experts"] = ex
        tree["layers"].append(lp)
    plan.add(tree, "final_norm", (h,), "one", s)
    weights.linear(plan, tree, "lm_head", h, cfg["vocab_size"], s, bias=False)
    return tree


# -------------------------------------------------------------- reference


def inv_freq(cfg: dict, kind: str, device=None):
    """(head size / 2,) float32 inverse frequencies and the cos / sin
    scale of the RoPE of layer kind ``kind``."""
    p = cfg["rope_parameters"][kind]
    d = dims(cfg)[3]
    base = float(p["rope_theta"])
    pos = base ** (torch.arange(0, d, 2, device=device,
                                dtype=torch.float32) / d)
    if p.get("rope_type", "default") == "default":
        return 1.0 / pos, 1.0
    factor = float(p["factor"])
    scale = p.get("attention_factor")
    if scale is None:
        scale = 0.1 * math.log(factor) + 1.0 if factor > 1 else 1.0
    orig = p.get("original_max_position_embeddings") \
        or cfg["max_position_embeddings"]

    def corr(rot):  # the dim at which a wavelength makes ``rot`` turns
        return d * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))
    lo, hi = corr(p.get("beta_fast") or 32), corr(p.get("beta_slow") or 1)
    if p.get("truncate", True):
        lo, hi = math.floor(lo), math.ceil(hi)
    lo, hi = max(lo, 0), min(hi, d - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(d // 2, device=device, dtype=torch.float32) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1 - ramp  # the share of the extrapolated frequency
    return (1 / (factor * pos)) * (1 - keep) + (1 / pos) * keep, float(scale)


class Reference(reference.Base):
    def _norm(self, x, w):
        var = x.pow(2).mean(-1, keepdim=True)
        return x / torch.sqrt(var + self.cfg["rms_norm_eps"]) * self._w(w)

    def _expert(self, x, w):
        """x @ w for one expert's (in, out) weight, cast (and under the
        control rounded) at use and not kept."""
        w = w.float()
        if self.quant:
            w, x = reference.q8(w, 0), reference.q8(x, -1)
        return x @ w

    def experts(self, y, lp):
        """The routed experts of one layer over (T, hidden) ``y``."""
        _, _, _, _, e, top, inter, _ = dims(self.cfg)
        probs = torch.softmax(self.linear(y, lp["router"], bias=False), -1)
        wts, ids = probs.topk(top, dim=-1)
        if self.cfg["norm_topk_prob"]:
            wts = wts / wts.sum(-1, keepdim=True)
        out = torch.zeros_like(y)
        ex = lp["experts"]
        for j in range(e):
            tok, slot = (ids == j).nonzero(as_tuple=True)
            if tok.numel() == 0:
                continue
            gu = self._expert(y[tok], ex["gateup"][j])
            hid = F.silu(gu[:, :inter]) * gu[:, inter:]
            out.index_add_(0, tok, self._expert(hid, ex["down"][j])
                           * wts[tok, slot, None])
        return out

    def hidden(self, embeds: torch.Tensor) -> torch.Tensor:
        """(T, hidden) input embeddings -> final-normed hidden states."""
        cfg = self.cfg
        _, hq, hkv, d, _, _, _, layers = dims(cfg)
        t, dev = embeds.shape[0], embeds.device
        half = d // 2
        pos = torch.arange(t, device=dev, dtype=torch.float32)[:, None]
        tables = {}
        for kind in set(cfg["layer_types"]):
            inv, scale = inv_freq(cfg, kind, dev)
            ang = pos * inv[None]
            tables[kind] = (ang.cos().repeat(1, 2)[:, None] * scale,
                            ang.sin().repeat(1, 2)[:, None] * scale)
        i = torch.arange(t, device=dev)
        back = i[:, None] - i[None, :]  # query i, key j: i - j
        x = embeds
        for n, lp in enumerate(self.tree["decoder"]["layers"]):
            cos, sin = tables[cfg["layer_types"][n]]

            def rotate(z):  # (T, H, d)
                return z * cos + torch.cat([-z[..., half:], z[..., :half]],
                                           -1) * sin
            w = window_of(cfg, n)
            seen = (back >= 0) if w is None else (back >= 0) & (back < w)
            y = self._norm(x, lp["ln1"])
            q = rotate(self.linear(y, lp["q"]).view(t, hq, d)).transpose(0, 1)
            k = rotate(self.linear(y, lp["k"]).view(t, hkv, d)).transpose(0, 1)
            v = self.linear(y, lp["v"]).view(t, hkv, d).transpose(0, 1)
            k = k[torch.arange(hq, device=dev) // (hq // hkv)]
            v = v[torch.arange(hq, device=dev) // (hq // hkv)]
            o = torch.empty_like(q)
            for h0 in range(0, hq, 8):  # eight heads' scores at a time
                score = q[h0:h0 + 8] @ k[h0:h0 + 8].transpose(1, 2) \
                    / math.sqrt(d)
                score = torch.where(seen, score, torch.finfo(score.dtype).min)
                o[h0:h0 + 8] = torch.softmax(score, -1) @ v[h0:h0 + 8]
                del score
            x = x + self.linear(o.transpose(0, 1).reshape(t, -1), lp["o"],
                                bias=False)
            x = x + self.experts(self._norm(x, lp["ln2"]), lp)
        return self._norm(x, self.tree["decoder"]["final_norm"])

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return self.linear(h, self.tree["decoder"]["lm_head"], bias=False)


# ----------------------------------------------------------------- counts


def active_params(cfg: dict) -> int:
    """Weights of one layer's products that a token goes through: the
    attention projections, the router, and its k experts (no norms)."""
    h, hq, hkv, d, e, top, inter, _ = dims(cfg)
    return h * (hq + 2 * hkv) * d + hq * d * h + h * e + top * 3 * h * inter


def flops(cfg: dict, new: int, cached: int = 0, head_rows: int = 1) -> float:
    """Operations of ``new`` tokens after ``cached`` ones: the active
    products (k of E experts), attention over the keys each layer's window
    lets a token see, and the LM head at ``head_rows`` positions."""
    h, hq, _, d, _, _, _, layers = dims(cfg)
    ops = 0.0
    for i in range(layers):
        pairs = counts.causal_pairs(new, cached, window_of(cfg, i))
        ops += 2 * new * active_params(cfg) + 4 * hq * d * pairs
    return ops + 2.0 * head_rows * h * cfg["vocab_size"]


def attention(cfg: dict):
    _, hq, hkv, d, _, _, _, layers = dims(cfg)
    return [(hq, hkv, d, window_of(cfg, i)) for i in range(layers)]


def k5_layer(cfg: dict, tokens: int):
    """Kernel K5 (routed experts, bf16) over ``tokens`` real tokens in one
    sparse layer: (operations, bytes). Operations: the k experts' three
    products a token; bytes: the router and the experts the tokens reach
    read once (under a uniform router, E (1 - (1 - k/E)^tokens) of them:
    k for one token, all E for a prefill's thousands), the tokens' rows
    read once and their outputs written once."""
    h, _, _, _, e, top, inter, _ = dims(cfg)
    ops = 2.0 * 3 * h * inter * top * tokens
    touched = e * (1 - (1 - top / e) ** tokens)
    nbytes = counts.BF16 * (h * e + touched * 3 * h * inter + 2 * tokens * h)
    return ops, nbytes


def k5_call_bound_s(cfg: dict, info: dict, peak: dict) -> float:
    """The least time of one prefill call's expert layers: each sparse
    layer's ``k5_layer`` bound over the call's real rows (an image, or more
    than one token; padding rows count nothing)."""
    tokens = sum(n for n, at in zip(info["lens"], info["starts"])
                 if at >= 0 or n > 1)
    if tokens == 0:
        return 0.0
    layers = sum(sparse(cfg, i) for i in range(dims(cfg)[-1]))
    return layers * counts.bound_s(*k5_layer(cfg, tokens), peak)
