"""The dense Qwen2 decoder family (``Qwen2ForCausalLM``): pre-norm layers
of RMSNorm, GQA attention with q / k / v biases and RoPE (GPT-NeoX
halves, one theta) over every earlier key, and a SwiGLU FFN; a final
RMSNorm, and the LM head tied to the embeddings or not. It is the family
of a configuration that names none (``family.DEFAULT``); its contract is
``family.py``'s.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from port_bench import flops as counts
from port_bench import reference, weights


def dims(cfg: dict):
    """(hidden, query heads, kv heads, head size, FFN width, layers)."""
    h = cfg["hidden_size"]
    hq = cfg["num_attention_heads"]
    hkv = cfg["num_key_value_heads"]
    d = cfg.get("head_dim") or h // hq
    return h, hq, hkv, d, cfg["intermediate_size"], cfg["num_hidden_layers"]


# ---------------------------------------------------------------- weights


def draw(plan, cfg: dict) -> dict:
    h, hq, hkv, d, ffn, layers = dims(cfg)
    s = cfg["initializer_range"]
    tree: Dict[str, Any] = {}
    plan.add(tree, "embed", (cfg["vocab_size"], h), "normal", s)
    out = []
    for _ in range(layers):
        lp: Dict[str, Any] = {}
        plan.add(lp, "ln1", (h,), "one", s)
        qk = weights.qk_gain(h, s)
        weights.linear(plan, lp, "q", h, hq * d, s, bias_kind="normal",
                       gain=qk)
        weights.linear(plan, lp, "k", h, hkv * d, s, bias_kind="normal",
                       gain=qk)
        weights.linear(plan, lp, "v", h, hkv * d, s, bias_kind="normal")
        weights.linear(plan, lp, "o", hq * d, h, s, bias=False)
        plan.add(lp, "ln2", (h,), "one", s)
        weights.linear(plan, lp, "gate", h, ffn, s, bias=False)
        weights.linear(plan, lp, "up", h, ffn, s, bias=False)
        weights.linear(plan, lp, "down", ffn, h, s, bias=False)
        out.append(lp)
    tree["layers"] = out
    plan.add(tree, "final_norm", (h,), "one", s)
    if not cfg["tie_word_embeddings"]:
        weights.linear(plan, tree, "lm_head", h, cfg["vocab_size"], s,
                       bias=False)
    return tree


# -------------------------------------------------------------- reference


class Reference(reference.Base):
    def _rms(self, x, w):
        eps = self.cfg["rms_norm_eps"]
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
            * self._w(w)

    def hidden(self, embeds: torch.Tensor) -> torch.Tensor:
        """(T, hidden) input embeddings -> final-normed hidden states."""
        cfg, p = self.cfg, self.tree["decoder"]
        t = embeds.shape[0]
        _, hq, hkv, d, _, _ = dims(cfg)
        pos = torch.arange(t, device=embeds.device, dtype=torch.float32)
        inv = 1.0 / cfg["rope_theta"] ** (
            torch.arange(0, d // 2, device=embeds.device,
                         dtype=torch.float32) / (d // 2))
        ang = pos[:, None] * inv[None]
        cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)

        def rope(x):  # (T, H, d), GPT-NeoX halves
            rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
            return x * cos[:, None] + rot * sin[:, None]

        causal = torch.ones(t, t, dtype=torch.bool,
                            device=embeds.device).tril()
        x = embeds
        for lp in p["layers"]:
            y = self._rms(x, lp["ln1"])
            q = rope(self.linear(y, lp["q"]).reshape(t, hq, d))
            k = rope(self.linear(y, lp["k"]).reshape(t, hkv, d))
            v = self.linear(y, lp["v"]).reshape(t, hkv, d)
            k = k.repeat_interleave(hq // hkv, dim=1)
            v = v.repeat_interleave(hq // hkv, dim=1)
            s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(d)
            s = s.masked_fill(~causal, float("-inf"))
            o = torch.einsum("hts,shd->thd", torch.softmax(s, -1), v)
            x = x + self.linear(o.reshape(t, hq * d), lp["o"], bias=False)
            y = self._rms(x, lp["ln2"])
            g = F.silu(self.linear(y, lp["gate"], bias=False))
            x = x + self.linear(g * self.linear(y, lp["up"], bias=False),
                                lp["down"], bias=False)
        return self._rms(x, p["final_norm"])

    def head(self, h: torch.Tensor) -> torch.Tensor:
        p = self.tree["decoder"]
        if self.cfg["tie_word_embeddings"]:
            w = self._w(p["embed"], 1).t()
            return torch.matmul(reference.q8(h, -1) if self.quant else h, w)
        return self.linear(h, p["lm_head"], bias=False)


# ----------------------------------------------------------------- counts


def layer_params(cfg: dict) -> int:
    """Weights of one decoder layer's products (no norms, no biases)."""
    h, hq, hkv, d, ffn, _ = dims(cfg)
    return h * (hq + 2 * hkv) * d + hq * d * h + 3 * h * ffn


def flops(cfg: dict, new: int, cached: int = 0, head_rows: int = 1) -> float:
    """Operations of ``new`` tokens after ``cached`` ones: every product,
    causal attention over the keys each token sees, and the LM head at
    ``head_rows`` positions."""
    h, hq, _, d, _, layers = dims(cfg)
    keys = counts.causal_pairs(new, cached)  # Σ keys seen a token
    per_layer = 2 * new * layer_params(cfg) + 4 * hq * d * keys
    return layers * per_layer + 2.0 * head_rows * h * cfg["vocab_size"]


def attention(cfg: dict):
    """Every layer full causal GQA."""
    _, hq, hkv, d, _, layers = dims(cfg)
    return [(hq, hkv, d, None)] * layers
