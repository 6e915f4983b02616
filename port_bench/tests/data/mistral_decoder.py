"""A second decoder family, for the tests: Mistral (``MistralForCausalLM``),
whose every layer attends a sliding window of ``sliding_window`` keys: the
query at position i sees the key at j where 0 <= i - j < W. Pre-norm
layers of RMSNorm, GQA attention with no q / k / v biases and RoPE
(GPT-NeoX halves), a SwiGLU FFN; a final RMSNorm and an LM head of its own
unless the file ties it. Written from that description alone; its contract
is ``port_bench/family.py``'s.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from port_bench import flops as counts
from port_bench import reference, weights


def _dims(cfg: dict):
    h, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    return (h, hq, cfg["num_key_value_heads"], cfg.get("head_dim") or h // hq,
            cfg["intermediate_size"], cfg["num_hidden_layers"],
            cfg["sliding_window"])


def draw(plan, cfg: dict) -> dict:
    h, hq, hkv, d, ffn, layers, _ = _dims(cfg)
    s = cfg["initializer_range"]
    qk = weights.qk_gain(h, s)
    tree: Dict[str, Any] = {}
    plan.add(tree, "embed", (cfg["vocab_size"], h), "normal", s)
    tree["layers"] = []
    for _ in range(layers):
        lp: Dict[str, Any] = {}
        plan.add(lp, "ln1", (h,), "one", s)
        weights.linear(plan, lp, "q", h, hq * d, s, bias=False, gain=qk)
        weights.linear(plan, lp, "k", h, hkv * d, s, bias=False, gain=qk)
        weights.linear(plan, lp, "v", h, hkv * d, s, bias=False)
        weights.linear(plan, lp, "o", hq * d, h, s, bias=False)
        plan.add(lp, "ln2", (h,), "one", s)
        for key, cin, cout in (("gate", h, ffn), ("up", h, ffn),
                               ("down", ffn, h)):
            weights.linear(plan, lp, key, cin, cout, s, bias=False)
        tree["layers"].append(lp)
    plan.add(tree, "final_norm", (h,), "one", s)
    if not cfg["tie_word_embeddings"]:
        weights.linear(plan, tree, "lm_head", h, cfg["vocab_size"], s,
                       bias=False)
    return tree


class Reference(reference.Base):
    def _norm(self, x, w):
        var = x.pow(2).mean(-1, keepdim=True)
        return x / torch.sqrt(var + self.cfg["rms_norm_eps"]) * self._w(w)

    def hidden(self, embeds: torch.Tensor) -> torch.Tensor:
        _, hq, hkv, d, _, _, window = _dims(self.cfg)
        t, dev = embeds.shape[0], embeds.device
        half = d // 2
        freq = self.cfg["rope_theta"] ** (
            -torch.arange(half, device=dev, dtype=torch.float32) / half)
        theta = torch.arange(t, device=dev, dtype=torch.float32)[:, None] \
            * freq[None]
        cos = theta.cos().repeat(1, 2)[:, None]
        sin = theta.sin().repeat(1, 2)[:, None]

        def rotate(x):  # (T, H, d)
            return x * cos + torch.cat([-x[..., half:], x[..., :half]],
                                       -1) * sin

        i = torch.arange(t, device=dev)
        back = i[:, None] - i[None, :]  # query i, key j: i - j
        seen = (back >= 0) & (back < window)
        x = embeds
        for lp in self.tree["decoder"]["layers"]:
            y = self._norm(x, lp["ln1"])
            q = rotate(self.linear(y, lp["q"]).view(t, hq, d)).transpose(0, 1)
            k = rotate(self.linear(y, lp["k"]).view(t, hkv, d)).transpose(0, 1)
            v = self.linear(y, lp["v"]).view(t, hkv, d).transpose(0, 1)
            k = k[torch.arange(hq, device=dev) // (hq // hkv)]
            v = v[torch.arange(hq, device=dev) // (hq // hkv)]
            score = q @ k.transpose(1, 2) / math.sqrt(d)
            score = torch.where(seen, score, torch.finfo(score.dtype).min)
            o = (torch.softmax(score, -1) @ v).transpose(0, 1).reshape(t, -1)
            x = x + self.linear(o, lp["o"], bias=False)
            y = self._norm(x, lp["ln2"])
            x = x + self.linear(F.silu(self.linear(y, lp["gate"], bias=False))
                                * self.linear(y, lp["up"], bias=False),
                                lp["down"], bias=False)
        return self._norm(x, self.tree["decoder"]["final_norm"])

    def head(self, h: torch.Tensor) -> torch.Tensor:
        p = self.tree["decoder"]
        if self.cfg["tie_word_embeddings"]:
            w = self._w(p["embed"], 1).t()
            return (reference.q8(h, -1) if self.quant else h) @ w
        return self.linear(h, p["lm_head"], bias=False)


def flops(cfg: dict, new: int, cached: int = 0, head_rows: int = 1) -> float:
    h, hq, hkv, d, ffn, layers, window = _dims(cfg)
    params = h * (hq + 2 * hkv) * d + hq * d * h + 3 * h * ffn
    pairs = counts.causal_pairs(new, cached, window)
    return layers * (2 * new * params + 4 * hq * d * pairs) \
        + 2.0 * head_rows * h * cfg["vocab_size"]


def attention(cfg: dict):
    _, hq, hkv, d, _, layers, window = _dims(cfg)
    return [(hq, hkv, d, window)] * layers
