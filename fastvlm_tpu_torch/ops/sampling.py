"""Token sampling: greedy, temperature, top-k, top-p.

Same knobs and filtering rules as ``fastvlm_tpu/ops/sampling.py``; the
random draw comes from an explicit ``torch.Generator`` (no global RNG state),
so a seed reproduces a run on one device but not the JAX package's draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


class SamplingParams(NamedTuple):
    temperature: float = 0.0  # 0 => greedy
    top_p: float = 1.0
    top_k: int = 0  # 0 => disabled


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V) -> ids (B,) int32 (first maximum on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _apply_top_k(logits, k):
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def _apply_top_p(logits, top_p):
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens while the exclusive cumulative prob < top_p; top-1 always
    keep_sorted = (cum - probs) < top_p
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.amin(-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def sample(generator: Optional[torch.Generator], logits: torch.Tensor,
           params: SamplingParams = SamplingParams()) -> torch.Tensor:
    """logits (B, V) float -> sampled ids (B,) int32. temperature <= 0 is
    greedy and draws nothing from ``generator``."""
    if params.temperature <= 0.0:
        return greedy(logits)
    logits = logits.float() / params.temperature
    if params.top_k and params.top_k > 0:
        logits = _apply_top_k(logits, params.top_k)
    if params.top_p < 1.0:
        logits = _apply_top_p(logits, params.top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
