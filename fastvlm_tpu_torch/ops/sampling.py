"""Token sampling: greedy, temperature, top-k, top-p.

Same knobs and filtering rules as ``fastvlm_tpu/ops/sampling.py``; the
random draw comes from an explicit ``torch.Generator`` (no global RNG state),
so a seed reproduces a run on one device but not the JAX package's draws.
``RowSampling`` / ``sample_rows`` carry the knobs per row, so the serving
scheduler's one decode loop serves any mix of greedy and sampled requests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
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


class RowSampling(NamedTuple):
    """Per-row sampling knobs as ``(B,)`` tensors on the logits' device,
    plus a host flag: whether any row samples. The flag is what JAX's
    ``lax.cond`` decides on the device; here the host knows it when the
    knobs are built, so an all-greedy batch skips the sort and the draw
    without reading anything back from the device."""

    temperature: torch.Tensor  # (B,) float32; <= 0 => greedy for that row
    top_p: torch.Tensor        # (B,) float32; 1.0 => disabled
    top_k: torch.Tensor        # (B,) int32;   0   => disabled
    any_sampled: bool

    @staticmethod
    def build(params_per_row: Sequence[Optional[SamplingParams]], b: int,
              device="cpu") -> "RowSampling":
        """Stack per-row ``SamplingParams`` (None => greedy pad row)."""
        t = np.zeros((b,), np.float32)
        p = np.ones((b,), np.float32)
        k = np.zeros((b,), np.int32)
        for i, sp in enumerate(params_per_row[:b]):
            if sp is None:
                continue
            t[i] = sp.temperature
            p[i] = sp.top_p
            k[i] = sp.top_k
        return RowSampling(torch.from_numpy(t).to(device),
                           torch.from_numpy(p).to(device),
                           torch.from_numpy(k).to(device),
                           bool((t > 0).any()))


def row_filter(logits: torch.Tensor, rows: RowSampling) -> torch.Tensor:
    """Temperature-scaled f32 logits (B, V) with each row's top-k and top-p
    masks applied (masked entries -1e30): the distribution a sampled row
    draws from. Top-p is taken over the top-k-masked distribution, and the
    top-1 token is always kept."""
    v = logits.shape[-1]
    scaled = logits.float() / rows.temperature.clamp_min(1e-6)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    ranks = torch.arange(v, device=logits.device)[None, :]
    top_k = rows.top_k[:, None]
    keep_k = (top_k <= 0) | (ranks < top_k)
    neg = torch.full_like(srt, NEG_INF)
    srt_m = torch.where(keep_k, srt, neg)
    probs = torch.softmax(srt_m, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_p = (((cum - probs) < rows.top_p[:, None]) | (ranks == 0)) & keep_k
    thresh = torch.where(keep_p, srt_m, torch.full_like(srt_m, float("inf")))
    thresh = thresh.amin(-1, keepdim=True)
    return torch.where(scaled < thresh, torch.full_like(scaled, NEG_INF),
                       scaled)


def sample_rows(generator: Optional[torch.Generator], logits: torch.Tensor,
                rows: RowSampling) -> torch.Tensor:
    """Per-row sampling: logits (B, V) -> ids (B,) int32. Greedy rows
    (temperature <= 0) take the argmax; sampled rows draw from
    ``row_filter``'s distribution. An all-greedy batch draws nothing from
    ``generator``."""
    g = greedy(logits)
    if not rows.any_sampled:
        return g
    probs = torch.softmax(row_filter(logits, rows), dim=-1)
    s = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.where(rows.temperature <= 0.0, g, s)
