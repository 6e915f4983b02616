"""Prompt-lookup (n-gram) speculative decoding: exact greedy, on the device.

Counterpart of ``fastvlm_tpu/ops/speculative.py``. A draft of k tokens is
the continuation of the most recent earlier occurrence of each row's
trailing n-gram in its own history (prompt + generation); one decoder pass
over [last token, draft] (a *verify pass*, ``models/vlm.py``) checks all k
at once and commits the longest matching prefix plus the model's next
token, 1..k+1 tokens. Greedy only: the committed tokens are the ones plain
greedy decode gives, in fewer passes.

Plain functions on tensors, with no host reads. The JAX functions slice
with ``lax.dynamic_slice`` / ``lax.dynamic_update_slice``, which CLAMP a
start so that the window fits; torch indexing would raise or wrap instead,
so the clamps are written out here, exactly as JAX applies them:

  * ``ngram_draft``: the trailing n-gram starts at ``clip(hist_len - n, 0,
    L - n)``; the draft at ``clip(p + n, 0, L - k)`` for a match at p, so
    near the buffer's end the draft window shifts left;
  * ``masked_window_write``: the window starts at ``clip(start, 0, L -
    width)`` for the read of the old values and for the write alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SpecResult(NamedTuple):
    tokens: torch.Tensor         # (B, max_new_tokens) int32, zero after EOS
    num_generated: torch.Tensor  # (B,) int32 (including the EOS token)
    steps: int                   # verify passes taken
    drafted: torch.Tensor        # () int32: draft tokens proposed (active rows)
    accepted: torch.Tensor       # () int32: draft tokens accepted


def _window(x: torch.Tensor, start: torch.Tensor, width: int) -> torch.Tensor:
    """(B, width) column indices [start[b], start[b] + width)."""
    return start.long()[:, None] + torch.arange(width, device=x.device)[None]


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, k: int,
                n: int = 3) -> torch.Tensor:
    """Propose k draft tokens per row by prompt lookup.

    Finds the most recent earlier occurrence of each row's trailing n-gram
    in hist[:hist_len] and returns the k tokens that followed it. A row with
    no match drafts a repeat of its last token (acceptance then drops to the
    one token a pass commits anyway).

    hist: (B, L) int32 history (prompt + generated, right-padded);
    hist_len: (B,) valid counts (>= n). Returns (B, k) int32."""
    b, length = hist.shape
    tail = torch.gather(hist, 1, _window(
        hist, (hist_len - n).clamp(0, length - n), n))           # (B, n)
    # match positions p: hist[p:p+n] == tail, by n shifted comparisons
    eq = torch.ones((b, length - n + 1), dtype=torch.bool, device=hist.device)
    for i in range(n):
        eq = eq & (hist[:, i:length - n + 1 + i] == tail[:, i:i + 1])
    pos = torch.arange(length - n + 1, device=hist.device)[None, :]
    # the trailing n-gram itself (p = hist_len - n) and what follows it are
    # not matches
    valid = eq & (pos < (hist_len - n)[:, None])
    p = torch.where(valid, pos, -1).amax(dim=-1)               # -1: no match
    has = p >= 0
    start = torch.where(has, p + n, 0).clamp(0, length - k)
    draft = torch.gather(hist, 1, _window(hist, start, k))
    return torch.where(has[:, None], draft, tail[:, -1:].expand(b, k))


def spec_mask(lengths: torch.Tensor, t: int, s_max: int) -> torch.Tensor:
    """(B, T, S_max) verify-pass mask: query i of row b sits at position
    lengths[b] + i and attends keys k_pos <= lengths[b] + i (its own key
    was just written, as in ``qwen2.decode_mask``)."""
    q_pos = lengths[:, None, None] + torch.arange(
        t, device=lengths.device)[None, :, None]
    k_pos = torch.arange(s_max, device=lengths.device)[None, None, :]
    return k_pos <= q_pos


def accept_counts(draft: torch.Tensor, verified: torch.Tensor) -> torch.Tensor:
    """(B, k) draft vs (B, k) model-verified next tokens -> (B,) int32
    length of the longest accepted prefix."""
    match = (draft == verified).to(torch.int32)
    return torch.cumprod(match, dim=-1).sum(dim=-1).to(torch.int32)


def masked_window_write(rows: torch.Tensor, vec: torch.Tensor,
                        start: torch.Tensor, count: torch.Tensor,
                        width: int) -> torch.Tensor:
    """Write ``vec[b, :count[b]]`` into ``rows[b]`` at ``start[b]`` through a
    ``width``-wide window (window slots >= count keep their old values), in
    place: the speculative commit of a verify pass's k+1 tokens, of which
    0..k+1 are kept. The window start clamps to ``L - width`` as JAX's
    ``dynamic_slice`` / ``dynamic_update_slice`` do. rows: (B, L); vec:
    (B, width); start, count: (B,). Returns ``rows``."""
    idx = _window(rows, start.clamp(0, rows.shape[1] - width), width)
    keep = torch.arange(width, device=rows.device)[None, :] < count[:, None]
    rows.scatter_(1, idx, torch.where(keep, vec.to(rows.dtype),
                                      torch.gather(rows, 1, idx)))
    return rows
