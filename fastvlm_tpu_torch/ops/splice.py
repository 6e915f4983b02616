"""Image-token splice: host-side sentinel expansion, on-device overlay.

The host expands the -200 sentinel into ``num_image_tokens`` placeholder
slots when tokenizing, so the prompt length is known before the device sees
it; the device then overlays the projected vision embeddings onto the
placeholder span with a masked gather (one select, no per-row loop). Same
contract as ``fastvlm_tpu/ops/splice.py``; the multi-image variants are not
ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def expand_image_ids(
    ids: Sequence[int],
    num_image_tokens: int,
    image_token_index: int = -200,
    pad_id: int = 0,
) -> Tuple[np.ndarray, int]:
    """Replace the -200 sentinel with N placeholder ids. Returns
    (expanded_ids, image_start); image_start = -1 for a text-only row."""
    ids = list(ids)
    if image_token_index not in ids:
        return np.asarray(ids, np.int32), -1
    pos = ids.index(image_token_index)
    if image_token_index in ids[pos + 1:]:
        raise ValueError("multiple <image> sentinels in a single-image row: "
                         "multi-image prompts are not yet ported")
    out = ids[:pos] + [pad_id] * num_image_tokens + ids[pos + 1:]
    return np.asarray(out, np.int32), pos


def pad_batch(
    rows: List[np.ndarray],
    image_starts: Sequence[int],
    pad_to: int,
    pad_id: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Right-pad expanded rows to a bucket length.
    Returns (ids (B, T), seq_lens (B,), image_starts (B,))."""
    b = len(rows)
    ids = np.full((b, pad_to), pad_id, np.int32)
    seq_lens = np.zeros((b,), np.int32)
    for i, r in enumerate(rows):
        if len(r) > pad_to:
            raise ValueError(f"row {i} length {len(r)} exceeds bucket {pad_to}")
        ids[i, : len(r)] = r
        seq_lens[i] = len(r)
    return ids, seq_lens, np.asarray(image_starts, np.int32)


def overlay_image_embeds(
    text_embeds: torch.Tensor,   # (B, T, D)
    image_embeds: torch.Tensor,  # (B, N, D) projected vision tokens
    image_starts: torch.Tensor,  # (B,) int; -1 => no image in that row
) -> torch.Tensor:
    """Overlay vision embeddings onto positions [start, start+N) per row."""
    b, t, d = text_embeds.shape
    n = image_embeds.shape[1]
    pos = torch.arange(t, device=text_embeds.device)[None, :]       # (1, T)
    start = image_starts.to(text_embeds.device).long()[:, None]     # (B, 1)
    in_span = (start >= 0) & (pos >= start) & (pos < start + n)
    rel = (pos - start).clamp(0, n - 1)                              # (B, T)
    gathered = torch.gather(image_embeds, 1,
                            rel[:, :, None].expand(b, t, d))
    return torch.where(in_span[:, :, None], gathered.to(text_embeds.dtype),
                       text_embeds)
