"""Vision special-token setup: grow the vocabulary and the embeddings.

Counterpart of ``fastvlm_tpu/utils/tokens.py`` (the reference's
``initialize_vision_tokenizer``): optionally add <im_patch> / <im_start> /
<im_end> to the tokenizer and grow the embedding rows (and an untied LM
head's columns), the new ones set to the mean of the existing ones.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from fastvlm_tpu_torch.config import Qwen2Config
from fastvlm_tpu_torch.data.constants import (
    DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_PATCH_TOKEN)


def _mean_init_rows(mat: torch.Tensor, n_new: int, dim: int) -> torch.Tensor:
    """Append n_new slices along ``dim``, each the f32 mean over that dim,
    cast to the matrix's dtype."""
    mean = mat.float().mean(dim=dim, keepdim=True)
    new = mean.repeat_interleave(n_new, dim=dim).to(mat.dtype)
    return torch.cat([mat, new], dim=dim)


def add_special_tokens(
    tokenizer,
    decoder_params: Dict[str, Any],
    cfg: Qwen2Config,
    *,
    use_im_patch: bool = False,
    use_im_start_end: bool = False,
) -> Tuple[Dict[str, Any], Qwen2Config, int]:
    """Returns (new_decoder_params, new_cfg, num_added)."""
    tokens: List[str] = []
    if use_im_patch:
        tokens.append(DEFAULT_IMAGE_PATCH_TOKEN)
    if use_im_start_end:
        tokens.extend([DEFAULT_IM_START_TOKEN, DEFAULT_IM_END_TOKEN])
    if not tokens:
        return decoder_params, cfg, 0

    added = tokenizer.add_tokens(tokens, special_tokens=True) \
        if hasattr(tokenizer, "add_tokens") else len(tokens)
    if added == 0:
        return decoder_params, cfg, 0

    params = dict(decoder_params)
    params["embed"] = _mean_init_rows(params["embed"], added, 0)
    if "lm_head" in params:
        # lm_head w is (D, V): grow its columns
        head = dict(params["lm_head"])
        head["w"] = _mean_init_rows(head["w"], added, 1)
        params["lm_head"] = head
    new_cfg = dataclasses.replace(cfg, vocab_size=cfg.vocab_size + added)
    return params, new_cfg, added
