"""FastVLM in PyTorch: vision encode -> projector -> splice -> prefill -> decode.

Counterpart of the single-image path of ``fastvlm_tpu/models/vlm.py``. The
JAX package compiles prefill and a ``lax.scan`` / ``while_loop`` decode; here
the same functions run eagerly, and the decode loops are Python loops over
``decode_step`` that keep every tensor on the device (the host reads tokens
once per chunk, in the engine).

Prompts are right-padded to a bucket length; the image sentinel is expanded
host-side to ``num_image_tokens`` placeholder slots (ops/splice.py); the KV
cache is allocated by the caller and updated in place. ``prefill``,
``prefill_continue`` (a suffix after cached prefix tokens: video frames,
prefix-cache hits, chunked admissions), ``decode_step`` and
``decode_chunk`` take the dense ``KVCache`` or the paged ``PagedKVCache``
of the serving scheduler (serve/batcher.py) alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from fastvlm_tpu_torch.config import FastVLMConfig, resolve_dtype
from fastvlm_tpu_torch.models import fastvit, projector, qwen2
from fastvlm_tpu_torch.ops.kv_cache import KVCache, PagedKVCache, init_cache
from fastvlm_tpu_torch.ops.sampling import (
    RowSampling, SamplingParams, sample, sample_rows)
from fastvlm_tpu_torch.ops.splice import overlay_image_embeds

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: FastVLMConfig, device="cpu") -> Params:
    """Random params for the whole model, drawn from ``gen`` (a generator on
    ``device``)."""
    if "unpad" in cfg.mm_patch_merge_type:
        raise NotImplementedError("unpad merges (anyres) are not yet ported, "
                                  "see ROADMAP.md")
    return {
        "vision": fastvit.init(gen, cfg.vision, device),
        "projector": projector.init(gen, cfg.projector, device),
        "decoder": qwen2.init(gen, cfg.decoder, device),
    }


def encode_images(params: Params, cfg: FastVLMConfig,
                  images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) -> projected vision embeddings (B, N, hidden)."""
    feats = fastvit.apply(params["vision"], images, cfg.vision)
    return projector.apply(params["projector"], feats, cfg.projector)


def _spliced_prompt_embeds(params, cfg, images, ids, image_starts,
                           vision_embeds=None):
    """Text embeddings of ids (B, T) with the image span overlaid (single
    image per row)."""
    cd = resolve_dtype(cfg.decoder.compute_dtype)
    text = qwen2.embed(params["decoder"], ids).to(cd)
    if vision_embeds is None and images is not None:
        vision_embeds = encode_images(params, cfg, images)
    if vision_embeds is not None:
        text = overlay_image_embeds(text, vision_embeds.to(cd), image_starts)
    return text


def prefill(
    params: Params,
    cfg: FastVLMConfig,
    images: Optional[torch.Tensor],  # (B, H, W, 3) or None (text-only)
    ids: torch.Tensor,               # (B, T) sentinel-expanded, right-padded
    seq_lens: torch.Tensor,          # (B,) int32
    image_starts: torch.Tensor,      # (B,) -1 for text-only rows
    cache: Union[KVCache, PagedKVCache],
    vision_embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Union[KVCache, PagedKVCache]]:
    """Encode + prefill. Returns (next-token logits (B, V) f32, cache).

    The cache is empty, so prefill attends the prompt's own keys under a
    (B, T, T) mask; logits come from each row's last real token."""
    embeds = _spliced_prompt_embeds(params, cfg, images, ids, image_starts,
                                    vision_embeds)
    b, t, _ = embeds.shape
    positions = torch.arange(t, device=embeds.device)[None, :].expand(b, t)
    mask = qwen2.prefill_mask(seq_lens, t, t, window=cfg.decoder.attn_window)
    hidden, cache = qwen2.forward(params["decoder"], cfg.decoder, embeds,
                                  positions, cache=cache, mask=mask,
                                  prefill=True)
    cache = dataclasses.replace(cache, lengths=seq_lens.to(torch.int32))
    last = (seq_lens.long() - 1).clamp(0, t - 1)
    last_hidden = hidden[torch.arange(b, device=hidden.device), last][:, None]
    logits = qwen2.logits_from_hidden(params["decoder"], last_hidden,
                                      cfg.decoder)
    return logits[:, 0], cache


def prefill_continue(
    params: Params,
    cfg: FastVLMConfig,
    images: Optional[torch.Tensor],
    suffix_ids: torch.Tensor,     # (B, T') sentinel-expanded suffix tokens
    suffix_lens: torch.Tensor,    # (B,) real suffix lengths (<= T')
    image_starts: torch.Tensor,   # (B,) start WITHIN the suffix; -1 if none
    offset: int,                  # tokens already cached (the prefix)
    cache: Union[KVCache, PagedKVCache],
) -> Tuple[torch.Tensor, Union[KVCache, PagedKVCache]]:
    """Continue a prefill after ``offset`` cached prefix tokens: the video
    path's per-frame suffix, a prefix-cache hit's suffix, or one chunk of a
    chunked admission. The suffix is written at [offset, offset + T') and
    attends the whole cache under ``k <= offset + i`` (the plain attention
    over the dense cache, or over the paged rows gathered into order).
    Returns (next-token logits (B, V) f32 at each row's last real suffix
    token, cache with lengths offset + suffix_lens)."""
    embeds = _spliced_prompt_embeds(params, cfg, images, suffix_ids,
                                    image_starts)
    b, t, _ = embeds.shape
    dev = embeds.device
    positions = offset + torch.arange(t, device=dev)[None, :].expand(b, t)
    q_pos = offset + torch.arange(t, device=dev)[:, None]
    k_pos = torch.arange(cache.max_len, device=dev)[None, :]
    mask = k_pos <= q_pos
    if cfg.decoder.attn_window is not None:
        mask = mask & (q_pos - k_pos < cfg.decoder.attn_window)
    mask = mask[None].expand(b, t, cache.max_len)
    hidden, cache = qwen2.forward(params["decoder"], cfg.decoder, embeds,
                                  positions, cache=cache, mask=mask,
                                  prefill=True, prefill_offset=offset)
    cache = dataclasses.replace(
        cache, lengths=(offset + suffix_lens).to(torch.int32))
    last = (suffix_lens.long() - 1).clamp(0, t - 1)
    last_hidden = hidden[torch.arange(b, device=dev), last][:, None]
    logits = qwen2.logits_from_hidden(params["decoder"], last_hidden,
                                      cfg.decoder)
    return logits[:, 0], cache


def decode_step(params: Params, cfg: FastVLMConfig, tokens: torch.Tensor,
                cache: Union[KVCache, PagedKVCache]
                ) -> Tuple[torch.Tensor, Union[KVCache, PagedKVCache]]:
    """One decode step: embed the last tokens (B,), attend over the cache
    (kernel K2 on a dense cache, K3 on a paged one, on the card), return
    (logits (B, V), cache)."""
    embeds = qwen2.embed(params["decoder"], tokens[:, None]).to(
        resolve_dtype(cfg.decoder.compute_dtype))
    positions = cache.lengths[:, None]
    mask = qwen2.decode_mask(cache.lengths, cache.max_len,
                             window=cfg.decoder.attn_window)
    hidden, cache = qwen2.forward(params["decoder"], cfg.decoder, embeds,
                                  positions, cache=cache, mask=mask,
                                  prefill=False)
    logits = qwen2.logits_from_hidden(params["decoder"], hidden, cfg.decoder)
    return logits[:, 0], cache


def decode_chunk(
    params: Params,
    cfg: FastVLMConfig,
    last_tok: torch.Tensor,   # (B,) int32
    done: torch.Tensor,       # (B,) bool
    cache: Union[KVCache, PagedKVCache],
    generator: Optional[torch.Generator],
    *,
    k: int = 8,
    eos_ids: Tuple[int, ...] = (151645,),
    sampling: SamplingParams = SamplingParams(),
    row_sampling: Optional[RowSampling] = None,
):
    """Decode k tokens without reading anything back to the host: the
    streaming unit. Slots after a row's EOS hold 0. ``row_sampling`` (per-row
    knobs, the continuous-batching scheduler's) replaces ``sampling`` when
    given.

    Returns (tokens (B, k) int32, done (B,), last_tok (B,), cache)."""
    eos = torch.tensor(eos_ids, dtype=torch.int32, device=last_tok.device)
    toks = []
    tok = last_tok
    for _ in range(k):
        logits, cache = decode_step(params, cfg, tok, cache)
        if row_sampling is not None:
            new = sample_rows(generator, logits, row_sampling)
        else:
            new = sample(generator, logits, sampling)
        new = torch.where(done, torch.zeros_like(new), new)
        done = done | torch.isin(new, eos)
        toks.append(new)
        tok = new
    return torch.stack(toks, dim=1), done, tok, cache


class GenerateResult(NamedTuple):
    tokens: torch.Tensor         # (B, max_new_tokens) int32
    num_generated: torch.Tensor  # (B,) int32, through the first EOS


def generate(
    params: Params,
    cfg: FastVLMConfig,
    images: Optional[torch.Tensor],
    ids: torch.Tensor,
    seq_lens: torch.Tensor,
    image_starts: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int = 256,
    eos_ids: Sequence[int] = (151645,),
    sampling: SamplingParams = SamplingParams(),
) -> GenerateResult:
    """Whole generation: prefill, then decode until every row has emitted an
    EOS or max_new_tokens are out. The loop checks ``done`` on the host once
    per token, where the JAX package's ``while_loop`` checks it on device."""
    b, t = ids.shape
    dev = ids.device
    cache = init_cache(cfg.decoder.num_layers, b, t + max_new_tokens,
                       cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                       dtype=resolve_dtype(cfg.decoder.compute_dtype),
                       device=dev)
    logits, cache = prefill(params, cfg, images, ids, seq_lens, image_starts,
                            cache)
    eos = torch.tensor(tuple(eos_ids), dtype=torch.int32, device=dev)
    tok = sample(generator, logits, sampling)
    out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=dev)
    out[:, 0] = tok
    done = torch.isin(tok, eos)
    steps = 1
    while steps < max_new_tokens and not bool(done.all()):
        logits, cache = decode_step(params, cfg, tok, cache)
        tok = sample(generator, logits, sampling)
        tok = torch.where(done, torch.zeros_like(tok), tok)
        out[:, steps] = tok
        done = done | torch.isin(tok, eos)
        steps += 1
    is_eos = torch.isin(out, eos)
    first_eos = torch.argmax(is_eos.int(), dim=1)
    num = torch.where(is_eos.any(dim=1), first_eos + 1,
                      torch.full_like(first_eos, steps))
    return GenerateResult(tokens=out, num_generated=num.to(torch.int32))
