"""FastVLM in PyTorch: vision encode -> projector -> splice -> prefill -> decode.

Counterpart of ``fastvlm_tpu/models/vlm.py``. The tower is FastViTHD or
a CLIP ViT (``models/clip_vit.py``, with S2), picked by the vision config's
type in ``init`` and ``encode_images`` / ``encode_tile_grids``. The
JAX package compiles prefill and a ``lax.scan`` / ``while_loop`` decode; here
the same functions run eagerly, and the decode loops are Python loops over
``decode_step`` that keep every tensor on the device (the host reads tokens
once per chunk, in the engine).

Prompts are right-padded to a bucket length; the image sentinel is expanded
host-side to ``num_image_tokens`` placeholder slots (ops/splice.py), or, for
an anyres image, to its merged token count; the KV
cache is allocated by the caller and updated in place. ``prefill``,
``prefill_continue`` (a suffix after cached prefix tokens: video frames,
prefix-cache hits, chunked admissions), ``decode_step`` and
``decode_chunk`` take the dense ``KVCache`` or the paged ``PagedKVCache``
of the serving scheduler (serve/batcher.py) alike.

The JAX scheduler's dense views of the pool: ``decode_chunk_paged`` (the
chunk view: gather once a chunk, k dense steps, write back),
``gather_view`` / ``decode_chunk`` on the view / ``sync_pool_from_view`` /
``update_view_row`` (the persistent view, synced at boundaries) and
``decode_chunk_view`` (a view step with its write-back). The dense steps
run ``decode_chunk`` on a ``KVCache``, so on the card kernel K2 runs on the
view. ``decode_chunk_pool`` attends the whole pool under an ownership mask.

AnyRes: ``encode_tile_grids`` runs the tower and the projector once over a
[global view + tiles] stack, ``merge_tile_grids`` merges the grids per
``mm_patch_merge_type`` (``ops/anyres.py``); the merged tokens reach
``prefill`` as ``vision_embeds``. Multi-image rows take (B, M, N, D)
``vision_embeds`` or (B, M, H, W, 3) images with (B, M) image starts.

Speculative decoding (prompt lookup, greedy only; ``ops/speculative.py``):
``spec_decode`` / ``spec_decode_from_tok`` / ``generate_spec`` run whole
generations, ``spec_carry_init`` + ``spec_stream_chunk`` run m verify
passes a dispatch for the streaming engine and, over a ``PagedKVCache``,
for the scheduler. The JAX ``lax.while_loop`` checks ``all(done)`` on the
device; here the host reads it once a verify pass, so passes, drafts and
acceptances equal JAX's exactly.

Tensor parallelism (``engine.Engine(mesh=)``): every function that runs
the decoder takes ``group``, the mesh's "model" process group, and the
params and caches are then this rank's pieces (``parallel/sharding.py``):
the embedding lookup and the vocab-split logits are reduced and gathered
over it, so every rank holds the same logits and picks the same tokens.

Inside ``prefill`` and ``prefill_continue``, the tower with the projector
and the decoder through the logits are the spans "vlm.encode" and
"vlm.decoder" of the timeline the serving scheduler binds to its thread
(``timeline.py``); on other threads they record nothing.

int8 KV (``cfg.decoder.kv_cache_dtype == "int8"``): ``generate`` and
``generate_spec`` allocate the int8 dense cache (``kv_cache_dtype``); every
other function takes the cache it is given, and the writes carry its scale
planes with the keys and values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from fastvlm_tpu_torch import timeline
from fastvlm_tpu_torch.config import FastVLMConfig, resolve_dtype
from fastvlm_tpu_torch.models import clip_vit, fastvit, projector, qwen2
from fastvlm_tpu_torch.ops.kv_cache import (
    KVCache, PagedKVCache, gather_pool_view, init_cache, table_columns,
    write_tokens_paged_rows)
from fastvlm_tpu_torch.ops.sampling import (
    RowSampling, SamplingParams, sample, sample_rows)
from fastvlm_tpu_torch.ops.speculative import (
    SpecResult, accept_counts, masked_window_write, ngram_draft, spec_mask)
from fastvlm_tpu_torch.ops import anyres
from fastvlm_tpu_torch.ops.splice import (
    overlay_image_embeds, overlay_image_embeds_multi)

Params = Dict[str, Any]


def kv_cache_dtype(cfg: FastVLMConfig) -> torch.dtype:
    """The dense KV cache's storage type: int8 for a decoder with
    ``kv_cache_dtype="int8"``, else its compute dtype."""
    if cfg.decoder.kv_cache_dtype == "int8":
        cfg.decoder.require_uniform("the dense int8 KV cache")
        return torch.int8
    return resolve_dtype(cfg.decoder.compute_dtype)


def init(gen: torch.Generator, cfg: FastVLMConfig, device="cpu") -> Params:
    """Random params for the whole model, drawn from ``gen`` (a generator on
    ``device``); unpad merges add the ``image_newline`` row separator,
    N(0, 1/d) in the decoder's param dtype. A CLIP tower is drawn in f32,
    as the JAX ``vlm.init`` draws it."""
    if isinstance(cfg.vision, clip_vit.CLIPViTConfig):
        vision = clip_vit.init(gen, cfg.vision, device)
    else:
        vision = fastvit.init(gen, cfg.vision, device)
    params = {
        "vision": vision,
        "projector": projector.init(gen, cfg.projector, device),
        "decoder": qwen2.init(gen, cfg.decoder, device),
    }
    if "unpad" in cfg.mm_patch_merge_type:
        d = cfg.decoder.hidden_size
        params["image_newline"] = (
            torch.randn((d,), generator=gen, device=device) / d ** 0.5
        ).to(resolve_dtype(cfg.decoder.param_dtype))
    return params


def _tower_features(params: Params, cfg: FastVLMConfig,
                    images: torch.Tensor) -> torch.Tensor:
    """The tower picked by the vision config's type: FastViTHD, or a CLIP
    ViT (S2 when ``s2_scales`` is set) -> (B, N, C) features."""
    if isinstance(cfg.vision, clip_vit.CLIPViTConfig):
        if cfg.vision.s2_scales:
            return clip_vit.features_s2(params["vision"], images, cfg.vision)
        return clip_vit.features(params["vision"], images, cfg.vision)
    return fastvit.apply(params["vision"], images, cfg.vision)


def encode_images(params: Params, cfg: FastVLMConfig,
                  images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) -> projected vision embeddings (B, N, hidden)."""
    feats = _tower_features(params, cfg, images)
    return projector.apply(params["projector"], feats, cfg.projector)


def encode_tile_grids(params: Params, cfg: FastVLMConfig,
                      tiles: torch.Tensor) -> torch.Tensor:
    """Tower + projector over a [global view + tiles] stack (T, S, S, 3) ->
    (T, h, w, hidden) feature grids, in one tower call. FastViTHD only: a
    CLIP tower raises (the JAX function calls FastViTHD's
    ``features_grid`` for any tower, so a CLIP tower fails there too)."""
    if isinstance(cfg.vision, clip_vit.CLIPViTConfig):
        raise ValueError("anyres tiles need a FastViTHD tower, got a CLIP "
                         "ViT")
    grids = fastvit.features_grid(params["vision"], tiles, cfg.vision)
    return projector.apply(params["projector"], grids, cfg.projector)


def merge_tile_grids(
    params: Params,
    cfg: FastVLMConfig,
    grids: torch.Tensor,                 # (T, h, w, hidden)
    grid_shape: Tuple[int, int],         # (grid_w, grid_h) in tiles
    crop_box: Optional[Tuple[int, int, int, int]] = None,
) -> torch.Tensor:
    """Merge the tile grids per cfg.mm_patch_merge_type -> (1, N, hidden).
    The newline separators exist only for unpad merges."""
    merge = cfg.mm_patch_merge_type
    if merge == "flat":
        feats = anyres.merge_flat(grids)
    else:
        unpad = "unpad" in merge
        feats = anyres.merge_spatial(
            grids, grid_shape,
            image_newline=params.get("image_newline") if unpad else None,
            crop_box=crop_box if unpad else None, unpad=unpad)
    return feats[None]


def anyres_crop_box(cfg: FastVLMConfig, grid_shape: Tuple[int, int],
                    original_size: Optional[Tuple[int, int]]):
    """Unpad crop box of a merged anyres feature grid, shared by
    ``encode_tiles`` and the engine. None when the merge type does not
    unpad or the original size is unknown."""
    if "unpad" not in cfg.mm_patch_merge_type or original_size is None:
        return None
    h = w = cfg.vision.grid_size
    gw, gh = grid_shape
    return anyres.unpad_hw((gh * h, gw * w), original_size)


def encode_tiles(
    params: Params,
    cfg: FastVLMConfig,
    tiles: torch.Tensor,                 # (T, S, S, 3) global view + tiles
    grid_shape: Tuple[int, int],         # (grid_w, grid_h) in tiles
    original_size: Optional[Tuple[int, int]] = None,  # (width, height)
) -> torch.Tensor:
    """AnyRes encode: ``encode_tile_grids`` then ``merge_tile_grids`` ->
    (1, N, hidden)."""
    grids = encode_tile_grids(params, cfg, tiles)
    crop_box = anyres_crop_box(cfg, grid_shape, original_size)
    return merge_tile_grids(params, cfg, grids, grid_shape, crop_box)


def _spliced_prompt_embeds(params, cfg, images, ids, image_starts,
                           vision_embeds=None, text=None):
    """Text embeddings of ids (B, T) with the image spans overlaid: images
    (B, H, W, 3) or vision_embeds (B, N, D) with (B,) starts, one image a
    row; images (B, M, H, W, 3) or vision_embeds (B, M, N, D) with (B, M)
    starts (-1 for an absent slot), M images a row. ``text``: the ids'
    embeddings, where the caller looked them up (a vocab-split table)."""
    cd = resolve_dtype(cfg.decoder.compute_dtype)
    if text is None:
        text = qwen2.embed(params["decoder"], ids)
    text = text.to(cd)
    if vision_embeds is None and images is not None:
        tl = timeline.current()
        span = None if tl is None else tl.open(
            "vlm.encode", device=True,
            images=images.shape[0] * (images.shape[1] if images.dim() == 5
                                      else 1))
        if images.dim() == 5:
            b, m = images.shape[:2]
            vis = encode_images(params, cfg, images.reshape(
                (b * m,) + tuple(images.shape[2:])))
            vision_embeds = vis.reshape(b, m, vis.shape[1], vis.shape[2])
        else:
            vision_embeds = encode_images(params, cfg, images)
        if span is not None:
            tl.close(span)
    if vision_embeds is None:
        return text
    if vision_embeds.dim() == 4:
        return overlay_image_embeds_multi(text, vision_embeds.to(cd),
                                          image_starts)
    return overlay_image_embeds(text, vision_embeds.to(cd), image_starts)


def prefill(
    params: Params,
    cfg: FastVLMConfig,
    images: Optional[torch.Tensor],  # (B, H, W, 3) or None (text-only)
    ids: torch.Tensor,               # (B, T) sentinel-expanded, right-padded
    seq_lens: torch.Tensor,          # (B,) int32
    image_starts: torch.Tensor,      # (B,) -1 for text-only rows
    cache: Union[KVCache, PagedKVCache],
    vision_embeds: Optional[torch.Tensor] = None,
    group=None,
) -> Tuple[torch.Tensor, Union[KVCache, PagedKVCache]]:
    """Encode + prefill. Returns (next-token logits (B, V) f32, cache).

    The cache is empty, so prefill attends the prompt's own keys under a
    (B, T, T) mask; logits come from each row's last real token."""
    embeds = _spliced_prompt_embeds(
        params, cfg, images, ids, image_starts, vision_embeds,
        text=qwen2.embed(params["decoder"], ids, cfg.decoder, group))
    b, t, _ = embeds.shape
    tl = timeline.current()
    span = None if tl is None else tl.open("vlm.decoder", device=True)
    positions = torch.arange(t, device=embeds.device)[None, :].expand(b, t)
    mask = qwen2.prefill_mask(seq_lens, t, t)
    hidden, cache = qwen2.forward(params["decoder"], cfg.decoder, embeds,
                                  positions, cache=cache, mask=mask,
                                  prefill=True, group=group,
                                  causal=qwen2.CausalMask(seq_lens))
    cache = dataclasses.replace(cache, lengths=seq_lens.to(torch.int32))
    last = (seq_lens.long() - 1).clamp(0, t - 1)
    last_hidden = hidden[torch.arange(b, device=hidden.device), last][:, None]
    logits = qwen2.logits_from_hidden(params["decoder"], last_hidden,
                                      cfg.decoder, group)
    if span is not None:
        tl.close(span)
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
    group=None,
) -> Tuple[torch.Tensor, Union[KVCache, PagedKVCache]]:
    """Continue a prefill after ``offset`` cached prefix tokens: the video
    path's per-frame suffix, a prefix-cache hit's suffix, or one chunk of a
    chunked admission. The suffix is written at [offset, offset + T') and
    attends the whole cache under ``k <= offset + i`` (the plain attention
    over the dense cache, or over the paged rows gathered into order).
    Returns (next-token logits (B, V) f32 at each row's last real suffix
    token, cache with lengths offset + suffix_lens)."""
    embeds = _spliced_prompt_embeds(
        params, cfg, images, suffix_ids, image_starts,
        text=qwen2.embed(params["decoder"], suffix_ids, cfg.decoder, group))
    b, t, _ = embeds.shape
    dev = embeds.device
    tl = timeline.current()
    span = None if tl is None else tl.open("vlm.decoder", device=True)
    positions = offset + torch.arange(t, device=dev)[None, :].expand(b, t)
    q_pos = offset + torch.arange(t, device=dev)[:, None]
    k_pos = torch.arange(cache.max_len, device=dev)[None, :]
    mask = (k_pos <= q_pos)[None].expand(b, t, cache.max_len)
    hidden, cache = qwen2.forward(params["decoder"], cfg.decoder, embeds,
                                  positions, cache=cache, mask=mask,
                                  prefill=True, prefill_offset=offset,
                                  group=group, causal=qwen2.CausalMask())
    cache = dataclasses.replace(
        cache, lengths=(offset + suffix_lens).to(torch.int32))
    last = (suffix_lens.long() - 1).clamp(0, t - 1)
    last_hidden = hidden[torch.arange(b, device=dev), last][:, None]
    logits = qwen2.logits_from_hidden(params["decoder"], last_hidden,
                                      cfg.decoder, group)
    if span is not None:
        tl.close(span)
    return logits[:, 0], cache


def decode_step(params: Params, cfg: FastVLMConfig, tokens: torch.Tensor,
                cache: Union[KVCache, PagedKVCache], group=None
                ) -> Tuple[torch.Tensor, Union[KVCache, PagedKVCache]]:
    """One decode step: embed the last tokens (B,), attend over the cache
    (kernel K2 on a dense cache, K3 on a paged one, on the card), return
    (logits (B, V), cache)."""
    embeds = qwen2.embed(params["decoder"], tokens[:, None], cfg.decoder,
                         group).to(resolve_dtype(cfg.decoder.compute_dtype))
    positions = cache.lengths[:, None]
    mask = qwen2.decode_mask(cache.lengths, cache.max_len)
    hidden, cache = qwen2.forward(params["decoder"], cfg.decoder, embeds,
                                  positions, cache=cache, mask=mask,
                                  prefill=False, group=group)
    logits = qwen2.logits_from_hidden(params["decoder"], hidden, cfg.decoder,
                                      group)
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
    group=None,
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
        logits, cache = decode_step(params, cfg, tok, cache, group)
        if row_sampling is not None:
            new = sample_rows(generator, logits, row_sampling)
        else:
            new = sample(generator, logits, sampling)
        new = torch.where(done, torch.zeros_like(new), new)
        done = done | torch.isin(new, eos)
        toks.append(new)
        tok = new
    return torch.stack(toks, dim=1), done, tok, cache


# ---------------------------------------------------------------------------
# dense views of the page pool (the JAX scheduler's chunk view and
# persistent view)
# ---------------------------------------------------------------------------


def _write_back(pool: PagedKVCache, view: KVCache, starts: torch.Tensor,
                w: int, at: Optional[torch.Tensor] = None) -> None:
    """Copy each row's view columns [starts[b], starts[b] + w) to its pool
    positions [at[b], at[b] + w) (``at`` defaults to ``starts``), every
    layer in one copy a plane; unmapped positions land in the sink."""
    dev = starts.device
    idx = (starts.long()[:, None]
           + torch.arange(w, device=dev)[None, :])          # (B, w)
    rows = torch.arange(idx.shape[0], device=dev)[:, None]
    ext_k, ext_v = view.k[:, rows, idx], view.v[:, rows, idx]
    write_tokens_paged_rows(pool.k_pages, pool.v_pages, ext_k, ext_v,
                            pool.block_tables, starts if at is None else at)


def gather_view(cache: PagedKVCache, s_bucket: int) -> KVCache:
    """The dense working view of the pool as a ``KVCache`` of width
    ``s_bucket``: the persistent view's (re)gather, made when its rows'
    identity or its width changes, not each chunk. Its planes are new
    tensors (on a tensor-parallel engine, rank-local: ``Engine.call``
    registers them)."""
    k, v = gather_pool_view(cache, s_bucket)
    return KVCache(k=k, v=v, lengths=cache.lengths.clone(),
                   pool_view=True)


def sync_pool_from_view(view: KVCache, pool: PagedKVCache,
                        synced_lens: torch.Tensor, w: int) -> PagedKVCache:
    """Write the view's columns [start[b], start[b] + w) back to the pool,
    in place, with ``start = clip(synced_lens, 0, view width - w)``: the
    persistent view's deferred sync, made before anything reads the pool.
    A window wider than the new columns is safe: the start clamp rewrites
    earlier columns with their own values, positions past a row's mapped
    pages land in the sink, and mapped future positions are written again
    before any length unmasks them. Returns the pool with the view's
    lengths."""
    start = synced_lens.clamp(0, view.max_len - w)
    _write_back(pool, view, start, w)
    return dataclasses.replace(pool, lengths=view.lengths)


def update_view_row(view: KVCache, pool: PagedKVCache,
                    row: int) -> KVCache:
    """Refresh one row of a persistent view from the pool, in place: a slot
    rebound to a new request (an admission) makes that row stale, while
    every other row's columns stay ahead of the pool. Copies the row's
    pages over the view's width and its pool length."""
    npages = view.max_len // pool.page_size
    tbl = table_columns(pool.block_tables[row:row + 1], npages)
    idx = tbl.clamp(min=0).reshape(-1).long()
    for dst, pages in ((view.k, pool.k_pages), (view.v, pool.v_pages)):
        dst[:, row] = pages.index_select(1, idx).reshape(dst[:, row].shape)
    lengths = view.lengths.clone()
    lengths[row] = pool.lengths[row]
    return dataclasses.replace(view, lengths=lengths)


def decode_chunk_view(params: Params, cfg: FastVLMConfig,
                      last_tok: torch.Tensor, done: torch.Tensor,
                      view: KVCache, pool: PagedKVCache,
                      generator: Optional[torch.Generator], *, k: int = 8,
                      eos_ids: Tuple[int, ...] = (151645,),
                      sampling: SamplingParams = SamplingParams(),
                      row_sampling: Optional[RowSampling] = None,
                      group=None):
    """k decode steps on a persistent dense view (kernel K2 on the card),
    then the k new columns of each row written back to the pool. Returns
    (tokens (B, k), done, last_tok, view, pool)."""
    start = view.lengths
    toks, done, tok, view = decode_chunk(
        params, cfg, last_tok, done, view, generator, k=k, eos_ids=eos_ids,
        sampling=sampling, row_sampling=row_sampling, group=group)
    _write_back(pool, view, start.clamp(0, view.max_len - k), k, at=start)
    return (toks, done, tok, view,
            dataclasses.replace(pool, lengths=view.lengths))


def decode_chunk_paged(params: Params, cfg: FastVLMConfig,
                       last_tok: torch.Tensor, done: torch.Tensor,
                       cache: PagedKVCache,
                       generator: Optional[torch.Generator], *, k: int = 8,
                       s_bucket: int = 512,
                       eos_ids: Tuple[int, ...] = (151645,),
                       sampling: SamplingParams = SamplingParams(),
                       row_sampling: Optional[RowSampling] = None,
                       group=None):
    """The chunk view: gather the pool's first ``s_bucket`` positions of
    each row once (``s_bucket`` >= the longest live row + k, a multiple of
    the page size), run the chunk's k steps on that dense view (kernel K2
    on the card), and write each row's k new columns back to its pages.
    Returns (tokens (B, k), done, last_tok, cache)."""
    start = cache.lengths
    view_k, view_v = gather_pool_view(cache, s_bucket)
    dense = KVCache(k=view_k, v=view_v, lengths=start, pool_view=True)
    toks, done, tok, dense = decode_chunk(
        params, cfg, last_tok, done, dense, generator, k=k, eos_ids=eos_ids,
        sampling=sampling, row_sampling=row_sampling, group=group)
    _write_back(cache, dense, start.clamp(0, s_bucket - k), k, at=start)
    return toks, done, tok, dataclasses.replace(cache, lengths=dense.lengths)


def decode_chunk_pool(params: Params, cfg: FastVLMConfig,
                      last_tok: torch.Tensor, done: torch.Tensor,
                      cache: PagedKVCache,
                      generator: Optional[torch.Generator], *, k: int = 8,
                      eos_ids: Tuple[int, ...] = (151645,),
                      sampling: SamplingParams = SamplingParams(),
                      row_sampling: Optional[RowSampling] = None,
                      p_bucket: Optional[int] = None, group=None):
    """k decode steps that attend the whole pool in place under an
    ownership mask (``qwen2._attend_pool``; plain torch, as JAX computes it
    in XLA), or its first ``p_bucket`` pages when every mapped page lies
    below that. No gather, no view, no write-back. Returns (tokens (B, k),
    done, last_tok, cache)."""
    eos = torch.tensor(eos_ids, dtype=torch.int32, device=last_tok.device)
    cd = resolve_dtype(cfg.decoder.compute_dtype)
    toks = []
    tok = last_tok
    for _ in range(k):
        embeds = qwen2.embed(params["decoder"], tok[:, None], cfg.decoder,
                             group).to(cd)
        hidden, cache = qwen2.forward(
            params["decoder"], cfg.decoder, embeds, cache.lengths[:, None],
            cache=cache, mask=torch.ones((tok.shape[0], 1, 1),
                                         dtype=torch.bool,
                                         device=tok.device),
            prefill=False, group=group, pool_inplace=True,
            pool_bucket=p_bucket)
        logits = qwen2.logits_from_hidden(params["decoder"], hidden,
                                          cfg.decoder, group)[:, 0]
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
                       dtype=kv_cache_dtype(cfg), device=dev)
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


# ---------------------------------------------------------------------------
# speculative decoding (prompt lookup, greedy)
# ---------------------------------------------------------------------------


def spec_cache_len(prompt_bucket: int, max_new_tokens: int,
                   draft_k: int) -> int:
    """KV length a speculative-decode cache must be allocated with: a verify
    pass writes draft_k + 1 slots past the committed length before
    acceptance cuts it, so the cache needs that slack past prompt +
    generation."""
    return prompt_bucket + max_new_tokens + draft_k + 1


def _spec_verify_pass(params, cfg, last_tok, done, num, cache, hist, hist_len,
                      *, k, ngram_n, eos, max_new_tokens, cd, group=None):
    """One verify pass: draft k tokens from the history, run the decoder
    over [last_tok, draft] at each row's own offset, commit the longest
    matching prefix + the model's next token, cut at the first EOS inside
    that span and at the budget; rows already done commit 0.

    Returns (g (B, k+1) verified tokens, count (B,) committed, done',
    last_tok', cache', hist', hist_len')."""
    cfg.decoder.require_uniform("the speculative verify pass")
    dev = last_tok.device
    active = ~done
    draft = ngram_draft(hist, hist_len, k, n=ngram_n)
    seq = torch.cat([last_tok[:, None], draft], dim=1)       # (B, k+1)
    embeds = qwen2.embed(params["decoder"], seq, cfg.decoder, group).to(cd)
    lengths = cache.lengths
    steps = torch.arange(k + 1, dtype=torch.int32, device=dev)
    positions = lengths[:, None] + steps[None]
    mask = spec_mask(lengths, k + 1, cache.max_len)
    hidden, cache = qwen2.forward(params["decoder"], cfg.decoder, embeds,
                                  positions, cache=cache, mask=mask,
                                  prefill=False, group=group)
    logits = qwen2.logits_from_hidden(params["decoder"], hidden, cfg.decoder,
                                      group)
    g = logits.argmax(dim=-1).to(torch.int32)                # (B, k+1)

    count = accept_counts(draft, g[:, :k]) + 1               # + the bonus
    is_eos = torch.isin(g, eos) & (steps[None] < count[:, None])
    hit = is_eos.any(dim=-1)
    count = torch.where(hit, is_eos.to(torch.int32).argmax(dim=-1)
                        .to(torch.int32) + 1, count)
    count = torch.minimum(count, max_new_tokens - num)       # budget cap
    count = torch.where(active, count, torch.zeros_like(count))
    done = done | hit | (num + count >= max_new_tokens)

    hist = masked_window_write(hist, g, hist_len, count, k + 1)
    new_last = g.gather(1, (count - 1).clamp(0, k)[:, None].long())[:, 0]
    last_tok = torch.where(count > 0, new_last, last_tok)
    # the forward returned lengths + 1; the pass commits count of its k+1
    cache = dataclasses.replace(cache, lengths=lengths + count)
    return g, count, done, last_tok, cache, hist, hist_len + count


def _spec_history(corpus, corpus_lens, tok0, width):
    """(B, width) int32 draft history: the corpus, then tok0 at each row's
    corpus length."""
    b, t = corpus.shape
    hist = torch.zeros((b, width), dtype=torch.int32, device=corpus.device)
    hist[:, :t] = corpus
    hist.scatter_(1, corpus_lens.long()[:, None], tok0[:, None])
    return hist


def _spec_loop(params, cfg, tok0, cache, corpus, corpus_lens,
               max_new_tokens, eos_ids, draft_k, ngram_n,
               group=None) -> SpecResult:
    """Verify passes until every row is done: the loop shared by
    ``spec_decode`` and ``spec_decode_from_tok``. Gives the tokens of greedy
    decode (up to float reassociation: a pass scores k+1 positions in one
    product, so an exact argmax tie may resolve differently) in fewer
    passes, each committing 1..draft_k+1 tokens."""
    b, t = corpus.shape
    k = draft_k
    dev = tok0.device
    # a verify pass writes k+1 slots past the committed length (the prompt
    # part of spec_cache_len is the caller's; this checks the rest)
    assert cache.max_len >= max_new_tokens + k + 1, \
        "spec cache lacks the draft_k+1 verify slack"
    eos = torch.tensor(tuple(eos_ids), dtype=torch.int32, device=dev)
    cd = resolve_dtype(cfg.decoder.compute_dtype)
    tok0 = tok0.to(torch.int32)
    done = torch.isin(tok0, eos) | (max_new_tokens <= 1)
    buf = max_new_tokens + k + 1
    out = torch.zeros((b, buf), dtype=torch.int32, device=dev)
    out[:, 0] = tok0
    hist = _spec_history(corpus, corpus_lens, tok0, t + buf)
    hist_len = corpus_lens.to(torch.int32) + 1
    num = torch.ones((b,), dtype=torch.int32, device=dev)
    last_tok = tok0
    drafted = torch.zeros((), dtype=torch.int32, device=dev)
    accepted = torch.zeros((), dtype=torch.int32, device=dev)
    steps = 0
    while not bool(done.all()):  # the host's one read a pass
        active = ~done
        g, count, done, last_tok, cache, hist, hist_len = _spec_verify_pass(
            params, cfg, last_tok, done, num, cache, hist, hist_len, k=k,
            ngram_n=ngram_n, eos=eos, max_new_tokens=max_new_tokens, cd=cd,
            group=group)
        out = masked_window_write(out, g, num, count, k + 1)
        drafted = drafted + (active.to(torch.int32) * k).sum()
        accepted = accepted + torch.where(active, count - 1, 0).sum()
        num = num + count
        steps += 1
    keep = torch.arange(buf, device=dev)[None, :] < num[:, None]
    out = torch.where(keep, out, torch.zeros_like(out))
    return SpecResult(tokens=out[:, :max_new_tokens], num_generated=num,
                      steps=steps, drafted=drafted.to(torch.int32),
                      accepted=accepted.to(torch.int32))


def spec_decode(params, cfg, logits, cache, ids, seq_lens, *,
                max_new_tokens: int = 256, eos_ids=(151645,),
                draft_k: int = 8, ngram_n: int = 3,
                group=None) -> SpecResult:
    """Greedy speculative decode after prefill: logits (B, V) are the
    prefill's, cache holds the prompt (max_len >= spec_cache_len(...)), and
    the prompt ids (B, T) are the draft corpus."""
    tok0 = logits.argmax(dim=-1).to(torch.int32)
    return _spec_loop(params, cfg, tok0, cache, ids, seq_lens,
                      max_new_tokens, eos_ids, draft_k, ngram_n, group)


def spec_decode_from_tok(params, cfg, tok0, cache, corpus, corpus_lens, *,
                         max_new_tokens: int = 256, eos_ids=(151645,),
                         draft_k: int = 8, ngram_n: int = 3,
                         group=None) -> SpecResult:
    """Greedy speculative decode for a caller that already has the first
    token (the video path reads it for TTFT); ``corpus`` (B, T) with
    ``corpus_lens`` is the draft corpus (the video path's holds the
    previous frame's answer)."""
    return _spec_loop(params, cfg, tok0, cache, corpus, corpus_lens,
                      max_new_tokens, eos_ids, draft_k, ngram_n, group)


class SpecCarry(NamedTuple):
    """Speculative-decode state carried between dispatches of
    ``spec_stream_chunk``."""
    last_tok: torch.Tensor   # (B,) int32
    done: torch.Tensor       # (B,) bool
    num: torch.Tensor        # (B,) int32 tokens generated so far (incl. tok0)
    cache: Union[KVCache, PagedKVCache]
    hist: torch.Tensor       # (B, W) int32 corpus + generated tokens
    hist_len: torch.Tensor   # (B,) int32


def spec_carry_init(cfg, tok0, cache, corpus, corpus_lens, *,
                    max_new_tokens: int, draft_k: int,
                    eos_ids) -> SpecCarry:
    """The first carry after prefill (tok0 already sampled)."""
    b, t = corpus.shape
    tok0 = tok0.to(torch.int32)
    eos = torch.tensor(tuple(eos_ids), dtype=torch.int32, device=tok0.device)
    return SpecCarry(
        last_tok=tok0, done=torch.isin(tok0, eos) | (max_new_tokens <= 1),
        num=torch.ones((b,), dtype=torch.int32, device=tok0.device),
        cache=cache,
        hist=_spec_history(corpus, corpus_lens, tok0,
                           t + max_new_tokens + draft_k + 1),
        hist_len=corpus_lens.to(torch.int32) + 1)


def spec_stream_chunk(params, cfg, carry: SpecCarry, *, m: int = 4,
                      max_new_tokens: int = 256, eos_ids=(151645,),
                      draft_k: int = 8, ngram_n: int = 3, group=None):
    """``m`` verify passes, no host read: the streaming unit of speculative
    decode (the counterpart of ``decode_chunk``), committing m..m*(k+1)
    tokens a row. Returns (tokens (B, m*(k+1)) zero-padded, counts (B,),
    carry'): tokens and counts of this dispatch only.

    Over a ``PagedKVCache`` this is the scheduler's speculative chunk, on
    the pool in place: each pass writes its k+1 keys at each row's own
    offset through the block tables and attends the pages gathered into
    row order. Caller contract: every row's pages are mapped through
    ``lengths + m*(k+1)`` before the dispatch, so committed positions never
    fall in the sink; rejected draft keys past that bound do. (JAX's
    ``spec_chunk_paged`` instead gathers a dense view, verifies on it and
    writes the view back.)"""
    k = draft_k
    dev = carry.last_tok.device
    eos = torch.tensor(tuple(eos_ids), dtype=torch.int32, device=dev)
    cd = resolve_dtype(cfg.decoder.compute_dtype)
    b = carry.last_tok.shape[0]
    width = m * (k + 1)
    out = torch.zeros((b, width + k + 1), dtype=torch.int32, device=dev)
    off = torch.zeros((b,), dtype=torch.int32, device=dev)
    for _ in range(m):
        g, count, done, last_tok, cache, hist, hist_len = _spec_verify_pass(
            params, cfg, carry.last_tok, carry.done, carry.num, carry.cache,
            carry.hist, carry.hist_len, k=k, ngram_n=ngram_n, eos=eos,
            max_new_tokens=max_new_tokens, cd=cd, group=group)
        out = masked_window_write(out, g, off, count, k + 1)
        carry = SpecCarry(last_tok=last_tok, done=done, num=carry.num + count,
                          cache=cache, hist=hist, hist_len=hist_len)
        off = off + count
    return out[:, :width], off, carry


def generate_spec(params, cfg, images, ids, seq_lens, image_starts, *,
                  max_new_tokens: int = 256, eos_ids=(151645,),
                  draft_k: int = 8, ngram_n: int = 3) -> SpecResult:
    """Whole-generation speculative greedy decode: prefill into a cache of
    ``spec_cache_len``, then ``spec_decode``."""
    b, t = ids.shape
    cache = init_cache(cfg.decoder.num_layers, b,
                       spec_cache_len(t, max_new_tokens, draft_k),
                       cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                       dtype=kv_cache_dtype(cfg), device=ids.device)
    logits, cache = prefill(params, cfg, images, ids, seq_lens, image_starts,
                            cache)
    return spec_decode(params, cfg, logits, cache, ids, seq_lens,
                       max_new_tokens=max_new_tokens, eos_ids=eos_ids,
                       draft_k=draft_k, ngram_n=ngram_n)
