"""Beam search decode over the dense KV cache.

Counterpart of ``fastvlm_tpu/ops/beam.py``, the same algorithm and the same
numbers. Beam width W folds into the batch axis: the cache holds B*W rows,
every step is one ``vlm.decode_step`` over all beams (kernel K2 at batch
B*W on the card), and reordering the beams gathers the cache's batch axis
(``index_select`` into a second buffer, then the two swap; an int8 cache's
scale planes move with its keys and values). The search runs
a FIXED trip count, max_new_tokens - 1 steps after the prefill's, with no
early exit and no host read inside: finished hypotheses are compared with
the live beams normalized at full length, so stopping early would change
the answer. The host reads the result once, at the end.

At each step the top 2W of the W*V continuations are taken; EOS candidates
move to a per-row finished set of size W (score normalized by
length**length_penalty); the best W non-EOS candidates continue. The answer
is the best of {finished} and {live beams normalized at max_new_tokens}.

Tie order: ``lax.top_k`` puts the lower index first among equal values,
which ``torch.topk`` does not promise, so every top-k here is a stable
descending sort and a slice (``_top_k``). Equal scores are common: the
NEG_INF fill of the finished set, and live beams left at NEG_INF when more
than W of the 2W candidates are EOS.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from fastvlm_tpu_torch.config import FastVLMConfig
from fastvlm_tpu_torch.models import vlm
from fastvlm_tpu_torch.ops.kv_cache import KVCache

NEG_INF = -1e30


class BeamResult(NamedTuple):
    tokens: torch.Tensor   # (B, max_new) int32, junk after length
    lengths: torch.Tensor  # (B,) int32 tokens incl. EOS if finished
    scores: torch.Tensor   # (B,) f32 length-normalized log-prob


_ROW_PLANES = ("k", "v", "k_scale", "v_scale")  # batch axis 1; None skipped


def _replicate_cache(cache: KVCache, w: int) -> KVCache:
    """(L, B, S, H, D) -> (L, B*W, S, H, D): row b*W + j is beam j of row b,
    and all start as copies of row b (an int8 cache's scales too)."""
    planes = {n: None if getattr(cache, n) is None
              else getattr(cache, n).repeat_interleave(w, dim=1)
              for n in _ROW_PLANES}
    return KVCache(lengths=cache.lengths.repeat_interleave(w, dim=0),
                   **planes)


def _reorder_cache(cache: KVCache, spare: KVCache,
                   flat: torch.Tensor) -> Tuple[KVCache, KVCache]:
    """Rows ``flat`` of every plane into ``spare``'s buffers: returns (the
    reordered cache, the old one as the next spare)."""
    for n in _ROW_PLANES:
        src = getattr(cache, n)
        if src is not None:
            torch.index_select(src, 1, flat, out=getattr(spare, n))
    out = KVCache(lengths=cache.lengths.index_select(0, flat),
                  **{n: getattr(spare, n) for n in _ROW_PLANES})
    return out, cache


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, the
    lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx, axis=1)`` for (B, N) or (B, N, T) x and
    (B, M) idx."""
    if x.dim() == 3:
        idx = idx[:, :, None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def _norm(score: torch.Tensor, length: int, length_penalty: float):
    """score / length**length_penalty, the power taken in float32."""
    return score / float(np.float32(length) ** np.float32(length_penalty))


def beam_search(
    params: Any,
    cfg: FastVLMConfig,
    prefill_logits: torch.Tensor,  # (B, V) from vlm.prefill
    cache: KVCache,                # B rows, prompt prefilled, lengths set
    *,
    num_beams: int = 4,
    max_new_tokens: int = 64,
    eos_ids: Tuple[int, ...] = (151645,),
    length_penalty: float = 1.0,
    group=None,
) -> BeamResult:
    """The cache must hold each row's prompt plus max_new_tokens - 1 decode
    writes (the engine allocates prompt bucket + max_new_tokens). ``group``:
    a tensor-parallel engine's "model" group (``vlm.decode_step``); each
    rank reorders its own cache's kv heads, on the same parents, since
    every rank holds the same logits."""
    cfg.decoder.require_uniform("beam search")
    b, v = prefill_logits.shape
    w = num_beams
    n2 = min(2 * w, v)
    dev = prefill_logits.device
    eos = torch.tensor(tuple(eos_ids), dtype=torch.int32, device=dev)
    cache = _replicate_cache(cache, w)
    spare = KVCache(lengths=cache.lengths, **{
        n: None if getattr(cache, n) is None
        else torch.empty_like(getattr(cache, n)) for n in _ROW_PLANES})

    # step 0: the first tokens come from the prefill logits (all beams of a
    # row share one prompt, so the candidates are one row's top 2W tokens)
    logp0 = torch.log_softmax(prefill_logits.float(), dim=-1)
    cand_score, cand_tok = _top_k(logp0, n2)                  # (B, 2W)
    cand_tok = cand_tok.to(torch.int32)
    is_eos = torch.isin(cand_tok, eos)
    neg = torch.full_like(cand_score, NEG_INF)

    fin_scores = torch.full((b, w), NEG_INF, device=dev)
    fin_tokens = torch.zeros((b, w, max_new_tokens), dtype=torch.int32,
                             device=dev)
    fin_lens = torch.zeros((b, w), dtype=torch.int32, device=dev)
    cand_fin = torch.where(is_eos, _norm(cand_score, 1, length_penalty), neg)
    fin_scores, sel = _top_k(torch.cat([fin_scores, cand_fin], dim=1), w)
    cand_seq = torch.zeros((b, n2, max_new_tokens), dtype=torch.int32,
                           device=dev)
    cand_seq[:, :, 0] = cand_tok
    fin_tokens = _take(torch.cat([fin_tokens, cand_seq], dim=1), sel)
    fin_lens = _take(torch.cat(
        [fin_lens, torch.ones((b, n2), dtype=torch.int32, device=dev)], dim=1),
        sel)

    live_scores, sel = _top_k(torch.where(is_eos, neg, cand_score), w)
    last_tok = _take(cand_tok, sel)                           # (B, W)
    live_tokens = torch.zeros((b, w, max_new_tokens), dtype=torch.int32,
                              device=dev)
    live_tokens[:, :, 0] = last_tok
    # step-0 parents are all the same (replicated) row: no cache gather

    row0 = torch.arange(b, device=dev)[:, None] * w
    for step in range(1, max_new_tokens):
        logits, cache = vlm.decode_step(params, cfg, last_tok.reshape(b * w),
                                        cache, group)
        logp = torch.log_softmax(logits.float(), dim=-1)
        total = live_scores[:, :, None] + logp.reshape(b, w, v)
        cand_score, idx = _top_k(total.reshape(b, w * v), n2)
        parent = idx // v
        tok = (idx % v).to(torch.int32)
        is_eos = torch.isin(tok, eos)
        length = step + 1  # tokens in each candidate sequence

        # candidate sequences: parent prefix + this token at position `step`
        cand_seq = _take(live_tokens, parent)
        cand_seq[:, :, step] = tok

        # EOS candidates -> finished set (keep the best W by normalized score)
        cand_fin = torch.where(is_eos, _norm(cand_score, length,
                                             length_penalty), neg)
        fin_scores, sel = _top_k(torch.cat([fin_scores, cand_fin], dim=1), w)
        fin_tokens = _take(torch.cat([fin_tokens, cand_seq], dim=1), sel)
        fin_lens = _take(torch.cat(
            [fin_lens, torch.full((b, n2), length, dtype=torch.int32,
                                  device=dev)], dim=1), sel)

        # the best W non-EOS candidates continue
        live_scores, sel = _top_k(torch.where(is_eos, neg, cand_score), w)
        sel_parent = _take(parent, sel)
        last_tok = _take(tok, sel)
        live_tokens = _take(cand_seq, sel)

        # reorder the cache rows to the selected parents (this step's KV
        # write used the pre-selection arrangement, which `parent` indexes)
        flat = (row0 + sel_parent).reshape(-1)
        cache, spare = _reorder_cache(cache, spare, flat)

    # best of finished hypotheses vs live beams normalized at full length
    live_norm = _norm(live_scores, max_new_tokens, length_penalty)
    all_scores = torch.cat([fin_scores, live_norm], dim=1)    # (B, 2W)
    all_tokens = torch.cat([fin_tokens, live_tokens], dim=1)
    all_lens = torch.cat([fin_lens, torch.full(
        (b, w), max_new_tokens, dtype=torch.int32, device=dev)], dim=1)
    best = torch.argmax(all_scores, dim=1)[:, None]
    return BeamResult(tokens=_take(all_tokens, best)[:, 0],
                      lengths=_take(all_lens, best)[:, 0],
                      scores=_take(all_scores, best)[:, 0])
