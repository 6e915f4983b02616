"""Continuous batching over a paged KV pool: the serving scheduler.

Counterpart of ``fastvlm_tpu/serve/batcher.py``, with its names and
behaviour. Concurrent requests share one decode loop, and each request's
tokens stream to its own queue:

  * requests arriving within a gather window (default 15 ms) are grouped,
    padded to a common prompt length and prefilled together into the page
    pool;
  * the decode loop runs k-token chunks (``engine.chunk``) over the whole
    batch; a request's stream closes, and its pages return to the pool, the
    moment ITS row finishes (finish reason "stop", "length", "truncated" or
    "cancelled");
  * at every chunk boundary a queued request is admitted into a free row:
    its prompt prefills straight into pages of the shared pool through a
    1-row ``PagedKVCache`` view, the batch grows (batch sizes {1, 2, 4, 8})
    when every row is live, and shrinks after two under-occupied boundaries;
  * per-row sampling (``ops.sampling.RowSampling``): greedy and sampled
    requests share one batch.

  * prefix caching (``PrefixCache``): full pages of prompt KV before the
    first image slot are registered by their token ids; an admission or a
    gathered batch whose prompts extend a cached prefix maps those pages
    read-only and prefills only the suffix (``vlm.prefill_continue``
    through ``Engine.prefill_suffix``);
  * chunked admission prefill: an admission whose suffix is longer than
    ``prefill_chunk`` tokens, while other rows are live, reserves its slot
    and pages and prefills one chunk per boundary (``advance_pending``),
    the image span always in one chunk, so the live rows keep decoding.

Both are on by default from 1e9 decoder parameters (1.5B and up:
``prefix_cache=None`` and ``prefill_chunk=None`` resolve as in the JAX
scheduler), off below.

  * speculative chunks (``spec=True``, greedy batches): while at most
    ``spec_max_rows`` rows are live (default 1) and none is mid-prefill, a
    chunk is ceil(chunk / (k+1)) prompt-lookup verify passes
    (``vlm.spec_stream_chunk``) instead of k plain steps. A mode-rate
    tuner keeps it only while its measured committed tok/s at that row
    count beats plain chunks' (re-probing every ``spec_reprobe_every``
    skipped chunks), and a low acceptance EMA bans it for the rest of the
    batch. Admissions, activations and resizes drop the device state;
    it is rebuilt from the host's prompts and texts when spec is next
    wanted.

Decode of a pool batch, in one of the JAX scheduler's modes:

  * in place (the port's default; JAX's ``chunk_view=False,
    persist_view=False``): every chunk is one ``vlm.decode_chunk`` over the
    ``PagedKVCache``, whose T=1 steps run kernel K3
    (``ops/cuda/paged_decode_attention.py``) on the pool: one launch a
    layer a step;
  * ``chunk_view=True``: ``vlm.decode_chunk_paged`` gathers each row's
    first s_bucket positions (the longest row + k, in 512-token buckets)
    into a dense view, runs the chunk's steps on it (kernel K2) and writes
    each row's k new columns back;
  * ``persist_view=True``: a dense view (``vlm.gather_view``) is carried
    across chunks and decoded on (K2); the pool catches up only at a
    boundary that reads it (``flush_view``: ``vlm.sync_pool_from_view``
    before an admission, a chunked admission's activation, a resize, a
    spec chunk, a regather), an admitted row is spliced in alone
    (``vlm.update_view_row``), and the view is regathered when it is too
    narrow or its batch changed. ``pipeline_depth`` > 1 dispatches that
    many chunks back to back, the host read once, while no request waits,
    no spec chunk or prefill is live and no row is within a chunk of its
    cap. Counters "view_gathers", "view_row_updates", "view_syncs",
    "pipelined_groups", "view_dropped_stale"; tuner shape keys ("persist",
    b, view width, k) and ("plain", b, s_bucket, k), ("plain", b, k) in
    place.

The JAX scheduler defaults to the persistent view, pipelined 2 deep: its
views exist because XLA cannot fuse the page gather into attention. The
port reads the pages where they lie (K3), and keeps that as its default.

  * requests that cannot join a batch (an anyres PIL image or several
    images: their token counts are ragged) are served one at a time
    through ``engine.stream`` (the serial path; its updates are the
    engine's, without a finish reason, as in the JAX scheduler), each
    checked for cancellation at every update. A gathered batch holding one
    is served wholly so; at a chunk boundary one is deferred
    (``_deferred``), and ``_gather`` serves it first once the batch ends;
  * ``fairness_s`` (default 2 s): once the oldest deferred request has
    waited that long, admission stops for the rest of the batch (counter
    "drained_for_fairness", ``trace`` "drain"), so a steady stream of
    batchable requests cannot starve it;
  * ``continuous=False``: window batching, the JAX benchmark's baseline. A
    gathered batch runs to its end with no admission; later requests wait
    for the next gather.

The dense per-batch path (``paged=False``, any engine whose KV cache is
int8: the pool has no int8 layout, as in JAX; and, as in JAX, a gathered
batch whose prompts the pool cannot hold, with a warning and the counter
"dense_fallbacks"): the batch prefills into a dense cache of its own
(``engine.new_cache``, in the engine's ``_kv_dtype``) and decodes k-token
chunks (kernel K2) to its end, as the JAX scheduler does with ``tables is
None``: no admission, shrink, prefix cache, chunked admission or
speculative chunks; ``warmup()`` does nothing with ``paged=False``.
``warmup()`` runs one dummy dispatch of each kind (its docstring), where
the JAX one compiles every (batch, view width) program.

Where the port differs without changing an output:
  * the device sees the block tables cut to the page watermark (the widest
    row's mapped pages); the JAX tables span the pool, a width XLA compiles
    against. K3's grid then follows the pages in flight, not the pool;
  * prompts, suffixes and admission chunks pad to the engine's bucket (64
    tokens), not to 256, and an admission's 1-row view maps only its
    prompt's pages (the JAX widths are canonical so that ``warmup()`` can
    compile them all; eager torch compiles nothing);
  * a request whose ``prepare`` fails, or whose serial stream raises, is
    failed alone, where the JAX scheduler fails the gathered batch;
  * speculative chunks verify on the pool in place, in every mode (the
    persistent view is synced and dropped first, as in JAX): each pass
    writes its k+1 keys at each row's own offset through the block tables
    and attends the pages gathered into row order, with the rows' pages
    mapped through ``cur_len + m*(k+1)`` first, so committed keys never
    fall in the sink (rejected drafts past that bound may). The JAX
    ``spec_chunk_paged`` gathers a dense view (``s_bucket``) once a chunk
    and writes it back, and runs only with ``chunk_view``. The tuner's
    shape keys drop that bucket; the spec state marks free slots done, so
    a row the host closed commits nothing on the device;
  * ``counters`` add "prefills" (prefill dispatches, each admission chunk
    one), "image_prefills" (those that encode images), "chunks" and
    "decode_steps" (k a chunk; plain chunks only), "dense_fallbacks";
    ``trace`` "disp" events carry (batch, live rows, steps dispatched, ms
    from dispatch to the host read, rows mid-prefill), "spec" events
    (batch, live rows, passes, ms, tokens committed); update
    stats add "cached_tokens" (prefix tokens the request reused) and
    "prefill_chunks" (its admission chunks, 0 when single-shot).

Threads: ``submit()`` from any thread; one scheduler thread runs the loop
under its own ``torch.inference_mode()`` (the mode is per thread) and reads
tokens back once per chunk.

Over a tensor-parallel engine (``Engine(mesh=)``) the scheduler runs on
rank 0 alone: its pool, tables and page accounting are host state there,
and every device call (the pool's and a dense batch's constructors, the
prefills, decode and spec chunks, the views' gathers, syncs and row
updates, ``warmup``'s) goes through ``engine.call``, which the other ranks
follow with their own kv heads (a gathered view's planes are rank-local:
they cross by handle).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from fastvlm_tpu_torch.models import vlm
from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import PAGE_SIZES
from fastvlm_tpu_torch.ops.kv_cache import PagedKVCache
from fastvlm_tpu_torch.ops.sampling import (
    RowSampling, SamplingParams, sample, sample_rows)
from fastvlm_tpu_torch.ops.splice import pad_batch

logger = logging.getLogger(__name__)

_SENTINEL = object()


@dataclasses.dataclass
class _Request:
    prompt: str
    image: Any
    max_new_tokens: int
    sampling: SamplingParams
    out: "queue.Queue"
    stop_strings: Tuple[str, ...] = ()
    t_submit: float = dataclasses.field(default_factory=time.perf_counter)
    # client-side cancellation: once set, the scheduler aborts the row at
    # the next chunk boundary and releases its pages and slot
    cancel: Optional[threading.Event] = None
    # prefix tokens reused from the registry, and admission chunks run
    # (0: prefilled in one dispatch); set by the scheduler thread
    cached_tokens: int = 0
    prefill_chunks: int = 0

    @property
    def cancelled(self) -> bool:
        return self.cancel is not None and self.cancel.is_set()


def _decoder_param_count(dec) -> int:
    """Rough decoder parameter count from the config, for the scale-aware
    defaults (only the 0.5B vs 1.5B-and-up split matters)."""
    h, n_layers = dec.hidden_size, dec.num_layers
    qh = dec.num_heads * dec.head_dim
    kvh = dec.num_kv_heads * dec.head_dim
    per_layer = h * qh + 2 * h * kvh + qh * h + 3 * h * dec.intermediate_size
    embed = dec.vocab_size * h * (1 if dec.tie_word_embeddings else 2)
    return n_layers * per_layer + embed


def _round_batch(n: int, caps=(1, 2, 4, 8)) -> int:
    for c in caps:
        if n <= c:
            return c
    return caps[-1]


def _round_bucket(n: int, page: int, step: int = 512) -> int:
    """A view's width: ``n`` rounded up to the 512-token bucket step and to
    whole pages (the JAX scheduler's view buckets)."""
    b = -(-n // step) * step
    return -(-b // page) * page


def _prefill_chunk_bounds(lo: int, hi: int, w: int,
                          img_s: int, img_e: int) -> List[int]:
    """Chunk boundaries [lo, ..., hi] of a chunked admission prefill: every
    ``w`` tokens, but never strictly inside the image span [img_s, img_e),
    which the vision embeddings overlay as one block, so one chunk covers
    it. That chunk is exactly [img_s, min(img_e, hi)): a boundary is forced
    at img_s even where the running chunk could take the whole span.
    img_s < 0: no image (text-only requests still carry sentinel slots,
    which may split freely)."""
    bounds = [lo]
    p = lo
    while p < hi:
        n = min(p + w, hi)
        if 0 <= img_s < img_e:
            if p < img_s < n:
                n = img_s          # a boundary at the span's start
            elif p == img_s:
                n = min(img_e, hi)  # the image chunk
        bounds.append(n)
        p = n
    return bounds


class PagePool:
    """Host-side free list over the device KV page pool.

    The device tensors (``ops/kv_cache.PagedKVCache`` pools) never move;
    this tracks which pool pages are mapped into some row's block table.
    Pages are allocated as sequences grow and returned the moment a request
    finishes, so the memory the cache holds is bounded by tokens in flight.
    Refcounted: a page returns to the free list when its last reference
    releases (``share`` takes an extra one)."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages))
        self.min_free = num_pages  # low-water mark (observability/tests)
        self._ref: Dict[int, int] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        if n <= 0:
            # guard: self._free[-0:] would alias the WHOLE free list
            return []
        if n > len(self._free):
            return None
        out = self._free[-n:]
        del self._free[-n:]
        for p in out:
            self._ref[p] = 1
        self.min_free = min(self.min_free, len(self._free))
        return out

    def share(self, pages: List[int]) -> None:
        """Take an extra reference on already-mapped pages."""
        for p in pages:
            self._ref[p] += 1

    def release(self, pages: List[int]) -> None:
        for p in pages:
            r = self._ref[p] - 1
            if r:
                self._ref[p] = r
            else:
                del self._ref[p]
                self._free.append(p)


class PrefixCache:
    """Page-aligned prompt-prefix reuse over the shared page pool.

    A full page of prompt KV never changes once written (a row writes only
    at positions >= its prompt length, and a suffix prefill starts at the
    cached boundary), so rows whose prompts share a token prefix can map
    the same pool pages read-only. Entries are keyed by the exact token ids
    of each full-page prefix; a hit maps its pages into the new row's table
    and only the suffix is prefilled. Causal attention and absolute RoPE
    positions make the reuse exact: the prefix's KV depends only on the
    ids before it. Image prompts take part up to their first image slot
    (image KV depends on pixels, not ids).

    The registry holds one pool reference per entry page; when the pool
    cannot satisfy an allocation, least recently used entries go first."""

    def __init__(self, pool: PagePool, page_size: int,
                 max_entries: int = 256):
        self.pool = pool
        self.page = page_size
        self.max_entries = max_entries
        self.entries: "collections.OrderedDict[bytes, List[int]]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(ids, n: int) -> bytes:
        return np.asarray(ids[:n], np.int32).tobytes()

    def peek(self, ids) -> int:
        """Length of the longest cached full-page prefix of ``ids``, taking
        no references (a gathered batch plans one offset for all rows
        before mapping any)."""
        for j in range(len(ids) // self.page, 0, -1):
            if self._key(ids, j * self.page) in self.entries:
                return j * self.page
        return 0

    def lookup(self, ids) -> Tuple[int, List[int]]:
        """Longest cached full-page prefix of ``ids`` -> (cached_len,
        pages), with one pool reference a page taken FOR THE CALLER (the
        row releases them like its own pages); (0, []) on a miss."""
        for j in range(len(ids) // self.page, 0, -1):
            key = self._key(ids, j * self.page)
            pages = self.entries.get(key)
            if pages is not None:
                self.entries.move_to_end(key)
                self.pool.share(pages)
                self.hits += 1
                return j * self.page, list(pages)
        self.misses += 1
        return 0, []

    def publish(self, ids, pages: List[int]) -> None:
        """Register every full-page prefix of ``ids``, whose KV lies in
        ``pages`` (one a page, in order). A new entry takes pool references
        on its pages; an existing one is left alone (its pages hold the
        same KV)."""
        n_full = min(len(ids) // self.page, len(pages))
        for j in range(1, n_full + 1):
            key = self._key(ids, j * self.page)
            if key in self.entries:
                self.entries.move_to_end(key)
                continue
            entry = list(pages[:j])
            self.pool.share(entry)
            self.entries[key] = entry
        while len(self.entries) > self.max_entries:
            _, old = self.entries.popitem(last=False)
            self.pool.release(old)

    def evict_for(self, n: int) -> bool:
        """Drop least recently used entries until the pool could satisfy
        an ``n``-page allocation. True if it can."""
        while self.pool.free_pages < n and self.entries:
            _, pages = self.entries.popitem(last=False)
            self.pool.release(pages)
        return self.pool.free_pages >= n

    def clear(self) -> None:
        for pages in self.entries.values():
            self.pool.release(pages)
        self.entries.clear()


class BatchScheduler:
    """Wraps an Engine; submit() returns an iterator of cumulative-text
    updates like Engine.stream's, each with its stats and finish reason."""

    def __init__(self, engine, *, max_batch: int = 8, window_ms: float = 15.0,
                 paged: bool = True, page_size: int = 64,
                 pool_tokens: int = 16384,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None, max_pending: int = 2,
                 spec: bool = False, spec_draft_k: int = 8,
                 spec_ngram_n: int = 3, spec_max_rows: int = 1,
                 spec_min_accept: float = 0.1, continuous: bool = True,
                 fairness_s: float = 2.0, chunk_view: Optional[bool] = None,
                 persist_view: bool = False, pipeline_depth: int = 1):
        """``prefix_cache`` / ``prefill_chunk``: None picks the JAX
        scheduler's scale-aware default, on (256-token chunks) from 1e9
        decoder parameters and off below; False / 0 turns one off.
        ``max_pending`` bounds the rows mid-prefill (their pages are held
        but produce no tokens yet). ``spec``: speculative chunks for greedy
        batches (module docstring), with ``spec_draft_k`` draft tokens from
        ``spec_ngram_n``-grams, at most ``spec_max_rows`` live rows, banned
        for the batch below an acceptance EMA of ``spec_min_accept``.
        ``continuous=False``: window batching, no admission into a running
        batch. ``fairness_s``: how long the oldest deferred request may wait
        before admission stops and the batch drains (module docstring).
        ``paged=False``, or an int8-KV engine: the dense per-batch path
        (module docstring).

        The decode of a pool batch, with JAX's meanings (module docstring):
        ``chunk_view`` gathers a dense view of the pool each chunk;
        ``persist_view`` keeps one across chunks and syncs the pool at
        boundaries (JAX's persist_view needs chunk_view, its default;
        here ``chunk_view=None`` follows ``persist_view``, and an explicit
        ``chunk_view=False`` turns the persistent view off, as in JAX);
        ``pipeline_depth``: under the persistent view, up to that many
        chunks dispatched back to back, the host read once, while nothing
        waits. The JAX scheduler defaults to chunk view, persistent view
        and depth 2. The port defaults to neither view and depth 1: the
        pool in place with kernel K3, the path its measurements stand on.
        No workload measured on the H100 so far favours a view (chip_smoke's
        phase serve-view: each mode's served rate within the runs' spread,
        and more device time a step with a view). Switching the default,
        and dropping the modes that lose, is a performance decision, to be
        made on a benchmark cell."""
        if paged and getattr(engine, "_kv_dtype", None) == torch.int8:
            # the pool has no int8 layout: the dense int8 cache serves
            logger.info("kv_cache_dtype=int8: paged pool disabled (dense "
                        "int8 cache serves instead)")
            paged = False
        if paged and engine.device.type == "cuda" \
                and page_size not in PAGE_SIZES:
            raise ValueError(f"page_size {page_size} not in {PAGE_SIZES}, the "
                             f"sizes kernel K3 takes")
        self.engine = engine
        self.paged = paged
        if chunk_view is None:
            chunk_view = persist_view
        self.chunk_view = chunk_view
        self.persist_view = persist_view and chunk_view
        self.pipeline_depth = (max(1, pipeline_depth) if self.persist_view
                               else 1)
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.continuous = continuous
        self.fairness_s = fairness_s
        self.page_size = page_size
        self.pool = PagePool(max(1, pool_tokens // page_size)) if paged \
            else None
        # a suffix prefill skips the prefix's compute, which pays for the
        # host bookkeeping only where prefill is expensive: 1.5B and up
        large = _decoder_param_count(engine.cfg.decoder) >= 1e9
        if prefix_cache is None:
            prefix_cache = large
        self.prefix = PrefixCache(self.pool, page_size) \
            if paged and prefix_cache else None
        if prefill_chunk is None:
            prefill_chunk = 256 if large else 0
        self.prefill_chunk = int(prefill_chunk or 0)
        self.max_pending = max(1, max_pending)
        # speculation amortises a step's launches over up to k+1 tokens,
        # which a batch already amortises over its rows: a latency tool for
        # near-empty batches, and kept only while it measures faster
        self.spec = spec
        self.spec_draft_k = spec_draft_k
        self.spec_ngram_n = spec_ngram_n
        self.spec_max_rows = spec_max_rows
        self.spec_min_accept = spec_min_accept
        self.spec_reprobe_every = 64
        self._mode_rate: Dict[Tuple[str, int], float] = {}  # tok/s EMA
        self._spec_skips = 0
        self._warm_shapes: set = set()
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = False
        self._pool_kv = None  # lazy (k_pages, v_pages) device tensors
        # continuous-batching events (admitted / grown / shrunk / truncated
        # / cancelled / prefills / chunks / decode_steps ...)
        self.counters = collections.Counter()
        # opt-in event timeline (set to a list): (t, event, *detail)
        self.trace: Optional[list] = None
        # requests an admission scan popped but could not place (batch at
        # capacity, pool full): served first by the next admission or
        # _gather. Touched only by the scheduler thread.
        self._deferred: List[_Request] = []
        self._gen = torch.Generator(device=engine.device)
        self._gen.manual_seed(time.time_ns() % 2**31)
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def warmup(self, prompt_len: int = 64, max_new_tokens: int = 256,
               sampling: Optional[SamplingParams] = None,
               admission_prefill: bool = True, images: bool = True) -> int:
        """Run one dummy dispatch of each kind a workload with prompts up to
        ``prompt_len`` tokens and ``max_new_tokens`` generation meets, so no
        live request pays a first use: on the card, the kernels' nvcc builds
        and loads (K3 in the decode chunks, K1 in an image prefill, K2 in
        the serial path's step), cuBLAS's set-up and the allocator's growth.
        Call it before the first ``submit``.

        * at each batch bucket {1, 2, 4, 8} up to ``max_batch``: the decode
          dispatch of the scheduler's mode, in place one chunk; with a view,
          one at each of JAX's view buckets (512-token steps from the
          prompt bucket + k to prompt + cap): the chunk view's
          ``decode_chunk_paged``, or the persistent view's set (a gather, a
          chunk on the view, a sync, a row update); and a speculative chunk
          at each bucket up to ``spec_max_rows`` when ``spec`` is on and
          ``sampling`` is greedy;
        * ``admission_prefill``: a 1-row text prefill at the prompt bucket
          into the pool, with ``images`` an image prefill too when the
          bucket holds the image's tokens, and one decode step of the
          serial path on a dense 1-row cache.

        Every block-table entry is -1, so the writes land in the sink page
        and the pool is never mapped; the pool, the counters and the
        scheduler's generator are left as they were. Returns the number of
        dummy dispatches: 0 on the dense path, as in JAX."""
        if not self.paged:
            return 0
        engine = self.engine
        cfg, dev = engine.cfg, engine.device
        sampling = sampling or SamplingParams()
        k = engine.chunk
        spec_on = self.spec and sampling.temperature <= 0.0
        spec_k = self.spec_draft_k
        spec_m = max(1, -(-k // (spec_k + 1)))
        spec_slack = spec_m * (spec_k + 1) + spec_k + 1 if spec_on else 0
        # the engine pads a prompt (plus its first token) to its bucket
        pad_to = -(-(max(prompt_len, 1) + 1) // engine.bucket) * engine.bucket
        pps = min(self.pool.num_pages, -(-(pad_to + max_new_tokens
                                          + spec_slack) // self.page_size))
        if self._pool_kv is None:
            c0 = engine.new_pool(self.pool.num_pages, self.page_size)
            self._pool_kv = (c0.k_pages, c0.v_pages)
        hw = self._hist_width(pad_to + max_new_tokens + spec_slack)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        # JAX's view buckets (in place: one dispatch a batch bucket)
        page, cap = self.page_size, self.pool.num_pages * self.page_size
        buckets = [0]
        if self.chunk_view:
            lo = _round_bucket(pad_to + k, page)
            hi = _round_bucket(pad_to + max_new_tokens + spec_slack, page)
            buckets = sorted({min(cap, x) for x in range(lo, hi + 512, 512)})

        def blank(nb, width):
            return PagedKVCache(
                k_pages=self._pool_kv[0], v_pages=self._pool_kv[1],
                block_tables=torch.full((nb, width), -1, dtype=torch.int32,
                                        device=dev),
                lengths=torch.zeros((nb,), dtype=torch.int32, device=dev))

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        n = 0
        with torch.inference_mode():
            for nb in (c for c in (1, 2, 4, 8) if c <= self.max_batch):
                rs = RowSampling.build([sampling] * nb, nb, dev)
                tok, done = zeros(nb), zeros(nb, dtype=torch.bool)
                for sb in buckets:
                    if self.persist_view:
                        vb = min(cap, _round_bucket(sb + k, page))
                        if ("persist", nb, vb, k) in self._warm_shapes:
                            continue  # two buckets capped at the pool
                        view = engine.call("gather_view",
                                           blank(nb, vb // page), vb)
                        _, _, _, view = engine.call(
                            "decode_chunk", tok, done, view, gen, k=k,
                            eos_ids=engine.eos_ids, row_sampling=rs)
                        cache = engine.call(
                            "sync_pool_from_view", view,
                            blank(nb, vb // page), zeros(nb),
                            w=min(8 * k, vb))
                        engine.call("update_view_row", view, cache, 0)
                        self._warm_shapes.add(("persist", nb, vb, k))
                    elif self.chunk_view:
                        engine.call(
                            "decode_chunk_paged", tok, done,
                            blank(nb, sb // page), gen, k=k, s_bucket=sb,
                            eos_ids=engine.eos_ids, row_sampling=rs)
                        self._warm_shapes.add(("plain", nb, sb, k))
                    else:
                        engine.call(
                            "decode_chunk", tok, done, blank(nb, pps), gen,
                            k=k, eos_ids=engine.eos_ids, row_sampling=rs)
                        self._warm_shapes.add(("plain", nb, k))
                    n += 1
                if spec_on and nb <= _round_batch(self.spec_max_rows):
                    carry = vlm.SpecCarry(
                        last_tok=zeros(nb), done=zeros(nb, dtype=torch.bool),
                        num=zeros(nb) + 1, cache=blank(nb, pps),
                        hist=zeros(nb, hw), hist_len=zeros(nb) + 1)
                    engine.call(
                        "spec_stream_chunk", carry, m=spec_m,
                        max_new_tokens=pps * self.page_size,
                        eos_ids=engine.eos_ids, draft_k=spec_k,
                        ngram_n=self.spec_ngram_n)
                    self._warm_shapes.add(("spec", nb, spec_m, hw))
                    n += 1
            if admission_prefill:
                width = -(-pad_to // self.page_size)
                s = cfg.vision.image_size
                kinds = [(None, -1)]
                if images and pad_to >= cfg.num_image_tokens:
                    kinds.append((zeros(1, s, s, 3, dtype=engine._dtype), 0))
                for image, start in kinds:
                    engine.call("prefill", image, zeros(1, pad_to),
                                torch.tensor([pad_to], dtype=torch.int32,
                                             device=dev),
                                torch.tensor([start], dtype=torch.int32,
                                             device=dev),
                                blank(1, width))
                    n += 1
                dense = engine.new_cache(1, pad_to + k, engine._dtype)
                engine.call("decode_step", zeros(1), dense)
                n += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return n

    # ------------- speculative auto-tuner -------------

    def _spec_preferred(self, n: int) -> bool:
        """Cross-batch decision: run verify passes only while their measured
        committed tok/s at ``n`` live rows beats plain chunks' (both EMAs,
        first dispatches at a shape excluded). Unknown spec rate: probe
        spec; unknown plain rate: run plain to learn it; a losing spec
        re-probes every ``spec_reprobe_every`` skipped chunks."""
        rs = self._mode_rate.get(("spec", n))
        rp = self._mode_rate.get(("plain", n))
        if rs is None:
            return True
        if rp is None:
            return False
        if rs >= rp:
            return True
        self._spec_skips += 1
        if self._spec_skips >= self.spec_reprobe_every:
            self._spec_skips = 0
            self.counters["spec_reprobe"] += 1
            return True
        self.counters["spec_rate_skips"] += 1
        return False

    def _note_rate(self, shape_key, act_n: int, committed: int,
                   dt: float) -> None:
        """Update the (mode, live rows) committed tok/s EMA of a decode
        dispatch. The first dispatch at a shape only marks it seen (its
        library set-up on the card). A plain chunk's ``committed`` is its
        k x rows capacity: spec must beat what plain could deliver."""
        mode = "spec" if shape_key[0] == "spec" else "plain"
        self.counters[f"disp_{mode}@{act_n}"] += 1
        self.counters[f"ms_{mode}@{act_n}"] += int(dt * 1000)
        if shape_key not in self._warm_shapes:
            self._warm_shapes.add(shape_key)
            return
        rate = committed / max(dt, 1e-6)
        prev = self._mode_rate.get((mode, act_n))
        self._mode_rate[(mode, act_n)] = (
            rate if prev is None else 0.5 * prev + 0.5 * rate)

    def _hist_width(self, budget_max: int) -> int:
        """Draft-history width of a batch whose largest row budget (prompt +
        cap + spec slack) is ``budget_max``: rounded up to 512, at most the
        pool's tokens, plus the draft slack."""
        w = -(-max(budget_max, 1) // 512) * 512
        return (min(w, self.pool.num_pages * self.page_size)
                + self.spec_draft_k + 1)

    # ------------- client side -------------

    def submit(self, prompt: str, image=None, *, max_new_tokens: int = 256,
               sampling: Optional[SamplingParams] = None,
               stop_strings: Tuple[str, ...] = (),
               cancel: Optional[threading.Event] = None) -> Iterator[dict]:
        """``cancel``: set it (from any thread) to abort the request — the
        scheduler closes its stream, frees its pages and batch slot at the
        next chunk boundary (finish_reason "cancelled")."""
        req = _Request(prompt, image, max_new_tokens,
                       sampling or SamplingParams(), queue.Queue(),
                       tuple(stop_strings), cancel=cancel)
        self.queue.put(req)
        while True:
            item = req.out.get()
            if item is _SENTINEL:
                return
            yield item

    def shutdown(self):
        self._stop = True
        if self.thread is not threading.current_thread():
            self.thread.join(timeout=30)

    # ------------- scheduler side -------------

    def _gather(self) -> List[_Request]:
        if self._deferred:
            first = self._deferred.pop(0)
        else:
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                return []
        batch = [first]
        for r in list(self._deferred):
            if len(batch) >= self.max_batch:
                break
            batch.append(r)
            self._deferred.remove(r)
        deadline = time.perf_counter() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        # inference mode is per thread: the scheduler thread enters its own
        with torch.inference_mode():
            while not self._stop:
                batch = self._gather()
                if not batch:
                    continue
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "batch_start",
                                       len(batch)))
                try:
                    self._run_batch(batch)
                except Exception as e:  # surface errors to every waiter
                    logger.exception("batch failed")
                    for r in batch:
                        r.out.put({"error": str(e)})
                        r.out.put(_SENTINEL)
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "batch_end"))

    def _batchable(self, r: _Request) -> bool:
        """Requests the batched decode loop can serve: not an anyres PIL
        merge, not several images (ragged token counts, served serially)."""
        cfg = self.engine.cfg
        anyres = (cfg.image_aspect_ratio == "anyres"
                  and cfg.image_grid_pinpoints
                  and hasattr(r.image, "convert"))
        multi = isinstance(r.image, (list, tuple)) and len(r.image) > 1
        return not (anyres or multi)

    def _serve_serial(self, r: _Request) -> None:
        """One request through ``engine.stream``; the stream stops at the
        first update after the client cancels, and a failure fails this
        request alone."""
        stream = self.engine.stream(
            r.prompt, r.image, max_new_tokens=r.max_new_tokens,
            sampling=r.sampling, stop_strings=r.stop_strings)
        try:
            for update in stream:
                if r.cancelled:
                    self.counters["cancelled"] += 1
                    break
                r.out.put(update)
        except Exception as e:  # a bad request must not fail the others
            logger.exception("serial request failed")
            r.out.put({"error": str(e)})
        finally:
            stream.close()
            r.out.put(_SENTINEL)

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """pool.alloc with prefix-cache eviction: pages the registry pins
        are a cache, not a reservation; live rows win."""
        got = self.pool.alloc(n)
        if got is None and self.prefix is not None \
                and self.prefix.evict_for(n):
            self.counters["prefix_evicted_for_rows"] += 1
            got = self.pool.alloc(n)
        return got

    def _device_tables(self, tables: np.ndarray,
                       row_pages: List[List[int]]) -> torch.Tensor:
        """The block tables the device sees: the host tables (which span the
        pool) cut to the widest row's mapped pages. Every mapped entry lies
        in that prefix; positions past it drop like unmapped ones."""
        w = max([len(p) for p in row_pages] + [1])
        return torch.from_numpy(np.ascontiguousarray(tables[:, :w])).to(
            self.engine.device)

    def _map_prompts(self, ready) -> Optional[List[List[int]]]:
        """Map every prompt's pages, in arrival order: their pages, or None
        when the pool cannot hold them all (whatever was mapped goes back),
        and the batch then runs on a dense cache of its own, as in JAX."""
        row_pages = []
        for _, p in ready:
            got = self._alloc_pages(-(-int(p["prompt_tokens"])
                                      // self.page_size))
            if got is None:
                for pgs in row_pages:
                    self.pool.release(pgs)
                logger.warning("page pool (%d pages) can't hold batch "
                               "prompts; dense fallback", self.pool.num_pages)
                self.counters["dense_fallbacks"] += 1
                return None
            row_pages.append(got)
        return row_pages

    def _batch_cache(self, b, row_pages):
        """(cache, tables) of a new batch over the shared pool: row i maps
        ``row_pages[i]``. Pad rows keep an all-(-1) table: their cache
        writes drop into the sink page."""
        engine = self.engine
        if self._pool_kv is None:
            c0 = engine.new_pool(self.pool.num_pages, self.page_size)
            self._pool_kv = (c0.k_pages, c0.v_pages)
        tables = np.full((b, self.pool.num_pages), -1, np.int32)
        for i, pgs in enumerate(row_pages):
            tables[i, :len(pgs)] = pgs
        cache = PagedKVCache(
            k_pages=self._pool_kv[0], v_pages=self._pool_kv[1],
            block_tables=self._device_tables(tables, row_pages),
            lengths=torch.zeros((b,), dtype=torch.int32, device=engine.device))
        return cache, tables

    def _grow_pages(self, cache, tables, row_pages, cur_len, finished, slots,
                    k, reasons, force=False, budget=None, pending=()):
        """Chunk-boundary page accounting: free straggler pages of finished
        rows, map pages covering the next k tokens of each active row
        (``cur_len[i]`` = row i's current device length). Exhaustion
        truncates the row (finishes it, reason "truncated") rather than
        stalling the batch. ``force`` pushes the host tables to the device
        even with no new mappings (a just-closed row zeroed its table so its
        later writes drop instead of landing in pages the pool may
        re-issue). ``pending``: rows mid-prefill, which hold their prompt's
        pages already and whose table row stays -1 until activation."""
        page = self.page_size
        pps = tables.shape[1]
        changed = force
        for i in range(len(finished)):
            if i in pending:
                continue
            if finished[i] or slots[i] is None:
                if row_pages[i]:
                    self.pool.release(row_pages[i])
                    row_pages[i] = []
                    tables[i, :] = -1
                    changed = True
                continue
            # device lengths advance k per chunk for every row; budget[i]
            # (prompt + cap) bounds the pages a row can ever NEED — full-width
            # chunks overshoot small caps, and those writes drop unmapped
            target = min(cur_len[i] + k, pps * page)
            if budget is not None:
                target = min(target, budget[i])
            need = -(-max(target, 1) // page)
            delta = need - len(row_pages[i])
            if delta <= 0:
                continue
            got = self._alloc_pages(delta)
            if got is None:
                logger.warning(
                    "page pool exhausted (%d rows in flight); truncating row %d",
                    sum(sl is not None and not f
                        for sl, f in zip(slots, finished)), i)
                finished[i] = True
                reasons[i] = "truncated"
                self.counters["truncated"] += 1
                self.pool.release(row_pages[i])
                row_pages[i] = []
                tables[i, :] = -1
                changed = True
                continue
            tables[i, len(row_pages[i]):need] = got
            row_pages[i].extend(got)
            changed = True
        if changed:
            cache = dataclasses.replace(
                cache, block_tables=self._device_tables(tables, row_pages))
        return cache

    def _count_prefill(self, encodes_images: bool) -> None:
        self.counters["prefills"] += 1
        if encodes_images:
            self.counters["image_prefills"] += 1

    def _prefill_suffix(self, images, ids_row, start: int, c0: int, c1: int,
                        view):
        """Prefill prompt tokens [c0, c1) of a 1-row pool view after c0
        tokens already there (a prefix-cache hit's suffix, or one admission
        chunk), padded to the engine's bucket. The image goes in only when
        [c0, c1) covers its start. Returns (logits, view)."""
        engine = self.engine
        dev = engine.device
        w = c1 - c0
        sids = np.zeros((1, -(-w // engine.bucket) * engine.bucket), np.int32)
        sids[0, :w] = ids_row[c0:c1]
        has_img = images is not None and c0 <= start < c1
        logits, view = engine.prefill_suffix(
            images if has_img else None, torch.from_numpy(sids).to(dev),
            torch.tensor([w], dtype=torch.int32, device=dev),
            torch.tensor([start - c0 if has_img else -1], dtype=torch.int32,
                         device=dev), c0, view)
        self._count_prefill(has_img)
        return logits, view

    def _reuse_batch_prefix(self, rows, starts_l, n_real, row_pages,
                            tables) -> int:
        """Batch-level prefix reuse: where EVERY gathered row extends one
        cached prefix (a burst of prompts sharing a template), map its pages
        into every row in place of the row's own first pages. One offset
        serves the batch, the longest prefix common to all rows, each row
        bounded by its first image slot and its last prompt token (whose
        logits give the first token). Returns that offset, 0 for none."""
        if self.prefix is None:
            return 0
        bounds = [min(starts_l[i] if starts_l[i] >= 0 else len(rows[i]),
                      len(rows[i]) - 1) for i in range(n_real)]
        # peek(ids[:bound]) is page-aligned and <= bound: the min is a valid
        # common offset for every row
        cached = min(self.prefix.peek(rows[i][:max(bounds[i], 0)])
                     for i in range(n_real))
        if not cached:
            return 0
        n_shared = cached // self.page_size
        taken = []
        for i in range(n_real):
            ln, shared = self.prefix.lookup(rows[i][:cached])
            # the exact entry may be gone while a longer one stays (the LRU
            # bound evicts each prefix length apart): no common offset
            if ln != cached:
                self.pool.release(shared)
                for _, pgs in taken:
                    self.pool.release(pgs)
                return 0
            taken.append((i, shared))
        for i, shared in taken:
            self.pool.release(row_pages[i][:n_shared])
            row_pages[i][:n_shared] = shared
            tables[i, :n_shared] = shared
        self.counters["prefix_hits"] += n_real
        self.counters["prefix_hit_tokens"] += cached * n_real
        return cached

    def _run_batch(self, batch: List[_Request]):
        engine = self.engine
        cfg = engine.cfg
        dev = engine.device
        # requests cancelled while queued never prefill
        live = []
        for r in batch:
            if r.cancelled:
                self.counters["cancelled"] += 1
                r.out.put(_SENTINEL)
            else:
                live.append(r)
        # anyres merges and multi-image prompts have ragged token counts:
        # the batch is served one request at a time, decided before
        # prepare() so the tower runs once per request
        if not all(self._batchable(r) for r in live):
            for r in live:
                self._serve_serial(r)
            return
        # a request that cannot be prepared fails alone
        ready = []
        for r in live:
            try:
                ready.append((r, engine.prepare(r.prompt, r.image)))
            except Exception as e:
                logger.exception("prepare failed")
                r.out.put({"error": str(e)})
                r.out.put(_SENTINEL)
        # in place: requests admitted later join this list, so the failure
        # envelopes of _loop reach them too
        batch[:] = [r for r, _ in ready]
        if not batch:
            return
        # a pool batch maps its prompts' pages; the dense path (paged=False,
        # an int8-KV engine) and a batch whose prompts the pool cannot hold
        # run on a dense cache of their own
        row_pages = self._map_prompts(ready) if self.paged else None
        pool_batch = row_pages is not None
        n_real = len(batch)
        b = _round_batch(n_real)
        row_pages = (row_pages or [[] for _ in range(n_real)]) + [
            [] for _ in range(b - n_real)]
        try:
            pad_to = max(int(p["ids"].shape[1]) for _, p in ready)
            s = cfg.vision.image_size
            rows, starts_l, imgs = [], [], []
            for _, p in ready:
                rows.append(p["ids"][0, :p["prompt_tokens"]].cpu().numpy())
                starts_l.append(int(p["starts"][0]))
                imgs.append(None if p["images"] is None else p["images"][0])
            # pad rows to the batch bucket
            while len(rows) < b:
                rows.append(rows[0][:1])
                starts_l.append(-1)
                imgs.append(None)
            ids, lens, starts = pad_batch(rows, starts_l, pad_to)
            # rows without an image encode a zero image, as the JAX
            # scheduler does (it overlays it where the prompt has image
            # slots)
            zero = torch.zeros((s, s, 3), dtype=engine._dtype, device=dev)
            images = torch.stack([zero if x is None else x for x in imgs])
            # full-width chunks always: caps end rows on the host, and page
            # growth covers the overshoot (_grow_pages' cur_len + k target)
            k = engine.chunk
            batch_cached = 0
            tables = None
            if pool_batch:
                cache, tables = self._batch_cache(b, row_pages)
                batch_cached = self._reuse_batch_prefix(
                    rows, starts_l, n_real, row_pages, tables)
                if batch_cached:
                    cache = dataclasses.replace(
                        cache,
                        block_tables=self._device_tables(tables, row_pages))
            else:
                # the dense path: a row may decode one chunk past its cap
                # before the host closes it (JAX sizes the cache to the cap
                # and clamps those writes)
                max_new = max(r.max_new_tokens for r in batch)
                cache = engine.new_cache(b, pad_to + (max_new // k + 1) * k)
        except BaseException:
            for pgs in row_pages:
                if pgs:
                    self.pool.release(pgs)
            raise

        # cur_len[i] = row i's current device length (prompt + decoded)
        cur_len = [len(r) for r in rows]
        # speculative chunks: a verify pass writes k+1 slots past a row's
        # length and a chunk commits up to spec_width tokens, so the page
        # budgets and the admission guard carry that slack. Armed when the
        # gathered batch is all greedy; a sampled admission turns it off
        spec_on = self.spec and pool_batch and all(
            r.sampling.temperature <= 0.0 for r in batch)
        spec_k = self.spec_draft_k
        spec_m = max(1, -(-k // (spec_k + 1)))
        spec_width = spec_m * (spec_k + 1)
        spec_slack = spec_width + spec_k + 1 if spec_on else 0
        # spec_live: the next chunk runs verify passes on the device state
        # (hist, hist_len, num), which is rebuilt from the host's prompt_ids
        # and texts whenever spec turns on
        spec_live = spec_banned = False
        spec_ema = None
        spec_chunks = 0
        hist = hist_len = num = None
        prompt_ids: List[np.ndarray] = [np.asarray(r, np.int32) for r in rows]

        # slot state: slots[i] = the request occupying row i (None = free)
        slots: List[Optional[_Request]] = [
            batch[i] if i < n_real else None for i in range(b)]
        texts: List[List[int]] = [[] for _ in range(b)]
        finished = [slots[i] is None for i in range(b)]
        reasons: List[Optional[str]] = [None] * b
        caps = [slots[i].max_new_tokens if slots[i] else 0 for i in range(b)]
        # per-row page budget: prompt + cap tokens is all a row's kept
        # tokens can ever attend to — growth never maps past it
        budget_tok = [cur_len[i] + caps[i] + spec_slack if slots[i] else 0
                      for i in range(b)]
        emitted = [0] * b
        ttfts = [0.0] * b
        queue_ms = [0.0] * b
        tables_dirty = False  # host tables changed; push at next boundary
        for r in batch:
            r.cached_tokens = batch_cached
        # chunked admission: slot index -> mid-prefill state. A pending row
        # holds its slot (which keeps the loop alive and the slot taken) and
        # its pages (row_pages[i]), but its host table row stays -1 until
        # activation: the device never sees its pages before then, so the
        # decode writes of the row (a free slot's, done on the device) drop
        # into the sink
        pending: Dict[int, dict] = {}
        # the persistent view (persist_view): a dense KVCache of the pool
        # carried across chunks, ahead of the pool by pview_chunks chunks
        # past pview_base (the rows' pool lengths when it was last synced;
        # host-tracked). pview_stale: rows rebound by an admission since,
        # refreshed one by one (update_view_row) at the next dispatch
        pview = None
        pview_chunks = 0
        pview_base = None
        pview_stale: set = set()

        def flush_view(cache, keep=False):
            """Sync the pool from the persistent view, before anything that
            reads the pool's KV or a row's identity: an admission (its
            prefill reads the pool; what it publishes to the prefix cache
            lies there), a chunked admission's activation, a resize, a spec
            chunk, a regather. One wide sync a step of w = min(8k, view
            width) columns, ceil(total / w) of them. ``keep=False`` drops
            the view (the rows' layout is about to change); ``keep=True``
            keeps it, as every row whose slot is not rebound is still
            current, and an admission then refreshes its own row only."""
            nonlocal pview, pview_chunks, pview_base
            if pview is None:
                return cache
            total = pview_chunks * k
            # a stale row holds another request's columns: the view is
            # synced before any admission rebinds a row, and a stale row is
            # refreshed before the next dispatch adds chunks
            assert not pview_stale or total == 0, (pview_stale, total)
            w = min(8 * k, pview.max_len)
            off = 0
            while off < total:
                cache = engine.call(
                    "sync_pool_from_view", pview, cache,
                    torch.from_numpy((pview_base + off).astype(np.int32))
                    .to(dev), w=w)
                self.counters["view_syncs"] += 1
                off += w
            if keep:
                pview_base = pview_base + total
                pview_chunks = 0
            else:
                pview = None
                pview_chunks = 0
                pview_base = None
                pview_stale.clear()
            return cache

        # per-row sampling knobs, rebuilt only when the slots' mix changes
        _rs_cache = {"sig": None, "rs": None}

        def row_samp() -> RowSampling:
            sig = (b, tuple(
                None if sl is None else (sl.sampling.temperature,
                                         sl.sampling.top_p, sl.sampling.top_k)
                for sl in slots))
            if _rs_cache["sig"] != sig:
                _rs_cache["sig"] = sig
                _rs_cache["rs"] = RowSampling.build(
                    [sl.sampling if sl else None for sl in slots], b, dev)
            return _rs_cache["rs"]

        def n_active() -> int:
            return sum(sl is not None for sl in slots)

        def emit(i: int):
            """Push row i's cumulative update; the moment the row finishes,
            close ITS stream (sentinel) and release its pages."""
            nonlocal tables_dirty
            r = slots[i]
            text = engine.tokenizer.decode(texts[i], skip_special_tokens=True)
            for ss in r.stop_strings:
                if ss and ss in text:
                    text = text.split(ss)[0]
                    finished[i] = True
                    reasons[i] = reasons[i] or "stop"
            if finished[i] and reasons[i] is None:
                reasons[i] = "length" if emitted[i] >= caps[i] else "stop"
            r.out.put({"text": text,
                       "stats": {"ttft_ms": ttfts[i],
                                 "queue_ms": queue_ms[i],
                                 "decode_tokens": len(texts[i]),
                                 "batch_size": n_active(),
                                 "finish_reason": reasons[i],
                                 "cached_tokens": r.cached_tokens,
                                 "prefill_chunks": r.prefill_chunks}})
            if finished[i]:
                r.out.put(_SENTINEL)
                if row_pages[i]:
                    self.pool.release(row_pages[i])
                    row_pages[i] = []
                    tables[i, :] = -1
                    tables_dirty = True  # device writes must drop next chunk
                slots[i] = None

        def first_token(i: int, t: int):
            """Record row i's prefill-sampled token and stream the first
            update (closing immediately on EOS / a 1-token cap)."""
            if t in engine.eos_ids:
                finished[i] = True
                reasons[i] = "stop"
            else:
                texts[i].append(t)
                emitted[i] = 1
                if emitted[i] >= caps[i]:
                    finished[i] = True
                    reasons[i] = "length"
            emit(i)

        def resize(new_b, cache, ht, hd):
            """Re-bucket the live batch to ``new_b`` rows. The page pool is
            batch-size-independent; the b-shaped state (block tables,
            lengths, last token, done, the per-row bookkeeping) is rebuilt
            on the host and uploaded. Occupied rows compact to the front;
            ht/hd are HOST copies of (tok, done)."""
            nonlocal b, tables, tables_dirty, slots, texts, finished, \
                reasons, caps, emitted, ttfts, queue_ms, cur_len, row_pages, \
                budget_tok, prompt_ids, spec_live
            # the view is row-indexed against the current tables: sync it
            # while the rows still match, and drop it (the next chunk
            # regathers at the new batch)
            cache = flush_view(cache)
            mapping = [i for i in range(b) if slots[i] is not None]
            # the spec state is row-indexed: rebuilt at the new b if wanted
            spec_live = False
            lens_old = cache.lengths.cpu().numpy()
            new_tables = np.full((new_b, tables.shape[1]), -1, np.int32)
            new_lens = np.zeros((new_b,), np.int32)
            nt = np.zeros((new_b,), ht.dtype)
            nd = np.ones((new_b,), bool)

            def moved(src, pad):
                out = [pad() for _ in range(new_b)]
                for j, i in enumerate(mapping):
                    out[j] = src[i]
                return out

            for j, i in enumerate(mapping):
                new_tables[j] = tables[i]
                new_lens[j] = lens_old[i]
                nt[j] = ht[i]
                nd[j] = hd[i]
            slots = moved(slots, lambda: None)
            texts = moved(texts, list)
            finished = moved(finished, lambda: True)
            reasons = moved(reasons, lambda: None)
            caps = moved(caps, lambda: 0)
            budget_tok = moved(budget_tok, lambda: 0)
            emitted = moved(emitted, lambda: 0)
            ttfts = moved(ttfts, lambda: 0.0)
            queue_ms = moved(queue_ms, lambda: 0.0)
            cur_len = moved(cur_len, lambda: 0)
            row_pages = moved(row_pages, list)
            prompt_ids = moved(prompt_ids, lambda: np.zeros((0,), np.int32))
            # mid-prefill rows move with their slots (ascending order cannot
            # collide: compaction maps every index down or onto itself)
            remap = {i: j for j, i in enumerate(mapping)}
            for old_i in sorted(pending):
                pending[remap[old_i]] = pending.pop(old_i)
            b = new_b
            tables = new_tables
            tables_dirty = False  # pushed below
            cache = dataclasses.replace(
                cache, block_tables=self._device_tables(tables, row_pages),
                lengths=torch.from_numpy(new_lens).to(dev))
            return cache, nt, nd

        def try_admit(cache, tok, done):
            """Continuous batching: fill freed rows with queued requests at
            a chunk boundary, growing the batch bucket when every row is
            live. The prompt prefills through a 1-row PagedKVCache view over
            the SAME pool tensors, so its KV lands in the pages just
            allocated for it."""
            nonlocal tables_dirty, spec_live, admitting
            ht = hd = None  # lazy host copies of (tok, done)
            if self._deferred and (time.perf_counter()
                                   - min(d.t_submit for d in self._deferred)
                                   > self.fairness_s):
                # a deferred request (one that cannot join this batch, or
                # one that kept failing to place) has waited past the
                # fairness bound: stop admitting so the batch drains, and
                # the next _gather serves the deferred requests first
                admitting = False
                self.counters["drained_for_fairness"] += 1
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "drain",
                                       len(self._deferred)))
                return cache, tok, done
            # bound the admissions per boundary to the requests already
            # waiting when it started, so in-flight rows keep getting decode
            # service under a steady stream of arrivals
            budget = len(self._deferred) + self.queue.qsize()
            while not self._stop and budget > 0:
                budget -= 1
                # deferred batchable requests first: a freed slot goes to
                # them before fresh arrivals
                r = next((d for d in self._deferred if self._batchable(d)),
                         None)
                if r is not None:
                    self._deferred.remove(r)
                else:
                    try:
                        r = self.queue.get_nowait()
                    except queue.Empty:
                        break
                if r.cancelled:
                    self.counters["cancelled"] += 1
                    r.out.put(_SENTINEL)
                    continue
                if not self._batchable(r):
                    # an anyres / multi-image request waits for the batch
                    # to end; batchable requests behind it may still admit
                    self._deferred.append(r)
                    if self.trace is not None:
                        self.trace.append((time.perf_counter(), "defer",
                                           "shape"))
                    continue
                # the admission reads the pool: sync the view, and keep it
                # (only the rebound row goes stale)
                cache = flush_view(cache, keep=True)
                if n_active() >= b:
                    new_b = _round_batch(n_active() + 1)
                    if b >= self.max_batch or new_b > self.max_batch:
                        self._deferred.append(r)  # batch at capacity
                        if self.trace is not None:
                            self.trace.append((time.perf_counter(), "defer",
                                               "capacity"))
                        break
                    if ht is None:
                        ht = tok.cpu().numpy().copy()
                        hd = done.cpu().numpy().copy()
                    self.counters["grown"] += 1
                    t_rs = time.perf_counter()
                    cache, ht, hd = resize(new_b, cache, ht, hd)
                    if self.trace is not None:
                        self.trace.append((time.perf_counter(), "grow", new_b,
                                           (time.perf_counter() - t_rs)
                                           * 1000))
                try:
                    prep = engine.prepare(r.prompt, r.image)
                except Exception as e:  # a bad request must not kill the batch
                    logger.exception("admission prepare failed")
                    r.out.put({"error": str(e)})
                    r.out.put(_SENTINEL)
                    continue
                plen = prep["prompt_tokens"]
                if (plen + r.max_new_tokens + spec_slack
                        > tables.shape[1] * self.page_size):
                    self._deferred.append(r)  # more than the pool: next batch
                    break
                ids_row = prep["ids"][0, :plen].cpu().numpy()
                start0 = int(prep["starts"][0])
                cached_len, shared = 0, []
                if self.prefix is not None and prep["vision_embeds"] is None:
                    # reuse ends before the first image slot (image KV
                    # depends on pixels, not ids) and before the last prompt
                    # token (its logits give the first token)
                    bound = min(start0 if start0 >= 0 else plen, plen - 1)
                    cached_len, shared = self.prefix.lookup(
                        ids_row[:max(bound, 0)])
                need = -(-plen // self.page_size)
                got = self._alloc_pages(need - len(shared))
                if got is None:
                    self.pool.release(shared)  # hand back the row's refs
                    self._deferred.append(r)  # pool full; retry next boundary
                    break
                row_pgs = shared + got
                i = slots.index(None)
                r.cached_tokens = cached_len
                if cached_len:
                    self.counters["prefix_hits"] += 1
                    self.counters["prefix_hit_tokens"] += cached_len
                wait_ms = (time.perf_counter() - r.t_submit) * 1000
                t0 = time.perf_counter()
                if (self.prefill_chunk and prep["vision_embeds"] is None
                        and plen - cached_len > self.prefill_chunk
                        and len(pending) < self.max_pending
                        and n_active() > len(pending)):
                    # chunked admission, worth it only while another row is
                    # live: reserve the slot and pages now, prefill a chunk
                    # a boundary (advance_pending); the table row stays -1
                    # until activation. Text-only requests carry sentinel
                    # slots but no pixels: their chunks may split the slots
                    img_s = start0 if (start0 >= 0
                                       and prep["images"] is not None) else -1
                    img_e = img_s + cfg.num_image_tokens if img_s >= 0 else -1
                    row_pages[i] = row_pgs
                    tables[i, :] = -1
                    pending[i] = {
                        "r": r, "ids": ids_row, "plen": plen, "start": start0,
                        "images": prep["images"],
                        "bounds": _prefill_chunk_bounds(
                            cached_len, plen, self.prefill_chunk, img_s,
                            img_e),
                        "bi": 0, "t0": t0, "wait_ms": wait_ms,
                        "table": torch.tensor([row_pgs], dtype=torch.int32,
                                              device=dev)}
                    slots[i] = r
                    batch.append(r)
                    texts[i] = []
                    finished[i] = False
                    reasons[i] = None
                    caps[i] = r.max_new_tokens
                    budget_tok[i] = plen + r.max_new_tokens + spec_slack
                    emitted[i] = 0
                    cur_len[i] = 0
                    prompt_ids[i] = ids_row
                    self.counters["chunked_admissions"] += 1
                    if self.trace is not None:
                        self.trace.append((time.perf_counter(), "padmit", i,
                                           plen))
                    continue
                tables[i, :] = -1
                tables[i, :need] = row_pgs
                row_pages[i] = row_pgs
                view = PagedKVCache(
                    k_pages=cache.k_pages, v_pages=cache.v_pages,
                    block_tables=torch.tensor([row_pgs], dtype=torch.int32,
                                              device=dev),
                    lengths=torch.zeros((1,), dtype=torch.int32, device=dev))
                try:
                    if cached_len:
                        # prefill only the suffix, attending the shared
                        # prefix pages read-only
                        logits, view = self._prefill_suffix(
                            prep["images"], ids_row, start0, cached_len, plen,
                            view)
                    else:
                        logits, view = engine.call(
                            "prefill", prep["images"], prep["ids"],
                            prep["lens"], prep["starts"], view,
                            vision_embeds=prep["vision_embeds"])
                        self._count_prefill(prep["images"] is not None)
                    t_new = int(sample(self._gen, logits, r.sampling)[0])
                except Exception as e:
                    # fail this request alone and keep the batch alive
                    logger.exception("admission prefill failed")
                    self.pool.release(row_pages[i])
                    row_pages[i] = []
                    tables[i, :] = -1
                    tables_dirty = True
                    r.out.put({"error": str(e)})
                    r.out.put(_SENTINEL)
                    continue
                if ht is None:
                    ht = tok.cpu().numpy().copy()
                    hd = done.cpu().numpy().copy()
                lengths = cache.lengths.cpu().numpy().copy()
                lengths[i] = plen
                cache = dataclasses.replace(
                    cache, block_tables=self._device_tables(tables, row_pages),
                    lengths=torch.from_numpy(lengths).to(dev))
                tables_dirty = False  # pushed above
                slots[i] = r
                batch.append(r)  # failure envelopes reach admitted rows too
                texts[i] = []
                finished[i] = False
                reasons[i] = None
                caps[i] = r.max_new_tokens
                budget_tok[i] = plen + r.max_new_tokens + spec_slack
                emitted[i] = 0
                cur_len[i] = plen
                prompt_ids[i] = ids_row
                if self.prefix is not None and prep["vision_embeds"] is None:
                    # the row's full prompt pages before its image hold
                    # reusable KV now
                    self.prefix.publish(
                        ids_row[:start0 if start0 >= 0 else plen], row_pgs)
                ttfts[i] = (time.perf_counter() - t0) * 1000
                queue_ms[i] = wait_ms
                first_token(i, t_new)
                self.counters["admitted"] += 1
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "admit", i, plen,
                                       ttfts[i]))
                ht[i] = t_new
                hd[i] = finished[i] or slots[i] is None
                if pview is not None and not hd[i]:
                    pview_stale.add(i)
                # the new row's history is not in the spec state
                spec_live = False
            if ht is not None:
                tok = torch.from_numpy(ht).to(dev)
                done = torch.from_numpy(hd).to(dev)
            return cache, tok, done

        def advance_pending(cache, tok, done):
            """One prefill chunk for every mid-prefill row, over its 1-row
            view of the pool in place. The final chunk activates the row as
            a single-shot admission does: it samples the first token from
            the chunk's last logits, exposes the row's pages in the batch
            table, sets its length and publishes its prefix."""
            nonlocal tables_dirty, spec_live
            ht = hd = None
            for i in sorted(pending):
                st = pending[i]
                r = st["r"]
                c0, c1 = st["bounds"][st["bi"]], st["bounds"][st["bi"] + 1]
                view = PagedKVCache(
                    k_pages=cache.k_pages, v_pages=cache.v_pages,
                    block_tables=st["table"],
                    lengths=torch.full((1,), c0, dtype=torch.int32,
                                       device=dev))
                t_ck = time.perf_counter()
                try:
                    logits, _ = self._prefill_suffix(
                        st["images"], st["ids"], st["start"], c0, c1, view)
                    if c1 == st["plen"]:
                        t_new = int(sample(self._gen, logits,
                                           r.sampling)[0])
                except Exception as e:
                    # fail this request alone, as a single-shot admission
                    logger.exception("pending prefill chunk failed")
                    self.pool.release(row_pages[i])
                    row_pages[i] = []
                    pending.pop(i)
                    slots[i] = None
                    finished[i] = True
                    r.out.put({"error": str(e)})
                    r.out.put(_SENTINEL)
                    continue
                st["bi"] += 1
                r.prefill_chunks += 1
                self.counters["prefill_chunks"] += 1
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "pchunk", i, c0,
                                       c1, (time.perf_counter() - t_ck)
                                       * 1000))
                if c1 < st["plen"]:
                    continue
                # the last chunk: activate the row. Sync the live rows' view
                # while the row's table is still -1 (its view columns drop),
                # then expose its pages; the view stays, this row stale
                plen = st["plen"]
                if ht is None:
                    ht = tok.cpu().numpy().copy()
                    hd = done.cpu().numpy().copy()
                cache = flush_view(cache, keep=True)
                lengths = cache.lengths.cpu().numpy().copy()
                lengths[i] = plen
                tables[i, :] = -1
                tables[i, :len(row_pages[i])] = row_pages[i]
                cache = dataclasses.replace(
                    cache, block_tables=self._device_tables(tables, row_pages),
                    lengths=torch.from_numpy(lengths).to(dev))
                tables_dirty = False  # pushed above
                cur_len[i] = plen
                if self.prefix is not None:
                    self.prefix.publish(
                        st["ids"][:st["start"] if st["start"] >= 0 else plen],
                        row_pages[i])
                pending.pop(i)
                ttfts[i] = (time.perf_counter() - st["t0"]) * 1000
                queue_ms[i] = st["wait_ms"]
                first_token(i, t_new)
                self.counters["admitted"] += 1
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "activate", i,
                                       plen, ttfts[i]))
                ht[i] = t_new
                hd[i] = finished[i] or slots[i] is None
                if pview is not None and not hd[i]:
                    pview_stale.add(i)
                spec_live = False
            if ht is not None:
                tok = torch.from_numpy(ht).to(dev)
                done = torch.from_numpy(hd).to(dev)
            return cache, tok, done

        def build_spec_state(done):
            """The device spec state from the host: a live row's history is
            its prompt + text so far, ``num`` its tokens so far; free slots
            are marked done, so they commit nothing. Returns (hist,
            hist_len, num, done)."""
            hist_w = self._hist_width(max(budget_tok[i] for i in range(b)
                                          if slots[i] is not None))
            hh = np.zeros((b, hist_w), np.int32)
            hl = np.zeros((b,), np.int32)
            nm = np.ones((b,), np.int32)
            free = np.array([sl is None for sl in slots])
            for i in range(b):
                if slots[i] is None:
                    continue
                p, t = prompt_ids[i], texts[i]
                hh[i, :len(p)] = p
                hh[i, len(p):len(p) + len(t)] = t
                hl[i] = len(p) + len(t)
                nm[i] = max(1, len(t))
            return (torch.from_numpy(hh).to(dev), torch.from_numpy(hl).to(dev),
                    torch.from_numpy(nm).to(dev),
                    done | torch.from_numpy(free).to(dev))

        def sweep_cancelled():
            """Abort client-cancelled rows at the chunk boundary: the stream
            closes and pages release via the normal finish path. On the
            device the row behaves like a host-finished row: its writes
            drop through the zeroed table. A row mid-prefill drops its
            reserved pages and closes."""
            nonlocal spec_live
            for i in range(b):
                r = slots[i]
                if r is None or not r.cancelled:
                    continue
                self.counters["cancelled"] += 1
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "cancel", i))
                if i in pending:  # its table row is still -1
                    pending.pop(i)
                    self.pool.release(row_pages[i])
                    row_pages[i] = []
                    slots[i] = None
                    finished[i] = True
                    r.out.put(_SENTINEL)
                    continue
                if not finished[i]:
                    finished[i] = True
                    reasons[i] = "cancelled"
                    emit(i)
                    spec_live = False  # rebuilt with the slot marked done

        batch_ok = False
        try:
            t0 = time.perf_counter()
            if batch_cached:
                # every row extends the cached prefix: prefill the suffixes
                sfx = [rows[i][batch_cached:] for i in range(n_real)]
                w = max(len(x) for x in sfx)
                sids = np.zeros((b, -(-w // engine.bucket) * engine.bucket),
                                np.int32)
                slens = np.zeros((b,), np.int32)
                sstarts = np.full((b,), -1, np.int32)
                for i, x in enumerate(sfx):
                    sids[i, :len(x)] = x
                    slens[i] = len(x)
                    if starts_l[i] >= 0:
                        sstarts[i] = starts_l[i] - batch_cached
                logits, cache = engine.prefill_suffix(
                    images, torch.from_numpy(sids).to(dev),
                    torch.from_numpy(slens).to(dev),
                    torch.from_numpy(sstarts).to(dev), batch_cached, cache)
            else:
                logits, cache = engine.call(
                    "prefill", images, torch.from_numpy(ids).to(dev),
                    torch.from_numpy(lens).to(dev),
                    torch.from_numpy(starts).to(dev), cache)
            self._count_prefill(True)
            tok = sample_rows(self._gen, logits, row_samp())
            host_tok = tok.cpu().numpy()  # the host read waits for the device
            ttft_ms = (time.perf_counter() - t0) * 1000
            if self.prefix is not None:
                # the rows' prompt pages before their images hold reusable
                # KV now: publish them for later admissions
                for i in range(n_real):
                    pub = starts_l[i] if starts_l[i] >= 0 else len(rows[i])
                    self.prefix.publish(rows[i][:pub], row_pages[i])
            for i in range(b):
                if slots[i] is None:
                    continue
                ttfts[i] = ttft_ms
                queue_ms[i] = (t0 - slots[i].t_submit) * 1000
                first_token(i, int(host_tok[i]))

            done = torch.tensor(
                [finished[i] or slots[i] is None for i in range(b)],
                device=dev)
            under_occ = 0  # consecutive under-occupied boundaries
            # window batching (continuous=False) and a dense batch never
            # admit; a fairness drain stops admission for the rest of the
            # batch
            admitting = self.continuous and pool_batch

            while n_active() > 0 or (admitting and not self._stop
                                     and not self.queue.empty()):
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "iter",
                                       n_active(), b))
                sweep_cancelled()
                if admitting:
                    cache, tok, done = try_admit(cache, tok, done)
                if pending:
                    cache, tok, done = advance_pending(cache, tok, done)
                # decide speculation after admission: one live row can
                # become a full batch at this boundary, and the spec state
                # is row-indexed (no row may be mid-prefill)
                want_spec = (spec_on and not spec_banned and not pending
                             and 0 < n_active() <= self.spec_max_rows
                             and b <= _round_batch(self.spec_max_rows)
                             and all(sl is None
                                     or sl.sampling.temperature <= 0.0
                                     for sl in slots)
                             and self._spec_preferred(n_active()))
                if want_spec and not spec_live:
                    hist, hist_len, num, done = build_spec_state(done)
                    spec_live = True
                elif not want_spec:
                    spec_live = False
                # pipelining (persistent view only): dispatch `depth` chunks
                # back to back and read the host once, while nothing needs a
                # boundary: no request waits, no spec chunk or prefill is
                # live, and no live row is within one chunk of its cap
                depth = 1
                if (self.pipeline_depth > 1 and not spec_live and not pending
                        and pool_batch and self.persist_view
                        and self.queue.empty() and not self._deferred):
                    live_rem = [caps[i] - emitted[i] for i in range(b)
                                if slots[i] is not None]
                    if live_rem and min(live_rem) > k:
                        depth = self.pipeline_depth
                        self.counters["pipelined_groups"] += 1
                disp_k = k * depth
                # pages through cur_len + spec_width before a spec chunk
                # (spec_stream_chunk's caller contract)
                if pool_batch:
                    cache = self._grow_pages(
                        cache, tables, row_pages, cur_len, finished, slots,
                        spec_width if spec_live else disp_k, reasons,
                        force=tables_dirty, budget=budget_tok,
                        pending=pending)
                tables_dirty = False
                # pool exhaustion may have truncated rows: close them now
                for i in range(b):
                    if slots[i] is not None and finished[i]:
                        emit(i)
                if n_active() == 0:
                    break
                if n_active() == len(pending):
                    # nothing to decode yet: spend the boundary on the
                    # prefills instead of an all-done chunk
                    continue
                act_n = n_active() - len(pending)  # rows that decode
                t_disp = time.perf_counter()
                counts_host = None
                cap = tables.shape[1] * self.page_size if pool_batch else 0
                # the longest row of the slots (the view's width follows it)
                longest = max(cur_len[i] for i in range(b)
                              if slots[i] is not None)
                if spec_live:
                    # the verify passes run on the pool in place
                    cache = flush_view(cache)
                    # the pool's table capacity is the device budget; the
                    # host's caps end each row
                    carry = vlm.SpecCarry(last_tok=tok, done=done, num=num,
                                          cache=cache, hist=hist,
                                          hist_len=hist_len)
                    toks, counts, carry = engine.call(
                        "spec_stream_chunk", carry, m=spec_m,
                        max_new_tokens=tables.shape[1] * self.page_size,
                        eos_ids=engine.eos_ids, draft_k=spec_k,
                        ngram_n=self.spec_ngram_n)
                    tok, done, num, cache, hist, hist_len = (
                        carry.last_tok, carry.done, carry.num, carry.cache,
                        carry.hist, carry.hist_len)
                    # one host read: counts, done, tokens
                    packed = torch.cat([counts[:, None],
                                        done[:, None].to(torch.int32), toks],
                                       dim=1).cpu().numpy()
                    counts_host, host_done = packed[:, 0], packed[:, 1] > 0
                    host = packed[:, 2:]
                    committed = int(counts_host.sum())
                    shape_key = ("spec", b, spec_m, int(hist.shape[1]))
                else:
                    if pool_batch and self.persist_view:
                        # decode on the carried view (K2); gather it when
                        # there is none or it is too narrow for the chunk
                        s_bucket = min(cap, _round_bucket(
                            longest + disp_k, self.page_size))
                        if pview is not None and pview.lengths.shape[0] != b:
                            # resize() flushes before it compacts the rows,
                            # so this is a backstop: a view of other rows
                            # cannot be synced, drop it unsynced
                            logger.error("stale persistent view (batch %d != "
                                         "%d) dropped unsynced",
                                         pview.lengths.shape[0], b)
                            self.counters["view_dropped_stale"] += 1
                            pview, pview_chunks, pview_base = None, 0, None
                            pview_stale.clear()
                        # a view of the pool's width holds every position a
                        # row can write: the need is capped there
                        if pview is None or pview.max_len < min(
                                cap, s_bucket + k):
                            cache = flush_view(cache)
                            # one page bucket of headroom
                            vb = min(cap, _round_bucket(s_bucket + k,
                                                        self.page_size))
                            pview = engine.call("gather_view", cache, vb)
                            pview_base = np.asarray(
                                [cur_len[i] if slots[i] is not None else 0
                                 for i in range(b)], np.int32)
                            pview_chunks = 0
                            pview_stale.clear()  # every row is fresh
                            self.counters["view_gathers"] += 1
                        elif pview_stale:
                            for i in sorted(pview_stale):
                                if slots[i] is None or finished[i]:
                                    continue  # closed before the dispatch
                                pview = engine.call("update_view_row", pview,
                                                    cache, i)
                                pview_base[i] = cur_len[i]
                                self.counters["view_row_updates"] += 1
                            pview_stale.clear()
                        shape_key = ("persist", b, pview.max_len, k)
                        group = []
                        for _ in range(depth):
                            toks, done, tok, pview = engine.call(
                                "decode_chunk", tok, done, pview, self._gen,
                                k=k, eos_ids=engine.eos_ids,
                                row_sampling=row_samp())
                            group.append(toks)
                            pview_chunks += 1
                        if depth > 1:
                            toks = torch.cat(group, dim=1)
                    elif pool_batch and self.chunk_view:
                        # a dense view of each row's first s_bucket
                        # positions, gathered for this chunk only
                        s_bucket = min(cap, _round_bucket(
                            longest + k, self.page_size))
                        shape_key = ("plain", b, s_bucket, k)
                        toks, done, tok, cache = engine.call(
                            "decode_chunk_paged", tok, done, cache,
                            self._gen, k=k, s_bucket=s_bucket,
                            eos_ids=engine.eos_ids, row_sampling=row_samp())
                    else:  # the pool in place (K3), or a dense batch (K2)
                        shape_key = ("plain", b, k)
                        toks, done, tok, cache = engine.call(
                            "decode_chunk", tok, done, cache, self._gen, k=k,
                            eos_ids=engine.eos_ids, row_sampling=row_samp())
                    host = toks.cpu().numpy()  # the host read = the sync
                    host_done = done.cpu().numpy()
                    committed = disp_k * act_n
                dt = time.perf_counter() - t_disp
                self._note_rate(shape_key, act_n, committed, dt)
                if spec_live:
                    if self.trace is not None:
                        self.trace.append((time.perf_counter(), "spec", b,
                                           act_n, spec_m, dt * 1000,
                                           committed))
                else:
                    self.counters["chunks"] += depth
                    self.counters["decode_steps"] += disp_k
                    if self.trace is not None:
                        self.trace.append((time.perf_counter(), "disp", b,
                                           act_n, disp_k, dt * 1000,
                                           len(pending)))
                for i in range(b):
                    if slots[i] is None or i in pending:
                        # a pending row is a free slot on the device: its
                        # chunk slots are not its text
                        continue
                    row_toks = (host[i] if counts_host is None
                                else host[i][:int(counts_host[i])])
                    for t in row_toks:
                        t = int(t)
                        # post-EOS pad slots are always preceded by the EOS
                        # token in the same chunk, so breaking on EOS is
                        # sufficient (token id 0 is a real token)
                        if t in engine.eos_ids or emitted[i] >= caps[i]:
                            finished[i] = True
                            reasons[i] = reasons[i] or (
                                "stop" if t in engine.eos_ids else "length")
                            break
                        texts[i].append(t)
                        emitted[i] += 1
                    if host_done[i] and not finished[i]:
                        finished[i] = True
                        reasons[i] = reasons[i] or "stop"
                    cur_len[i] += (disp_k if counts_host is None
                                   else int(counts_host[i]))
                    emit(i)
                if counts_host is not None:
                    # acceptance EMA: drafts that keep missing make verify
                    # passes cost more than the plain steps they replace
                    accept = (max(0, committed - spec_m * act_n)
                              / max(1, spec_m * spec_k * act_n))
                    spec_ema = (accept if spec_ema is None
                                else 0.5 * spec_ema + 0.5 * accept)
                    spec_chunks += 1
                    if spec_chunks >= 3 and spec_ema < self.spec_min_accept:
                        spec_banned = True
                        spec_live = False
                        self.counters["spec_banned_low_accept"] += 1
                if pool_batch and n_active() > 0:
                    nb = _round_batch(n_active())
                    if nb < b:
                        # long-tail shrink, with hysteresis: only after 2
                        # consecutive under-occupied boundaries (a finish is
                        # often followed by an admission within one chunk)
                        under_occ += 1
                        if under_occ >= 2:
                            under_occ = 0
                            self.counters["shrunk"] += 1
                            ht = tok.cpu().numpy().copy()
                            hd = done.cpu().numpy().copy()
                            cache, ht, hd = resize(nb, cache, ht, hd)
                            tok = torch.from_numpy(ht).to(dev)
                            done = torch.from_numpy(hd).to(dev)
                    else:
                        under_occ = 0
            batch_ok = True
        finally:
            for pgs in row_pages:
                if pgs:
                    self.pool.release(pgs)
            row_pages = [[] for _ in range(b)]
            if pool_batch and not batch_ok:
                # a failed dispatch may have left the pool mid-write (or the
                # device in a bad state): reallocate for the next batch; the
                # cached prefixes' KV lived in that pool, so they go too
                self._pool_kv = None
                if self.prefix is not None:
                    self.prefix.clear()

        # safety net: emit() closed every stream on finish; a second
        # sentinel after a close is unread
        for r in batch:
            r.out.put(_SENTINEL)
