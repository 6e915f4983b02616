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

Decode: every chunk is one ``vlm.decode_chunk`` over the ``PagedKVCache``,
whose T=1 steps run kernel K3 (``ops/cuda/paged_decode_attention.py``) on
the pool in place: 24 launches a step at 0.5B. This is how the JAX
scheduler serves with ``paged=True, chunk_view=False, persist_view=False``
and ``attn_backend="pallas"``. Its dense working views (chunk view,
persistent view) exist because XLA cannot fuse the page gather into
attention; a hand-written paged kernel reads the pages where they lie.

Held back (constructor knobs; setting one on raises NotImplementedError):
``prefix_cache`` (with ``prefill_continue``), ``prefill_chunk`` (chunked
admission prefill), ``spec`` (speculative chunks and their rate tuner),
``chunk_view`` / ``persist_view`` / ``pipeline_depth``, and ``warmup()``.
``prefix_cache=None`` resolves to off. Left out with the serial path for
requests that cannot join a batch (anyres, multi-image; the port's engine
serves neither): ``fairness_s``, the drain that keeps such a request from
starving, and ``continuous=False``, the window-batching baseline of the JAX
benchmark. Left out as well: ``paged=False``, the JAX scheduler's dense
per-batch cache, and its fallback to it when the pool cannot hold a
gathered batch's prompts. Here the requests that do not fit wait for the
next admission, and a prompt larger than the whole pool fails alone.

Where the port differs without changing an output:
  * the device sees the block tables cut to the page watermark (the widest
    row's mapped pages); the JAX tables span the pool, a width XLA compiles
    against. K3's grid then follows the pages in flight, not the pool;
  * prompts pad to the engine's bucket (64 tokens), not to 256, and an
    admission's 1-row view maps only its prompt's pages;
  * a request whose ``prepare`` fails is failed alone, where the JAX
    scheduler fails the gathered batch;
  * ``counters`` add "prefills" (prefill dispatches), "chunks" and
    "decode_steps" (k a chunk); ``trace`` "disp" events carry (batch, live
    rows, k, ms from dispatch to the host read).

Threads: ``submit()`` from any thread; one scheduler thread runs the loop
under its own ``torch.inference_mode()`` (the mode is per thread) and reads
tokens back once per chunk.
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
from fastvlm_tpu_torch.ops.kv_cache import PagedKVCache, init_paged_cache
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

    @property
    def cancelled(self) -> bool:
        return self.cancel is not None and self.cancel.is_set()


def _round_batch(n: int, caps=(1, 2, 4, 8)) -> int:
    for c in caps:
        if n <= c:
            return c
    return caps[-1]


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


class BatchScheduler:
    """Wraps an Engine; submit() returns an iterator of cumulative-text
    updates like Engine.stream's, each with its stats and finish reason."""

    def __init__(self, engine, *, max_batch: int = 8, window_ms: float = 15.0,
                 page_size: int = 64,
                 pool_tokens: int = 16384,
                 prefix_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None, spec: bool = False,
                 chunk_view: bool = False, persist_view: bool = False,
                 pipeline_depth: int = 1):
        held = {"prefix_cache": bool(prefix_cache),
                "prefill_chunk": bool(prefill_chunk), "spec": spec,
                "chunk_view": chunk_view, "persist_view": persist_view,
                "pipeline_depth": pipeline_depth > 1}
        for name, on in held.items():
            if on:
                raise NotImplementedError(
                    f"BatchScheduler {name} is not yet ported, see ROADMAP.md")
        if engine.device.type == "cuda" and page_size not in PAGE_SIZES:
            raise ValueError(f"page_size {page_size} not in {PAGE_SIZES}, the "
                             f"sizes kernel K3 takes")
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.page_size = page_size
        self.pool = PagePool(max(1, pool_tokens // page_size))
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

    def warmup(self, *args, **kwargs) -> int:
        raise NotImplementedError("BatchScheduler.warmup is not yet ported, "
                                  "see ROADMAP.md")

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

    def _device_tables(self, tables: np.ndarray,
                       row_pages: List[List[int]]) -> torch.Tensor:
        """The block tables the device sees: the host tables (which span the
        pool) cut to the widest row's mapped pages. Every mapped entry lies
        in that prefix; positions past it drop like unmapped ones."""
        w = max([len(p) for p in row_pages] + [1])
        return torch.from_numpy(np.ascontiguousarray(tables[:, :w])).to(
            self.engine.device)

    def _map_prompts(self, ready):
        """Map each prompt's pages, in arrival order. Returns (placed,
        row_pages): the (request, prepared) pairs that got pages, and their
        pages. From the first request the pool cannot hold now, the rest
        wait for the next admission; a prompt larger than the whole pool
        fails alone."""
        placed, row_pages, waiting = [], [], []
        for r, p in ready:
            need = -(-int(p["prompt_tokens"]) // self.page_size)
            if need > self.pool.num_pages:
                r.out.put({"error": (
                    f"prompt of {p['prompt_tokens']} tokens exceeds the page "
                    f"pool ({self.pool.num_pages} pages of {self.page_size})")})
                r.out.put(_SENTINEL)
                continue
            got = None if waiting else self.pool.alloc(need)
            if got is None:
                waiting.append(r)
                continue
            placed.append((r, p))
            row_pages.append(got)
        if waiting:
            self._deferred[:0] = waiting
            if self.trace is not None:
                self.trace.append((time.perf_counter(), "defer", "pool"))
        return placed, row_pages

    def _batch_cache(self, b, row_pages):
        """(cache, tables) of a new batch over the shared pool: row i maps
        ``row_pages[i]``. Pad rows keep an all-(-1) table: their cache
        writes drop into the sink page."""
        engine = self.engine
        cfg = engine.cfg
        if self._pool_kv is None:
            c0 = init_paged_cache(
                cfg.decoder.num_layers, 1, self.pool.num_pages, self.page_size,
                1, cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                engine._dtype, engine.device)
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
                    k, reasons, force=False, budget=None):
        """Chunk-boundary page accounting: free straggler pages of finished
        rows, map pages covering the next k tokens of each active row
        (``cur_len[i]`` = row i's current device length). Exhaustion
        truncates the row (finishes it, reason "truncated") rather than
        stalling the batch. ``force`` pushes the host tables to the device
        even with no new mappings (a just-closed row zeroed its table so its
        later writes drop instead of landing in pages the pool may
        re-issue)."""
        page = self.page_size
        pps = tables.shape[1]
        changed = force
        for i in range(len(finished)):
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
            got = self.pool.alloc(delta)
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

    def _run_batch(self, batch: List[_Request]):
        engine = self.engine
        cfg = engine.cfg
        dev = engine.device
        # requests cancelled while queued never prefill; a request that
        # cannot be prepared fails alone
        ready = []
        for r in batch:
            if r.cancelled:
                self.counters["cancelled"] += 1
                r.out.put(_SENTINEL)
                continue
            try:
                ready.append((r, engine.prepare(r.prompt, r.image)))
            except Exception as e:
                logger.exception("prepare failed")
                r.out.put({"error": str(e)})
                r.out.put(_SENTINEL)
        placed, row_pages = self._map_prompts(ready)
        # in place: requests admitted later join this list, so the failure
        # envelopes of _loop reach them too
        batch[:] = [r for r, _ in placed]
        if not batch:
            return
        n_real = len(batch)
        b = _round_batch(n_real)
        row_pages += [[] for _ in range(b - n_real)]
        try:
            pad_to = max(int(p["ids"].shape[1]) for _, p in placed)
            s = cfg.vision.image_size
            rows, starts_l, imgs = [], [], []
            for _, p in placed:
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
            cache, tables = self._batch_cache(b, row_pages)
        except BaseException:
            for pgs in row_pages:
                self.pool.release(pgs)
            raise

        # full-width chunks always: caps end rows on the host, and page
        # growth covers the overshoot (_grow_pages' cur_len + k target)
        k = engine.chunk
        # cur_len[i] = row i's current device length (prompt + decoded)
        cur_len = [len(r) for r in rows]

        # slot state: slots[i] = the request occupying row i (None = free)
        slots: List[Optional[_Request]] = [
            batch[i] if i < n_real else None for i in range(b)]
        texts: List[List[int]] = [[] for _ in range(b)]
        finished = [slots[i] is None for i in range(b)]
        reasons: List[Optional[str]] = [None] * b
        caps = [slots[i].max_new_tokens if slots[i] else 0 for i in range(b)]
        # per-row page budget: prompt + cap tokens is all a row's kept
        # tokens can ever attend to — growth never maps past it
        budget_tok = [cur_len[i] + caps[i] if slots[i] else 0
                      for i in range(b)]
        emitted = [0] * b
        ttfts = [0.0] * b
        queue_ms = [0.0] * b
        tables_dirty = False  # host tables changed; push at next boundary

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
                                 "finish_reason": reasons[i]}})
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
                budget_tok
            mapping = [i for i in range(b) if slots[i] is not None]
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
            nonlocal tables_dirty
            ht = hd = None  # lazy host copies of (tok, done)
            # bound the admissions per boundary to the requests already
            # waiting when it started, so in-flight rows keep getting decode
            # service under a steady stream of arrivals
            budget = len(self._deferred) + self.queue.qsize()
            while not self._stop and budget > 0:
                budget -= 1
                if self._deferred:
                    r = self._deferred.pop(0)
                else:
                    try:
                        r = self.queue.get_nowait()
                    except queue.Empty:
                        break
                if r.cancelled:
                    self.counters["cancelled"] += 1
                    r.out.put(_SENTINEL)
                    continue
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
                if plen + r.max_new_tokens > tables.shape[1] * self.page_size:
                    self._deferred.append(r)  # more than the pool: next batch
                    break
                need = -(-plen // self.page_size)
                got = self.pool.alloc(need)
                if got is None:
                    self._deferred.append(r)  # pool full; retry next boundary
                    break
                i = slots.index(None)
                tables[i, :] = -1
                tables[i, :need] = got
                row_pages[i] = got
                view = PagedKVCache(
                    k_pages=cache.k_pages, v_pages=cache.v_pages,
                    block_tables=torch.tensor([got], dtype=torch.int32,
                                              device=dev),
                    lengths=torch.zeros((1,), dtype=torch.int32, device=dev))
                wait_ms = (time.perf_counter() - r.t_submit) * 1000
                t0 = time.perf_counter()
                try:
                    logits, view = vlm.prefill(
                        engine.params, cfg, prep["images"], prep["ids"],
                        prep["lens"], prep["starts"], view,
                        vision_embeds=prep["vision_embeds"])
                    self.counters["prefills"] += 1
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
                budget_tok[i] = plen + r.max_new_tokens
                emitted[i] = 0
                cur_len[i] = plen
                ttfts[i] = (time.perf_counter() - t0) * 1000
                queue_ms[i] = wait_ms
                first_token(i, t_new)
                self.counters["admitted"] += 1
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "admit", i, plen,
                                       ttfts[i]))
                ht[i] = t_new
                hd[i] = finished[i] or slots[i] is None
            if ht is not None:
                tok = torch.from_numpy(ht).to(dev)
                done = torch.from_numpy(hd).to(dev)
            return cache, tok, done

        def sweep_cancelled():
            """Abort client-cancelled rows at the chunk boundary: the stream
            closes and pages release via the normal finish path. On the
            device the row behaves like a host-finished row: its writes
            drop through the zeroed table."""
            for i in range(b):
                r = slots[i]
                if r is None or not r.cancelled:
                    continue
                self.counters["cancelled"] += 1
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "cancel", i))
                if not finished[i]:
                    finished[i] = True
                    reasons[i] = "cancelled"
                    emit(i)

        batch_ok = False
        try:
            t0 = time.perf_counter()
            logits, cache = vlm.prefill(
                engine.params, cfg, images, torch.from_numpy(ids).to(dev),
                torch.from_numpy(lens).to(dev),
                torch.from_numpy(starts).to(dev), cache)
            self.counters["prefills"] += 1
            tok = sample_rows(self._gen, logits, row_samp())
            host_tok = tok.cpu().numpy()  # the host read waits for the device
            ttft_ms = (time.perf_counter() - t0) * 1000
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

            while n_active() > 0 or (not self._stop
                                     and not self.queue.empty()):
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "iter",
                                       n_active(), b))
                sweep_cancelled()
                cache, tok, done = try_admit(cache, tok, done)
                cache = self._grow_pages(cache, tables, row_pages, cur_len,
                                         finished, slots, k, reasons,
                                         force=tables_dirty, budget=budget_tok)
                tables_dirty = False
                # pool exhaustion may have truncated rows: close them now
                for i in range(b):
                    if slots[i] is not None and finished[i]:
                        emit(i)
                if n_active() == 0:
                    break
                act_n = n_active()
                t_disp = time.perf_counter()
                toks, done, tok, cache = vlm.decode_chunk(
                    engine.params, cfg, tok, done, cache, self._gen, k=k,
                    eos_ids=engine.eos_ids, row_sampling=row_samp())
                host = toks.cpu().numpy()  # the host read = the device sync
                host_done = done.cpu().numpy()
                dt = time.perf_counter() - t_disp
                self.counters["chunks"] += 1
                self.counters["decode_steps"] += k
                if self.trace is not None:
                    self.trace.append((time.perf_counter(), "disp", b, act_n,
                                       k, dt * 1000))
                for i in range(b):
                    if slots[i] is None:
                        continue
                    for t in host[i]:
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
                    cur_len[i] += k
                    emit(i)
                if n_active() > 0:
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
                self.pool.release(pgs)
            row_pages = [[] for _ in range(b)]
            if not batch_ok:
                # a failed dispatch may have left the pool mid-write (or the
                # device in a bad state): reallocate for the next batch
                self._pool_kv = None

        # safety net: emit() closed every stream on finish; a second
        # sentinel after a close is unread
        for r in batch:
            r.out.put(_SENTINEL)
