"""Streaming video-frame QA: a fixed question over a stream of frames, with
the prompt prefix's KV reused across frames.

Counterpart of ``fastvlm_tpu/video.py`` (the reference app's camera loop:
one frame at a time, a fixed question, a whole answer per frame, TTFT per
frame):

  * the prompt before the image span (system + user header) is prefilled
    ONCE into one persistent dense cache; each frame encodes its image and
    runs only the suffix prefill (``vlm.prefill_continue``, through
    ``Engine.prefill_suffix``) and decode. The suffix rewrites the cache
    from the image span on, and the lengths reset, so nothing of the last
    frame leaks;
  * ``ask`` reads the host twice a frame: the first token (TTFT), then all
    decode chunks at once (plus one ``done`` read halfway for budgets over
    64 tokens);
  * ``dispatch`` / ``finish`` split a frame in two: ``dispatch`` queues
    encode, prefill and every decode chunk and reads nothing back, so a
    caller can queue frame N+1 before it reads frame N (``qa_over_stream(
    pipelined=True)``). The card runs the queued work in order on one
    stream, so frame N's tokens are final before N+1 rewrites the cache;
  * ``spec=True`` (greedy only) decodes each frame by prompt-lookup
    speculative decoding (``vlm.spec_decode_from_tok``) over a draft corpus
    of [prompt | the previous frame's answer]: consecutive frames tend to
    answer alike, so whole spans verify in one pass. It stops at EOS. The
    JAX loop checks ``done`` on the device; here the host reads it once a
    verify pass, so a spec ``dispatch`` reads the device (its tokens are
    still read by ``finish``).

Frames are PIL images or (H, W, 3) arrays of any size; arrays go to the
device as they are and are resized there (``Engine.prepare_array_image``).

The device calls go through ``engine.call`` (the cache's constructor, the
prefills, decode chunks and spec decodes), so a tensor-parallel engine
serves VideoQA on rank 0 while the other ranks follow.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Iterator, Tuple

import numpy as np
import torch

from fastvlm_tpu_torch.data.preprocessing import (
    process_images, tokenizer_image_token)
from fastvlm_tpu_torch.ops.sampling import SamplingParams, sample
from fastvlm_tpu_torch.ops.splice import expand_image_ids, pad_batch


class VideoQA:
    """Fixed-question QA over a stream of frames, with prefix KV reuse."""

    def __init__(self, engine, question: str, *, max_new_tokens: int = 48,
                 sampling: SamplingParams = SamplingParams(),
                 spec: bool = False, draft_k: int = 8):
        if spec and sampling.temperature > 0:
            raise ValueError("spec video decode is greedy-only "
                             "(temperature must be 0)")
        self.engine = engine
        self.cfg = cfg = engine.cfg
        self.max_new_tokens = max_new_tokens
        self.sampling = sampling
        self.spec = spec
        self.draft_k = draft_k
        dev = engine.device

        ids = tokenizer_image_token(engine.build_prompt(question),
                                    engine.tokenizer)
        row, start = expand_image_ids(ids, cfg.num_image_tokens)
        if start <= 0:
            raise ValueError("the video QA prompt must have text before "
                             "<image>")
        self.prefix_len = start
        suffix = row[start:]
        bucket = -(-len(suffix) // 64) * 64
        suf_ids, suf_lens, _ = pad_batch([suffix], [0], bucket)
        self.suffix_ids = torch.as_tensor(suf_ids).to(dev)
        self.suffix_lens = torch.as_tensor(suf_lens).to(dev)
        self.suffix_starts = torch.zeros((1,), dtype=torch.int32,
                                         device=dev)  # image at suffix 0
        # a verify pass writes draft_k + 1 slots past the committed length
        slack = draft_k + 1 if spec else 0
        self.cache = engine.new_cache(1, start + bucket + max_new_tokens
                                      + slack)
        if spec:
            # draft corpus = [prompt row | the previous frame's answer at
            # start + bucket]; the answer region is rewritten every frame
            self._answer_off = start + bucket
            corpus = np.zeros((1, self._answer_off + max_new_tokens),
                              np.int32)
            corpus[0, :len(row)] = row
            self._corpus = torch.from_numpy(corpus).to(dev)
            self._corpus_lens = torch.tensor([len(row)], dtype=torch.int32,
                                             device=dev)
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(time.time_ns() % 2**31)
        self._eos = torch.tensor(engine.eos_ids, dtype=torch.int32,
                                 device=dev)

        # the prefix, once (it has no image)
        pre_ids, pre_lens, pre_starts = pad_batch(
            [np.asarray(row[:start], np.int32)], [-1], start)
        with torch.inference_mode():
            _, self.cache = engine.call(
                "prefill", None, torch.as_tensor(pre_ids).to(dev),
                torch.as_tensor(pre_lens).to(dev),
                torch.as_tensor(pre_starts).to(dev), self.cache)

    def _images(self, frame) -> torch.Tensor:
        engine = self.engine
        if hasattr(frame, "convert"):  # PIL
            return torch.as_tensor(process_images(
                [frame], engine.processor, self.cfg)).to(engine.device,
                                                         engine._dtype)
        # arrays go to the device as they are (uint8: a quarter of f32's
        # bytes) and are rescaled, and resized if need be, there
        return engine.prepare_array_image(frame)

    def _suffix_prefill(self, images):
        """Encode + suffix prefill + first-token sample; the cache is
        rewritten from the image span on and its lengths reset."""
        logits, cache = self.engine.prefill_suffix(
            images, self.suffix_ids, self.suffix_lens, self.suffix_starts,
            self.prefix_len, self.cache)
        return sample(self._gen, logits, self.sampling), cache

    def _decode_chunk(self, tok, done, cache, emitted):
        k = min(self.engine.chunk, self.max_new_tokens - emitted)
        toks, done, tok, cache = self.engine.call(
            "decode_chunk", tok, done, cache, self._gen, k=k,
            eos_ids=self.engine.eos_ids, sampling=self.sampling)
        return toks, done, tok, cache, emitted + k

    def _answer(self, first: int, chunks) -> list:
        """The answer's ids: the first token, then the chunks' up to EOS."""
        eos = self.engine.eos_ids
        out = [] if first in eos else [first]
        if out and chunks:
            for tk in torch.cat(chunks, dim=1)[0].cpu().tolist():
                if tk in eos:
                    break
                out.append(tk)
        return out

    def _result(self, out, t0, ttft_ms, steps) -> Tuple[str, Dict[str, Any]]:
        text = self.engine.tokenizer.decode(
            out, skip_special_tokens=True).strip()
        return text, {"ttft_ms": round(ttft_ms, 2),
                      "total_ms": round((time.perf_counter() - t0) * 1000, 2),
                      "tokens": len(out), "decode_steps": steps}

    def _spec_dispatch(self, tok, cache) -> torch.Tensor:
        """Spec decode of a frame from its first token, then the corpus
        reseeded with this answer; returns the packed row [num, steps,
        accepted, drafted, tokens...] for one host read."""
        res = self.engine.call(
            "spec_decode_from_tok", tok, cache, self._corpus,
            self._corpus_lens, max_new_tokens=self.max_new_tokens,
            eos_ids=self.engine.eos_ids, draft_k=self.draft_k)
        off = self._answer_off
        self._corpus[:, off:] = res.tokens
        self._corpus_lens = off + res.num_generated
        meta = torch.stack([res.num_generated[0],
                            torch.tensor(res.steps, dtype=torch.int32,
                                         device=tok.device),
                            res.accepted, res.drafted])
        return torch.cat([meta[None], res.tokens], dim=1)

    def _spec_result(self, packed, t0, ttft_ms=None):
        """Unpack a frame's spec row (one host read). ``ttft_ms`` None: the
        first token became available with that read."""
        host = packed[0].tolist()
        if ttft_ms is None:
            ttft_ms = (time.perf_counter() - t0) * 1000
        num, steps, accepted, drafted = host[:4]
        out = host[4:4 + num]
        eos = self.engine.eos_ids
        if out and out[0] in eos:
            out = []
        elif out and out[-1] in eos:
            out = out[:-1]
        text, stats = self._result(out, t0, ttft_ms, 0)
        stats["spec_steps"] = steps
        stats["spec_accept_rate"] = round(accepted / max(1, drafted), 3)
        return text, stats

    @torch.inference_mode()
    def ask(self, frame) -> Tuple[str, Dict[str, Any]]:
        """frame: PIL image or (H, W, 3) array. Returns (answer, stats)."""
        images = self._images(frame)
        t0 = time.perf_counter()
        tok, cache = self._suffix_prefill(images)
        first = int(tok[0])  # the host read waits for the device
        ttft_ms = (time.perf_counter() - t0) * 1000
        eos = first in self.engine.eos_ids
        if self.spec:
            return self._spec_result(self._spec_dispatch(tok, cache), t0,
                                     ttft_ms)
        done = torch.tensor([eos], device=tok.device)
        chunks, emitted, mid_checked = [], 1, False
        # the first token already EOS (known on the host): decode nothing
        while not eos and emitted < self.max_new_tokens:
            toks, done, tok, cache, emitted = self._decode_chunk(
                tok, done, cache, emitted)
            chunks.append(toks)
            # large budgets: one read halfway bounds the decode wasted past
            # EOS to about half the budget
            if (self.max_new_tokens > 64 and not mid_checked
                    and emitted * 2 >= self.max_new_tokens):
                mid_checked = True
                if bool(done[0]):
                    break
        self.cache = cache
        return self._result(self._answer(first, chunks), t0, ttft_ms,
                            emitted - 1)

    @torch.inference_mode()
    def dispatch(self, frame) -> Dict[str, Any]:
        """Queue a frame's whole computation and read nothing back: the
        first-token EOS decision stays on the device (decode_chunk's
        ``done`` mask). ``finish`` reads the result. With ``spec=True`` the
        verify loop reads ``done`` once a pass (module docstring); the
        answer's tokens still wait for ``finish``."""
        images = self._images(frame)
        t0 = time.perf_counter()
        first, cache = self._suffix_prefill(images)
        if self.spec:
            # an EOS first token ends the loop before any pass (num = 1)
            return {"t0": t0, "packed": self._spec_dispatch(first, cache)}
        done = torch.isin(first, self._eos)
        tok, chunks, emitted = first, [], 1
        while emitted < self.max_new_tokens:
            toks, done, tok, cache, emitted = self._decode_chunk(
                tok, done, cache, emitted)
            chunks.append(toks)
        self.cache = cache
        return {"t0": t0, "first": first, "chunks": chunks,
                "steps": emitted - 1}

    def finish(self, state: Dict[str, Any]) -> Tuple[str, Dict[str, Any]]:
        """Read a dispatched frame's tokens. ``ttft_ms`` is the time to the
        first token being AVAILABLE on the host: in pipelined use the read
        may come after later frames were queued, so it includes that
        queueing."""
        if "packed" in state:
            return self._spec_result(state["packed"], state["t0"])
        first = int(state["first"][0])
        ttft_ms = (time.perf_counter() - state["t0"]) * 1000
        return self._result(self._answer(first, state["chunks"]),
                            state["t0"], ttft_ms, state["steps"])


def qa_over_stream(video_qa: VideoQA, frames: Iterable,
                   latest_only: bool = True,
                   pipelined: bool = False
                   ) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """Drive VideoQA over a frame iterable. ``latest_only``: frames that
    arrive while a generation is in flight are dropped except the newest
    (the app's bufferingNewest(1)); over a plain iterable that is the next
    one. ``pipelined``: frame N+1 is dispatched before frame N's results
    are read (double buffering), every frame answered."""
    it = iter(frames)
    if pipelined:
        prev = None
        for frame in it:
            state = video_qa.dispatch(frame)
            if prev is not None:
                yield video_qa.finish(prev)
            prev = state
        if prev is not None:
            yield video_qa.finish(prev)
        return
    end = object()
    frame = next(it, end)
    while frame is not end:
        yield video_qa.ask(frame)
        # with latest_only a camera source hands over only the newest frame
        # queued during the generation; a plain iterable queues nothing, so
        # either way the next frame is the next item
        frame = next(it, end)
