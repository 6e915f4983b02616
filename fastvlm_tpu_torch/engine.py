"""Inference engine: the host-side API over the PyTorch pipeline.

Counterpart of ``fastvlm_tpu/engine.py`` on one card. Owns params, config
and tokenizer; builds the prompt, expands the image sentinel, pads to a
length bucket, allocates the dense KV cache, and streams chunked decode with
EOS ids, token-level stop keywords and stop strings. A PIL image under an
anyres config is tiled (a global view + the tiles of its best grid
resolution) and its merged tile features become the prompt's image span; a
list of images fills one ``<image>`` sentinel each, all encoded in one tower
call. Every request gets ``RequestStats``: TTFT (encode + prefill + first
token on the host) and decode time, both ending in a device synchronise on
the card.
Greedy requests may decode speculatively (prompt lookup): ``stream(...,
spec=True)`` and ``generate_spec``; ``generate_beam`` decodes by beam
search. The dense cache is int8 for a decoder with
``kv_cache_dtype="int8"``; quantized decoder linears (``ops/quant.py``)
run as they come. ``build_engine`` loads a HF checkpoint directory or
builds the tiny random model.

Every call that runs the decoder or allocates a KV cache goes through
``Engine.call`` (the registry ``_device_calls``): the engine's own paths,
``serve/batcher.py`` and ``video.py`` alike. Tensor parallelism
(``mesh=``, a (data=1, model=tp) mesh, the port of the JAX engine's
``mesh=`` / ``shard_cache``): each rank holds its pieces of the decoder
(``parallel/sharding.serving_layout``; tower and projector whole) and
sizes every KV cache by its own kv heads (``sharding.kv_heads``). Rank 0
runs the host API; ``call`` sends each device call to the other ranks
first (``parallel/lockstep.py``), which serve it in ``follow()`` until
rank 0's ``close()``. The tower of an anyres or multi-image request runs
on rank 0 alone (its merged features cross with the prefill); a single
image's runs inside the prefill, on every rank. Without a mesh ``call``
makes the call, nothing more.

Used by: predict CLI, serve/batcher.py, video.py, chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fastvlm_tpu_torch.config import FastVLMConfig, resolve_dtype
from fastvlm_tpu_torch.data.constants import DEFAULT_IMAGE_TOKEN, QWEN_IM_END_ID
from fastvlm_tpu_torch.data.conversation import conv_templates
from fastvlm_tpu_torch.data.preprocessing import (
    ImageProcessor, process_anyres_image, process_images,
    select_best_resolution, tokenizer_image_token)
from fastvlm_tpu_torch.models import vlm
from fastvlm_tpu_torch.models.fastvit import fold_layer_scale
from fastvlm_tpu_torch.ops import beam, image_ops
from fastvlm_tpu_torch.ops.anyres import num_merged_tokens
from fastvlm_tpu_torch.ops.kv_cache import init_cache, init_paged_cache
from fastvlm_tpu_torch.ops.sampling import SamplingParams, sample
from fastvlm_tpu_torch.ops.splice import (
    expand_image_ids, expand_image_ids_multi, pad_batch)


# device calls whose results hold new KV planes: the caches' constructors
# and a gathered view of the pool (each rank's own kv heads)
_LOCAL_CALLS = frozenset({"init_cache", "init_paged_cache", "gather_view"})


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class RequestStats:
    ttft_ms: float = 0.0
    decode_tokens: int = 0
    decode_ms: float = 0.0
    prompt_tokens: int = 0
    decode_steps: int = 0  # plain decode steps dispatched (whole chunks)
    # the tower pass prepare() runs for anyres tiles or several images
    # (included in ttft_ms; a single image encodes inside the prefill)
    encode_ms: float = 0.0
    spec_steps: int = 0    # verify passes (speculative decode only)
    spec_accept_rate: float = 0.0

    @property
    def tok_per_s(self) -> float:
        return self.decode_tokens / self.decode_ms * 1000 if self.decode_ms else 0.0

    def as_dict(self) -> Dict[str, float]:
        d = {
            "ttft_ms": round(self.ttft_ms, 2),
            "decode_tokens": self.decode_tokens,
            "tok_per_s": round(self.tok_per_s, 2),
            "prompt_tokens": self.prompt_tokens,
            "decode_steps": self.decode_steps,
        }
        if self.encode_ms:
            d["encode_ms"] = round(self.encode_ms, 2)
        if self.spec_steps:
            d["spec_steps"] = self.spec_steps
            d["spec_accept_rate"] = round(self.spec_accept_rate, 3)
        return d


class Engine:
    def __init__(
        self,
        cfg: FastVLMConfig,
        params: Any,
        tokenizer,
        *,
        conv_mode: str = "qwen_2",
        bucket: int = 64,
        chunk: int = 16,
        eos_ids: Optional[Tuple[int, ...]] = None,
        mesh=None,
    ):
        """``mesh``: a (data=1, model=tp) ``parallel.make_mesh`` mesh on the
        params' device type; every rank of it builds the Engine from the
        whole tree, the ranks after the first then ``follow()``."""
        self.cfg = cfg
        # inference build: fold FastViTHD's layer scales into the adjacent
        # weights (exact; the FFN kernel then skips its layer-scale
        # multiply). A CLIP tower has none.
        self.params = params
        if "stages" in params["vision"]:
            self.params = {**params,
                           "vision": fold_layer_scale(params["vision"])}
        self.device = params["decoder"]["embed"].device
        self.tokenizer = tokenizer
        self.conv_mode = conv_mode
        self.bucket = bucket
        self.chunk = chunk
        self.processor = ImageProcessor(cfg.vision.image_size)
        if eos_ids is None:
            eos = {getattr(tokenizer, "eos_token_id", None)}
            if hasattr(tokenizer, "convert_tokens_to_ids"):
                im_end = tokenizer.convert_tokens_to_ids("<|im_end|>")
                unk = getattr(tokenizer, "unk_token_id", None)
                if im_end is not None and im_end != unk:
                    eos.add(im_end)
            eos_ids = tuple(i for i in eos if i is not None and i >= 0)
            if not eos_ids:
                eos_ids = (QWEN_IM_END_ID,)
        self.eos_ids = tuple(eos_ids)
        self._dtype = resolve_dtype(cfg.decoder.compute_dtype)
        # the dense KV cache's storage: int8 (with scale planes) for a
        # decoder with kv_cache_dtype="int8", else the compute dtype
        self._kv_dtype = vlm.kv_cache_dtype(cfg)
        self.mesh = mesh
        self.group = None      # the mesh's "model" process group
        self.lockstep = None
        self.rank = 0
        self._kv_heads = cfg.decoder.num_kv_heads  # this rank's cache heads
        self._calls = self._device_calls()
        if mesh is not None:
            self._shard(mesh)

    # ---------------- device calls and the mesh ----------------

    def _device_calls(self) -> Dict[str, Any]:
        """The registry of the calls that run the decoder or allocate a KV
        cache: on a mesh, the calls every rank makes."""
        def on_params(module, name):
            # looked up at each call, as a direct call would be
            return lambda *a, **kw: getattr(module, name)(
                self.params, self.cfg, *a, group=self.group, **kw)

        def plain(module, name):
            return lambda *a, **kw: getattr(module, name)(*a, **kw)

        calls = {name: on_params(vlm, name) for name in (
            "prefill", "prefill_continue", "decode_step", "decode_chunk",
            "spec_stream_chunk", "spec_decode", "spec_decode_from_tok",
            "decode_chunk_paged")}
        calls["beam_search"] = on_params(beam, "beam_search")
        for name in ("gather_view", "sync_pool_from_view", "update_view_row"):
            calls[name] = plain(vlm, name)  # the pool's views: no params
        calls["init_cache"] = self._init_cache
        calls["init_paged_cache"] = self._init_paged_cache
        return calls

    def call(self, name: str, *args, **kw):
        """Make the device call ``name`` (``_device_calls``) on this
        engine's params, e.g. ``call("prefill", images, ids, lens, starts,
        cache)`` for ``vlm.prefill(params, cfg, ...)``. On a mesh, rank 0
        sends it to the other ranks first; the results of the calls that
        make new KV planes (``_LOCAL_CALLS``) are rank-local there, and
        cross by handle afterwards."""
        if self.lockstep is not None:
            return self.lockstep.call(name, args, kw,
                                      local=name in _LOCAL_CALLS)
        return self._calls[name](*args, **kw)

    def new_cache(self, batch: int, max_len: int, dtype=None):
        """A dense KV cache over this rank's kv heads, in the engine's KV
        dtype unless ``dtype`` is given."""
        return self.call("init_cache", batch, max_len, dtype)

    def new_pool(self, num_pages: int, page_size: int):
        """A paged KV pool of ``num_pages`` pages (plus the sink) over this
        rank's kv heads, in the compute dtype, with a 1-row empty table."""
        return self.call("init_paged_cache", num_pages, page_size)

    def _init_cache(self, batch, max_len, dtype=None):
        dec = self.cfg.decoder
        return init_cache(dec.num_layers, batch, max_len, self._kv_heads,
                          dec.head_dim, dtype or self._kv_dtype, self.device)

    def _init_paged_cache(self, num_pages, page_size):
        dec = self.cfg.decoder
        return init_paged_cache(dec.num_layers, 1, num_pages, page_size, 1,
                                self._kv_heads, dec.head_dim, self._dtype,
                                self.device)

    def _shard(self, mesh) -> None:
        """Cut the params to this rank's pieces and open the lockstep
        channel (collective: every rank of the world calls it)."""
        import torch.distributed as dist

        from fastvlm_tpu_torch.models.qwen2 import split_fused_layer
        from fastvlm_tpu_torch.parallel import collectives as coll
        from fastvlm_tpu_torch.parallel.lockstep import Lockstep
        from fastvlm_tpu_torch.parallel.mesh import (
            DATA_AXIS, MODEL_AXIS, axis_group, axis_size)
        from fastvlm_tpu_torch.parallel.sharding import (
            kv_heads, serving_layout)

        if axis_size(mesh, DATA_AXIS) != 1:
            raise ValueError(f"Engine(mesh=): serving takes a (data=1, "
                             f"model=tp) mesh, got data="
                             f"{axis_size(mesh, DATA_AXIS)}")
        if mesh.device_type != self.device.type:
            raise ValueError(f"Engine(mesh=): the mesh is on "
                             f"{mesh.device_type!r} but the params on "
                             f"{self.device.type!r}")
        tp = axis_size(mesh, MODEL_AXIS)
        params = self.params
        if tp > 1:
            # the layout splits q / k / v and gate / up apart
            dec = params["decoder"]
            params = {**params, "decoder": {**dec, "layers": [
                split_fused_layer(lp, self.cfg.decoder)
                for lp in dec["layers"]]}}
        self.params = serving_layout(params, self.cfg, mesh).shard(params)
        self.group = axis_group(mesh, MODEL_AXIS)
        self.rank = coll.rank(self.group)
        self._kv_heads = len(kv_heads(self.cfg.decoder, tp, self.rank))
        self.lockstep = Lockstep(self._calls,
                                 dist.get_process_group_ranks(self.group),
                                 self.device)

    @property
    def is_leader(self) -> bool:
        """Whether this rank runs the host API (rank 0 of the mesh, or the
        only rank)."""
        return self.rank == 0

    def follow(self) -> None:
        """A rank after the first: make rank 0's device calls until its
        ``close()``."""
        if self.lockstep is None or self.is_leader:
            raise RuntimeError("Engine.follow: only the ranks after the "
                               "first of a mesh follow")
        with torch.inference_mode():
            self.lockstep.follow()

    def close(self) -> None:
        """Rank 0 of a mesh: release the followers (a no-op elsewhere)."""
        if self.lockstep is not None and self.is_leader:
            self.lockstep.stop()

    # ---------------- prompt/image preparation ----------------

    def build_prompt(self, user_prompt: str, system: Optional[str] = None) -> str:
        conv = conv_templates[self.conv_mode].copy()
        if system is not None:
            conv.system = system
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + user_prompt)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def prepare_array_image(self, image) -> torch.Tensor:
        """(H, W, 3) / (B, H, W, 3) array or tensor of any size -> (B, S, S,
        3) model-dtype images on the engine's device. uint8 is rescaled by
        1/255; float numpy input whose max exceeds 1.5 is taken as [0, 255]
        and rescaled; other float input is taken as [0, 1]. The array goes
        to the device as it is (a uint8 frame in a quarter of f32's bytes);
        a non-native size is then padded / resized there
        (``ops/image_ops.preprocess``), so the encoder always emits
        ``num_image_tokens`` tokens."""
        scale255 = (isinstance(image, np.ndarray) and image.dtype.kind == "f"
                    and image.size > 0 and float(image.max()) > 1.5)
        arr = torch.as_tensor(np.asarray(image) if isinstance(image, np.ndarray)
                              else image)
        if arr.dim() == 3:
            arr = arr[None]
        arr = arr.to(self.device)
        if scale255:
            arr = arr.float() / 255.0
        s = self.cfg.vision.image_size
        if tuple(arr.shape[-3:-1]) != (s, s):
            mode = "pad" if self.cfg.image_aspect_ratio == "pad" else "none"
            arr = image_ops.preprocess(arr, s, mode)
        else:
            arr = image_ops.rescale(arr)
        return arr.to(self._dtype)

    def prepare(self, prompt: str, image=None) -> Dict[str, Any]:
        """prompt: full template string (may contain <image>); image: PIL,
        NHWC array/tensor, a list of them (one per ``<image>``), or None.
        Returns the prefill inputs on the device, with the host counts
        ``prompt_tokens`` and ``encode_ms``.

        anyres mode (cfg.image_aspect_ratio == 'anyres' with grid pinpoints,
        a PIL image): the image becomes [global view + tiles], the sentinel
        expands to the merged token count, and the merged tile features come
        back as ``vision_embeds`` (the tower runs here, once over the stack,
        timed as ``encode_ms``). An array under an anyres config is resized
        to one image of ``num_image_tokens``, as in the JAX engine."""
        cfg = self.cfg
        if isinstance(image, (list, tuple)) and len(image) > 1:
            return self._prepare_multi(prompt, list(image))
        if isinstance(image, (list, tuple)):
            image = image[0] if image else None
        anyres_mode = (cfg.image_aspect_ratio == "anyres"
                       and cfg.image_grid_pinpoints
                       and image is not None and hasattr(image, "convert"))
        images = vision_embeds = None
        encode_ms = 0.0
        n_img_tokens = cfg.num_image_tokens
        if anyres_mode:
            s = cfg.vision.image_size
            best = select_best_resolution(image.size,
                                          list(cfg.image_grid_pinpoints))
            tiles = process_anyres_image(image, self.processor,
                                         cfg.image_grid_pinpoints)
            grid_shape = (best[0] // s, best[1] // s)
            n_img_tokens = num_merged_tokens(
                grid_shape, cfg.vision.grid_size, cfg.mm_patch_merge_type,
                image.size)
            vision_embeds, encode_ms = self._timed(
                self._encode_tiles,
                torch.as_tensor(tiles).to(self.device, self._dtype),
                grid_shape, tuple(image.size))
        elif image is not None:
            if hasattr(image, "convert"):  # PIL
                images = torch.as_tensor(
                    process_images([image], self.processor, self.cfg)
                ).to(self.device, self._dtype)
            else:
                images = self.prepare_array_image(image)
        ids = tokenizer_image_token(prompt, self.tokenizer)
        row, start = expand_image_ids(ids, n_img_tokens)
        pad_to = -(-(len(row) + 1) // self.bucket) * self.bucket
        ids_a, lens, starts = pad_batch([row], [start], pad_to)
        return {
            "images": images,
            "vision_embeds": vision_embeds,
            "ids": torch.as_tensor(ids_a).to(self.device),
            "lens": torch.as_tensor(lens).to(self.device),
            "starts": torch.as_tensor(starts).to(self.device),
            "prompt_tokens": int(lens[0]),
            "encode_ms": encode_ms,
        }

    def _prepare_multi(self, prompt: str, images_list) -> Dict[str, Any]:
        """Multi-image prompts: one ``<image>`` sentinel per image; the tower
        encodes all images in one call and each span is overlaid with its
        image's tokens (``vision_embeds`` (1, M, N, D), starts (1, M))."""
        cfg = self.cfg
        ids = tokenizer_image_token(prompt, self.tokenizer)
        row, starts = expand_image_ids_multi(ids, cfg.num_image_tokens)
        if len(starts) != len(images_list):
            raise ValueError(
                f"{len(images_list)} images but {len(starts)} <image> tokens")
        pad_to = -(-(len(row) + 1) // self.bucket) * self.bucket
        ids_a, lens, _ = pad_batch([row], [0], pad_to)
        proc = torch.cat([
            torch.as_tensor(process_images([im], self.processor, cfg)).to(
                self.device, self._dtype)
            if hasattr(im, "convert") else self.prepare_array_image(im)
            for im in images_list
        ])
        vis, encode_ms = self._timed(self._encode_multi, proc)
        return {
            "images": None,
            "vision_embeds": vis[None],
            "ids": torch.as_tensor(ids_a).to(self.device),
            "lens": torch.as_tensor(lens).to(self.device),
            "starts": torch.as_tensor(np.asarray([starts], np.int32)).to(
                self.device),
            "prompt_tokens": int(lens[0]),
            "encode_ms": encode_ms,
        }

    def _timed(self, fn, *args):
        """(fn(*args), its ms on the host clock, ending in a device
        synchronise)."""
        _sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(self.device)
        return out, (time.perf_counter() - t0) * 1000

    def _encode_multi(self, images: torch.Tensor) -> torch.Tensor:
        """(M, S, S, 3) -> (M, N, hidden): every image in one tower call."""
        return vlm.encode_images(self.params, self.cfg, images)

    def _encode_tiles(self, tiles: torch.Tensor, grid_shape, original_size):
        """AnyRes encode -> (1, N, hidden): the tower and projector once over
        the whole [global + tiles] stack (``vlm.encode_tile_grids``), then
        the merge with the host's crop box."""
        grids = vlm.encode_tile_grids(self.params, self.cfg, tiles)
        crop_box = vlm.anyres_crop_box(self.cfg, grid_shape, original_size)
        return vlm.merge_tile_grids(self.params, self.cfg, grids, grid_shape,
                                    crop_box)

    # ---------------- generation ----------------

    @torch.inference_mode()
    def stream(
        self,
        prompt: str,
        image=None,
        *,
        max_new_tokens: Optional[int] = None,
        sampling: SamplingParams = SamplingParams(),
        stop_strings: Sequence[str] = (),
        seed: Optional[int] = None,
        spec: bool = False,
        draft_k: int = 8,
    ) -> Iterator[Dict[str, Any]]:
        """Yields {"text": full_text_so_far, "stats": {...}} dicts: one after
        the first token, then one per decode chunk. ``spec=True`` (greedy
        only) decodes each chunk as ceil(chunk / (draft_k + 1)) speculative
        verify passes (``vlm.spec_stream_chunk``): the same tokens, one host
        read a dispatch."""
        cfg = self.cfg
        max_new = max_new_tokens or cfg.max_new_tokens
        if spec and sampling.temperature > 0:
            raise ValueError("spec streaming is greedy-only (temperature 0)")
        kw_ids = self._keyword_token_ids(stop_strings)
        inputs = self.prepare(prompt, image)
        ids = inputs["ids"]
        b, t = ids.shape
        stats = RequestStats(prompt_tokens=inputs["prompt_tokens"],
                             encode_ms=inputs["encode_ms"])

        # decode dispatches FULL chunk-wide chunks (the tail is cut on the
        # host), so the cache is sized for n_chunks * chunk writes; a verify
        # pass writes draft_k + 1 slots past the committed length
        n_chunks = -(-max_new // self.chunk)
        cache = self.new_cache(b, (vlm.spec_cache_len(t, max_new, draft_k)
                                   if spec else t + n_chunks * self.chunk))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else time.time_ns() % 2**31)

        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self.call("prefill", inputs["images"], ids,
                                  inputs["lens"], inputs["starts"], cache,
                                  vision_embeds=inputs["vision_embeds"])
        tok = sample(gen, logits, sampling)
        first = int(tok[0])  # the host read waits for the device
        stats.ttft_ms = inputs["encode_ms"] + (time.perf_counter() - t0) * 1000

        out_ids: List[int] = [] if first in self.eos_ids else [first]
        done_host = first in self.eos_ids
        for kid in kw_ids:
            if out_ids and out_ids[-len(kid):] == kid:
                del out_ids[-len(kid):]
                done_host = True
        done = torch.tensor([done_host], device=self.device)
        yield {"text": self._decode_text(out_ids), "stats": stats.as_dict()}

        t_dec = time.perf_counter()
        emitted = 1
        decode_tokens = 0  # chunk slots actually consumed (incl. the EOS)

        def consume(tokens) -> bool:
            """Append host tokens to out_ids; True => stop (EOS, or the tail
            matches a stop keyword's token ids)."""
            nonlocal decode_tokens
            for tk in tokens:
                tk = int(tk)
                decode_tokens += 1
                if tk in self.eos_ids:
                    return True
                out_ids.append(tk)
                for kid in kw_ids:
                    if out_ids[-len(kid):] == kid:
                        del out_ids[-len(kid):]
                        return True
            return False

        def emit(stop: bool):
            """(stop, update) after a dispatch: stop strings cut the text
            and end the stream."""
            stats.decode_tokens = decode_tokens
            stats.decode_ms = (time.perf_counter() - t_dec) * 1000
            text = self._decode_text(out_ids)
            for s in stop_strings:
                if s and s in text:
                    text = text.split(s)[0]
                    stop = True
            return stop, {"text": text, "stats": stats.as_dict()}

        if spec:
            # m verify passes a dispatch commit m..m*(draft_k+1) tokens; the
            # host reads the tokens and counts once a dispatch
            carry = vlm.spec_carry_init(cfg, tok, cache, ids, inputs["lens"],
                                        max_new_tokens=max_new,
                                        draft_k=draft_k, eos_ids=self.eos_ids)
            m = max(1, -(-self.chunk // (draft_k + 1)))
            while not done_host and emitted < max_new:
                toks, counts, carry = self.call(
                    "spec_stream_chunk", carry, m=m, max_new_tokens=max_new,
                    eos_ids=self.eos_ids, draft_k=draft_k)
                host = torch.cat([counts[:, None], toks], dim=1)[0].tolist()
                n = host[0]
                if n == 0:  # the row finished on an earlier dispatch
                    break
                emitted += n
                stats.spec_steps += m  # passes dispatched
                # each pass commits one token besides its accepted drafts,
                # so accepted ~ committed - passes (a lower bound: a pass
                # after the row finished commits nothing); generate_spec
                # counts exactly on the device, the stream on the host
                stats.spec_accept_rate = (
                    max(0, emitted - 1 - stats.spec_steps)
                    / max(1, stats.spec_steps * draft_k))
                done_host, update = emit(consume(host[1:1 + n]))
                yield update
            return

        while not done_host and emitted < max_new:
            take = min(self.chunk, max_new - emitted)
            toks, done, tok, cache = self.call(
                "decode_chunk", tok, done, cache, gen, k=self.chunk,
                eos_ids=self.eos_ids, sampling=sampling)
            stats.decode_steps += self.chunk
            host_toks = toks[0].cpu().tolist()[:take]
            emitted += take
            done_host, update = emit(consume(host_toks) or bool(done[0]))
            yield update

    def generate(self, prompt: str, image=None, **kw) -> Tuple[str, Dict[str, Any]]:
        last = {"text": "", "stats": {}}
        for last in self.stream(prompt, image, **kw):
            pass
        return last["text"], last["stats"]

    @torch.inference_mode()
    def generate_spec(
        self,
        prompt: str,
        image=None,
        *,
        max_new_tokens: Optional[int] = None,
        draft_k: int = 8,
        stop_strings: Sequence[str] = (),
    ) -> Tuple[str, Dict[str, Any]]:
        """Greedy generate with prompt-lookup speculative decoding
        (``vlm.spec_decode``): the tokens of greedy ``generate`` in fewer
        decoder passes, each committing 1..draft_k+1 tokens. Stop keywords
        and strings cut the finished answer once, at the earliest stop.
        ``decode_ms`` runs from the prefill's start (TTFT is not split out,
        as in the JAX engine)."""
        cfg = self.cfg
        max_new = max_new_tokens or cfg.max_new_tokens
        inputs = self.prepare(prompt, image)
        ids, lens = inputs["ids"], inputs["lens"]
        b, t = ids.shape
        stats = RequestStats(prompt_tokens=inputs["prompt_tokens"],
                             encode_ms=inputs["encode_ms"])
        cache = self.new_cache(b, vlm.spec_cache_len(t, max_new, draft_k))
        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self.call("prefill", inputs["images"], ids, lens,
                                  inputs["starts"], cache,
                                  vision_embeds=inputs["vision_embeds"])
        res = self.call("spec_decode", logits, cache, ids, lens,
                        max_new_tokens=max_new, eos_ids=self.eos_ids,
                        draft_k=draft_k)
        n = int(res.num_generated[0])
        toks = res.tokens[0, :n].tolist()
        stats.decode_ms = (time.perf_counter() - t0) * 1000
        stats.decode_tokens = n
        stats.spec_steps = res.steps
        stats.spec_accept_rate = (int(res.accepted)
                                  / max(1, int(res.drafted)))
        if toks and toks[-1] in self.eos_ids:
            toks = toks[:-1]
        # spec commits whole spans: one cut at the earliest stop site
        for kid in self._keyword_token_ids(stop_strings):
            for i in range(len(toks) - len(kid) + 1):
                if toks[i:i + len(kid)] == kid:
                    toks = toks[:i]
                    break
        text = self._decode_text(toks)
        for s in stop_strings:
            if s and s in text:
                text = text.split(s)[0]
        return text, stats.as_dict()

    @torch.inference_mode()
    def generate_beam(
        self,
        prompt: str,
        image=None,
        *,
        num_beams: int = 4,
        max_new_tokens: Optional[int] = None,
        length_penalty: float = 1.0,
    ) -> Tuple[str, Dict[str, Any]]:
        """Deterministic beam-search generate (``ops/beam.beam_search``: W
        beams folded into the batch axis of the dense cache, a fixed
        max_new_tokens - 1 steps after the prefill). Prefill and search run
        as one chain read once at the end, so ``ttft_ms`` and ``decode_ms``
        both cover the whole of it; ``decode_tokens`` is the chosen
        hypothesis's length."""
        cfg = self.cfg
        max_new = max_new_tokens or cfg.max_new_tokens
        inputs = self.prepare(prompt, image)
        ids, lens = inputs["ids"], inputs["lens"]
        b, t = ids.shape
        stats = RequestStats(prompt_tokens=inputs["prompt_tokens"],
                             encode_ms=inputs["encode_ms"])
        cache = self.new_cache(b, t + max_new)
        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = self.call("prefill", inputs["images"], ids, lens,
                                  inputs["starts"], cache,
                                  vision_embeds=inputs["vision_embeds"])
        res = self.call("beam_search", logits, cache, num_beams=num_beams,
                        max_new_tokens=max_new, eos_ids=self.eos_ids,
                        length_penalty=length_penalty)
        n = int(res.lengths[0])  # the host's one read
        toks = res.tokens[0, :n].tolist()
        stats.ttft_ms = inputs["encode_ms"] + (time.perf_counter() - t0) * 1000
        stats.decode_ms = stats.ttft_ms
        stats.decode_tokens = n
        if toks and toks[-1] in self.eos_ids:
            toks = toks[:-1]
        return self._decode_text(toks), stats.as_dict()

    def chat(self, user_prompt: str, image=None, **kw):
        """Convenience: wraps user_prompt in the conversation template."""
        return self.generate(self.build_prompt(user_prompt), image, **kw)

    def prefill_suffix(self, images, ids, lens, starts, offset: int, cache):
        """Suffix prefill after ``offset`` cached prefix tokens
        (``vlm.prefill_continue``): the scheduler's prefix-cache hits and
        admission chunks, and the video path's frames. Returns (logits,
        cache)."""
        return self.call("prefill_continue", images, ids, lens, starts,
                         offset, cache)

    # ---------------- internals ----------------

    def _keyword_token_ids(self, stop_strings) -> List[List[int]]:
        """Tokenize each stop keyword, dropping a leading BOS; the output
        tail is compared token for token during decode."""
        out: List[List[int]] = []
        bos = getattr(self.tokenizer, "bos_token_id", None)
        for s in stop_strings:
            if not s:
                continue
            enc = self.tokenizer(s)
            ids = list(getattr(enc, "input_ids", enc))
            if len(ids) > 1 and bos is not None and ids[0] == bos:
                ids = ids[1:]
            if ids:
                out.append([int(i) for i in ids])
        return out

    def _decode_text(self, ids: List[int]) -> str:
        if not ids:
            return ""
        return self.tokenizer.decode(ids, skip_special_tokens=True)


def tiny_config():
    """The tiny random configuration of ``build_engine(random_tiny=True)``
    (the JAX package's, so the two engines can be compared)."""
    from fastvlm_tpu_torch.config import FastViTConfig, ProjectorConfig, Qwen2Config

    vision = FastViTConfig(layers=(1, 1, 1, 1, 1),
                           embed_dims=(8, 16, 32, 64, 128),
                           image_size=256, attn_head_dim=16)
    decoder = Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          intermediate_size=128)
    return FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=ProjectorConfig(mm_hidden_size=vision.out_channels,
                                  hidden_size=64))


def _with_dtype(cfg: FastVLMConfig, dtype: str) -> FastVLMConfig:
    """The config with the decoder's param and compute dtypes set to
    ``dtype``, and the vision tower's where its config has them (FastViTHD;
    a CLIP tower computes in its input's dtype, which is the decoder's
    compute dtype, and the projector in its input's)."""
    kw = {"param_dtype": dtype, "compute_dtype": dtype}
    vision = cfg.vision
    if hasattr(vision, "compute_dtype"):
        vision = dataclasses.replace(vision, **kw)
    return dataclasses.replace(
        cfg, vision=vision, decoder=dataclasses.replace(cfg.decoder, **kw))


def build_engine(model_path: Optional[str] = None, *, random_tiny: bool = False,
                 dtype: str = "bfloat16", device: str = "cuda", seed: int = 0,
                 tokenizer=None, **engine_kw) -> Engine:
    """Build an Engine on ``device``: the CUDA card unless the caller asks
    for "cpu" (the kernels' plain versions).

    ``model_path``: a HF checkpoint directory (config.json + safetensors or
    pytorch_model.bin; ``utils/checkpoint.load_vlm``), loaded in ``dtype``,
    which the model also computes in (the JAX package's ``build_engine``
    keeps config.json's float32 compute dtype and casts only the params).
    ``tokenizer`` (a port-only keyword) replaces the HF tokenizer that is
    otherwise ``transformers.AutoTokenizer.from_pretrained(model_path)``: a
    machine without ``transformers`` passes its own, and without one the
    import raises. ``random_tiny=True``: the tiny random model (weights
    from ``seed``, byte tokenizer, float32). ``engine_kw`` go to
    ``Engine``: ``mesh=`` makes a tensor-parallel engine, each rank
    building it from the whole weights."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"build_engine: device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_engine: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    if not random_tiny:
        from fastvlm_tpu_torch.utils.checkpoint import load_vlm
        from fastvlm_tpu_torch.utils.convert import to_device

        cfg, params = load_vlm(model_path, dtype=resolve_dtype(dtype))
        params = to_device(params, device)
        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(model_path)
        return Engine(_with_dtype(cfg, dtype), params, tokenizer, **engine_kw)
    from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer

    cfg = tiny_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = vlm.init(gen, cfg, device)
    tok = ByteTokenizer()
    engine_kw.setdefault("eos_ids", (tok.eos_token_id,))
    return Engine(cfg, params, tok, **engine_kw)
