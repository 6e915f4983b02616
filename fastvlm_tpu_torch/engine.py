"""Inference engine: the host-side API over the PyTorch pipeline.

Counterpart of the single-image path of ``fastvlm_tpu/engine.py``. Owns
params, config and tokenizer; builds the prompt, expands the image sentinel,
pads to a length bucket, allocates the dense KV cache, and streams chunked
decode with EOS ids, token-level stop keywords and stop strings. Every
request gets ``RequestStats``: TTFT (encode + prefill + first token on the
host) and decode time, both ending in a device synchronise on the card.

Used by: predict CLI, serve/batcher.py, chip_smoke.py.
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
    ImageProcessor, process_images, tokenizer_image_token)
from fastvlm_tpu_torch.models import vlm
from fastvlm_tpu_torch.models.fastvit import fold_layer_scale
from fastvlm_tpu_torch.ops.kv_cache import init_cache
from fastvlm_tpu_torch.ops.sampling import SamplingParams, sample
from fastvlm_tpu_torch.ops.splice import expand_image_ids, pad_batch


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
    decode_steps: int = 0  # decode steps dispatched (whole chunks)

    @property
    def tok_per_s(self) -> float:
        return self.decode_tokens / self.decode_ms * 1000 if self.decode_ms else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "ttft_ms": round(self.ttft_ms, 2),
            "decode_tokens": self.decode_tokens,
            "tok_per_s": round(self.tok_per_s, 2),
            "prompt_tokens": self.prompt_tokens,
            "decode_steps": self.decode_steps,
        }


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
    ):
        if cfg.image_aspect_ratio == "anyres":
            raise NotImplementedError("anyres is not yet ported, see ROADMAP.md")
        if cfg.decoder.kv_cache_dtype is not None:
            raise NotImplementedError("the int8 KV cache is not yet ported, "
                                      "see ROADMAP.md")
        self.cfg = cfg
        # inference build: fold the layer scales into the adjacent weights
        # (exact; the FFN kernel then skips its layer-scale multiply)
        self.params = {**params, "vision": fold_layer_scale(params["vision"])}
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

    # ---------------- prompt/image preparation ----------------

    def build_prompt(self, user_prompt: str, system: Optional[str] = None) -> str:
        conv = conv_templates[self.conv_mode].copy()
        if system is not None:
            conv.system = system
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + user_prompt)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def prepare_array_image(self, image) -> torch.Tensor:
        """(H, W, 3) / (B, H, W, 3) array or tensor at the model's native
        size -> (B, S, S, 3) model-dtype images on the engine's device. uint8
        is rescaled by 1/255; float numpy input whose max exceeds 1.5 is
        taken as [0, 255] and rescaled. Other sizes raise: the on-device
        resize (ops/image_ops.py) is not ported yet."""
        scale255 = (isinstance(image, np.ndarray) and image.dtype.kind == "f"
                    and image.size > 0 and float(image.max()) > 1.5)
        arr = torch.as_tensor(np.asarray(image) if isinstance(image, np.ndarray)
                              else image)
        if arr.dim() == 3:
            arr = arr[None]
        s = self.cfg.vision.image_size
        if tuple(arr.shape[-3:-1]) != (s, s):
            raise NotImplementedError(
                f"image size {tuple(arr.shape[-3:-1])} != native {(s, s)}: "
                "resizing arrays is not yet ported, see ROADMAP.md")
        arr = arr.to(self.device)
        if arr.dtype == torch.uint8 or scale255:
            arr = arr.float() / 255.0
        return arr.float().to(self._dtype)

    def prepare(self, prompt: str, image=None) -> Dict[str, Optional[torch.Tensor]]:
        """prompt: full template string (may contain <image>); image: PIL,
        NHWC array/tensor, or None. Returns the prefill inputs on device.
        ``vision_embeds`` is always None: it carries the anyres and
        multi-image embeddings in the JAX package, neither ported yet."""
        if isinstance(image, (list, tuple)):
            if len(image) > 1:
                raise NotImplementedError("multi-image prompts are not yet "
                                          "ported, see ROADMAP.md")
            image = image[0] if image else None
        images = None
        if image is not None:
            if hasattr(image, "convert"):  # PIL
                images = torch.as_tensor(
                    process_images([image], self.processor, self.cfg)
                ).to(self.device, self._dtype)
            else:
                images = self.prepare_array_image(image)
        ids = tokenizer_image_token(prompt, self.tokenizer)
        row, start = expand_image_ids(ids, self.cfg.num_image_tokens)
        pad_to = -(-(len(row) + 1) // self.bucket) * self.bucket
        ids_a, lens, starts = pad_batch([row], [start], pad_to)
        return {
            "images": images,
            "vision_embeds": None,
            "ids": torch.as_tensor(ids_a).to(self.device),
            "lens": torch.as_tensor(lens).to(self.device),
            "starts": torch.as_tensor(starts).to(self.device),
            "prompt_tokens": int(lens[0]),
        }

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
    ) -> Iterator[Dict[str, Any]]:
        """Yields {"text": full_text_so_far, "stats": {...}} dicts: one after
        the first token, then one per decode chunk."""
        cfg = self.cfg
        max_new = max_new_tokens or cfg.max_new_tokens
        kw_ids = self._keyword_token_ids(stop_strings)
        inputs = self.prepare(prompt, image)
        ids = inputs["ids"]
        b, t = ids.shape
        stats = RequestStats(prompt_tokens=inputs["prompt_tokens"])

        # decode dispatches FULL chunk-wide chunks (the tail is cut on the
        # host), so the cache is sized for n_chunks * chunk writes
        n_chunks = -(-max_new // self.chunk)
        cache = init_cache(cfg.decoder.num_layers, b, t + n_chunks * self.chunk,
                           cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                           self._dtype, self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else time.time_ns() % 2**31)

        _sync(self.device)
        t0 = time.perf_counter()
        logits, cache = vlm.prefill(self.params, cfg, inputs["images"], ids,
                                    inputs["lens"], inputs["starts"], cache)
        tok = sample(gen, logits, sampling)
        first = int(tok[0])  # the host read waits for the device
        stats.ttft_ms = (time.perf_counter() - t0) * 1000

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

        while not done_host and emitted < max_new:
            take = min(self.chunk, max_new - emitted)
            toks, done, tok, cache = vlm.decode_chunk(
                self.params, cfg, tok, done, cache, gen, k=self.chunk,
                eos_ids=self.eos_ids, sampling=sampling)
            stats.decode_steps += self.chunk
            host_toks = toks[0].cpu().tolist()[:take]
            emitted += take
            done_host = consume(host_toks) or bool(done[0])
            stats.decode_tokens = decode_tokens
            stats.decode_ms = (time.perf_counter() - t_dec) * 1000
            text = self._decode_text(out_ids)
            for s in stop_strings:
                if s and s in text:
                    text = text.split(s)[0]
                    done_host = True
            yield {"text": text, "stats": stats.as_dict()}

    def generate(self, prompt: str, image=None, **kw) -> Tuple[str, Dict[str, Any]]:
        last = {"text": "", "stats": {}}
        for last in self.stream(prompt, image, **kw):
            pass
        return last["text"], last["stats"]

    def chat(self, user_prompt: str, image=None, **kw):
        """Convenience: wraps user_prompt in the conversation template."""
        return self.generate(self.build_prompt(user_prompt), image, **kw)

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


def build_engine(model_path: Optional[str] = None, *, random_tiny: bool = False,
                 device: str = "cuda", seed: int = 0, **engine_kw) -> Engine:
    """Build an Engine on ``device``: the CUDA card unless the caller asks
    for "cpu" (the kernels' plain versions). Only ``random_tiny=True``
    (random weights from ``seed``, byte tokenizer) is ported; checkpoint
    loading waits until weights are in the repository (see ROADMAP.md)."""
    if not random_tiny:
        raise NotImplementedError(
            "checkpoint loading (--model-path) is not yet ported, see ROADMAP.md")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"build_engine: device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_engine: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer

    cfg = tiny_config()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = vlm.init(gen, cfg, device)
    tok = ByteTokenizer()
    engine_kw.setdefault("eos_ids", (tok.eos_token_id,))
    return Engine(cfg, params, tok, **engine_kw)
