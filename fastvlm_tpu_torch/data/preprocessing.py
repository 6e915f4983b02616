"""Host-side image + prompt preprocessing (pad mode).

A copy of the framework-neutral half of ``fastvlm_tpu/data/preprocessing.py``:
the FastVLM image processor is a CLIP processor with mean 0 / std 1, i.e.
resize-shortest-edge (bicubic) + center-crop + rescale(1/255), on PIL images
and numpy arrays. The anyres tiling helpers are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from fastvlm_tpu_torch.data.constants import IMAGE_TOKEN_INDEX


class ImageProcessor:
    """resize-shortest-edge -> center-crop -> rescale(1/255), NHWC float32."""

    def __init__(self, image_size: int):
        self.image_size = image_size
        self.image_mean = [0.0, 0.0, 0.0]  # the pad fill; std is 1

    def resize_shortest_edge(self, image):
        from PIL import Image

        w, h = image.size
        s = self.image_size
        short, long = (w, h) if w <= h else (h, w)
        new_short = s
        new_long = int(s * long / short)
        nw, nh = (new_short, new_long) if w <= h else (new_long, new_short)
        return image.resize((nw, nh), Image.BICUBIC)

    def center_crop(self, image):
        s = self.image_size
        w, h = image.size
        left = (w - s) // 2
        top = (h - s) // 2
        return image.crop((left, top, left + s, top + s))

    def preprocess(self, image) -> np.ndarray:
        """PIL image -> (S, S, 3) float32 in [0, 1]."""
        image = image.convert("RGB")
        image = self.resize_shortest_edge(image)
        image = self.center_crop(image)
        return np.asarray(image, np.float32) / 255.0

    def __call__(self, images):
        if not isinstance(images, (list, tuple)):
            images = [images]
        return np.stack([self.preprocess(im) for im in images])


def expand2square(pil_img, background_color: Tuple[int, int, int]):
    """Pad to square with a solid background, image centered. FastVLM's
    mean-color fill is black because image_mean == 0."""
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    side = max(width, height)
    result = Image.new(pil_img.mode, (side, side), background_color)
    result.paste(pil_img, ((side - width) // 2, (side - height) // 2))
    return result


def process_images(images, processor: ImageProcessor, cfg) -> np.ndarray:
    """Pad mode (square-pad, then the processor) or the plain processor.
    Returns NHWC float32. ``image_aspect_ratio == 'anyres'`` is not ported
    yet and raises."""
    mode = getattr(cfg, "image_aspect_ratio", None)
    if mode == "pad":
        bg = tuple(int(x * 255) for x in processor.image_mean)
        return np.stack([
            processor.preprocess(expand2square(im, bg)) for im in images
        ])
    if mode == "anyres":
        raise NotImplementedError("anyres preprocessing is not yet ported, "
                                  "see ROADMAP.md")
    return processor(images)


def tokenizer_image_token(
    prompt: str, tokenizer, image_token_index: int = IMAGE_TOKEN_INDEX
) -> List[int]:
    """Tokenize text around ``<image>`` and interleave the sentinel id,
    preserving a leading BOS."""
    chunks = [tokenizer(c).input_ids for c in prompt.split("<image>")]

    ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if chunks and chunks[0] and bos is not None and chunks[0][0] == bos:
        offset = 1
        ids.append(chunks[0][0])
    sep = [image_token_index] * (offset + 1)
    merged: List[List[int]] = []
    for i, c in enumerate(chunks):
        merged.append(c)
        if i + 1 < len(chunks):
            merged.append(sep)
    for x in merged:
        ids.extend(x[offset:])
    return ids


class ByteTokenizer:
    """Self-contained byte-level tokenizer for smoke runs where no HF
    tokenizer files exist. Vocab: 256 bytes + BOS(256) + EOS(257)."""

    vocab_size = 258
    bos_token_id = 256
    eos_token_id = 257

    class _Enc(list):
        @property
        def input_ids(self):
            return list(self)

    def __call__(self, text: str):
        return self._Enc(list(text.encode("utf-8")))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")
