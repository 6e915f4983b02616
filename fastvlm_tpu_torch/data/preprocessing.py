"""Host-side image + prompt preprocessing.

A copy of the framework-neutral half of ``fastvlm_tpu/data/preprocessing.py``:
the FastVLM image processor is a CLIP processor with mean 0 / std 1, i.e.
resize-shortest-edge (bicubic) + center-crop + rescale(1/255), on PIL images
and numpy arrays; pad mode squares the image first, anyres mode tiles it
(a global view + the tiles of the best grid resolution). Every PIL call is
the JAX package's, so the pixels are equal.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from fastvlm_tpu_torch.data.constants import IMAGE_TOKEN_INDEX


class ImageProcessor:
    """resize-shortest-edge -> center-crop -> rescale(1/255), NHWC float32."""

    def __init__(self, image_size: int):
        self.image_size = image_size
        # the CLIPImageProcessor attributes the anyres code reads
        self.size = {"shortest_edge": image_size}
        self.crop_size = {"height": image_size, "width": image_size}
        self.image_mean = [0.0, 0.0, 0.0]  # the pad fill
        self.image_std = [1.0, 1.0, 1.0]

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


def select_best_resolution(original_size, possible_resolutions):
    """The grid resolution that keeps the most effective pixels, then wastes
    the fewest. Sizes are (width, height)."""
    ow, oh = original_size
    best, best_eff, best_waste = None, 0, float("inf")
    for w, h in possible_resolutions:
        scale = min(w / ow, h / oh)
        eff = min(int(ow * scale) * int(oh * scale), ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def resize_and_pad_image(image, target_resolution):
    """Aspect-preserving resize (PIL's default filter), then a centred black
    pad to the target (width, height)."""
    from PIL import Image

    ow, oh = image.size
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = image.resize((nw, nh))
    out = Image.new("RGB", (tw, th), (0, 0, 0))
    out.paste(resized, ((tw - nw) // 2, (th - nh) // 2))
    return out


def divide_to_patches(image, patch_size: int):
    """Row-major non-overlapping square crops."""
    patches = []
    w, h = image.size
    for i in range(0, h, patch_size):
        for j in range(0, w, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size: int):
    """(grid_w, grid_h) in tiles of the best resolution for ``image_size``."""
    w, h = select_best_resolution(image_size, list(grid_pinpoints))
    return w // patch_size, h // patch_size


def process_anyres_image(image, processor: ImageProcessor, grid_pinpoints):
    """The global view (the image resized to a square) + the tiles of the
    resized and padded image, each through the processor: (1 + G, S, S, 3)
    NHWC float32."""
    best = select_best_resolution(image.size, list(grid_pinpoints))
    padded = resize_and_pad_image(image, best)
    patches = divide_to_patches(padded, processor.crop_size["height"])
    global_view = image.resize(
        (processor.size["shortest_edge"], processor.size["shortest_edge"]))
    return np.stack([processor.preprocess(p) for p in [global_view] + patches])


def process_images(images, processor: ImageProcessor, cfg) -> np.ndarray:
    """Dispatch on cfg.image_aspect_ratio: 'pad' (square-pad, then the
    processor), 'anyres' (``process_anyres_image`` each: one array when the
    tile counts agree, else a list) or the plain processor. NHWC float32."""
    mode = getattr(cfg, "image_aspect_ratio", None)
    if mode == "pad":
        bg = tuple(int(x * 255) for x in processor.image_mean)
        return np.stack([
            processor.preprocess(expand2square(im, bg)) for im in images
        ])
    if mode == "anyres":
        tiles = [
            process_anyres_image(im, processor, cfg.image_grid_pinpoints)
            for im in images
        ]
        if all(t.shape == tiles[0].shape for t in tiles):
            return np.stack(tiles)
        return tiles
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
