"""Image preprocessing on the tensor's device: rescale, bicubic resize,
center crop, pad to square, anyres tiles.

Counterpart of ``fastvlm_tpu/ops/image_ops.py``. A uint8 camera frame goes
to the device once and is rescaled and resized there, so the encoder takes
frames of any size.

The resize is ``jax.image.resize(..., "bicubic", antialias=True)``'s: Keys'
cubic with a = -0.5, the kernel widened by the scale factor when
downsampling, sample points at pixel centres, and the weights of each
output pixel renormalised over the input pixels in range. That is
``F.interpolate(mode="bicubic", antialias=True)`` (PIL's filter);
``antialias=False`` would take a = -0.75 and no widening. The two agree to
float rounding (``tests/test_torch_image_ops.py`` states the tolerance).
Layouts are channels-last, (..., H, W, 3), as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def rescale(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [0, 1]; float input is taken as already
    rescaled and passes through as float32 (FastVLM normalises with mean 0,
    std 1: nothing else to do)."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


def resize_bicubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(..., H, W, 3) -> (..., out_h, out_w, 3) float32, bicubic with
    antialiasing (PIL-equivalent)."""
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    nchw = x.float().reshape(-1, h, w, c).permute(0, 3, 1, 2)
    out = F.interpolate(nchw, size=(out_h, out_w), mode="bicubic",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def resize_shortest_edge(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    if h <= w:
        nh, nw = size, int(size * w / h)
    else:
        nh, nw = int(size * h / w), size
    return resize_bicubic(x, nh, nw)


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    h, w = x.shape[-3], x.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top:top + size, left:left + size, :]


def pad_to_square(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Centred pad to a square (the reference's expand2square; FastVLM's
    fill is black)."""
    h, w = x.shape[-3], x.shape[-2]
    side = max(h, w)
    ph, pw = side - h, side - w
    # F.pad lists the last dimension first: channels, width, height
    return F.pad(x.float(), (0, 0, pw // 2, pw - pw // 2, ph // 2,
                             ph - ph // 2), value=fill)


def preprocess(image: torch.Tensor, image_size: int,
               mode: str = "pad") -> torch.Tensor:
    """(H, W, 3) or (B, H, W, 3) uint8 / float -> (B, S, S, 3) float32 in
    [0, 1] (B = 1 for unbatched input).

    mode 'pad':  pad to square -> resize   (FastVLM's default)
    mode 'none': resize the shortest edge -> center crop
    """
    x = rescale(image)
    if mode == "pad":
        x = resize_bicubic(pad_to_square(x), image_size, image_size)
    else:
        x = center_crop(resize_shortest_edge(x, image_size), image_size)
    # clip the bicubic overshoot (PIL clips at uint8 on every pass)
    x = x.clamp(0.0, 1.0)
    return x if x.dim() == 4 else x[None]


def anyres_tiles(image: torch.Tensor, image_size: int,
                 best_resolution: Tuple[int, int]) -> torch.Tensor:
    """(H, W, 3) -> (1 + grid_w*grid_h, S, S, 3) float32: the global view,
    then the tiles row-major.

    The device version of ``data/preprocessing.process_anyres_image``:
    ``best_resolution`` (width, height) comes from the host's
    ``select_best_resolution`` on the image's size. The image is resized
    keeping its aspect (the scaled side rounded up), pasted centred on a
    zero canvas of that resolution, and cut into S x S tiles."""
    x = rescale(image)
    h, w = x.shape[0], x.shape[1]
    tw, th = best_resolution
    scale_w, scale_h = tw / w, th / h
    if scale_w < scale_h:
        nw, nh = tw, min(-(-h * tw // w), th)
    else:
        nh, nw = th, min(-(-w * th // h), tw)
    canvas = torch.zeros((th, tw, 3), dtype=torch.float32, device=x.device)
    top, left = (th - nh) // 2, (tw - nw) // 2
    canvas[top:top + nh, left:left + nw] = resize_bicubic(x, nh, nw)

    tiles = [resize_bicubic(x, image_size, image_size)]  # the global view
    for i in range(0, th, image_size):
        for j in range(0, tw, image_size):
            tiles.append(canvas[i:i + image_size, j:j + image_size])
    return torch.stack(tiles)
