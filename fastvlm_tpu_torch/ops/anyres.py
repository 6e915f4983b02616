"""AnyRes tile-feature merging: the global view's and the grid tiles' feature
grids become one token sequence, per ``mm_patch_merge_type``:

  flat           tiles' tokens concatenated;
  spatial        tiles re-assembled into one (gh*h, gw*w) grid;
  spatial_unpad  the same grid, cropped back to the original aspect ratio
                 (undoing the letterbox padding of the tiling), an
                 ``image_newline`` embedding appended to each grid row.

Counterpart of ``fastvlm_tpu/ops/anyres.py``. The grid shape and the crop box
are host values, known from the image's size before any pixel work; features
arrive as (T, h, w, C) channels-last grids from ``fastvit.features_grid``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def unpad_hw(cur_hw: Tuple[int, int], original_size: Tuple[int, int]):
    """Crop box that undoes centred letterbox padding.

    cur_hw: (H, W) of the feature grid; original_size: (width, height) of the
    raw image. Returns (top, bottom, left, right) slice bounds. The new
    extent truncates with ``int()`` on a float product, as the reference
    does: the token count and the crop agree to the row."""
    cur_h, cur_w = cur_hw
    ow, oh = original_size
    original_ar = ow / oh
    current_ar = cur_w / cur_h
    if original_ar > current_ar:
        # letterboxed vertically: crop rows back
        scale = cur_w / ow
        new_h = int(oh * scale)
        pad = (cur_h - new_h) // 2
        return pad, cur_h - pad, 0, cur_w
    # letterboxed horizontally: crop columns back
    scale = cur_h / oh
    new_w = int(ow * scale)
    pad = (cur_w - new_w) // 2
    return 0, cur_h, pad, cur_w - pad


def merge_flat(tile_feats: torch.Tensor) -> torch.Tensor:
    """(T, h, w, C) -> (T*h*w, C): plain token concatenation."""
    t, h, w, c = tile_feats.shape
    return tile_feats.reshape(t * h * w, c)


def merge_spatial(
    tile_feats: torch.Tensor,          # (1 + gw*gh, h, w, C): global + tiles
    grid_shape: Tuple[int, int],       # (grid_w, grid_h) in tiles
    image_newline: Optional[torch.Tensor] = None,  # (C,)
    original_size: Optional[Tuple[int, int]] = None,  # (width, height)
    unpad: bool = False,
    crop_box: Optional[Tuple[int, int, int, int]] = None,
) -> torch.Tensor:
    """Spatial / spatial_unpad merge. Returns (N, C) tokens: [global-view
    tokens | assembled grid tokens (+ a newline per grid row)].

    For unpad merges the crop may be given directly as ``crop_box`` (top,
    bottom, left, right), computed on the host by ``unpad_hw``."""
    gw, gh = grid_shape
    base = tile_feats[0]                     # (h, w, C) global view
    tiles = tile_feats[1:]                   # (gh*gw, h, w, C), row-major
    _, h, w, c = tile_feats.shape

    # (gh, gw, h, w, C) -> (gh*h, gw*w, C)
    grid = tiles.reshape(gh, gw, h, w, c).permute(0, 2, 1, 3, 4)
    grid = grid.reshape(gh * h, gw * w, c)

    if unpad:
        if crop_box is None:
            assert original_size is not None
            crop_box = unpad_hw((gh * h, gw * w), original_size)
        top, bottom, left, right = crop_box
        grid = grid[top:bottom, left:right]

    if image_newline is not None:
        nl = image_newline.to(grid.dtype)[None, None, :].expand(
            grid.shape[0], 1, c)
        grid = torch.cat([grid, nl], dim=1)

    return torch.cat([base.reshape(h * w, c), grid.reshape(-1, c)], dim=0)


def num_merged_tokens(
    grid_shape: Tuple[int, int],
    feat_hw: int,
    merge_type: str = "flat",
    original_size: Optional[Tuple[int, int]] = None,
) -> int:
    """Host-side token count for sentinel expansion (matches merge_*)."""
    gw, gh = grid_shape
    h = w = feat_hw
    if merge_type == "flat":
        return (1 + gw * gh) * h * w
    gh_px, gw_px = gh * h, gw * w
    newline = 0
    if "unpad" in merge_type:
        top, bottom, left, right = unpad_hw((gh_px, gw_px), original_size)
        gh_px, gw_px = bottom - top, right - left
        # the image_newline row separators exist only for unpad merges (the
        # param is created iff "unpad" is in the merge type, and only that
        # branch appends it)
        newline = gh_px
    return h * w + gh_px * gw_px + newline
