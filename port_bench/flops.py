"""Operations and bytes of the model and its kernels, counted from shapes,
and the table of peaks they are held against.

Every count is of the useful work that the inputs need: one multiply-add
is two operations; a kernel's bytes count each input byte read once and
each output byte written once, whatever the kernel reads again. A
configuration is the dict of its JSON file (``configs/<name>.json``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

# Published dense peaks (NVIDIA's data sheet, SXM part, no sparsity) at
# the full 700 W power limit, keyed by torch.cuda.get_device_name().
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}
BF16 = 2  # bytes an element


def peaks(device_kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(device_kind)


# ---------------------------------------------------------------- tower


def tower_stages(cfg: dict) -> List[Tuple[int, int, int, str]]:
    """(blocks, channels, rows an image, mixer) of each FastViTHD stage."""
    v = cfg["vision"]
    side = v["image_size"] // 4  # the stem's stride
    out = []
    for i, (n, c) in enumerate(zip(v["layers"], v["embed_dims"])):
        out.append((n, c, side * side, v["token_mixers"][i]))
        side //= v["down_stride"]
    return out


def tower_flops(cfg: dict, images: int = 1) -> float:
    """FastViTHD's operations for ``images`` images (inference form)."""
    v = cfg["vision"]
    s = v["image_size"]
    c0 = v["embed_dims"][0]
    half, quarter = (s // 2) ** 2, (s // 4) ** 2
    macs = half * c0 * 3 * 9 + quarter * c0 * 9 + quarter * c0 * c0  # stem
    stages = tower_stages(cfg)
    fk, mk = v["ffn_kernel"] ** 2, v["repmixer_kernel"] ** 2
    pk, dk = v["pos_emb_kernel"] ** 2, v["down_patch_size"] ** 2
    for i, (n, c, rows, mixer) in enumerate(stages):
        h = c * v["mlp_ratio"]
        ffn = rows * c * fk + 2 * rows * c * h
        if mixer == "repmixer":
            block = rows * c * mk + ffn
        else:  # qkv, q.k and p.v over all rows, proj, then the FFN
            block = rows * c * 3 * c + 2 * rows * rows * c + rows * c * c \
                + ffn
        macs += n * block
        if v["pos_embs"][i]:
            macs += rows * c * pk
        if i + 1 < len(stages):
            c_next, rows_next = stages[i + 1][1], stages[i + 1][2]
            macs += rows_next * c_next * dk + rows_next * c_next * c_next
    n_last, c_last, rows_last, _ = stages[-1]
    c_out = int(c_last * v["cls_ratio"])
    rd = int(c_out * v["se_rd_ratio"])
    macs += rows_last * c_out * 9 + 2 * c_out * rd  # conv_exp and its SE
    return 2.0 * macs * images


def image_tokens(cfg: dict) -> int:
    v = cfg["vision"]
    side = v["image_size"] // (4 * v["down_stride"] ** (len(v["layers"]) - 1))
    return side * side


def projector_flops(cfg: dict, images: int = 1) -> float:
    m, h = cfg["mm_hidden_size"], cfg["hidden_size"]
    return 2.0 * image_tokens(cfg) * (m * h + h * h) * images


# -------------------------------------------------------------- decoder
# A decoder's own counts are its family's (``family.py``); these count the
# attention pairs that every family's causal attention shares.


def causal_pairs(new: int, cached: int = 0, window: Optional[int] = None
                 ) -> int:
    """Σ keys seen a token, over ``new`` tokens after ``cached`` ones,
    each token's own key included: all earlier keys, or under a window of
    W keys the W latest (a query at p sees keys j with p - j < W)."""
    lo, hi = cached + 1, cached + new  # keys seen by the first, last token
    if window is None or hi <= window:
        return (lo + hi) * new // 2
    if lo >= window:
        return window * new
    return (lo + window) * (window - lo + 1) // 2 + window * (hi - window)


def keys_read(new: int, cached: int = 0, window: Optional[int] = None
              ) -> int:
    """Distinct keys that ``new`` tokens after ``cached`` ones attend."""
    if window is None:
        return cached + new
    return min(cached + new, window - 1 + new)


# -------------------------------------------------------------- kernels


def bound_s(flops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time the chip could take: operations at the compute peak
    or bytes at the memory peak, whichever is longer."""
    return max(flops / peak["bf16_flops"], nbytes / peak["hbm_bytes"])


def k1_call(rows: int, c: int, ratio: int = 4) -> Tuple[float, float]:
    """K1 (fused ConvFFN, bf16): out = res + fc2(gelu(fc1(t))) over
    (rows, c); layer scale folded into fc2. (operations, bytes)."""
    h = c * ratio
    flops = 4.0 * rows * c * h
    nbytes = BF16 * (3 * rows * c + 2 * c * h + h + c)
    return flops, nbytes


def k1_encode_bound_s(cfg: dict, images: int, peak: Dict[str, float]) -> float:
    """Σ bound time of K1's 44 calls in one tower pass over ``images``."""
    ratio = cfg["vision"]["mlp_ratio"]
    return sum(n * bound_s(*k1_call(rows * images, c, ratio), peak)
               for n, c, rows, _ in tower_stages(cfg))
