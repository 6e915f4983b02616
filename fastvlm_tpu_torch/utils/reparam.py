"""Import-time structural reparameterization (branch fusion).

Released FastVLM checkpoints ship the vision tower already reparameterized
(``inference_mode=True``, reference mci.py:1472), but a checkpoint saved
mid-pretraining carries the multi-branch train-time modules instead. This
module fuses those branches into the single conv+bias form our runtime
models (models/fastvit.py represents only the fused graph), reproducing the
reference's fusion math on the host with numpy:

  * MobileOneBlock._get_kernel_bias / _fuse_bn_tensor (mci.py:249-330):
    reparam = sum(conv_i*BN) + pad(scale*BN) + identity*BN_skip
  * ReparamLargeKernelConv.get_kernel_bias (mci.py:453-465):
    lkb_reparam = lkb_origin*BN + center-pad(small_conv*BN)
  * RepMixer.reparameterize (mci.py:819-858):
    reparam = Id + layer_scale * (mixer_fused - norm_fused)
  * RepCPE.reparameterize (mci.py:1000-1030): reparam = Id + pe.weight

All kernels stay in torch OIHW layout — the output state dict feeds the
normal import path (utils/checkpoint.convert_vision), which keeps them OIHW.

The port's own copy of ``fastvlm_tpu/utils/reparam.py``: numpy only, the
same arithmetic in the same order, so a fused kernel is bit-identical in
both packages.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

Array = np.ndarray

_BN_EPS = 1e-5  # nn.BatchNorm2d default; state dicts do not carry eps

_TRAIN_MARKERS = (".rbr_conv.", ".rbr_scale.", ".rbr_skip.", ".lkb_origin.")


def needs_fusion(sd: Mapping[str, Array]) -> bool:
    """True if the state dict contains train-time (multi-branch) modules."""
    return any(
        any(m in k for m in _TRAIN_MARKERS) or k.endswith(".pe.weight")
        for k in sd
    )


def _np(x) -> Array:
    return np.asarray(x, np.float32)


def _fuse_bn(w: Array, gamma, beta, mean, var, eps=_BN_EPS) -> Tuple[Array, Array]:
    """conv kernel (OIHW) followed by BN -> equivalent (kernel, bias)."""
    std = np.sqrt(_np(var) + eps)
    t = _np(gamma) / std
    return w * t[:, None, None, None], _np(beta) - _np(mean) * t


def _fuse_conv_bn(sd, base: str) -> Tuple[Array, Array]:
    """``base.conv`` (bias-free) + ``base.bn`` -> (kernel, bias)."""
    return _fuse_bn(
        _np(sd[base + ".conv.weight"]),
        sd[base + ".bn.weight"], sd[base + ".bn.bias"],
        sd[base + ".bn.running_mean"], sd[base + ".bn.running_var"])


def _identity_kernel(out_c: int, input_dim: int, k: int) -> Array:
    """Dirac kernel: out channel i passes through input channel i%input_dim
    (the reference's id_tensor, mci.py:295-305)."""
    w = np.zeros((out_c, input_dim, k, k), np.float32)
    for i in range(out_c):
        w[i, i % input_dim, k // 2, k // 2] = 1.0
    return w


def _center_pad(w: Array, k: int) -> Array:
    p = (k - w.shape[-1]) // 2
    if p == 0:
        return w
    return np.pad(w, ((0, 0), (0, 0), (p, p), (p, p)))


def _fuse_mobileone(sd, prefix: str) -> Tuple[Array, Array]:
    """MobileOneBlock branches -> (kernel, bias). Requires at least one conv
    or scale branch (the norm-only block lives inside RepMixer and is fused
    by _fuse_repmixer, which knows the kernel geometry)."""
    w = b = None
    i = 0
    while f"{prefix}.rbr_conv.{i}.conv.weight" in sd:
        wi, bi = _fuse_conv_bn(sd, f"{prefix}.rbr_conv.{i}")
        w = wi if w is None else w + wi
        b = bi if b is None else b + bi
        i += 1
    if f"{prefix}.rbr_scale.conv.weight" in sd:
        ws, bs = _fuse_conv_bn(sd, prefix + ".rbr_scale")
        if w is None:
            w, b = ws, bs
        else:
            w = w + _center_pad(ws, w.shape[-1])
            b = b + bs
    if w is None:
        raise KeyError(f"{prefix}: no conv/scale branch to fuse")
    if f"{prefix}.rbr_skip.weight" in sd:
        out_c, input_dim, k = w.shape[0], w.shape[1], w.shape[-1]
        wi, bi = _fuse_bn(
            _identity_kernel(out_c, input_dim, k),
            sd[prefix + ".rbr_skip.weight"], sd[prefix + ".rbr_skip.bias"],
            sd[prefix + ".rbr_skip.running_mean"],
            sd[prefix + ".rbr_skip.running_var"])
        w, b = w + wi, b + bi
    return w, b


def _fuse_replk(sd, prefix: str) -> Tuple[Array, Array]:
    w, b = _fuse_conv_bn(sd, prefix + ".lkb_origin")
    if f"{prefix}.small_conv.conv.weight" in sd:
        ws, bs = _fuse_conv_bn(sd, prefix + ".small_conv")
        w = w + _center_pad(ws, w.shape[-1])
        b = b + bs
    return w, b


def _fuse_repmixer(sd, prefix: str) -> Tuple[Array, Array]:
    """RepMixer (prefix = '...token_mixer'): mixer/norm MobileOne blocks and
    the internal layer scale collapse into one depthwise conv."""
    wm, bm = _fuse_mobileone(sd, prefix + ".mixer")
    out_c, input_dim, k = wm.shape[0], wm.shape[1], wm.shape[-1]
    # norm block = BN-only MobileOne (num_conv_branches=0, no scale branch)
    wn, bn = _fuse_bn(
        _identity_kernel(out_c, input_dim, k),
        sd[prefix + ".norm.rbr_skip.weight"],
        sd[prefix + ".norm.rbr_skip.bias"],
        sd[prefix + ".norm.rbr_skip.running_mean"],
        sd[prefix + ".norm.rbr_skip.running_var"])
    ident = _identity_kernel(out_c, input_dim, k)
    if prefix + ".layer_scale" in sd:
        ls = _np(sd[prefix + ".layer_scale"]).reshape(-1)
        w = ident + ls[:, None, None, None] * (wm - wn)
        b = ls * (bm - bn)
    else:
        w = ident + wm - wn
        b = bm - bn
    return w, b


def _fuse_repcpe(sd, prefix: str) -> Tuple[Array, Array]:
    w = _np(sd[prefix + ".pe.weight"])
    ident = _identity_kernel(w.shape[0], w.shape[1], w.shape[-1])
    return ident + w, _np(sd[prefix + ".pe.bias"])


def fuse_reparam_branches(sd: Mapping[str, Array]) -> Dict[str, Array]:
    """Rewrite every train-time multi-branch module in ``sd`` to its fused
    inference form (reparam_conv / lkb_reparam keys), leaving all other
    entries untouched. Idempotent on already-fused state dicts."""
    out = dict(sd)

    def consume(prefix):
        for k in list(out):
            if k.startswith(prefix + "."):
                del out[k]

    # 1. RepMixers first (their mixer/norm sub-blocks are MobileOne-shaped
    #    and must not be fused standalone)
    mixers = sorted({k.split(".mixer.rbr_conv.")[0] for k in sd
                     if ".mixer.rbr_conv." in k})
    for p in mixers:
        w, b = _fuse_repmixer(out, p)
        consume(p + ".mixer")
        consume(p + ".norm")
        out.pop(p + ".layer_scale", None)
        out[p + ".reparam_conv.weight"] = w
        out[p + ".reparam_conv.bias"] = b

    # 2. Large-kernel reparam convs
    lks = sorted({k.split(".lkb_origin.")[0] for k in out
                  if ".lkb_origin." in k})
    for p in lks:
        w, b = _fuse_replk(out, p)
        consume(p + ".lkb_origin")
        consume(p + ".small_conv")
        out[p + ".lkb_reparam.weight"] = w
        out[p + ".lkb_reparam.bias"] = b

    # 3. Standalone MobileOne blocks (stem, patch-embed pointwise, conv_exp)
    mobs = sorted({k.split(".rbr_conv.")[0] for k in out
                   if ".rbr_conv." in k}
                  | {k.split(".rbr_scale.")[0] for k in out
                     if ".rbr_scale." in k})
    for p in mobs:
        w, b = _fuse_mobileone(out, p)
        consume(p + ".rbr_conv")
        consume(p + ".rbr_scale")
        consume(p + ".rbr_skip")
        out[p + ".reparam_conv.weight"] = w
        out[p + ".reparam_conv.bias"] = b

    # 4. RepCPE position encoders
    cpes = sorted({k[: -len(".pe.weight")] for k in out
                   if k.endswith(".pe.weight")
                   and getattr(sd.get(k), "ndim", 0) == 4})
    for p in cpes:
        w, b = _fuse_repcpe(out, p)
        del out[p + ".pe.weight"], out[p + ".pe.bias"]
        out[p + ".reparam_conv.weight"] = w
        out[p + ".reparam_conv.bias"] = b

    return out
