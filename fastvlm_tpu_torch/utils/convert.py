"""Weight bridge: the JAX package's parameter tree -> the port's parameters.

Input is the JAX tree with every leaf as a numpy array (the caller runs
``jax.tree.map(np.asarray, params)``; nothing here imports JAX). bfloat16
leaves arrive as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
rejects, so every float leaf goes through float32 (exact) and back to its
own dtype. The conversion:

  * conv kernels HWIO (kh, kw, in/groups, out) -> OIHW;
  * 1x1 convs used as matmuls (the ConvFFN's fc1/fc2) -> (in, out) matrices;
  * linears stay (in, out);
  * scan-stacked leading axes (``stages[i]["blocks"]``, decoder and CLIP
    tower ``layers``) -> one dict per block / layer;
  * fused (``qkv``, ``gateup``) and unfused decoder layouts both pass
    through as they are; folded trees (no ``ls`` leaves) and unfolded ones
    both work;
  * quantized decoder linears (``fastvlm_tpu/ops/quant.py``: ``w_q`` int8,
    ``scale`` f32, ``a8`` int8, ``b``) keep their leaves and dtypes, the
    stacked ones split per layer like any other; an int8 ``w_q`` is laid
    out K-major (``ops/quant.card_layout``), its values unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from fastvlm_tpu_torch.config import FastVLMConfig, FastViTConfig
from fastvlm_tpu_torch.models.clip_vit import CLIPViTConfig
from fastvlm_tpu_torch.ops.quant import card_layout

Params = Dict[str, Any]

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    dtype = _TORCH_DTYPES.get(a.dtype.name)
    if dtype is None:  # integer leaves
        return torch.from_numpy(np.array(a))
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _conv(a) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _tensor(np.transpose(np.asarray(a), (3, 2, 0, 1)))


def _conv_p(p) -> Params:
    out = {"w": _conv(p["w"])}
    if "b" in p:
        out["b"] = _tensor(p["b"])
    return out


def _linear_p(p) -> Params:
    out = {k: _tensor(v) for k, v in p.items()}
    if "w_q" in out:
        out["w_q"] = card_layout(out["w_q"])
    return out


def _unstack(tree, n: int) -> List[Any]:
    """Split the leading (scan) axis of every leaf into n trees."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    arr = np.asarray(tree)
    return [arr[i] for i in range(n)]


def _ffn(p) -> Params:
    c = np.asarray(p["fc1"]["w"]).shape[2]
    return {
        "dw": _conv_p(p["dw"]),
        "fc1": {"w": _tensor(np.asarray(p["fc1"]["w"]).reshape(c, -1)),
                "b": _tensor(p["fc1"]["b"])},
        "fc2": {"w": _tensor(np.asarray(p["fc2"]["w"]).reshape(-1, c)),
                "b": _tensor(p["fc2"]["b"])},
    }


def _block(bp) -> Params:
    out: Params = {"ffn": _ffn(bp["ffn"])}
    for k, v in bp.items():
        if k == "ffn":
            continue
        if k == "mixer":
            out[k] = _conv_p(v)
        elif k in ("qkv", "proj"):
            out[k] = _linear_p(v)
        else:  # ls, ls1, ls2, norm_scale, norm_bias
            out[k] = _tensor(v)
    return out


def fastvit_from_jax(tree: Params, cfg: FastViTConfig) -> Params:
    stages = []
    for i, st in enumerate(tree["stages"]):
        stage: Params = {}
        if "cpe" in st:
            stage["cpe"] = _conv_p(st["cpe"])
        stage["blocks"] = [_block(bp) for bp in
                           _unstack(st["blocks"], cfg.layers[i])]
        if "down" in st:
            stage["down"] = {k: _conv_p(v) for k, v in st["down"].items()}
        stages.append(stage)
    ce = tree["conv_exp"]
    se = ce["se"]
    conv_exp = _conv_p(ce)
    conv_exp["se"] = {
        "reduce_w": _conv(se["reduce_w"]), "reduce_b": _tensor(se["reduce_b"]),
        "expand_w": _conv(se["expand_w"]), "expand_b": _tensor(se["expand_b"]),
    }
    return {"stem": [_conv_p(p) for p in tree["stem"]], "stages": stages,
            "conv_exp": conv_exp}


def clip_from_jax(tree: Params, num_layers: int) -> Params:
    """The JAX CLIP tower (HWIO patch embedding, scan-stacked layers) -> the
    port's (OIHW patch embedding, a list of layers)."""
    out = {k: _tensor(v) for k, v in tree.items()
           if k not in ("patch_embed", "layers")}
    out["patch_embed"] = _conv(tree["patch_embed"])
    out["layers"] = [
        {k: (_linear_p(v) if isinstance(v, dict) else _tensor(v))
         for k, v in lp.items()}
        for lp in _unstack(tree["layers"], num_layers)]
    return out


def projector_from_jax(tree: Params) -> Params:
    return {"layers": [_linear_p(lp) for lp in tree["layers"]]}


def qwen2_from_jax(tree: Params, num_layers: int) -> Params:
    layers = []
    for lp in _unstack(tree["layers"], num_layers):
        layers.append({k: (_linear_p(v) if isinstance(v, dict) else _tensor(v))
                       for k, v in lp.items()})
    out = {"embed": _tensor(tree["embed"]), "layers": layers,
           "final_norm": _tensor(tree["final_norm"])}
    if "lm_head" in tree:
        out["lm_head"] = _linear_p(tree["lm_head"])
    return out


def from_jax_params(np_tree: Params, cfg: FastVLMConfig) -> Params:
    """Whole-model tree {"vision", "projector", "decoder"[, "image_newline"]}
    -> port params (CPU tensors in the source dtypes; move them with
    ``to_device``). The tower is FastViTHD's or a CLIP ViT's, by the vision
    config's type."""
    if isinstance(cfg.vision, CLIPViTConfig):
        vision = clip_from_jax(np_tree["vision"], cfg.vision.num_layers)
    else:
        vision = fastvit_from_jax(np_tree["vision"], cfg.vision)
    out = {
        "vision": vision,
        "projector": projector_from_jax(np_tree["projector"]),
        "decoder": qwen2_from_jax(np_tree["decoder"], cfg.decoder.num_layers),
    }
    if "image_newline" in np_tree:
        out["image_newline"] = _tensor(np_tree["image_newline"])
    return out


def to_device(tree, device):
    """Move every tensor of a params tree to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def opt_state_from_jax(count, mu: Params, nu: Params, cfg: FastVLMConfig,
                       like: Dict[str, Any]) -> Dict[str, Any]:
    """An optax AdamW state carried across: ``mu`` and ``nu`` are numpy
    trees of the JAX params' structure (one value a leaf, anything at the
    frozen ones), ``count`` the update count. Each moment goes through the
    params' converter (``from_jax_params``), so it lands in the port's
    layout; the result is the port's ``{"count", "mu", "nu"}`` over the
    paths of ``like`` (the port optimizer's ``init``), in its dtypes and on
    its devices."""
    from fastvlm_tpu_torch.train.step import named_leaves

    def moments(tree, want):
        flat = dict(named_leaves(from_jax_params(tree, cfg)))
        return {p: flat[p].to(dtype=t.dtype, device=t.device)
                for p, t in want.items()}

    return {"count": torch.tensor(int(np.asarray(count)), dtype=torch.int32),
            "mu": moments(mu, like["mu"]), "nu": moments(nu, like["nu"])}
