"""LoRA adapters for the decoder: the port of ``fastvlm_tpu/train/lora.py``.

A LoRA'd linear carries extra leaves ``{"lora_a": (cin, r), "lora_b": (r,
cout), "lora_scale": (1,)}`` next to its frozen ``"w"`` (or a quantized
base's ``"w_q"`` / ``"scale"``: QLoRA); ``models/qwen2._project`` adds
``scale * (x @ A) @ B``. The port's decoder is a list of layer dicts, so
the adapters sit on each layer (JAX stacks them along the scan axis).
``merge`` folds them back into the weights for serving, requantizing a
quantized base at its width.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from fastvlm_tpu_torch.ops import quant
from fastvlm_tpu_torch.train.step import AdamW, ParamGroup

DEFAULT_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
LORA_KEYS = ("lora_a", "lora_b", "lora_scale")


def _target_cin(name: str, cfg) -> int:
    """Input width of a decoder linear by name (for quantized layers, whose
    packed int4 w_q can't reveal cin from shape alone)."""
    if name == "o":
        return cfg.q_dim
    if name == "down":
        return cfg.intermediate_size
    return cfg.hidden_size  # q/k/v/gate/up/qkv/gateup


def add_lora(
    decoder_params: Dict[str, Any],
    gen: torch.Generator,
    r: int = 8,
    alpha: float = 16.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    cfg=None,
) -> Dict[str, Any]:
    """Attach adapters with A ~ N(0, 0.02) drawn from ``gen`` (a generator
    on the params' device) and B = 0, so the model is unchanged at step 0.

    A quantized linear ({"w_q", "scale"}) takes adapters in its bias's dtype
    (bf16 without one), as in JAX; pass ``cfg`` (Qwen2Config) for it, since
    packed int4 weights hide cin. A fused tree (qkv, gateup) gets adapters
    only where ``targets`` names its linears (o and down by default), as in
    JAX. Returns a new tree sharing the base leaves."""
    if cfg is not None:
        cfg.require_uniform("LoRA")
    if any("experts" in lp for lp in decoder_params["layers"]):
        raise NotImplementedError("LoRA does not take routed experts")
    layers = [dict(lp) for lp in decoder_params["layers"]]
    for name in targets:
        if name not in layers[0]:
            continue
        for lp in layers:
            p = dict(lp[name])
            if "w" in p:
                (cin, cout), dtype = p["w"].shape, p["w"].dtype
            elif "w_q" in p:
                if cfg is None:
                    raise ValueError(
                        f"add_lora on quantized layer {name!r} needs cfg= "
                        "(int4 packing hides cin)")
                cin, cout = _target_cin(name, cfg), p["scale"].shape[-1]
                dtype = p["b"].dtype if "b" in p else torch.bfloat16
            else:
                continue
            dev = p["scale" if "w_q" in p else "w"].device
            p["lora_a"] = (torch.randn((cin, r), generator=gen, device=dev)
                           * 0.02).to(dtype)
            p["lora_b"] = torch.zeros((r, cout), dtype=dtype, device=dev)
            p["lora_scale"] = torch.full((1,), alpha / r, dtype=torch.float32,
                                         device=dev)
            lp[name] = p
    return {**decoder_params, "layers": layers}


@torch.no_grad()
def merge(decoder_params: Dict[str, Any]) -> Dict[str, Any]:
    """Fold adapters into the weights and drop the lora leaves: w + scale *
    A @ B in f32, rounded to w's dtype; a quantized base is dequantized,
    adapted and requantized at its width (``ops/quant._quantize_array``)."""
    layers = []
    for lp in decoder_params["layers"]:
        lp = dict(lp)
        for name, p in lp.items():
            if not (isinstance(p, dict) and "lora_a" in p):
                continue
            p = {k: v for k, v in p.items() if k not in LORA_KEYS}
            delta = lp[name]["lora_scale"].float() * torch.matmul(
                lp[name]["lora_a"].float(), lp[name]["lora_b"].float())
            if "w_q" in p:
                cin = lp[name]["lora_a"].shape[-2]
                bits = 8 if p["w_q"].shape[-2] == cin else 4
                w = quant.dequantize(p, cin) + delta
                p["w_q"], p["scale"] = quant._quantize_array(w, bits)
            else:
                p["w"] = (p["w"].float() + delta).to(p["w"].dtype)
            lp[name] = p
        layers.append(lp)
    return {**decoder_params, "layers": layers}


def split_lora_state(decoder_params: Dict[str, Any]) -> Dict[str, Any]:
    """Only the adapter leaves, {"layers": [{name: {lora_*}}]} (the
    reference's LoRA split save)."""
    return {"layers": [
        {name: {k: p[k] for k in LORA_KEYS} for name, p in lp.items()
         if isinstance(p, dict) and "lora_a" in p}
        for lp in decoder_params["layers"]]}


def is_lora_path(path: str) -> bool:
    """A leaf path of an adapter (JAX's ``lora_label_tree``: "lora_" in the
    path)."""
    return "lora_" in path


def make_lora_optimizer(params: Dict[str, Any], lr: float = 1e-4,
                        weight_decay: float = 0.0,
                        grad_clip: float = 1.0) -> AdamW:
    """AdamW on the adapter leaves only, at a constant lr, clipped by the
    global norm of all adapters together; every other leaf of the model
    (tower and projector too) is frozen."""
    del params  # the labels come from the paths, as JAX's label tree does
    group = ParamGroup(lambda count: lr, grad_clip, weight_decay)
    return AdamW({"lora": group},
                 lambda path: "lora" if is_lora_path(path) else "frozen")
