"""Tower and decoder builders: the vision tower picked by its name, the
decoder config by its HF ``model_type`` family.

Counterpart of ``fastvlm_tpu/models/builder.py``, unchanged: pure Python
over the port's config classes.
"""

from __future__ import annotations

from typing import Any, Dict

from fastvlm_tpu_torch.config import (
    FastViTConfig, Qwen2Config, RopeParams, decoder_from_hf_dict)
from fastvlm_tpu_torch.models.clip_vit import CLIPViTConfig


def build_vision_tower_config(name: str, **kw):
    """'mobileclip*' -> FastViTHD (a trailing ``_<digits>`` sets the image
    size, else 1024); a name with 'clip', 'openai' or 'laion', or a path
    ('/' or '.' first) -> CLIP ViT (S2 through the ``s2_scales`` keyword);
    anything else raises ValueError."""
    lowered = name.lower()
    if "mobileclip" in lowered:
        image_size = 1024
        tail = name.rsplit("_", 1)[-1]
        if tail.isdigit():
            image_size = int(tail)
        return FastViTConfig(image_size=image_size, **kw)
    if "clip" in lowered or "openai" in lowered or "laion" in lowered \
            or lowered.startswith(("/", ".")):
        return CLIPViTConfig(**kw)
    raise ValueError(f"unknown vision tower: {name}")


_FAMILY_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "qwen2": {},
    "llava_qwen2": {},
    "llama": {"qkv_bias": False},
    "llava_llama": {"qkv_bias": False},
    "mistral": {"qkv_bias": False},
    "llava_mistral": {"qkv_bias": False},
    "mpt": {"qkv_bias": False, "pos_emb": "alibi"},
    "llava_mpt": {"qkv_bias": False, "pos_emb": "alibi"},
    "mellum": {"qkv_bias": False},
}
# families whose config.json windows only the layers from
# ``max_window_layers`` on (transformers' Qwen2Config)
_MAX_WINDOW_FAMILIES = ("qwen2", "llava_qwen2")
_KINDS = ("sliding_attention", "full_attention")


def _rope(entry: Dict[str, Any], max_pos=None) -> RopeParams:
    """An HF ``rope_parameters`` entry -> ``RopeParams``; YaRN's original
    length defaults to the file's ``max_position_embeddings``, as
    transformers reads it."""
    kind = entry.get("rope_type", entry.get("type", "default"))
    if kind not in ("default", "yarn"):
        raise NotImplementedError(f"rope_type {kind!r}: the port computes "
                                  f"default and yarn RoPE only")
    kw: Dict[str, Any] = {"rope_type": kind,
                          "theta": float(entry["rope_theta"])}
    if kind == "yarn":
        if entry.get("truncate", True) is not True or entry.get("mscale"):
            raise NotImplementedError("YaRN without truncation or with "
                                      "mscale")
        kw["factor"] = float(entry["factor"])
        kw["original_max_position_embeddings"] = entry.get(
            "original_max_position_embeddings") or max_pos
        for key in ("beta_fast", "beta_slow", "attention_factor"):
            if entry.get(key) is not None:
                kw[key] = entry[key]
    return RopeParams(**kw)


def _layer_kinds(hf_config: Dict[str, Any], family: str, kw: Dict[str, Any]):
    """Per-layer attention kinds and RoPE into ``kw``: ``layer_types``
    where the file gives them; for a Qwen2 file with ``use_sliding_window``,
    the layers from ``max_window_layers`` on windowed, as transformers
    reads it; else one window in every layer where the file enables one.
    Kinds that all agree collapse to that one kind."""
    window = hf_config.get("sliding_window") \
        if hf_config.get("use_sliding_window", True) else None
    n = hf_config.get("num_hidden_layers")
    types = hf_config.get("layer_types")
    if types is None and window and family in _MAX_WINDOW_FAMILIES \
            and "max_window_layers" in hf_config:
        m = hf_config["max_window_layers"]
        types = ["sliding_attention" if i >= m else "full_attention"
                 for i in range(n)]
    rope = hf_config.get("rope_parameters")
    by_kind = isinstance(rope, dict) and any(k in rope for k in _KINDS)
    if rope and not by_kind:
        flat = _rope(rope)
        if flat.rope_type != "default":
            raise NotImplementedError("a RoPE other than the default one in "
                                      "every layer")
        kw["rope_theta"] = flat.theta
    if types is None:
        if window:
            kw["attn_window"] = window
        return
    types = tuple(types)
    if len(types) != n or not set(types) <= set(_KINDS):
        raise ValueError(f"layer_types {types}: need {n} entries of {_KINDS}")
    if by_kind:
        max_pos = hf_config.get("max_position_embeddings")
        slide = _rope(rope.get("sliding_attention", rope.get(
            "full_attention")), max_pos)
        full = _rope(rope.get("full_attention", rope.get(
            "sliding_attention")), max_pos)
        if slide.rope_type != "default":
            raise NotImplementedError("the port's sliding layers take the "
                                      "default RoPE only")
        kw["rope_theta"] = slide.theta
        if full != RopeParams(theta=slide.theta):
            kw["full_rope"] = full
    sliding = window and "sliding_attention" in types
    if sliding and "full_attention" not in types and "full_rope" not in kw:
        kw["attn_window"] = window       # every layer alike
    elif sliding or "full_rope" in kw:
        kw["layer_types"] = types
        kw["attn_window"] = window if sliding else None


def _experts(hf_config: Dict[str, Any], kw: Dict[str, Any]):
    """Routed-expert settings into ``kw`` (Qwen2-MoE / Qwen3-MoE keys)."""
    e = hf_config.get("num_experts") or 0
    if e <= 0:
        return
    if hf_config.get("shared_expert_intermediate_size"):
        raise NotImplementedError("a shared expert beside the routed ones")
    kw.update(num_experts=e,
              num_experts_per_tok=hf_config["num_experts_per_tok"],
              moe_intermediate_size=hf_config["moe_intermediate_size"],
              norm_topk_prob=bool(hf_config.get("norm_topk_prob", True)))
    kinds = hf_config.get("mlp_layer_types")
    if kinds is not None:
        kinds = tuple(kinds)
        if not set(kinds) <= {"sparse", "dense"}:
            raise ValueError(f"mlp_layer_types {kinds}: sparse or dense")
        if "dense" in kinds:
            kw["mlp_layer_types"] = kinds


def build_decoder_config(hf_config: Dict[str, Any], **overrides) -> Qwen2Config:
    """A HF config.json dict -> the decoder config, with the model_type
    family's defaults (QKV bias, ALiBi), each layer's attention kind and
    RoPE (``layer_types``, ``rope_parameters``; a Qwen2 file's sliding
    window from ``max_window_layers`` on) and the routed experts where the
    file has them."""
    family = hf_config.get("model_type", "qwen2")
    kw = dict(_FAMILY_DEFAULTS.get(family, {}))
    _layer_kinds(hf_config, family, kw)
    _experts(hf_config, kw)
    kw.update(overrides)
    return decoder_from_hf_dict(hf_config, **kw)
