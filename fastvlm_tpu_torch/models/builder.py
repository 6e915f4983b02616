"""Tower and decoder builders: the vision tower picked by its name, the
decoder config by its HF ``model_type`` family.

Counterpart of ``fastvlm_tpu/models/builder.py``, unchanged: pure Python
over the port's config classes.
"""

from __future__ import annotations

from typing import Any, Dict

from fastvlm_tpu_torch.config import Qwen2Config, FastViTConfig, decoder_from_hf_dict
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
}


def build_decoder_config(hf_config: Dict[str, Any], **overrides) -> Qwen2Config:
    """A HF config.json dict -> the decoder config, with the model_type
    family's defaults (QKV bias, ALiBi) and a sliding window where the
    config enables one."""
    family = hf_config.get("model_type", "qwen2")
    kw = dict(_FAMILY_DEFAULTS.get(family, {}))
    if hf_config.get("sliding_window") and hf_config.get(
            "use_sliding_window", True):
        kw["attn_window"] = hf_config["sliding_window"]
    kw.update(overrides)
    return decoder_from_hf_dict(hf_config, **kw)
