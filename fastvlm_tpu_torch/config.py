"""Typed configuration tree for the PyTorch port.

Same dataclasses, field names and defaults as ``fastvlm_tpu/config.py``, so a
configuration reads the same in both packages. Three TPU-era knobs are left
out: ``FastViTConfig.ffn_backend``, ``Qwen2Config.attn_backend`` and
``Qwen2Config.scan_unroll``. The port routes by device instead: a CUDA tensor
goes through the hand-written kernel, a CPU tensor through its plain version.
The HF ``config.json`` ingestion is pure Python and carried over unchanged.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

# dtype policy names -> torch dtypes
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name) -> torch.dtype:
    if isinstance(name, str):
        return _DTYPES[name]
    return name


@dataclass(frozen=True)
class FastViTConfig:
    """FastViTHD hybrid vision encoder (reparameterized inference form).

    Defaults are the ``fastvithd`` variant: 5 stages, layers [2,12,24,4,2],
    dims [96,192,384,768,1536], repmixer x3 + attention x2, RepCPE(7x7)
    before stages 4 and 5, stride 64 overall, and a final depthwise
    ``conv_exp`` expanding 1536 -> 3072.
    """

    layers: Tuple[int, ...] = (2, 12, 24, 4, 2)
    embed_dims: Tuple[int, ...] = (96, 192, 384, 768, 1536)
    mlp_ratios: Tuple[int, ...] = (4, 4, 4, 4, 4)
    token_mixers: Tuple[str, ...] = (
        "repmixer", "repmixer", "repmixer", "attention", "attention",
    )
    pos_embs: Tuple[bool, ...] = (False, False, False, True, True)
    pos_emb_kernel: int = 7
    repmixer_kernel: int = 3
    ffn_kernel: int = 7
    down_patch_size: int = 7
    down_stride: int = 2
    cls_ratio: float = 2.0
    attn_head_dim: int = 32
    se_rd_ratio: float = 0.0625
    ln_eps: float = 1e-5
    image_size: int = 1024
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def out_channels(self) -> int:
        return int(self.embed_dims[-1] * self.cls_ratio)

    @property
    def total_stride(self) -> int:
        # stem is x4; each of the 4 inter-stage downsamplers is x2.
        return 4 * (self.down_stride ** (len(self.layers) - 1))

    @property
    def grid_size(self) -> int:
        return self.image_size // self.total_stride

    @property
    def num_tokens(self) -> int:
        return self.grid_size * self.grid_size


@dataclass(frozen=True)
class ProjectorConfig:
    """Multimodal projector: ``mlp2x_gelu`` (Linear -> GELU -> Linear),
    ``linear`` or ``identity``."""

    projector_type: str = "mlp2x_gelu"
    mm_hidden_size: int = 3072
    hidden_size: int = 896

    @property
    def mlp_depth(self) -> int:
        m = re.match(r"^mlp(\d+)x_gelu$", self.projector_type)
        return int(m.group(1)) if m else 1


@dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 decoder family (HF ``Qwen2ForCausalLM`` semantics).

    Defaults are Qwen2-0.5B; see ``qwen2_0_5b`` / ``qwen2_1_5b`` /
    ``qwen2_7b``. The family knobs (window, ALiBi, LayerNorm, GELU MLP) run
    on the plain path; ``kv_cache_dtype="int8"`` is not ported yet.
    """

    vocab_size: int = 151936
    hidden_size: int = 896
    num_layers: int = 24
    num_heads: int = 14
    num_kv_heads: int = 2
    head_dim: int = 64
    intermediate_size: int = 4864
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    qkv_bias: bool = True
    attn_window: Optional[int] = None   # Mistral sliding window (e.g. 4096)
    pos_emb: str = "rope"               # 'rope' | 'alibi'
    norm_type: str = "rmsnorm"          # 'rmsnorm' | 'layernorm'
    mlp_type: str = "swiglu"            # 'swiglu' | 'gelu'
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    kv_cache_dtype: Optional[str] = None

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


def qwen2_0_5b(**kw) -> Qwen2Config:
    return Qwen2Config(**kw)


def qwen2_1_5b(**kw) -> Qwen2Config:
    base = dict(
        hidden_size=1536, num_layers=28, num_heads=12, num_kv_heads=2,
        head_dim=128, intermediate_size=8960, tie_word_embeddings=True,
    )
    base.update(kw)
    return Qwen2Config(**base)


def qwen2_7b(**kw) -> Qwen2Config:
    base = dict(
        hidden_size=3584, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, intermediate_size=18944, tie_word_embeddings=False,
    )
    base.update(kw)
    return Qwen2Config(**base)


def llama_7b(**kw) -> Qwen2Config:
    """Llama/Vicuna family: no QKV bias."""
    base = dict(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=32, head_dim=128, intermediate_size=11008,
        rope_theta=10000.0, rms_eps=1e-5, tie_word_embeddings=False,
        qkv_bias=False,
    )
    base.update(kw)
    return Qwen2Config(**base)


def mpt_7b(**kw) -> Qwen2Config:
    """MPT family: ALiBi positions, bias-free LayerNorm, GELU MLP, fused
    bias-free QKV, tied embeddings."""
    base = dict(
        vocab_size=50432, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=32, head_dim=128, intermediate_size=16384,
        rms_eps=1e-5, tie_word_embeddings=True, qkv_bias=False,
        pos_emb="alibi", norm_type="layernorm", mlp_type="gelu",
    )
    base.update(kw)
    return Qwen2Config(**base)


def mistral_7b(**kw) -> Qwen2Config:
    """Mistral family: GQA + sliding window."""
    base = dict(
        vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
        num_kv_heads=8, head_dim=128, intermediate_size=14336,
        rope_theta=10000.0, rms_eps=1e-5, tie_word_embeddings=False,
        qkv_bias=False, attn_window=4096,
    )
    base.update(kw)
    return Qwen2Config(**base)


@dataclass(frozen=True)
class FastVLMConfig:
    """Top-level VLM config: vision tower + projector + decoder + token
    plumbing, with the mm_* keys the reference writes into config.json."""

    vision: FastViTConfig = dataclasses.field(default_factory=FastViTConfig)
    projector: ProjectorConfig = dataclasses.field(default_factory=ProjectorConfig)
    decoder: Qwen2Config = dataclasses.field(default_factory=Qwen2Config)

    image_token_index: int = -200
    ignore_index: int = -100
    image_token: str = "<image>"

    image_aspect_ratio: str = "pad"  # 'pad' | 'anyres' | 'none'
    image_grid_pinpoints: Optional[Tuple[Tuple[int, int], ...]] = None
    mm_patch_merge_type: str = "flat"

    max_new_tokens: int = 256
    context_len: int = 2048

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_tokens


# -------------------------------------------------------------------------
# HF config.json ingestion
# -------------------------------------------------------------------------

_QWEN2_HF_KEYS = dict(
    vocab_size="vocab_size",
    hidden_size="hidden_size",
    num_layers="num_hidden_layers",
    num_heads="num_attention_heads",
    num_kv_heads="num_key_value_heads",
    intermediate_size="intermediate_size",
    rope_theta="rope_theta",
    rms_eps="rms_norm_eps",
    tie_word_embeddings="tie_word_embeddings",
    max_position_embeddings="max_position_embeddings",
)


def decoder_from_hf_dict(d: Dict[str, Any], **overrides) -> Qwen2Config:
    kw: Dict[str, Any] = {}
    for ours, theirs in _QWEN2_HF_KEYS.items():
        if theirs in d:
            kw[ours] = d[theirs]
    if "head_dim" in d and d["head_dim"]:
        kw["head_dim"] = d["head_dim"]
    elif "hidden_size" in kw and "num_heads" in kw:
        kw["head_dim"] = kw["hidden_size"] // kw["num_heads"]
    kw.update(overrides)
    return Qwen2Config(**kw)


def mpt_decoder_from_hf_dict(d: Dict[str, Any], **overrides) -> Qwen2Config:
    """MPT-style config.json (d_model/n_heads/n_layers keys); untied unless
    the file says otherwise."""
    dm = d.get("d_model", 4096)
    heads = d.get("n_heads", 32)
    kw = dict(
        vocab_size=d.get("vocab_size", 50432),
        hidden_size=dm,
        num_layers=d.get("n_layers", 32),
        num_heads=heads,
        num_kv_heads=heads,
        head_dim=dm // heads,
        intermediate_size=int(round(d.get("expansion_ratio", 4) * dm)),
        rms_eps=d.get("layer_norm_epsilon", 1e-5),
        tie_word_embeddings=d.get("tie_word_embeddings", True),
        qkv_bias=not d.get("no_bias", True),
        pos_emb="alibi", norm_type="layernorm", mlp_type="gelu",
    )
    kw.update(overrides)
    return Qwen2Config(**kw)


def vlm_config_from_hf_dict(d: Dict[str, Any], **overrides) -> FastVLMConfig:
    """Build a FastVLMConfig from a reference-style HF config.json dict: the
    mm_* keys, the ``mobileclip_l_1024`` tower name whose suffix sets the
    input resolution, and the llava_mpt model type."""
    if d.get("model_type") in ("llava_mpt", "mpt") or "d_model" in d:
        decoder = mpt_decoder_from_hf_dict(d)
    else:
        decoder = decoder_from_hf_dict(d)

    image_size = 1024
    tower = d.get("mm_vision_tower", d.get("vision_tower", "mobileclip_l_1024"))
    if isinstance(tower, str) and tower.rsplit("_", 1)[-1].isdigit():
        image_size = int(tower.rsplit("_", 1)[-1])
    vision = FastViTConfig(image_size=image_size)

    projector = ProjectorConfig(
        projector_type=d.get("mm_projector_type", "mlp2x_gelu"),
        mm_hidden_size=d.get("mm_hidden_size", vision.out_channels),
        hidden_size=decoder.hidden_size,
    )

    grid = d.get("image_grid_pinpoints")
    kw: Dict[str, Any] = dict(
        vision=vision,
        projector=projector,
        decoder=decoder,
        image_aspect_ratio=d.get("image_aspect_ratio", "pad"),
        image_grid_pinpoints=tuple(map(tuple, grid)) if grid else None,
        mm_patch_merge_type=d.get("mm_patch_merge_type", "flat"),
        context_len=d.get("max_sequence_length", d.get("max_position_embeddings", 2048)),
    )
    kw.update(overrides)
    return FastVLMConfig(**kw)


def load_vlm_config(path: str, **overrides) -> FastVLMConfig:
    """Load from a checkpoint dir containing HF config.json, or a json file."""
    if os.path.isdir(path):
        path = os.path.join(path, "config.json")
    with open(path) as f:
        return vlm_config_from_hf_dict(json.load(f), **overrides)
