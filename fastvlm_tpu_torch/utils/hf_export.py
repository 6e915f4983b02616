"""HF-format checkpoint export: the port's params -> reference state dicts.

Counterpart of ``fastvlm_tpu/utils/hf_export.py`` and the inverse of
``utils/checkpoint.convert_vlm``: a model is written back as a
``llava_qwen2`` (or ``llava_mpt``) HF checkpoint, safetensors + config.json,
with the reference module tree's key names. ``export_state_dict`` returns
float32 numpy arrays, the same arrays the JAX package's export gives for the
same weights.

Layout transforms (inverse of import):
  * OIHW conv kernels stay OIHW; (in, out) linears and the ConvFFN's fc1 /
    fc2 matrices -> torch (out, in) / (out, in, 1, 1)
  * the ConvFFN depthwise conv was BN-folded at import; the reference module
    is conv(bias=False)+BN, so the folded bias is carried by an identity BN:
    gamma=1, beta=b, mean=0, var=1-eps  (=> scale exactly 1.0)
  * fused qkv/gateup decoder layouts (qwen2.fuse_decoder_params) are split
    back into q/k/v and gate/up.

The tree must carry its layer scales (``ls``/``ls1``/``ls2``): export the
params given to ``Engine``, not ``Engine.params``, which has them folded.
Quantized (w_q) and unmerged-LoRA trees are rejected; the reference format
stores plain weights.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np
import torch

from fastvlm_tpu_torch.config import FastVLMConfig
from fastvlm_tpu_torch.models import qwen2
from fastvlm_tpu_torch.utils.checkpoint import PROJECTOR_PREFIX, VISION_PREFIX

Array = np.ndarray
Params = Dict[str, Any]
_BN_EPS = 1e-5


def _np32(x) -> Array:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _conv_out(sd, name: str, p: Params) -> None:
    """OIHW conv dict -> torch ``{name}.weight`` (+ bias)."""
    sd[name + ".weight"] = _np32(p["w"])
    if "b" in p:
        sd[name + ".bias"] = _np32(p["b"])


def _linear_out(sd, name: str, p: Params) -> None:
    if "w_q" in p:
        raise ValueError(f"{name}: quantized weights can't be exported to the"
                         " HF format — export the float tree instead")
    if "lora_a" in p:
        raise ValueError(f"{name}: merge LoRA adapters before HF export")
    sd[name + ".weight"] = _np32(p["w"]).T
    if "b" in p:
        sd[name + ".bias"] = _np32(p["b"])


def _pointwise_out(sd, name: str, p: Params) -> None:
    """(in, out) matrix + bias -> 1x1 conv (out, in, 1, 1) + bias."""
    w = _np32(p["w"]).T
    sd[name + ".weight"] = w.reshape(w.shape[0], w.shape[1], 1, 1)
    sd[name + ".bias"] = _np32(p["b"])


def _folded_conv_bn_out(sd, base: str, p: Params) -> None:
    """Folded conv+bias -> reference conv(bias=False) + identity BN."""
    c = _np32(p["b"]).shape[0]
    sd[base + ".conv.weight"] = _np32(p["w"])
    sd[base + ".bn.weight"] = np.ones(c, np.float32)
    sd[base + ".bn.bias"] = _np32(p["b"])
    sd[base + ".bn.running_mean"] = np.zeros(c, np.float32)
    sd[base + ".bn.running_var"] = np.full(c, 1.0 - _BN_EPS, np.float32)


def _vec3(x) -> Array:
    """(C,) layer scale -> the reference's (C, 1, 1) parameter shape."""
    return _np32(x).reshape(-1, 1, 1)


def export_vision(params: Params, cfg, sd: Dict[str, Array],
                  prefix: str = VISION_PREFIX) -> None:
    g = lambda n: prefix + n  # noqa: E731
    for i, p in enumerate(params["stem"]):
        _conv_out(sd, g(f"patch_embed.{i}.reparam_conv"), p)

    def ffn_out(base, p):
        _folded_conv_bn_out(sd, base + ".conv", p["dw"])
        _pointwise_out(sd, base + ".fc1", p["fc1"])
        _pointwise_out(sd, base + ".fc2", p["fc2"])

    net = 0
    for i, n_blocks in enumerate(cfg.layers):
        stage = params["stages"][i]
        if cfg.pos_embs[i]:
            _conv_out(sd, g(f"network.{net}.reparam_conv"), stage["cpe"])
            net += 1
        for b in range(n_blocks):
            blk = stage["blocks"][b]
            base = g(f"network.{net}.{b}")
            if cfg.token_mixers[i] == "repmixer":
                _conv_out(sd, base + ".token_mixer.reparam_conv", blk["mixer"])
                ffn_out(base + ".convffn", blk["ffn"])
                sd[base + ".layer_scale"] = _vec3(blk["ls"])
            else:
                sd[base + ".norm.weight"] = _np32(blk["norm_scale"])
                sd[base + ".norm.bias"] = _np32(blk["norm_bias"])
                _linear_out(sd, base + ".token_mixer.qkv", blk["qkv"])
                _linear_out(sd, base + ".token_mixer.proj", blk["proj"])
                ffn_out(base + ".convffn", blk["ffn"])
                sd[base + ".layer_scale_1"] = _vec3(blk["ls1"])
                sd[base + ".layer_scale_2"] = _vec3(blk["ls2"])
        net += 1
        if i + 1 < len(cfg.layers):
            _conv_out(sd, g(f"network.{net}.proj.0.lkb_reparam"),
                      stage["down"]["lk"])
            _conv_out(sd, g(f"network.{net}.proj.1.reparam_conv"),
                      stage["down"]["pw"])
            net += 1

    ce = params["conv_exp"]
    _conv_out(sd, g("conv_exp.reparam_conv"), ce)
    se = ce["se"]
    _conv_out(sd, g("conv_exp.se.reduce"),
              {"w": se["reduce_w"], "b": se["reduce_b"]})
    _conv_out(sd, g("conv_exp.se.expand"),
              {"w": se["expand_w"], "b": se["expand_b"]})


def export_projector(params: Params, sd: Dict[str, Array],
                     prefix: str = PROJECTOR_PREFIX) -> None:
    # reference Sequential: Linear, GELU, Linear, ... -> even indices
    for i, layer in enumerate(params["layers"]):
        _linear_out(sd, f"{prefix}{2 * i}", layer)


def export_decoder(params: Params, cfg, sd: Dict[str, Array],
                   prefix: str = "") -> None:
    g = lambda n: prefix + n  # noqa: E731
    sd[g("model.embed_tokens.weight")] = _np32(params["embed"])
    for i in range(cfg.num_layers):
        lp = qwen2.split_fused_layer(params["layers"][i], cfg)
        base = g(f"model.layers.{i}.")
        sd[base + "input_layernorm.weight"] = _np32(lp["ln1"])
        _linear_out(sd, base + "self_attn.q_proj", lp["q"])
        _linear_out(sd, base + "self_attn.k_proj", lp["k"])
        _linear_out(sd, base + "self_attn.v_proj", lp["v"])
        _linear_out(sd, base + "self_attn.o_proj", lp["o"])
        sd[base + "post_attention_layernorm.weight"] = _np32(lp["ln2"])
        _linear_out(sd, base + "mlp.gate_proj", lp["gate"])
        _linear_out(sd, base + "mlp.up_proj", lp["up"])
        _linear_out(sd, base + "mlp.down_proj", lp["down"])
    sd[g("model.norm.weight")] = _np32(params["final_norm"])
    if not cfg.tie_word_embeddings and "lm_head" in params:
        _linear_out(sd, g("lm_head"), params["lm_head"])


def export_decoder_mpt(params: Params, cfg, sd: Dict[str, Array],
                       prefix: str = "") -> None:
    """Inverse of checkpoint.convert_decoder_mpt: transformer.blocks.* keys,
    q/k/v re-fused into Wqkv, separate lm_head when untied."""
    g = lambda n: prefix + n  # noqa: E731
    sd[g("transformer.wte.weight")] = _np32(params["embed"])
    for i in range(cfg.num_layers):
        lp = qwen2.split_fused_layer(params["layers"][i], cfg)
        base = g(f"transformer.blocks.{i}.")
        sd[base + "norm_1.weight"] = _np32(lp["ln1"])
        sd[base + "attn.Wqkv.weight"] = np.concatenate(
            [_np32(lp["q"]["w"]).T, _np32(lp["k"]["w"]).T,
             _np32(lp["v"]["w"]).T], axis=0)
        if "b" in lp["q"]:  # no_bias=False family
            sd[base + "attn.Wqkv.bias"] = np.concatenate(
                [_np32(lp["q"]["b"]), _np32(lp["k"]["b"]),
                 _np32(lp["v"]["b"])])
        _linear_out(sd, base + "attn.out_proj", lp["o"])
        sd[base + "norm_2.weight"] = _np32(lp["ln2"])
        _linear_out(sd, base + "ffn.up_proj", lp["up"])
        _linear_out(sd, base + "ffn.down_proj", lp["down"])
    sd[g("transformer.norm_f.weight")] = _np32(params["final_norm"])
    if not cfg.tie_word_embeddings and "lm_head" in params:
        _linear_out(sd, g("lm_head"), params["lm_head"])


def export_state_dict(params: Params, cfg: FastVLMConfig) -> Dict[str, Array]:
    cfg.decoder.require_uniform("hf_export")
    sd: Dict[str, Array] = {}
    if cfg.decoder.mlp_type == "gelu":
        # llava_mpt layout: everything under `transformer.`
        export_vision(params["vision"], cfg.vision, sd,
                      prefix="transformer.vision_tower.vision_tower.model.")
        export_projector(params["projector"], sd,
                         prefix="transformer.mm_projector.")
        export_decoder_mpt(params["decoder"], cfg.decoder, sd)
        if "image_newline" in params:
            sd["transformer.image_newline"] = _np32(params["image_newline"])
        return sd
    export_vision(params["vision"], cfg.vision, sd)
    export_projector(params["projector"], sd)
    export_decoder(params["decoder"], cfg.decoder, sd)
    if "image_newline" in params:
        sd["model.image_newline"] = _np32(params["image_newline"])
    return sd


def vlm_config_to_hf_dict(cfg: FastVLMConfig) -> Dict[str, Any]:
    """Reference-style config.json (inverse of config.vlm_config_from_hf_dict)."""
    d = cfg.decoder
    mm = {
        "mm_vision_tower": f"mobileclip_l_{cfg.vision.image_size}",
        "mm_hidden_size": cfg.projector.mm_hidden_size,
        "mm_projector_type": cfg.projector.projector_type,
        "mm_patch_merge_type": cfg.mm_patch_merge_type,
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "mm_use_im_start_end": False,
        "mm_use_im_patch_token": False,
    }
    if cfg.image_grid_pinpoints:
        mm["image_grid_pinpoints"] = [list(p) for p in cfg.image_grid_pinpoints]
    if d.mlp_type == "gelu":  # MPT family (MptConfig field names)
        out = {
            "architectures": ["LlavaMptForCausalLM"],
            "model_type": "llava_mpt",
            "vocab_size": d.vocab_size,
            "d_model": d.hidden_size,
            "n_heads": d.num_heads,
            "n_layers": d.num_layers,
            "expansion_ratio": d.intermediate_size / d.hidden_size,
            "layer_norm_epsilon": d.rms_eps,
            "tie_word_embeddings": d.tie_word_embeddings,
            "no_bias": not d.qkv_bias,
            "torch_dtype": "float32",
        }
        out.update(mm)
        return out
    out = {
        "architectures": ["LlavaQwen2ForCausalLM"],
        "model_type": "llava_qwen2",
        "vocab_size": d.vocab_size,
        "hidden_size": d.hidden_size,
        "num_hidden_layers": d.num_layers,
        "num_attention_heads": d.num_heads,
        "num_key_value_heads": d.num_kv_heads,
        "head_dim": d.head_dim,
        "intermediate_size": d.intermediate_size,
        "rope_theta": d.rope_theta,
        "rms_norm_eps": d.rms_eps,
        "tie_word_embeddings": d.tie_word_embeddings,
        "max_position_embeddings": d.max_position_embeddings,
        "torch_dtype": "float32",
    }
    out.update(mm)
    return out


def export_hf(params: Params, cfg: FastVLMConfig, out_dir: str) -> str:
    """Write ``out_dir/model.safetensors`` + ``config.json``; returns out_dir."""
    from safetensors.numpy import save_file

    os.makedirs(out_dir, exist_ok=True)
    # safetensors serializes the raw buffer and ignores numpy strides:
    # transposed views must be made contiguous first
    sd = {k: np.ascontiguousarray(v)
          for k, v in export_state_dict(params, cfg).items()}
    save_file(sd, os.path.join(out_dir, "model.safetensors"),
              metadata={"format": "pt"})
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(vlm_config_to_hf_dict(cfg), f, indent=2)
    return out_dir
