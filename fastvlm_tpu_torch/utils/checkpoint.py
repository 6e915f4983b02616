"""Checkpoint import: released FastVLM (PyTorch/HF) weights -> the port's
params; and the native save / restore of the port's own trees
(``save_native`` / ``restore_native``, at the end of the module).

Counterpart of ``fastvlm_tpu/utils/checkpoint.py``, with the same functions
and key map. The released checkpoints are LlavaQwen2ForCausalLM state dicts
(model_type "llava_qwen2") whose vision tower is the *reparameterized*
FastViTHD, so every MobileOne / RepLK / RepMixer / RepCPE block arrives as
one ``reparam_conv`` / ``lkb_reparam`` conv+bias; a train-mode checkpoint's
branches are fused first (``utils/reparam.py``).

The converters write the port's parameter tree directly, in the layout
``utils/convert.py`` produces from a JAX tree:

  * conv kernels stay OIHW, as the file has them;
  * ``nn.Linear`` (out, in) -> (in, out), and the ConvFFN's 1x1 convs
    fc1 / fc2 -> (in, out) matrices;
  * stages and decoder layers are lists of per-block dicts;
  * the ConvFFN depthwise conv + BatchNorm pair (the only BN left at
    inference) is folded into one conv+bias, in float32 and in the JAX
    package's operation order, before the cast to the target dtype:
        w' = w * (gamma / sqrt(var + eps)),  b' = beta - mean * gamma / sqrt(var + eps)
    so a bf16 load equals the JAX package's bit for bit.

Every tensor goes through float32 numpy on the way in (a bf16 file
included) and is cast once to the target dtype. Layer scales (ls, ls1, ls2)
are imported verbatim, not folded: ``utils/hf_export.py`` can then rebuild
the state dict bit-exactly, and ``Engine`` folds them.

Key map (reference module tree):
  model.vision_tower.vision_tower.model.*   FastViT
  model.mm_projector.{0,2}.*                mlp2x_gelu Linear/GELU/Linear
  model.{embed_tokens,layers.*,norm}, lm_head   HF Qwen2
Network list indices: stages and downsamplers interleave as [stage0, down,
stage1, down, stage2, down, cpe, stage3, down, cpe, stage4].
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from fastvlm_tpu_torch.config import (
    FastViTConfig,
    FastVLMConfig,
    ProjectorConfig,
    Qwen2Config,
)

Array = np.ndarray
StateDict = Mapping[str, Array]
Params = Dict[str, Any]

VISION_PREFIX = "model.vision_tower.vision_tower.model."
PROJECTOR_PREFIX = "model.mm_projector."


# ---------------------------------------------------------------------------
# raw state-dict loading
# ---------------------------------------------------------------------------


def load_state_dict(path: str) -> Dict[str, Array]:
    """Load a HF checkpoint dir (safetensors single/sharded, or torch .bin)
    as numpy arrays, bf16 tensors as float32."""
    if os.path.isfile(path):
        return _load_one(path)
    idx = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx):
        with open(idx) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out: Dict[str, Array] = {}
        for s in shards:
            out.update(_load_one(os.path.join(path, s)))
        return out
    single = os.path.join(path, "model.safetensors")
    if os.path.exists(single):
        return _load_one(single)
    binp = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(binp):
        return _load_one(binp)
    raise FileNotFoundError(f"no checkpoint found under {path}")


def _load_one(fp: str) -> Dict[str, Array]:
    if fp.endswith(".safetensors"):
        # imported here: a .bin checkpoint must not need safetensors. The
        # torch loader reads bf16 files too (numpy has no bfloat16)
        from safetensors.torch import load_file

        sd = load_file(fp)
    else:
        sd = torch.load(fp, map_location="cpu", weights_only=True)
    return {k: _to_np(v) for k, v in sd.items()}


def _to_np(t) -> Array:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _f32(x) -> Array:
    return np.asarray(x, np.float32)


def _tensor(a: Array, dtype: torch.dtype) -> torch.Tensor:
    """float32 numpy (any strides) -> a contiguous CPU tensor of ``dtype``,
    rounded once (round to nearest even, as ``jnp.asarray(a, dtype)``)."""
    out = torch.empty(a.shape, dtype=dtype)
    out.copy_(torch.from_numpy(a))
    return out


def _conv(sd: StateDict, name: str, dtype) -> Params:
    """torch conv ``{name}.weight`` OIHW (+ optional bias), kept OIHW."""
    p = {"w": _tensor(_f32(sd[name + ".weight"]), dtype)}
    if name + ".bias" in sd:
        p["b"] = _tensor(_f32(sd[name + ".bias"]), dtype)
    return p


def _conv_bn_folded(sd: StateDict, conv: str, bn: str, dtype,
                    eps=1e-5) -> Params:
    w = _f32(sd[conv + ".weight"])  # OIHW
    gamma = _f32(sd[bn + ".weight"])
    beta = _f32(sd[bn + ".bias"])
    mean = _f32(sd[bn + ".running_mean"])
    var = _f32(sd[bn + ".running_var"])
    std = np.sqrt(var + eps)
    w = w * (gamma / std)[:, None, None, None]
    b = beta - mean * gamma / std
    return {"w": _tensor(w, dtype), "b": _tensor(b, dtype)}


def _pointwise(sd: StateDict, name: str, dtype) -> Params:
    """1x1 conv (out, in, 1, 1) + bias -> (in, out) matrix + bias."""
    w = _f32(sd[name + ".weight"])
    return {"w": _tensor(w.reshape(w.shape[0], w.shape[1]).T, dtype),
            "b": _tensor(_f32(sd[name + ".bias"]), dtype)}


def _linear(sd: StateDict, name: str, dtype, bias=True) -> Params:
    p = {"w": _tensor(_f32(sd[name + ".weight"]).T, dtype)}
    if bias and name + ".bias" in sd:
        p["b"] = _tensor(_f32(sd[name + ".bias"]), dtype)
    return p


def _vec(sd: StateDict, name: str, dtype) -> torch.Tensor:
    return _tensor(_f32(sd[name]).reshape(-1), dtype)


# ---------------------------------------------------------------------------
# FastViTHD vision tower
# ---------------------------------------------------------------------------


def convert_vision(sd: StateDict, cfg: FastViTConfig, dtype=torch.float32,
                   prefix: str = VISION_PREFIX) -> Params:
    from fastvlm_tpu_torch.utils.reparam import (
        fuse_reparam_branches, needs_fusion)

    if needs_fusion(sd):
        # train-time (multi-branch) checkpoint: fuse MobileOne / RepLK /
        # RepMixer / RepCPE branches first
        sd = fuse_reparam_branches(sd)
    g = lambda n: prefix + n  # noqa: E731

    stem = [_conv(sd, g(f"patch_embed.{i}.reparam_conv"), dtype)
            for i in range(3)]

    def ffn(base: str) -> Params:
        return {
            "dw": _conv_bn_folded(sd, base + ".conv.conv", base + ".conv.bn",
                                  dtype),
            "fc1": _pointwise(sd, base + ".fc1", dtype),
            "fc2": _pointwise(sd, base + ".fc2", dtype),
        }

    def repmixer_block(base: str) -> Params:
        return {
            "mixer": _conv(sd, base + ".token_mixer.reparam_conv", dtype),
            "ffn": ffn(base + ".convffn"),
            "ls": _vec(sd, base + ".layer_scale", dtype),
        }

    def attention_block(base: str) -> Params:
        return {
            "norm_scale": _vec(sd, base + ".norm.weight", dtype),
            "norm_bias": _vec(sd, base + ".norm.bias", dtype),
            "qkv": _linear(sd, base + ".token_mixer.qkv", dtype, bias=False),
            "proj": _linear(sd, base + ".token_mixer.proj", dtype),
            "ffn": ffn(base + ".convffn"),
            "ls1": _vec(sd, base + ".layer_scale_1", dtype),
            "ls2": _vec(sd, base + ".layer_scale_2", dtype),
        }

    stages: List[Params] = []
    net = 0  # index into the reference's flat ModuleList
    for i, n_blocks in enumerate(cfg.layers):
        stage: Params = {}
        if cfg.pos_embs[i]:
            stage["cpe"] = _conv(sd, g(f"network.{net}.reparam_conv"), dtype)
            net += 1
        make = (repmixer_block if cfg.token_mixers[i] == "repmixer"
                else attention_block)
        stage["blocks"] = [make(g(f"network.{net}.{b}"))
                           for b in range(n_blocks)]
        net += 1
        if i + 1 < len(cfg.layers):
            stage["down"] = {
                "lk": _conv(sd, g(f"network.{net}.proj.0.lkb_reparam"), dtype),
                "pw": _conv(sd, g(f"network.{net}.proj.1.reparam_conv"), dtype),
            }
            net += 1
        stages.append(stage)

    conv_exp = _conv(sd, g("conv_exp.reparam_conv"), dtype)
    conv_exp["se"] = {
        "reduce_w": _conv(sd, g("conv_exp.se.reduce"), dtype)["w"],
        "reduce_b": _vec(sd, g("conv_exp.se.reduce.bias"), dtype),
        "expand_w": _conv(sd, g("conv_exp.se.expand"), dtype)["w"],
        "expand_b": _vec(sd, g("conv_exp.se.expand.bias"), dtype),
    }
    return {"stem": stem, "stages": stages, "conv_exp": conv_exp}


# ---------------------------------------------------------------------------
# projector / decoder / full VLM
# ---------------------------------------------------------------------------


def convert_projector(sd: StateDict, cfg: ProjectorConfig, dtype=torch.float32,
                      prefix: str = PROJECTOR_PREFIX) -> Params:
    if cfg.projector_type == "identity":
        return {"layers": []}
    layers = []
    i = 0
    # reference Sequential: Linear, GELU, Linear, GELU, ... -> even indices
    while prefix + f"{i}.weight" in sd:
        layers.append(_linear(sd, prefix + str(i), dtype))
        i += 2
    if not layers:
        raise KeyError(f"no projector weights under {prefix}")
    return {"layers": layers}


def convert_decoder(sd: StateDict, cfg: Qwen2Config, dtype=torch.float32,
                    prefix: str = "") -> Params:
    g = lambda n: prefix + n  # noqa: E731
    layers = []
    for i in range(cfg.num_layers):
        base = g(f"model.layers.{i}.")
        layers.append({
            "ln1": _vec(sd, base + "input_layernorm.weight", dtype),
            "q": _linear(sd, base + "self_attn.q_proj", dtype),
            "k": _linear(sd, base + "self_attn.k_proj", dtype),
            "v": _linear(sd, base + "self_attn.v_proj", dtype),
            "o": _linear(sd, base + "self_attn.o_proj", dtype, bias=False),
            "ln2": _vec(sd, base + "post_attention_layernorm.weight", dtype),
            "gate": _linear(sd, base + "mlp.gate_proj", dtype, bias=False),
            "up": _linear(sd, base + "mlp.up_proj", dtype, bias=False),
            "down": _linear(sd, base + "mlp.down_proj", dtype, bias=False),
        })
    params: Params = {
        "embed": _tensor(_f32(sd[g("model.embed_tokens.weight")]), dtype),
        "layers": layers,
        "final_norm": _vec(sd, g("model.norm.weight"), dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _linear(sd, g("lm_head"), dtype, bias=False)
    return params


def convert_decoder_mpt(sd: StateDict, cfg: Qwen2Config, dtype=torch.float32,
                        prefix: str = "") -> Params:
    """HF MptForCausalLM state dict -> the port's tree (transformer.blocks.*,
    fused bias-free Wqkv, bias-free LayerNorm, up/down GELU MLP, tied
    embeddings)."""
    g = lambda n: prefix + n  # noqa: E731
    qd, kvd = cfg.q_dim, cfg.kv_dim
    layers = []
    for i in range(cfg.num_layers):
        base = g(f"transformer.blocks.{i}.")
        wqkv = _f32(sd[base + "attn.Wqkv.weight"])
        q = {"w": _tensor(wqkv[:qd].T, dtype)}
        k = {"w": _tensor(wqkv[qd:qd + kvd].T, dtype)}
        v = {"w": _tensor(wqkv[qd + kvd:].T, dtype)}
        if base + "attn.Wqkv.bias" in sd:  # no_bias=False checkpoints
            bqkv = _f32(sd[base + "attn.Wqkv.bias"])
            q["b"] = _tensor(bqkv[:qd], dtype)
            k["b"] = _tensor(bqkv[qd:qd + kvd], dtype)
            v["b"] = _tensor(bqkv[qd + kvd:], dtype)
        layers.append({
            "ln1": _vec(sd, base + "norm_1.weight", dtype),
            "q": q, "k": k, "v": v,
            "o": _linear(sd, base + "attn.out_proj", dtype),
            "ln2": _vec(sd, base + "norm_2.weight", dtype),
            "up": _linear(sd, base + "ffn.up_proj", dtype),
            "down": _linear(sd, base + "ffn.down_proj", dtype),
        })
    params: Params = {
        "embed": _tensor(_f32(sd[g("transformer.wte.weight")]), dtype),
        "layers": layers,
        "final_norm": _vec(sd, g("transformer.norm_f.weight"), dtype),
    }
    if not cfg.tie_word_embeddings:
        if g("lm_head.weight") not in sd:
            raise KeyError(
                "MPT config says untied embeddings but the checkpoint has no "
                "lm_head.weight — set tie_word_embeddings=true in config.json "
                "(vanilla MPT ties wte as the output head)")
        params["lm_head"] = _linear(sd, g("lm_head"), dtype, bias=False)
    return params


def convert_vlm(sd: StateDict, cfg: FastVLMConfig,
                dtype=torch.float32) -> Params:
    if any(k.startswith("transformer.blocks.") for k in sd):
        # llava_mpt layout: everything roots under `transformer.`
        params = {
            "vision": convert_vision(
                sd, cfg.vision, dtype,
                prefix="transformer.vision_tower.vision_tower.model."),
            "projector": convert_projector(
                sd, cfg.projector, dtype, prefix="transformer.mm_projector."),
            "decoder": convert_decoder_mpt(sd, cfg.decoder, dtype),
        }
        if "transformer.image_newline" in sd:
            params["image_newline"] = _vec(sd, "transformer.image_newline",
                                           dtype)
        return params
    params = {
        "vision": convert_vision(sd, cfg.vision, dtype),
        "projector": convert_projector(sd, cfg.projector, dtype),
        "decoder": convert_decoder(sd, cfg.decoder, dtype),
    }
    if "model.image_newline" in sd:  # anyres unpad row separator
        params["image_newline"] = _vec(sd, "model.image_newline", dtype)
    return params


def load_vlm(checkpoint_dir: str, cfg: Optional[FastVLMConfig] = None,
             dtype=torch.float32):
    """One-call loader: (config.json + weights) -> (cfg, params), the params
    CPU tensors of ``dtype``. The state dict is dropped once converted."""
    from fastvlm_tpu_torch.config import load_vlm_config

    if cfg is None:
        cfg = load_vlm_config(checkpoint_dir)
    return cfg, convert_vlm(load_state_dict(checkpoint_dir), cfg, dtype)


# ---------------------------------------------------------------------------
# key-map verification
# ---------------------------------------------------------------------------


class _RecordingSD(dict):
    """State-dict wrapper that records which keys the converter consumed."""

    def __init__(self, sd: Mapping[str, Array]):
        super().__init__(sd)
        self.used: set = set()

    def __getitem__(self, k):
        self.used.add(k)
        return super().__getitem__(k)

    def __contains__(self, k):  # `name + ".bias" in sd` probes count as use
        hit = super().__contains__(k)
        if hit:
            self.used.add(k)
        return hit


# buffers the reference model carries that hold no weights we need
_IGNORABLE_SUFFIXES = (
    ".rotary_emb.inv_freq",          # recomputed from rope_theta
    ".attention_bias_cache",         # HF scratch buffers
    ".masked_bias", ".attn.bias",    # GPT-style causal masks
)


def audit_key_map(sd: StateDict, cfg: FastVLMConfig) -> Dict[str, Any]:
    """Convert ``sd`` (float32) while recording key usage; any checkpoint
    key the converter did NOT consume means the key map diverges from the
    reference module tree. Train-mode branches are fused first, so the
    recording wrapper sees the converter's reads; used/total then count the
    fused dict, and ``file_keys_total`` / ``keys_folded_by_fusion`` the
    file's."""
    from fastvlm_tpu_torch.utils.reparam import (
        fuse_reparam_branches, needs_fusion)

    fused_branches = False
    file_total = len(sd)
    if needs_fusion(sd):
        sd = fuse_reparam_branches(sd)
        fused_branches = True
    rec = _RecordingSD(sd)
    params = convert_vlm(rec, cfg, torch.float32)
    ignorable = set()
    if cfg.decoder.tie_word_embeddings:
        # tied checkpoints sometimes ship the duplicated head anyway
        ignorable.add("lm_head.weight")
    unused = [k for k in sd if k not in rec.used and k not in ignorable
              and not any(k.endswith(s) for s in _IGNORABLE_SUFFIXES)]
    report = {"params": params, "unused_keys": sorted(unused),
              "used": len(rec.used), "total": len(sd),
              "fused_train_branches": fused_branches}
    if fused_branches:
        report["file_keys_total"] = file_total
        report["keys_folded_by_fusion"] = file_total - len(sd)
    return report


def verify_checkpoint(checkpoint_dir: str,
                      goldens_path: Optional[str] = None,
                      cfg: Optional[FastVLMConfig] = None,
                      device: str = "cuda") -> Dict[str, Any]:
    """Checkpoint audit, on ``device`` (the card unless the caller asks for
    "cpu"):

    1. every state-dict key consumed (key-map completeness),
    2. the encoder's features and grid on a fixed input, float32 (finite,
       mean magnitude),
    3. with ``goldens_path``, a comparison against saved goldens (.npz from
       the reference: 'input' (1, S, S, 3) in [0, 1] and 'features'
       (1, N, C)) at a 1e-3 bar. A missing goldens file raises.
    """
    from fastvlm_tpu_torch.config import load_vlm_config
    from fastvlm_tpu_torch.models import fastvit, vlm
    from fastvlm_tpu_torch.utils.convert import to_device

    if cfg is None:
        cfg = load_vlm_config(checkpoint_dir)
    audit = audit_key_map(load_state_dict(checkpoint_dir), cfg)
    report: Dict[str, Any] = {
        "checkpoint": checkpoint_dir,
        "keys_total": audit["total"],
        "keys_used": audit["used"],
        "unused_keys": audit["unused_keys"],
    }
    params = to_device(audit.pop("params"), device)

    s = cfg.vision.image_size
    if goldens_path:
        if not os.path.exists(goldens_path):
            # a typo'd goldens path must NOT silently downgrade to PASS
            raise FileNotFoundError(f"goldens file not found: {goldens_path}")
        g = np.load(goldens_path)
        x = _f32(g["input"])
    else:
        g = None
        x = np.random.RandomState(0).rand(1, s, s, 3).astype(np.float32)
    x = torch.from_numpy(x).to(device)

    with torch.inference_mode():
        feats = vlm.encode_images(params, cfg, x).float().cpu().numpy()
        grid = fastvit.features_grid(params["vision"], x,
                                     cfg.vision).float().cpu().numpy()
    report["features_shape"] = list(feats.shape)
    report["features_finite"] = bool(np.all(np.isfinite(feats)))
    report["features_abs_mean"] = float(np.abs(feats).mean())
    report["tower_grid_shape"] = list(grid.shape)
    report["tower_grid_finite"] = bool(np.all(np.isfinite(grid)))

    if g is not None and "features" in g:
        diff = np.abs(feats - _f32(g["features"]))
        report["golden_max_abs_diff"] = float(diff.max())
        report["golden_pass_1e-3"] = bool(diff.max() <= 1e-3)
    return report


# ---------------------------------------------------------------------------
# native save / restore (converted, quantized or trained trees)
# ---------------------------------------------------------------------------
#
# The JAX package writes these with Orbax (``save_native`` /
# ``restore_native``); Orbax imports JAX, so the port keeps its own format:
# a directory holding ``params.pt``, the nested tree (dicts, lists, tensors)
# written by ``torch.save`` from CPU copies and read back with
# ``torch.load(weights_only=True)``, which loads tensors and containers
# only. Strides are kept (an int8 ``w_q`` stays K-major). The two formats do
# not read each other; a tree moves between them through numpy
# (``utils/convert.py`` one way).

NATIVE_FILE = "params.pt"


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def save_native(path: str, params: Any) -> None:
    """Write ``params`` under the directory ``path`` (made if missing; an
    earlier bundle there is replaced, as Orbax's ``force=True``)."""
    os.makedirs(path, exist_ok=True)
    dst = os.path.join(path, NATIVE_FILE)
    tmp = dst + ".tmp"
    torch.save(_map_tree(lambda t: t.detach().cpu(), params), tmp)
    os.replace(tmp, dst)


def restore_native(path: str, like: Any = None, device="cpu") -> Any:
    """Read the tree under ``path`` onto ``device``. With ``like`` (a tree of
    the same structure, as the JAX ``restore_native`` takes), every leaf's
    shape and dtype must match it, and each lands on its ``like`` leaf's
    device."""
    tree = torch.load(os.path.join(path, NATIVE_FILE), map_location="cpu",
                      weights_only=True)
    if like is None:
        return _map_tree(lambda t: t.to(device), tree)
    return _restore_like(tree, like, "")


def _restore_like(tree, like, where):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(like):
            raise ValueError(f"restore_native: keys differ at {where or '/'}")
        return {k: _restore_like(tree[k], like[k], f"{where}/{k}")
                for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"restore_native: lengths differ at {where}")
        return type(like)(_restore_like(t, l, f"{where}/{i}")
                          for i, (t, l) in enumerate(zip(tree, like)))
    if tree.shape != like.shape or tree.dtype != like.dtype:
        raise ValueError(f"restore_native: {where} is {tuple(tree.shape)} "
                         f"{tree.dtype}, expected {tuple(like.shape)} "
                         f"{like.dtype}")
    return tree.to(like.device)
