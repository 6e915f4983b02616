"""The port's HF export (fastvlm_tpu_torch/utils/hf_export.py) against the
JAX package's, and its round trip through the port's importer.

* port params -> ``export_state_dict`` -> ``convert_vlm`` gives the params
  back bit for bit, for the Qwen2 and llava_mpt layouts, with the decoder
  unfused and fused (``qwen2.fuse_decoder_params``), and through a
  safetensors file (``export_hf`` -> ``load_state_dict``);
* the port's export of a tree equals the JAX package's export of the same
  weights, key for key and array for array;
* ``vlm_config_to_hf_dict`` equals JAX's;
* the exported vision keys are the reference module tree's;
* quantized and LoRA trees are rejected.

f32, tiny configs, CPU.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.utils import hf_export as jexport
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import qwen2 as tqwen2
from fastvlm_tpu_torch.utils import checkpoint as tckpt
from fastvlm_tpu_torch.utils import hf_export as texport
from fastvlm_tpu_torch.utils.convert import from_jax_params
from tests.test_checkpoint import _make_vision_sd, tiny_cfg
from tests.test_torch_checkpoint import _port_vision, assert_trees_equal


def _cfg(pkg, family):
    """A tiny VLM config of each family: untied head, anyres with the
    unpad merge (so the tree carries image_newline)."""
    vision = tiny_cfg() if pkg is jcfg else _port_vision(tiny_cfg())
    if family == "mpt":
        decoder = pkg.mpt_7b(vocab_size=128, hidden_size=32, num_layers=2,
                             num_heads=4, num_kv_heads=4, head_dim=8,
                             intermediate_size=128, tie_word_embeddings=False,
                             qkv_bias=True)
    else:
        decoder = pkg.Qwen2Config(vocab_size=128, hidden_size=32,
                                  num_layers=2, num_heads=4, num_kv_heads=2,
                                  head_dim=8, intermediate_size=64,
                                  tie_word_embeddings=False)
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=32),
        image_aspect_ratio="anyres",
        image_grid_pinpoints=((128, 256), (256, 128)),
        mm_patch_merge_type="spatial_unpad")


def _trees(family, seed=0):
    """(JAX cfg, numpy JAX-layout tree, port cfg, port tree): the same
    numpy-drawn weights in both layouts."""
    jc, tc = _cfg(jcfg, family), _cfg(tcfg, family)
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    tree = jax.tree.map(
        lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32), shapes)
    return jc, tree, tc, from_jax_params(tree, tc)


def _fused(params, cfg):
    return {**params,
            "decoder": tqwen2.fuse_decoder_params(params["decoder"],
                                                  cfg.decoder)}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("family", ["qwen2", "mpt"])
def test_roundtrip_bit_exact(family, fused):
    _, _, tc, params = _trees(family)
    src = _fused(params, tc) if fused else params
    sd = texport.export_state_dict(src, tc)
    assert all(v.dtype == np.float32 for v in sd.values())
    assert_trees_equal(tckpt.convert_vlm(sd, tc), params)
    audit = tckpt.audit_key_map(sd, tc)
    assert audit["unused_keys"] == [] and audit["used"] == len(sd)


@pytest.mark.parametrize("family", ["qwen2", "mpt"])
def test_export_hf_file_roundtrip(family, tmp_path):
    """export_hf -> load_state_dict -> convert_vlm gives the params back;
    exporting them again gives the file's arrays (byte-stable), and the
    config.json reads back to the decoder config."""
    _, _, tc, params = _trees(family, seed=1)
    out = texport.export_hf(params, tc, str(tmp_path / "ckpt"))
    sd = tckpt.load_state_dict(out)
    params2 = tckpt.convert_vlm(sd, tc)
    assert_trees_equal(params2, params)
    sd2 = texport.export_state_dict(params2, tc)
    assert sorted(sd2) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(sd2[k], sd[k], err_msg=k)
    with open(os.path.join(out, "config.json")) as f:
        cfg2 = tcfg.vlm_config_from_hf_dict(json.load(f))
    assert cfg2.decoder == tc.decoder


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("family", ["qwen2", "mpt"])
def test_export_matches_jax(family, fused):
    jc, tree, tc, params = _trees(family, seed=2)
    src = _fused(params, tc) if fused else params
    got = texport.export_state_dict(src, tc)
    want = jexport.export_state_dict(tree, jc)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("family", ["qwen2", "mpt", "qwen2-pad"])
def test_config_dict_matches_jax(family):
    base = "mpt" if family == "mpt" else "qwen2"
    jc, tc = _cfg(jcfg, base), _cfg(tcfg, base)
    if family == "qwen2-pad":
        kw = dict(image_aspect_ratio="pad", image_grid_pinpoints=None,
                  mm_patch_merge_type="flat")
        jc, tc = dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    assert texport.vlm_config_to_hf_dict(tc) == jexport.vlm_config_to_hf_dict(jc)


def test_vision_keys_match_reference_module_tree():
    _, _, tc, params = _trees("qwen2", seed=3)
    sd = {}
    texport.export_vision(params["vision"], tc.vision, sd)
    assert set(sd) == set(_make_vision_sd(tiny_cfg(),
                                          np.random.RandomState(0)))


@pytest.mark.parametrize("extra,match", [
    ({"w_q": torch.zeros(2, 2)}, "quantized"),
    ({"lora_a": torch.zeros(2, 2), "lora_b": torch.zeros(2, 2)}, "LoRA"),
])
def test_rejects_quantized_and_lora(extra, match):
    _, _, tc, params = _trees("qwen2", seed=4)
    dec = params["decoder"]
    layers = [dict(lp) for lp in dec["layers"]]
    layers[1]["q"] = {**layers[1]["q"], **extra}
    with pytest.raises(ValueError, match=match):
        texport.export_decoder({**dec, "layers": layers}, tc.decoder, {})


def test_folded_tree_is_refused():
    """Engine.params has its layer scales folded away: exporting it would
    lose them, so the exporter needs the tree given to the Engine."""
    from fastvlm_tpu_torch.models.fastvit import fold_layer_scale

    _, _, tc, params = _trees("qwen2", seed=5)
    with pytest.raises(KeyError):
        texport.export_vision(fold_layer_scale(params["vision"]), tc.vision,
                              {})
