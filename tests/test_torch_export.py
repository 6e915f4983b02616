"""The port's native save / restore (utils/checkpoint.py) and export tools
(fastvlm_tpu_torch/export.py) against the JAX package's, mirroring the
export half of tests/test_quant_export.py:

* ``save_native`` / ``restore_native`` round trip bitwise (dtypes, the
  K-major int8 layout, nested lists); ``like`` checks the structure;
* ``export_vision_encoder`` -> ``load_exported_encoder`` equals the eager
  encoder (kernel K1's plain version here, so bitwise; 1e-5 is the
  contract), holds one ``fastvlm::fused_ffn`` op per block, and writes the
  JAX exporter's sidecar JSON;
* ``quantize_checkpoint`` -> ``restore_native`` -> ``Engine`` gives the
  in-memory quantized engine's ids, and its tree and quantization.json
  equal the JAX command's (Orbax) output after convert;
* the CLI's default ``--device cuda`` refuses to run without a card.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import export as jexport
from fastvlm_tpu.models import fastvit as jfastvit
from fastvlm_tpu.utils import checkpoint as jckpt
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch import export as texport
from fastvlm_tpu_torch.models import fastvit as tfastvit
from fastvlm_tpu_torch.ops import quant as tquant
from fastvlm_tpu_torch.utils import checkpoint as tckpt
from fastvlm_tpu_torch.utils.convert import from_jax_params

import torch_tiny


@pytest.fixture(scope="module")
def weights():
    return torch_tiny.draw_weights(3)


@pytest.fixture(scope="module")
def port_tree(weights):
    return from_jax_params(weights, torch_tiny.tiny(tcfg))


def _assert_trees_identical(got, want):
    """Same structure, and every leaf the same dtype, shape, strides and
    bits."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_identical(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_identical(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.stride() == want.stride()
        assert torch.equal(got, want)


def test_save_restore_native_roundtrip_bitwise(port_tree, tmp_path):
    tree = {**port_tree,
            "decoder": tquant.quantize_decoder(port_tree["decoder"], 8,
                                               act_quant=True),
            "extra": [torch.arange(5, dtype=torch.int32),
                      torch.randn(3, 4).to(torch.bfloat16)]}
    path = str(tmp_path / "bundle")
    tckpt.save_native(path, tree)
    tckpt.save_native(path, tree)  # an existing bundle is replaced
    _assert_trees_identical(tckpt.restore_native(path), tree)
    _assert_trees_identical(tckpt.restore_native(path, like=tree), tree)
    w_q = tree["decoder"]["layers"][0]["q"]["w_q"]
    assert w_q.stride() == (1, w_q.shape[0])  # K-major survives the trip
    bad = {**tree, "extra": [tree["extra"][0]]}
    with pytest.raises(ValueError):
        tckpt.restore_native(path, like=bad)


def test_metadata_sidecars_match_jax(tmp_path):
    jexport.write_metadata(str(tmp_path / "j"), 1024, 64)
    texport.write_metadata(str(tmp_path / "t"), 1024, 64)
    for name in ("preprocessor_config.json", "processor_config.json"):
        assert (tmp_path / "t" / name).read_text() == \
            (tmp_path / "j" / name).read_text()


def test_export_vision_encoder_roundtrip(weights, port_tree, tmp_path):
    """The exported program (one fused_ffn op per block) run on the CPU
    equals the eager encoder, and equals the JAX encoder within 1e-5; the
    sidecars and the weights' bundle sit beside it."""
    cfg = torch_tiny.tiny(tcfg)
    vision = port_tree["vision"]
    out = str(tmp_path / "export")
    path = texport.export_vision_encoder(cfg, vision, out)
    assert path.endswith(".pt2") and os.path.exists(path)
    for name in ("preprocessor_config.json", "processor_config.json"):
        jexport.write_metadata(str(tmp_path / "j"), cfg.vision.image_size,
                               cfg.vision.total_stride)
        assert open(os.path.join(out, name)).read() == \
            (tmp_path / "j" / name).read_text()
    _assert_trees_identical(
        tckpt.restore_native(os.path.join(out, "vision_params")), vision)

    program = torch.export.load(path)
    ffn_ops = [n for n in program.graph.nodes
               if "fastvlm.fused_ffn" in str(n.target)]
    assert len(ffn_ops) == sum(cfg.vision.layers)

    fn = texport.load_exported_encoder(path)
    x = np.random.RandomState(1).rand(1, 128, 128, 3).astype(np.float32)
    got = fn(vision, torch.from_numpy(x))
    want = tfastvit.apply(vision, torch.from_numpy(x), cfg.vision)
    assert torch.equal(got, want)
    jwant = np.asarray(jfastvit.apply(
        jax.tree.map(jnp.asarray, weights["vision"]), jnp.asarray(x),
        torch_tiny.jax_config().vision))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-5, atol=1e-5)


def test_quantize_checkpoint_bundle_serves_in_memory_ids(weights, port_tree,
                                                         tmp_path):
    cfg = torch_tiny.tiny(tcfg)
    out = str(tmp_path / "q8")
    texport.quantize_checkpoint(cfg, port_tree, 8, out)
    meta = json.load(open(os.path.join(out, "quantization.json")))
    assert meta == {"bits": 8, "scheme": "weight-only per-channel",
                    "quantized": ["decoder.layers.*", "decoder.lm_head"]}
    restored = tckpt.restore_native(os.path.join(out, "params"))
    in_memory = {**port_tree,
                 "decoder": tquant.quantize_decoder(port_tree["decoder"], 8)}
    _assert_trees_identical(restored, in_memory)
    tok = torch_tiny.IdTokenizer()
    kw = dict(eos_ids=(tok.eos_token_id,))
    a = tengine.Engine(cfg, restored, tok, **kw)
    b = tengine.Engine(cfg, in_memory, tok, **kw)
    img = torch_tiny.image(5)
    got = a.chat("Describe the image.", img, max_new_tokens=8)[0]
    assert got and got == b.chat("Describe the image.", img,
                                 max_new_tokens=8)[0]


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_cli_matches_jax_cli(weights, tmp_path, monkeypatch, bits):
    """``export quantize`` in both packages over the same weights (the
    checkpoint loader patched to return them): the port's bundle equals the
    JAX bundle (Orbax, restored to numpy) after convert, and both write the
    same quantization.json."""
    tc, jc = torch_tiny.tiny(tcfg), torch_tiny.jax_config()
    monkeypatch.setattr(
        jckpt, "load_vlm",
        lambda path, dtype=None: (jc, jax.tree.map(jnp.asarray, weights)))
    monkeypatch.setattr(
        tckpt, "load_vlm", lambda path, dtype=None: (
            tc, from_jax_params(weights, tc)))
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    assert jexport.main(["quantize", "--model-path", "x", "--output", jout,
                         "--bits", str(bits)]) == 0
    assert texport.main(["quantize", "--model-path", "x", "--output", tout,
                         "--bits", str(bits), "--device", "cpu"]) == 0
    assert open(os.path.join(tout, "quantization.json")).read() == \
        open(os.path.join(jout, "quantization.json")).read()
    jtree = jax.tree.map(np.asarray, jckpt.restore_native(
        os.path.join(jout, "params"), None))
    want = from_jax_params(jtree, tc)
    got = tckpt.restore_native(os.path.join(tout, "params"))
    assert sorted(got) == sorted(want)
    for (gk, g), (wk, w) in zip(_leaves(got), _leaves(want)):
        assert gk == wk and g.dtype == w.dtype and torch.equal(g, w), gk


def test_quantization_json_names_lm_head_when_tied_like_jax(weights,
                                                            tmp_path):
    """A tied decoder has no lm_head to quantize, yet JAX's
    quantization.json lists "decoder.lm_head"; the port writes the same
    file (ROADMAP Queue 3)."""
    tc = torch_tiny.with_decoder(torch_tiny.tiny(tcfg),
                                 tie_word_embeddings=True)
    jc = torch_tiny.with_decoder(torch_tiny.jax_config(),
                                 tie_word_embeddings=True)
    tied = {**weights, "decoder": {k: v for k, v in
                                   weights["decoder"].items()
                                   if k != "lm_head"}}
    jexport.quantize_checkpoint(jc, jax.tree.map(jnp.asarray, tied), 8,
                                str(tmp_path / "j"))
    texport.quantize_checkpoint(tc, from_jax_params(tied, tc), 8,
                                str(tmp_path / "t"))
    got = (tmp_path / "t" / "quantization.json").read_text()
    assert got == (tmp_path / "j" / "quantization.json").read_text()
    assert "decoder.lm_head" in json.loads(got)["quantized"]
    restored = tckpt.restore_native(str(tmp_path / "t" / "params"))
    assert "lm_head" not in restored["decoder"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("cmd", ["vision", "quantize"])
def test_cli_default_device_needs_a_card(cmd, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        texport.main([cmd, "--model-path", "x", "--output", str(tmp_path)])
    assert e.value.code != 0


def test_vision_cli_exports_on_cpu(weights, tmp_path, monkeypatch):
    tc = torch_tiny.tiny(tcfg)
    monkeypatch.setattr(tckpt, "load_vlm", lambda path, dtype=None: (
        tc, from_jax_params(weights, tc)))
    out = str(tmp_path / "v")
    assert texport.main(["vision", "--model-path", "x", "--output", out,
                         "--device", "cpu"]) == 0
    fn = texport.load_exported_encoder(os.path.join(out, "fastvithd.pt2"))
    vision = tckpt.restore_native(os.path.join(out, "vision_params"))
    x = torch.rand(1, 128, 128, 3)
    assert torch.equal(fn(vision, x),
                       tfastvit.apply(vision, x, tc.vision))
