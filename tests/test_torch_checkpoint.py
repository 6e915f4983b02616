"""The port's checkpoint import (fastvlm_tpu_torch/utils/{reparam,checkpoint}.py,
``engine.build_engine(model_path)``, ``predict --model-path`` and
``--verify-checkpoint``) against the JAX package's.

* branch fusion equals JAX's bit for bit on each branch type and on a whole
  train-mode tower;
* ``convert_vlm`` writes exactly the tree ``utils/convert.from_jax_params``
  makes of JAX's ``convert_vlm``, in float32 and in bfloat16, for the Qwen2
  layout (with ``image_newline``), a train-mode tower and the llava_mpt
  layout;
* ``audit_key_map`` counts the keys JAX's does;
* ``load_state_dict`` reads a safetensors file, a sharded index and torch
  ``.bin`` files (float32 and bfloat16) to JAX's dict;
* the decoder on converted weights matches HF ``Qwen2ForCausalLM`` within
  2e-4 (no download: HF builds the random model on the CPU);
* ``build_engine(dir)`` gives the greedy ids of a JAX ``Engine`` built
  from JAX's ``load_vlm(dir)``; the CLI loads a directory and audits one.

Tiny configs on the CPU. The synthetic checkpoints reuse the state-dict
helpers of tests/test_checkpoint.py and tests/test_e2e_checkpoint.py; a
tiny tower's config overrides the one config.json implies
(``mobileclip_l_128`` is the full FastViTHD), as
tests/test_e2e_checkpoint.py does.
"""

import dataclasses
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.utils import checkpoint as jckpt
from fastvlm_tpu.utils import hf_export as jexport
from fastvlm_tpu.utils import reparam as jreparam
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine, predict
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.models import qwen2 as tqwen2
from fastvlm_tpu_torch.utils import checkpoint as tckpt
from fastvlm_tpu_torch.utils import reparam as treparam
from fastvlm_tpu_torch.utils.convert import from_jax_params
from tests.test_checkpoint import _make_vision_sd, tiny_cfg
from tests.test_e2e_checkpoint import HF_CONFIG, _make_decoder_sd

HF_TOL = 2e-4       # port decoder vs HF Qwen2ForCausalLM logits, f32
FEATURES_TOL = 1e-4  # port encoder features vs JAX's, f32


def flatten(tree, prefix=""):
    """{path: leaf} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}"))
    return out


def assert_trees_equal(got, want):
    """Same paths, dtypes and bits."""
    g, w = flatten(got), flatten(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        assert g[k].shape == w[k].shape, k
        assert torch.equal(g[k], w[k]), k


def _jax_to_port(jtree, cfg):
    return from_jax_params(jax.tree.map(np.asarray, jtree), cfg)


# ---------------------------------------------------------------------------
# synthetic state dicts
# ---------------------------------------------------------------------------

V = tckpt.VISION_PREFIX


def _bn(sd, name, c, rng):
    sd[name + ".weight"] = (1 + 0.3 * rng.randn(c)).astype(np.float32)
    sd[name + ".bias"] = (0.1 * rng.randn(c)).astype(np.float32)
    sd[name + ".running_mean"] = (0.2 * rng.randn(c)).astype(np.float32)
    sd[name + ".running_var"] = (0.5 + rng.rand(c)).astype(np.float32)


def _conv_bn(sd, name, cout, cin_g, k, rng):
    sd[name + ".conv.weight"] = (0.2 * rng.randn(cout, cin_g, k, k)
                                 ).astype(np.float32)
    _bn(sd, name + ".bn", cout, rng)


def _mobileone(sd, name, cout, cin_g, k, rng, skip=False):
    _conv_bn(sd, name + ".rbr_conv.0", cout, cin_g, k, rng)
    _conv_bn(sd, name + ".rbr_scale", cout, cin_g, 1, rng)
    if skip:
        _bn(sd, name + ".rbr_skip", cout, rng)


def _repmixer(sd, name, c, rng, layer_scale=True):
    _mobileone(sd, name + ".mixer", c, 1, 3, rng, skip=True)
    _bn(sd, name + ".norm.rbr_skip", c, rng)
    if layer_scale:
        sd[name + ".layer_scale"] = (0.01 * rng.rand(c, 1, 1)
                                     ).astype(np.float32)


def _replk(sd, name, c, rng):
    _conv_bn(sd, name + ".lkb_origin", c, 1, 7, rng)
    _conv_bn(sd, name + ".small_conv", c, 1, 3, rng)


def _repcpe(sd, name, c, rng):
    sd[name + ".pe.weight"] = (0.1 * rng.randn(c, 1, 7, 7)).astype(np.float32)
    sd[name + ".pe.bias"] = (0.1 * rng.randn(c)).astype(np.float32)


def _train_mode_vision_sd(cfg, rng):
    """The inference-mode reference tower of tests/test_checkpoint.py with
    every reparameterized conv replaced by its train-time branches: RepLK
    for the downsamplers' large kernels, RepMixer for the token mixers,
    RepCPE for the position convs, MobileOne elsewhere (with the BN skip
    where a 1x1 conv keeps its width)."""
    sd = _make_vision_sd(cfg, rng)
    fused = [k[:-len(".weight")] for k in list(sd)
             if k.endswith((".reparam_conv.weight", ".lkb_reparam.weight"))]
    for base in fused:
        w = sd.pop(base + ".weight")
        del sd[base + ".bias"]
        cout, cin_g, k = w.shape[0], w.shape[1], w.shape[-1]
        parent = base.rsplit(".", 1)[0]
        if base.endswith(".lkb_reparam"):
            _replk(sd, parent, cout, rng)
        elif base.endswith(".token_mixer.reparam_conv"):
            _repmixer(sd, parent, cout, rng)
        elif re.fullmatch(r".*\.network\.\d+", parent):
            _repcpe(sd, parent, cout, rng)
        else:
            _mobileone(sd, parent, cout, cin_g, k, rng,
                       skip=k == 1 and cin_g == cout)
    return sd


def _projector_sd(rng, prefix, cin, d):
    return {prefix + "0.weight": (0.05 * rng.randn(d, cin)).astype(np.float32),
            prefix + "0.bias": (0.05 * rng.randn(d)).astype(np.float32),
            prefix + "2.weight": (0.05 * rng.randn(d, d)).astype(np.float32),
            prefix + "2.bias": (0.05 * rng.randn(d)).astype(np.float32)}


def _qwen2_sd(rng, train_mode=False):
    vis = tiny_cfg()
    sd = (_train_mode_vision_sd(vis, rng) if train_mode
          else _make_vision_sd(vis, rng))
    sd.update(_make_decoder_sd(rng, HF_CONFIG))
    sd.update(_projector_sd(rng, tckpt.PROJECTOR_PREFIX, vis.out_channels,
                            HF_CONFIG["hidden_size"]))
    sd["model.image_newline"] = rng.randn(HF_CONFIG["hidden_size"]).astype(
        np.float32)
    return sd


def _port_vision(vision):
    """The port's FastViTConfig of a JAX one (less the TPU-only fields)."""
    return tcfg.FastViTConfig(**{f.name: getattr(vision, f.name)
                                 for f in dataclasses.fields(tcfg.FastViTConfig)})


def _qwen2_cfgs():
    """(JAX, port) configs of HF_CONFIG with the tiny tower."""
    return (dataclasses.replace(jcfg.vlm_config_from_hf_dict(HF_CONFIG),
                                vision=tiny_cfg()),
            dataclasses.replace(tcfg.vlm_config_from_hf_dict(HF_CONFIG),
                                vision=_port_vision(tiny_cfg())))


def _mpt_case(rng):
    """A llava_mpt state dict (transformer.* keys, fused Wqkv with bias,
    untied head, image_newline), written by the JAX package's exporter from
    numpy-drawn weights, and the (JAX, port) configs."""
    def cfg(pkg):
        vis = tiny_cfg() if pkg is jcfg else _port_vision(tiny_cfg())
        dec = pkg.mpt_7b(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=4, num_kv_heads=4, head_dim=8,
                         intermediate_size=128, tie_word_embeddings=False,
                         qkv_bias=True)
        return pkg.FastVLMConfig(
            vision=vis, decoder=dec, mm_patch_merge_type="spatial_unpad",
            projector=pkg.ProjectorConfig(mm_hidden_size=vis.out_channels,
                                          hidden_size=32))

    jc = cfg(jcfg)
    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    tree = jax.tree.map(
        lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32), shapes)
    return jexport.export_state_dict(tree, jc), jc, cfg(tcfg)


def _case(layout, rng):
    if layout == "mpt":
        return _mpt_case(rng)
    return (_qwen2_sd(rng, train_mode=layout == "qwen2-train-mode"),
            *_qwen2_cfgs())


# ---------------------------------------------------------------------------
# branch fusion
# ---------------------------------------------------------------------------


def _branch_sd(kind, rng):
    sd = {}
    if kind == "mobileone":
        _mobileone(sd, "blk", 6, 6, 3, rng, skip=True)
        _conv_bn(sd, "blk.rbr_conv.1", 6, 6, 3, rng)
    elif kind == "mobileone-dw-no-skip":
        _mobileone(sd, "dw", 4, 1, 3, rng)
    elif kind == "replk":
        _replk(sd, "down", 4, rng)
    elif kind == "repmixer":
        _repmixer(sd, "b.token_mixer", 4, rng)
    elif kind == "repmixer-no-ls":
        _repmixer(sd, "b.token_mixer", 4, rng, layer_scale=False)
    elif kind == "repcpe":
        _repcpe(sd, "net.0", 4, rng)
    elif kind == "tower":
        sd = _train_mode_vision_sd(tiny_cfg(), rng)
    return sd


@pytest.mark.parametrize("kind", ["mobileone", "mobileone-dw-no-skip",
                                  "replk", "repmixer", "repmixer-no-ls",
                                  "repcpe", "tower"])
def test_fuse_reparam_branches_matches_jax(kind):
    sd = _branch_sd(kind, np.random.RandomState(3))
    assert treparam.needs_fusion(sd) and jreparam.needs_fusion(sd)
    got, want = treparam.fuse_reparam_branches(sd), \
        jreparam.fuse_reparam_branches(sd)
    assert sorted(got) == sorted(want)
    assert not treparam.needs_fusion(got)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# conversion and the audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["qwen2", "qwen2-train-mode", "mpt"])
def test_convert_vlm_matches_jax_exactly(layout, dtype):
    """The port's converters write, bit for bit, what the weight bridge
    makes of the JAX converters' tree (the BN fold in JAX's float32 order,
    one rounding to bfloat16)."""
    sd, jc, tc = _case(layout, np.random.RandomState(4))
    want = _jax_to_port(jckpt.convert_vlm(sd, jc, getattr(jnp, dtype)), tc)
    got = tckpt.convert_vlm(sd, tc, getattr(torch, dtype))
    assert_trees_equal(got, want)
    assert "image_newline" in got
    for t in flatten(got).values():
        assert t.is_contiguous() and t.device.type == "cpu"


@pytest.mark.parametrize("case", ["clean", "extra-key", "train-mode",
                                  "ignorable-buffers", "mpt"])
def test_audit_key_map_matches_jax(case):
    rng = np.random.RandomState(5)
    sd, jc, tc = _case({"train-mode": "qwen2-train-mode", "mpt": "mpt"}.get(
        case, "qwen2"), rng)
    if case == "extra-key":
        # a key the map does not know (the SE's wrong name)
        sd[V + "conv_exp.se.fc1.weight"] = np.zeros((4, 4, 1, 1), np.float32)
    elif case == "ignorable-buffers":
        sd["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.zeros(
            4, np.float32)
        sd["lm_head.weight"] = np.zeros((8, 8), np.float32)  # tied duplicate
    got, want = tckpt.audit_key_map(sd, tc), jckpt.audit_key_map(sd, jc)
    for key in ("unused_keys", "used", "total", "fused_train_branches",
                "file_keys_total", "keys_folded_by_fusion"):
        assert got.get(key) == want.get(key), key
    assert got["unused_keys"] == ([V + "conv_exp.se.fc1.weight"]
                                  if case == "extra-key" else [])
    assert_trees_equal(got["params"], _jax_to_port(want["params"], tc))


@pytest.mark.parametrize("form", ["safetensors", "safetensors-bf16",
                                  "sharded", "bin", "bin-bf16"])
def test_load_state_dict_reads_every_form_like_jax(form, tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.RandomState(6)
    sd = {f"model.layers.{i}.w{j}": rng.randn(3, 5).astype(np.float32)
          for i in range(2) for j in range(3)}
    d = tmp_path / form
    d.mkdir()
    if form == "safetensors":
        save_file(sd, str(d / "model.safetensors"))
    elif form == "safetensors-bf16":
        from safetensors.torch import save_file as tsave

        tsave({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()},
              str(d / "model.safetensors"))
    elif form == "sharded":
        keys = sorted(sd)
        shards = {"model-00001-of-00002.safetensors": keys[:3],
                  "model-00002-of-00002.safetensors": keys[3:]}
        for name, ks in shards.items():
            save_file({k: sd[k] for k in ks}, str(d / name))
        (d / "model.safetensors.index.json").write_text(json.dumps(
            {"weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    else:
        dt = torch.bfloat16 if form == "bin-bf16" else torch.float32
        torch.save({k: torch.from_numpy(v).to(dt) for k, v in sd.items()},
                   str(d / "pytorch_model.bin"))

    if form.endswith("bf16"):
        sd = {k: torch.from_numpy(v).to(torch.bfloat16).float().numpy()
              for k, v in sd.items()}
    got, want = tckpt.load_state_dict(str(d)), jckpt.load_state_dict(str(d))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in sd:
        # JAX's numpy loader keeps a bf16 safetensors file in ml_dtypes'
        # bfloat16 where JAX has registered it; the port's gives float32
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k], np.float32))
        np.testing.assert_array_equal(got[k], sd[k])
    with pytest.raises(FileNotFoundError):
        tckpt.load_state_dict(str(tmp_path))


def test_decoder_converter_matches_hf():
    from transformers import Qwen2Config as HFCfg
    from transformers.models.qwen2 import Qwen2ForCausalLM

    cfg = tcfg.Qwen2Config(vocab_size=64, hidden_size=32, num_layers=2,
                           num_heads=4, num_kv_heads=2, head_dim=8,
                           intermediate_size=64, tie_word_embeddings=True)
    torch.manual_seed(1)
    hf = Qwen2ForCausalLM(HFCfg(
        vocab_size=64, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=8,
        intermediate_size=64, tie_word_embeddings=True,
        rope_theta=cfg.rope_theta, rms_norm_eps=cfg.rms_eps))
    hf.eval()
    sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    params = tckpt.convert_decoder(sd, cfg)
    ids = torch.tensor([[3, 9, 27, 5]])
    with torch.no_grad():
        want = hf(ids).logits
        hidden, _ = tqwen2.forward(params, cfg, tqwen2.embed(params, ids),
                                   torch.arange(4)[None])
        got = tqwen2.logits_from_hidden(params, hidden, cfg)
    torch.testing.assert_close(got, want, rtol=HF_TOL, atol=HF_TOL)


# ---------------------------------------------------------------------------
# build_engine, the CLI, verify_checkpoint
# ---------------------------------------------------------------------------


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """A llava_qwen2 checkpoint directory (config.json + model.safetensors)
    of the tiny tower and decoder, decoder matrices x4 so the tiny model
    does not echo."""
    from safetensors.numpy import save_file

    sd = _qwen2_sd(np.random.RandomState(7))
    del sd["model.image_newline"]
    for k in sd:
        if k.startswith("model.layers.") and sd[k].ndim == 2:
            sd[k] = sd[k] * 4
    d = tmp_path_factory.mktemp("ckpt") / "llava-fastvithd_tiny_stage3"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(HF_CONFIG))
    save_file(sd, str(d / "model.safetensors"))
    return str(d)


@pytest.fixture
def tiny_tower(monkeypatch):
    """config.json names the full tower; load the tiny one instead."""
    load = tcfg.load_vlm_config
    monkeypatch.setattr(tcfg, "load_vlm_config", lambda p, **o: dataclasses.
                        replace(load(p, **o), vision=_qwen2_cfgs()[1].vision))


def _jax_engine(path, tok):
    jc = _qwen2_cfgs()[0]
    jc = dataclasses.replace(
        jc, vision=dataclasses.replace(jc.vision, ffn_backend="pallas"),
        decoder=dataclasses.replace(jc.decoder, attn_backend="pallas"))
    jc, params = jckpt.load_vlm(path, cfg=jc)
    return jengine.Engine(jc, params, tok, eos_ids=(tok.eos_token_id,))


def _image():
    return np.random.RandomState(2).randint(0, 256, (128, 128, 3),
                                            dtype=np.uint8)


@pytest.mark.parametrize("prompt", ["Describe the image.",
                                    "What is written here?"])
def test_build_engine_from_dir_matches_jax(checkpoint_dir, tiny_tower,
                                           prompt):
    tok = IdTokenizer()
    te = engine.build_engine(checkpoint_dir, dtype="float32", device="cpu",
                             tokenizer=tok, eos_ids=(tok.eos_token_id,))
    je = _jax_engine(checkpoint_dir, tok)
    full = te.build_prompt(prompt)
    want, wstats = je.generate(full, _image(), max_new_tokens=12)
    got, gstats = te.generate(full, _image(), max_new_tokens=12)
    assert got == want
    assert len(set(got.split(","))) >= 3  # not one token repeated
    assert gstats["decode_tokens"] == wstats["decode_tokens"]
    assert te.device.type == "cpu" and te._dtype == torch.float32


def test_build_engine_bf16_loads_and_computes_in_bf16(checkpoint_dir,
                                                      tiny_tower):
    """A bfloat16 load: the params equal the JAX load's in bfloat16, and the
    engine computes in bfloat16 (where the JAX engine keeps config.json's
    float32 compute dtype)."""
    te = engine.build_engine(checkpoint_dir, dtype="bfloat16", device="cpu",
                             tokenizer=IdTokenizer())
    jc, jparams = jckpt.load_vlm(checkpoint_dir, cfg=_qwen2_cfgs()[0],
                                 dtype=jnp.bfloat16)
    want = _jax_to_port(jparams, te.cfg)
    # the engine folds the layer scales; the decoder is as loaded
    assert_trees_equal(te.params["decoder"], want["decoder"])
    assert_trees_equal(te.params["projector"], want["projector"])
    assert te._dtype == torch.bfloat16
    assert te.cfg.vision.compute_dtype == te.cfg.decoder.compute_dtype \
        == "bfloat16"
    text, stats = te.generate(te.build_prompt("Hi."), _image(),
                              max_new_tokens=4)
    assert stats["decode_tokens"] >= 1


def test_build_engine_without_transformers_raises(checkpoint_dir, tiny_tower,
                                                  monkeypatch):
    """tokenizer=None takes the HF tokenizer; without transformers the
    import raises instead of switching tokenizers."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        engine.build_engine(checkpoint_dir, dtype="float32", device="cpu")


def test_build_engine_from_dir_refuses_without_a_card(checkpoint_dir,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.build_engine(checkpoint_dir, tokenizer=IdTokenizer())


def test_predict_model_path_runs(checkpoint_dir, tiny_tower, tmp_path,
                                 capsys):
    """``predict --model-path`` on the CPU, a PIL image file, with
    ``AutoTokenizer`` standing in for the tokenizer files the synthetic
    directory lacks (tests/test_e2e_checkpoint.py's patch)."""
    import unittest.mock as mock

    from PIL import Image

    img = tmp_path / "img.jpg"
    Image.new("RGB", (200, 150), (90, 10, 240)).save(img)
    tok = IdTokenizer()
    tok.convert_tokens_to_ids = lambda s: None
    with mock.patch("transformers.AutoTokenizer") as auto:
        auto.from_pretrained.return_value = tok
        rc = predict.main(["--model-path", checkpoint_dir, "--image-file",
                           str(img), "--prompt", "Describe.",
                           "--temperature", "0", "--max-new-tokens", "4",
                           "--dtype", "float32", "--device", "cpu",
                           "--timing"])
        auto.from_pretrained.assert_called_once_with(checkpoint_dir)
    assert rc == 0
    assert '"device": "cpu"' in capsys.readouterr().err


def test_predict_verify_checkpoint_matches_jax(checkpoint_dir, tiny_tower,
                                               capsys):
    assert predict.main(["--model-path", checkpoint_dir,
                         "--verify-checkpoint", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert out.err.strip().endswith("PASS")
    got = json.loads(out.out)
    want = jckpt.verify_checkpoint(checkpoint_dir, cfg=_qwen2_cfgs()[0])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k == "features_abs_mean":
            assert abs(got[k] - v) <= FEATURES_TOL
        else:
            assert got[k] == v, k
    assert got["unused_keys"] == [] and got["features_shape"] == [1, 4, 64]


def test_verify_checkpoint_goldens(checkpoint_dir, tiny_tower, tmp_path,
                                   capsys):
    """Goldens of the JAX encoder pass the 1e-3 bar; a missing goldens file
    raises rather than passing without them."""
    jc = _qwen2_cfgs()[0]
    _, jparams = jckpt.load_vlm(checkpoint_dir, cfg=jc)
    x = np.random.RandomState(1).rand(1, 128, 128, 3).astype(np.float32)
    feats = np.asarray(jvlm.encode_images(jparams, jc, jnp.asarray(x)))
    gpath = str(tmp_path / "goldens.npz")
    np.savez(gpath, input=x, features=feats)
    report = tckpt.verify_checkpoint(checkpoint_dir, gpath, device="cpu")
    assert report["golden_pass_1e-3"], report["golden_max_abs_diff"]
    assert report["golden_max_abs_diff"] <= FEATURES_TOL
    with pytest.raises(FileNotFoundError, match="goldens"):
        tckpt.verify_checkpoint(checkpoint_dir, str(tmp_path / "none.npz"),
                                device="cpu")
    assert predict.main(["--model-path", checkpoint_dir, "--verify-checkpoint",
                         "--goldens", gpath, "--device", "cpu"]) == 0
    assert capsys.readouterr().err.strip().endswith("PASS")


def test_anyres_checkpoint_roundtrip_gives_same_ids(tiny_tower, tmp_path):
    """An anyres spatial_unpad model exported through utils/hf_export (its
    image_newline, image_grid_pinpoints and mm_patch_merge_type included)
    and loaded back by build_engine gives the exported engine's greedy ids
    on a PIL image that takes a 2 x 1 tile grid."""
    from PIL import Image

    from fastvlm_tpu_torch.utils import hf_export as texport

    vision = _qwen2_cfgs()[1].vision
    decoder = tcfg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                               num_heads=4, num_kv_heads=2, head_dim=16,
                               intermediate_size=128)
    pins = ((256, 128), (128, 256), (256, 256))
    tc = tcfg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=tcfg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                       hidden_size=64),
        image_aspect_ratio="anyres", image_grid_pinpoints=pins,
        mm_patch_merge_type="spatial_unpad")
    jc = dataclasses.replace(
        _qwen2_cfgs()[0], image_aspect_ratio="anyres",
        image_grid_pinpoints=pins, mm_patch_merge_type="spatial_unpad")
    rng = np.random.RandomState(11)

    def draw(path, leaf):
        scale = 0.2 if path[0].key == "decoder" and leaf.ndim >= 2 else 0.05
        if path[-1].key in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree_util.tree_map_with_path(draw, shapes),
                             tc)
    out = texport.export_hf(params, tc, str(tmp_path / "anyres"))
    tok = IdTokenizer()
    src = engine.Engine(tc, params, tok, eos_ids=(tok.eos_token_id,))
    got = engine.build_engine(out, dtype="float32", device="cpu",
                              tokenizer=tok, eos_ids=(tok.eos_token_id,))
    assert (got.cfg.image_aspect_ratio, got.cfg.image_grid_pinpoints,
            got.cfg.mm_patch_merge_type) == ("anyres", pins, "spatial_unpad")
    assert torch.equal(got.params["image_newline"], params["image_newline"])
    img = Image.fromarray(np.random.RandomState(12).randint(
        0, 256, (100, 230, 3), dtype=np.uint8))
    prompt = src.build_prompt("Describe the image.")
    want, wstats = src.generate(prompt, img, max_new_tokens=10)
    text, stats = got.generate(prompt, img, max_new_tokens=10)
    assert text == want and len(set(text.split(","))) >= 3
    assert stats["prompt_tokens"] == wstats["prompt_tokens"] > \
        src.prepare(prompt, np.array(img))["prompt_tokens"]
