"""The port's CLIP ViT tower, its S2 wrapper and the tower/decoder builders
against the JAX package's and HF ``CLIPVisionModel`` (f32, tiny configs).

* ``features`` equals JAX's on the same params (``from_jax_params``) at
  select_layer -2 / 'patch' and -1 / 'cls_patch': atol = rtol = 1e-5;
* ``convert_from_hf`` equals HF's hidden states (torch against torch):
  atol = rtol = 1e-5;
* ``features_s2`` equals JAX's at scales (28, 56) and (28, 56, 84): the
  bicubic up-resize and the antialiased bilinear pool agree to float
  rounding of their weights, atol = rtol = 1e-5; its first channels are
  the single-scale features (atol = rtol = 1e-6);
* a tiny CLIP-tower VLM gives JAX's greedy ids through ``vlm.generate`` and
  ``Engine.generate``;
* the builders agree with JAX's for each tower name and model_type family.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import builder as jbuilder
from fastvlm_tpu.models import clip_vit as jclip
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer
from fastvlm_tpu_torch.models import builder as tbuilder
from fastvlm_tpu_torch.models import clip_vit as tclip
from fastvlm_tpu_torch.models import vlm as tvlm
from fastvlm_tpu_torch.utils.convert import clip_from_jax, from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny(mod, **kw):
    base = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                num_heads=4, intermediate_size=64)
    base.update(kw)
    return mod.CLIPViTConfig(**base)


def _draw(shapes, seed):
    """Params of the JAX init's shapes drawn with numpy: LayerNorm scales
    near 1, biases and every other leaf N(0, 0.02) except the matrices and
    embeddings (N(0, 0.2), so the tiny tower's layers matter)."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name.endswith("_s"):
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _tower_params(cfg_j, cfg_t, seed=0):
    shapes = jax.eval_shape(lambda k: jclip.init(k, cfg_j),
                            jax.random.PRNGKey(0))
    tree = _draw(shapes, seed)
    return (jax.tree.map(jnp.asarray, tree),
            clip_from_jax(tree, cfg_t.num_layers))


def _images(n, size, seed):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("select_layer,select_feature",
                         [(-2, "patch"), (-1, "cls_patch"), (1, "patch")])
def test_features_match_jax(select_layer, select_feature):
    kw = dict(select_layer=select_layer, select_feature=select_feature)
    cj, ct = _tiny(jclip, **kw), _tiny(tclip, **kw)
    jp, tp = _tower_params(cj, ct)
    x = _images(2, 28, 1)
    want = np.asarray(jclip.features(jp, jnp.asarray(x), cj))
    got = tclip.features(tp, torch.from_numpy(x), ct).numpy()
    assert got.shape == want.shape == (2, ct.num_tokens, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_select_layer_runs_that_many_layers():
    """-2 runs all but the last layer, with no post-LN: the features are
    the hidden states after num_layers - 1 layers (dropping the last
    layer's params changes nothing)."""
    ct = _tiny(tclip)
    _, tp = _tower_params(_tiny(jclip), ct)
    x = torch.from_numpy(_images(1, 28, 2))
    got = tclip.features(tp, x, ct)
    short = {**tp, "layers": tp["layers"][:2]}
    np.testing.assert_array_equal(
        got.numpy(),
        tclip.features(short, x, dataclasses.replace(ct, num_layers=2,
                                                     select_layer=-1)).numpy())


def _hf_model(cfg):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    hf_cfg = CLIPVisionConfig(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads,
        intermediate_size=cfg.intermediate_size, hidden_act="quick_gelu",
        layer_norm_eps=cfg.ln_eps)
    torch.manual_seed(0)
    model = CLIPVisionModel(hf_cfg)
    with torch.no_grad():  # non-trivial biases and norms
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model.eval()


@pytest.mark.parametrize("select_layer,select_feature,drop",
                         [(-2, "patch", 1), (-1, "cls_patch", 0)])
def test_convert_from_hf_matches_hf_hidden_states(select_layer,
                                                  select_feature, drop):
    cfg = _tiny(tclip, select_layer=select_layer,
                select_feature=select_feature)
    hf = _hf_model(cfg)
    params = tclip.convert_from_hf(hf.state_dict(), cfg)
    x = _images(2, 28, 3)
    with torch.no_grad():
        out = hf(torch.from_numpy(x).permute(0, 3, 1, 2),
                 output_hidden_states=True)
    want = out.hidden_states[select_layer].numpy()[:, drop:]
    got = tclip.features(params, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # and the JAX converter gives the port's tree (through the bridge)
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    jtree = jax.tree.map(np.asarray, jclip.convert_from_hf(
        sd, _tiny(jclip, select_layer=select_layer,
                  select_feature=select_feature)))
    bridged = clip_from_jax(jtree, cfg.num_layers)
    np.testing.assert_array_equal(bridged["patch_embed"].numpy(),
                                  params["patch_embed"].numpy())
    for a, b in zip(bridged["layers"], params["layers"]):
        np.testing.assert_array_equal(a["qkv"]["w"].numpy(),
                                      b["qkv"]["w"].numpy())


@pytest.mark.parametrize("scales", [(28, 56), (28, 56, 84)])
def test_features_s2_match_jax(scales):
    cj, ct = _tiny(jclip, s2_scales=scales), _tiny(tclip, s2_scales=scales)
    jp, tp = _tower_params(cj, ct, seed=4)
    x = _images(2, 28, 5)
    want = np.asarray(jclip.features_s2(jp, jnp.asarray(x), cj))
    got = tclip.features_s2(tp, torch.from_numpy(x), ct)
    assert got.shape == (2, ct.num_patches, 32 * len(scales))
    assert ct.out_hidden_size == 32 * len(scales)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    single = tclip.features(tp, torch.from_numpy(x), ct)
    np.testing.assert_allclose(got[..., :32].numpy(), single.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_features_s2_tiles_and_stitch_like_jax():
    """The tile / stitch transposes at a factor of 3 on an 84 px input (the
    28 px scale a downsizing resize, the 84 px scale 3 x 3 crops with no
    resize): with every layer skipped (select_layer 0) each crop's tokens
    are its pre-LN patch embeddings, so a transposed tile or stitch would
    move whole cells."""
    cj = _tiny(jclip, select_layer=0, s2_scales=(28, 84))
    ct = _tiny(tclip, select_layer=0, s2_scales=(28, 84))
    jp, tp = _tower_params(cj, ct, seed=6)
    x = _images(1, 84, 7)
    want = np.asarray(jclip.features_s2(jp, jnp.asarray(x), cj))
    got = tclip.features_s2(tp, torch.from_numpy(x), ct).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_s2_needs_scales_and_base():
    ct = _tiny(tclip)
    _, tp = _tower_params(_tiny(jclip), ct)
    x = torch.from_numpy(_images(1, 28, 0))
    with pytest.raises(ValueError):
        tclip.features_s2(tp, x, ct)
    with pytest.raises(ValueError):
        tclip.features_s2(tp, x, dataclasses.replace(ct, s2_scales=(56, 84)))


def test_quick_gelu_matches_jax():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(tclip.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jclip.quick_gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    xb = torch.from_numpy(x).bfloat16()
    assert tclip.quick_gelu(xb).dtype == torch.bfloat16


def test_init_shapes_match_jax():
    ct, cj = _tiny(tclip), _tiny(jclip)
    gen = torch.Generator().manual_seed(0)
    tp = tclip.init(gen, ct, dtype=torch.bfloat16)
    shapes = jax.eval_shape(lambda k: jclip.init(k, cj), jax.random.PRNGKey(0))
    bridged = clip_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes), ct.num_layers)
    flat_t = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: tuple(t.shape), tp,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))
    flat_b = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: tuple(t.shape), bridged,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert flat_t == flat_b
    assert tp["patch_embed"].dtype == torch.bfloat16
    assert len(tp["layers"]) == 3


# ---------------------------------------------------------------------------
# a tiny CLIP-tower VLM, both packages
# ---------------------------------------------------------------------------


def _vlm_cfg(pkg, clip_mod, **vision_kw):
    vision = _tiny(clip_mod, **vision_kw)
    decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=48, num_layers=2,
                              num_heads=4, num_kv_heads=2, head_dim=12,
                              intermediate_size=96)
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_hidden_size,
                                      hidden_size=48))


@pytest.fixture(scope="module", params=[(), (28, 56)], ids=["single", "s2"])
def clip_vlm(request):
    scales = request.param
    cj = _vlm_cfg(jcfg, jclip, s2_scales=scales)
    ct = _vlm_cfg(tcfg, tclip, s2_scales=scales)
    assert cj.num_image_tokens == ct.num_image_tokens == 4
    shapes = jax.eval_shape(lambda k: jvlm.init(k, cj), jax.random.PRNGKey(0))
    rng = np.random.RandomState(8)

    def draw(path, leaf):
        name = path[-1].key
        if name.endswith("_s") or name in ("ln1", "ln2", "final_norm"):
            return (1 + 0.05 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return cj, ct, jax.tree.map(jnp.asarray, tree), from_jax_params(tree, ct)


def test_clip_vlm_generate_matches_jax(clip_vlm):
    from fastvlm_tpu.ops.splice import expand_image_ids, pad_batch

    cj, ct, jp, tp = clip_vlm
    row, start = expand_image_ids([5, -200, 9, 31, 77], cj.num_image_tokens)
    ids, lens, starts = pad_batch([row], [start], 16)
    images = np.random.RandomState(9).rand(1, 28, 28, 3).astype(np.float32)
    want = jvlm.generate(jp, cj, jnp.asarray(images), jnp.asarray(ids),
                         jnp.asarray(lens), jnp.asarray(starts),
                         jax.random.PRNGKey(2), max_new_tokens=8,
                         eos_ids=(257,))
    got = tvlm.generate(tp, ct, torch.from_numpy(images),
                        torch.from_numpy(ids), torch.from_numpy(lens),
                        torch.from_numpy(starts), max_new_tokens=8,
                        eos_ids=(257,))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    # the projected embeddings themselves
    np.testing.assert_allclose(
        tvlm.encode_images(tp, ct, torch.from_numpy(images)).numpy(),
        np.asarray(jvlm.encode_images(jp, cj, jnp.asarray(images))), **TOL)


class IdTokenizer(ByteTokenizer):
    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def test_clip_engine_generate_matches_jax(clip_vlm):
    cj, ct, jp, tp = clip_vlm
    tok = IdTokenizer()
    je = jengine.Engine(cj, jp, tok, eos_ids=(tok.eos_token_id,))
    te = tengine.Engine(ct, tp, tok, eos_ids=(tok.eos_token_id,))
    assert te.params["vision"] is tp["vision"]  # nothing to fold
    image = np.random.RandomState(10).randint(0, 256, (28, 28, 3), np.uint8)
    for prompt in ("Describe the image.", "What is here?"):
        full = te.build_prompt(prompt)
        jtext, _ = je.generate(full, image, max_new_tokens=12)
        ttext, _ = te.generate(full, image, max_new_tokens=12)
        assert ttext == jtext
        assert ttext


def test_clip_tile_grids_raise_like_jax(clip_vlm):
    """Anyres tiles need FastViTHD's feature grid: with a CLIP tower the
    JAX encode_tile_grids fails inside FastViTHD's features_grid, and the
    port's raises before the tower runs."""
    cj, ct, jp, tp = clip_vlm
    tiles = np.random.RandomState(11).rand(3, 28, 28, 3).astype(np.float32)
    with pytest.raises(Exception):
        jvlm.encode_tile_grids(jp, cj, jnp.asarray(tiles))
    with pytest.raises(ValueError, match="FastViTHD"):
        tvlm.encode_tile_grids(tp, ct, torch.from_numpy(tiles))


def test_with_dtype_keeps_a_clip_tower():
    ct = _vlm_cfg(tcfg, tclip)
    out = tengine._with_dtype(ct, "bfloat16")
    assert out.vision == ct.vision
    assert out.decoder.compute_dtype == out.decoder.param_dtype == "bfloat16"
    fv = tengine._with_dtype(tcfg.FastVLMConfig(), "bfloat16")
    assert fv.vision.compute_dtype == "bfloat16"


def test_vlm_init_draws_a_clip_tower():
    ct = _vlm_cfg(tcfg, tclip)
    params = tvlm.init(torch.Generator().manual_seed(0), ct)
    assert len(params["vision"]["layers"]) == 3
    assert params["vision"]["patch_embed"].shape == (32, 3, 14, 14)
    assert params["vision"]["patch_embed"].dtype == torch.float32


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("mobileclip_l_1024", {}), ("mobileclip_l_384", {}),
    ("openai/clip-vit-large-patch14-336", {}),
    ("openai/clip-vit-large-patch14-336", {"s2_scales": (336, 672, 1008)}),
    ("laion/CLIP-ViT-H-14", {}), ("/ckpt/vision_tower", {}),
    ("./local_tower", {}),
])
def test_build_vision_tower_config_matches_jax(name, kw):
    want = jbuilder.build_vision_tower_config(name, **kw)
    got = tbuilder.build_vision_tower_config(name, **kw)
    assert type(got).__name__ == type(want).__name__
    shared = [f.name for f in dataclasses.fields(got)]
    assert {f: getattr(got, f) for f in shared} == \
        {f: getattr(want, f) for f in shared}
    assert got.num_tokens == want.num_tokens
    assert got.out_channels == want.out_channels


def test_build_vision_tower_config_unknown_name_raises():
    for mod in (jbuilder, tbuilder):
        with pytest.raises(ValueError):
            mod.build_vision_tower_config("resnet50")


_HF = {"vocab_size": 32000, "hidden_size": 4096, "num_hidden_layers": 32,
       "num_attention_heads": 32, "num_key_value_heads": 32,
       "intermediate_size": 11008, "rms_norm_eps": 1e-5,
       "rope_theta": 10000.0, "tie_word_embeddings": False}


@pytest.mark.parametrize("family", sorted(jbuilder._FAMILY_DEFAULTS)
                         + ["unknown_family"])
def test_build_decoder_config_matches_jax(family):
    # the port reads every family the JAX package reads, the same way, and
    # one more that the JAX package has no decoder for: mellum
    assert tbuilder._FAMILY_DEFAULTS == {**jbuilder._FAMILY_DEFAULTS,
                                         "mellum": {"qkv_bias": False}}
    d = dict(_HF, model_type=family)
    if "mistral" in family:
        d.update(sliding_window=4096, num_key_value_heads=8)
    want = jbuilder.build_decoder_config(d)
    got = tbuilder.build_decoder_config(d)
    shared = [f.name for f in dataclasses.fields(got)]
    assert {f: getattr(got, f) for f in shared} == \
        {f: getattr(want, f) for f in shared}


def test_build_decoder_config_window_off_and_overrides():
    d = dict(_HF, model_type="qwen2", sliding_window=4096,
             use_sliding_window=False)
    for mod in (jbuilder, tbuilder):
        cfg = mod.build_decoder_config(d, num_layers=2)
        assert cfg.attn_window is None and cfg.num_layers == 2


def test_llava15_geometry():
    """LLaVA-1.5-7B is CLIPViTConfig()'s defaults + mlp2x_gelu 1024 -> 4096
    + llama_7b: 576 image tokens of 1024 channels, MHA 32/32/128."""
    v = tclip.CLIPViTConfig()
    assert (v.num_tokens, v.out_channels, v.grid_size) == (576, 1024, 24)
    d = tcfg.llama_7b()
    assert (d.num_heads, d.num_kv_heads, d.head_dim) == (32, 32, 128)
    jv = jclip.CLIPViTConfig()
    assert (jv.num_tokens, jv.out_channels) == (v.num_tokens, v.out_channels)
