"""The port's anyres tiling and tile merge (fastvlm_tpu_torch/ops/anyres.py,
the anyres half of data/preprocessing.py, ops/image_ops.anyres_tiles,
models/vlm.encode_tiles, the tile path of Engine.prepare) against the JAX
package's, mirroring tests/test_anyres.py:

* ``unpad_hw`` and ``num_merged_tokens`` equal JAX's over sizes, grids and
  merge types; the merges and ``process_anyres_image`` are bitwise equal;
* ``anyres_tiles`` on the tensor's device is within 1e-5 of JAX's (the
  bicubic resize agrees to float rounding, tests/test_torch_image_ops.py);
* ``vlm.encode_tiles`` is within 1e-5 of JAX's for each merge type;
* the anyres Engine's greedy ids equal the JAX Engine's for each merge type;
* the tower runs once per request over the whole [global + tiles] stack
  (the port's counterpart of JAX's one-compile-per-tile-count test).

Tiny f32 configs, weights drawn with numpy in the JAX init's shapes and
converted (utils/convert.py), 256 px tiles (4 x 4 feature grids, so an
unpad merge really crops)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.data import preprocessing as jpre
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import anyres as janyres
from fastvlm_tpu.ops import image_ops as jops
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.models import vlm as tvlm
from fastvlm_tpu_torch.ops import anyres, image_ops
from fastvlm_tpu_torch.utils.convert import from_jax_params

TOL = 1e-5
PINPOINTS = ((512, 256), (256, 512), (512, 512))
MERGES = ["flat", "spatial", "spatial_unpad"]


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def _cfg(pkg, merge, **extra):
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=256, attn_head_dim=16,
                               **extra.get("vision", {}))
    decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              intermediate_size=128,
                              **extra.get("decoder", {}))
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=64),
        image_aspect_ratio="anyres", image_grid_pinpoints=PINPOINTS,
        mm_patch_merge_type=merge)


def _jcfg(merge):
    return _cfg(jcfg, merge, vision={"ffn_backend": "pallas"},
                decoder={"attn_backend": "pallas"})


@pytest.fixture(scope="module")
def weights():
    """Numpy-drawn weights of the JAX init's shapes with the unpad merge's
    ``image_newline`` (tests/test_torch_engine.py's recipe: the decoder's
    matrices and embeddings N(0, 0.2), so the tiny decoder does not echo)."""
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "image_newline":
            return (rng.randn(*leaf.shape) / 8).astype(np.float32)
        scale = 0.2 if path[0].key == "decoder" and leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, _jcfg("spatial_unpad")),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _engines(weights, merge, **kw):
    tok = IdTokenizer()
    tc = _cfg(tcfg, merge)
    je = jengine.Engine(_jcfg(merge), jax.tree.map(jnp.asarray, weights), tok,
                        eos_ids=(tok.eos_token_id,), **kw)
    te = engine.Engine(tc, from_jax_params(weights, tc), tok,
                       eos_ids=(tok.eos_token_id,), **kw)
    return je, te


def _pil(w, h, seed=0):
    rng = np.random.RandomState(seed)
    return Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))


# ---------------------------------------------------------------------------
# host-side geometry
# ---------------------------------------------------------------------------

SIZES = [(1000, 400), (400, 1000), (640, 640), (1333, 777), (1920, 1080),
         (1024, 2048), (1600, 400), (300, 301)]


@pytest.mark.parametrize("orig", SIZES)
@pytest.mark.parametrize("grid_hw", [(32, 48), (8, 4), (4, 8), (16, 16)])
def test_unpad_hw_matches_jax(orig, grid_hw):
    assert anyres.unpad_hw(grid_hw, orig) == janyres.unpad_hw(grid_hw, orig)


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2), (3, 1)])
def test_num_merged_tokens_matches_jax(merge, grid):
    for orig in SIZES:
        for feat in (4, 16):
            assert anyres.num_merged_tokens(grid, feat, merge, orig) == \
                janyres.num_merged_tokens(grid, feat, merge, orig)


@pytest.mark.parametrize("orig", SIZES)
def test_select_best_resolution_matches_jax(orig):
    for pins in (PINPOINTS, ((2048, 1024), (1024, 2048), (2048, 2048)),
                 ((336, 672), (672, 336), (672, 672), (1008, 336))):
        assert preprocessing.select_best_resolution(orig, list(pins)) == \
            jpre.select_best_resolution(orig, list(pins))
        assert preprocessing.get_anyres_image_grid_shape(orig, pins, 256) == \
            jpre.get_anyres_image_grid_shape(orig, pins, 256)


@pytest.mark.parametrize("wh", [(900, 400), (400, 900), (600, 600),
                                (1600, 400), (333, 517)])
def test_process_anyres_image_bitwise(wh):
    img = _pil(*wh, seed=wh[0])
    want = jpre.process_anyres_image(img, jpre.ImageProcessor(256), PINPOINTS)
    got = preprocessing.process_anyres_image(
        img, preprocessing.ImageProcessor(256), PINPOINTS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    cfg = _cfg(tcfg, "spatial_unpad")
    np.testing.assert_array_equal(
        preprocessing.process_images([img], preprocessing.ImageProcessor(256),
                                     cfg),
        jpre.process_images([img], jpre.ImageProcessor(256), cfg))


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------


def test_merge_flat_bitwise():
    x = np.random.RandomState(0).randn(3, 2, 2, 4).astype(np.float32)
    np.testing.assert_array_equal(
        anyres.merge_flat(torch.from_numpy(x)).numpy(),
        np.asarray(janyres.merge_flat(jnp.asarray(x))))


@pytest.mark.parametrize("unpad", [False, True])
@pytest.mark.parametrize("newline", [False, True])
@pytest.mark.parametrize("grid,orig", [((2, 3), (1600, 400)),
                                       ((3, 2), (400, 1600)),
                                       ((2, 2), (640, 640))])
def test_merge_spatial_bitwise(unpad, newline, grid, orig):
    gw, gh = grid
    rng = np.random.RandomState(gw * 10 + gh)
    feats = rng.randn(1 + gw * gh, 4, 4, 5).astype(np.float32)
    nl = rng.randn(5).astype(np.float32) if newline else None
    want = np.asarray(janyres.merge_spatial(
        jnp.asarray(feats), grid, None if nl is None else jnp.asarray(nl),
        orig, unpad=unpad))
    got = anyres.merge_spatial(
        torch.from_numpy(feats), grid,
        None if nl is None else torch.from_numpy(nl), orig, unpad=unpad)
    np.testing.assert_array_equal(got.numpy(), want)
    # the crop box given directly gives the same tokens
    if unpad:
        box = anyres.unpad_hw((gh * 4, gw * 4), orig)
        again = anyres.merge_spatial(
            torch.from_numpy(feats), grid,
            None if nl is None else torch.from_numpy(nl), unpad=True,
            crop_box=box)
        np.testing.assert_array_equal(again.numpy(), want)


def test_merge_spatial_newline_cast_to_grid_dtype():
    feats = torch.randn(3, 2, 2, 4, dtype=torch.float64).to(torch.bfloat16)
    nl = torch.randn(4)
    out = anyres.merge_spatial(feats, (2, 1), nl, (400, 200), unpad=True)
    assert out.dtype == torch.bfloat16
    # 4 global tokens, then grid row 0: 4 tokens and its newline
    assert torch.equal(out[4 + 4], nl.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# device tiling, tile encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(200, 300), (300, 200), (150, 150),
                                (97, 260)])
def test_anyres_tiles_matches_jax(hw):
    x = np.random.RandomState(hw[0]).randint(0, 256, hw + (3,),
                                             dtype=np.uint8)
    pins = ((128, 64), (64, 128), (128, 128))
    best = preprocessing.select_best_resolution((hw[1], hw[0]), list(pins))
    want = np.asarray(jops.anyres_tiles(jnp.asarray(x), 64, best))
    got = image_ops.anyres_tiles(torch.from_numpy(x), 64, best)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (1 + best[0] // 64 * best[1] // 64,
                                       64, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("merge", MERGES)
def test_encode_tiles_matches_jax(weights, merge):
    img = _pil(1600, 400, seed=3)
    tiles = jpre.process_anyres_image(img, jpre.ImageProcessor(256),
                                      PINPOINTS)
    grid = jpre.get_anyres_image_grid_shape(img.size, PINPOINTS, 256)
    tc = _cfg(tcfg, merge)
    want = np.asarray(jvlm.encode_tiles(
        jax.tree.map(jnp.asarray, weights), _jcfg(merge), jnp.asarray(tiles),
        grid, img.size))
    got = tvlm.encode_tiles(from_jax_params(weights, tc), tc,
                            torch.from_numpy(tiles), grid, img.size)
    n = anyres.num_merged_tokens(grid, tc.vision.grid_size, merge, img.size)
    assert got.shape == want.shape == (1, n, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("merge", MERGES)
def test_engine_anyres_generate_matches_jax(weights, merge):
    """Greedy ids of the anyres Engine equal the JAX Engine's; the prompt
    holds the merged token count (more than one tile's)."""
    je, te = _engines(weights, merge)
    prompt = te.build_prompt("Describe.")
    img = _pil(1600, 400, seed=4)  # best (512, 256): a 2 x 1 grid
    jin, tin = je.prepare(prompt, img), te.prepare(prompt, img)
    for k in ("ids", "lens", "starts"):
        np.testing.assert_array_equal(tin[k].numpy(), np.asarray(jin[k]))
    np.testing.assert_allclose(tin["vision_embeds"].numpy(),
                               np.asarray(jin["vision_embeds"]), rtol=0,
                               atol=TOL)
    want, wstats = je.generate(prompt, img, max_new_tokens=10)
    got, gstats = te.generate(prompt, img, max_new_tokens=10)
    assert got == want
    assert len(set(got.split(","))) >= 3  # not one token repeated
    assert gstats["prompt_tokens"] == wstats["prompt_tokens"]
    assert gstats["prompt_tokens"] > te.cfg.num_image_tokens
    assert gstats["encode_ms"] > 0


def test_engine_anyres_arrays_take_one_image(weights):
    """An array under an anyres config is resized to one image of
    num_image_tokens, as in the JAX engine."""
    je, te = _engines(weights, "spatial_unpad")
    prompt = te.build_prompt("Describe.")
    x = np.random.RandomState(5).randint(0, 256, (200, 300, 3), np.uint8)
    jin, tin = je.prepare(prompt, x), te.prepare(prompt, x)
    assert tin["vision_embeds"] is None and tin["images"].shape == \
        (1, 256, 256, 3)
    np.testing.assert_array_equal(tin["ids"].numpy(), np.asarray(jin["ids"]))
    np.testing.assert_allclose(tin["images"].numpy(),
                               np.asarray(jin["images"]), rtol=0, atol=TOL)


def test_tower_runs_once_per_request(weights, monkeypatch):
    """Every anyres request runs the tower once, over its whole [global +
    tiles] stack, whatever its pixel size or grid."""
    _, te = _engines(weights, "spatial_unpad")
    calls = []
    real = tvlm.encode_tile_grids

    def counting(params, cfg, tiles):
        calls.append(tiles.shape[0])
        return real(params, cfg, tiles)

    monkeypatch.setattr(tvlm, "encode_tile_grids", counting)
    sizes = [(900, 400), (901, 400), (400, 900), (600, 600)]
    for w, h in sizes:
        te.prepare(te.build_prompt("hi"), Image.new("RGB", (w, h)))
    assert calls == [3, 3, 3, 5]
    te.generate(te.build_prompt("hi"), _pil(900, 400), max_new_tokens=3)
    assert calls == [3, 3, 3, 5, 3]
