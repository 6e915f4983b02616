"""The port's multi-image prompts (ops/splice.py's multi variants, the
multi-image branches of models/vlm.py, Engine._prepare_multi) and
utils/tokens.py against the JAX package's, mirroring
tests/test_multi_image_misc.py:

* ``expand_image_ids_multi`` and ``overlay_image_embeds_multi`` equal JAX's;
* prefill with (B, M, H, W, 3) images and with (B, M, N, D) vision
  embeddings gives JAX's logits within 1e-5;
* a two-image Engine gives the JAX Engine's greedy ids through generate,
  generate_spec and generate_beam; a sentinel-count mismatch raises
  ``ValueError``;
* ``add_special_tokens`` grows the embeddings as JAX's does.

Tiny f32 configs (128 px images, 4 image tokens), weights drawn with numpy
in the JAX init's shapes and converted (utils/convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu.ops import splice as jsplice
from fastvlm_tpu.utils import tokens as jtokens
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.models import vlm as tvlm
from fastvlm_tpu_torch.ops import kv_cache, splice
from fastvlm_tpu_torch.utils import tokens
from fastvlm_tpu_torch.utils.convert import from_jax_params, qwen2_from_jax

TOL = 1e-5


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def _tiny(pkg, **extra):
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=128, attn_head_dim=16,
                               **extra.get("vision", {}))
    decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, head_dim=16,
                              intermediate_size=128,
                              **extra.get("decoder", {}))
    return pkg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=64))


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) on the same numpy-drawn weights
    (tests/test_torch_engine.py's recipe)."""
    jc = _tiny(jcfg, vision={"ffn_backend": "pallas"},
               decoder={"attn_backend": "pallas"})
    tc = _tiny(tcfg)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if path[0].key == "decoder" and leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tok = IdTokenizer()
    je = jengine.Engine(jc, jax.tree.map(jnp.asarray, params), tok,
                        eos_ids=(tok.eos_token_id,))
    te = engine.Engine(tc, from_jax_params(params, tc), tok,
                       eos_ids=(tok.eos_token_id,))
    return je, te


def _arrays(n=2, seed=0, size=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(n)]


PROMPT = "Compare <image> with the first one."


# ---------------------------------------------------------------------------
# splice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ids,n", [([1, -200, 2, -200, 3], 4),
                                   ([-200, -200], 3), ([5, 6], 2),
                                   ([-200, 7, 8, 9, -200, 10, -200], 1)])
def test_expand_image_ids_multi_matches_jax(ids, n):
    row, starts = splice.expand_image_ids_multi(ids, n)
    jrow, jstarts = jsplice.expand_image_ids_multi(ids, n)
    np.testing.assert_array_equal(row, jrow)
    assert row.dtype == jrow.dtype and starts == jstarts


@pytest.mark.parametrize("starts", [[[1, 6]], [[1, -1]], [[-1, -1]],
                                    [[0, 8], [6, 2]]])
def test_overlay_image_embeds_multi_matches_jax(starts):
    starts = np.asarray(starts, np.int32)
    b, m, n, d = starts.shape[0], starts.shape[1], 2, 4
    rng = np.random.RandomState(b)
    text = rng.randn(b, 10, d).astype(np.float32)
    vis = rng.randn(b, m, n, d).astype(np.float32)
    got = splice.overlay_image_embeds_multi(
        torch.from_numpy(text), torch.from_numpy(vis), torch.from_numpy(starts))
    want = jsplice.overlay_image_embeds_multi(
        jnp.asarray(text), jnp.asarray(vis), jnp.asarray(starts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_single_image_expand_refuses_two_sentinels():
    with pytest.raises(ValueError, match="expand_image_ids_multi"):
        splice.expand_image_ids([1, -200, 2, -200], 4)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _multi_inputs(cfg, n_img=2):
    n = cfg.num_image_tokens
    row, starts = splice.expand_image_ids_multi(
        [5] + sum(([-200, 7 + i] for i in range(n_img)), []), n)
    ids, lens, _ = splice.pad_batch([row], [0], 16)
    images = np.random.RandomState(1).rand(1, n_img, 128, 128, 3).astype(
        np.float32)
    return ids, lens, np.asarray([starts], np.int32), images


@pytest.mark.parametrize("form", ["images", "vision_embeds"])
def test_prefill_multi_image_matches_jax(engines, form):
    """Prefill with 5-D images (the tower over B*M images) or with 4-D vision
    embeddings: the next-token logits and the cache equal JAX's within
    1e-5."""
    je, te = engines
    ids, lens, starts, images = _multi_inputs(te.cfg)
    dec = te.cfg.decoder
    jcache = jkv.init_cache(dec.num_layers, 1, 24, dec.num_kv_heads,
                            dec.head_dim, jnp.float32)
    tcache = kv_cache.init_cache(dec.num_layers, 1, 24, dec.num_kv_heads,
                                 dec.head_dim, torch.float32)
    if form == "images":
        jargs = (jnp.asarray(images), None)
        targs = (torch.from_numpy(images), None)
    else:
        flat = images.reshape((2,) + images.shape[2:])
        jvis = jvlm.encode_images(je.params, je.cfg, jnp.asarray(flat))[None]
        tvis = tvlm.encode_images(te.params, te.cfg, torch.from_numpy(flat))[None]
        np.testing.assert_allclose(tvis.numpy(), np.asarray(jvis), rtol=0,
                                   atol=TOL)
        jargs, targs = (None, jvis), (None, tvis)
    want, jc = jvlm.prefill(je.params, je.cfg, jargs[0], jnp.asarray(ids),
                            jnp.asarray(lens), jnp.asarray(starts), jcache,
                            vision_embeds=jargs[1])
    got, tc = tvlm.prefill(te.params, te.cfg, targs[0], torch.from_numpy(ids),
                           torch.from_numpy(lens), torch.from_numpy(starts),
                           tcache, vision_embeds=targs[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=0,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["arrays", "pil"])
def test_engine_two_images_match_jax(engines, kind):
    je, te = engines
    prompt = te.build_prompt(PROMPT)
    assert prompt.count("<image>") == 2
    imgs = _arrays(seed=3)
    if kind == "pil":
        imgs = [Image.fromarray(x[:96]) for x in imgs]  # pad mode squares
    jin, tin = je.prepare(prompt, imgs), te.prepare(prompt, imgs)
    for k in ("ids", "lens", "starts"):
        np.testing.assert_array_equal(tin[k].numpy(), np.asarray(jin[k]))
    assert tin["vision_embeds"].shape == (1, 2, te.cfg.num_image_tokens, 64)
    np.testing.assert_allclose(tin["vision_embeds"].numpy(),
                               np.asarray(jin["vision_embeds"]), rtol=0,
                               atol=TOL)
    want, wstats = je.generate(prompt, imgs, max_new_tokens=12)
    got, gstats = te.generate(prompt, imgs, max_new_tokens=12)
    assert got == want
    assert len(set(got.split(","))) >= 3  # not one token repeated
    assert gstats["prompt_tokens"] == wstats["prompt_tokens"] \
        > 2 * te.cfg.num_image_tokens
    assert gstats["encode_ms"] > 0


def test_engine_image_count_mismatch_raises(engines):
    _, te = engines
    prompt = te.build_prompt(PROMPT)
    with pytest.raises(ValueError, match="3 images but 2 <image> tokens"):
        te.generate(prompt, _arrays(3), max_new_tokens=2)


def test_engine_multi_image_spec_and_beam_match_jax(engines):
    """generate_spec and generate_beam pass the multi-image embeddings
    through the prefill as the JAX engine does: equal ids."""
    je, te = engines
    prompt = te.build_prompt("a b a b a b a b <image>")
    imgs = _arrays(seed=4)
    assert te.generate_spec(prompt, imgs, max_new_tokens=12)[0] == \
        je.generate_spec(prompt, imgs, max_new_tokens=12)[0]
    got, _ = te.generate_beam(prompt, imgs, num_beams=3, max_new_tokens=8)
    want, _ = je.generate_beam(prompt, imgs, num_beams=3, max_new_tokens=8)
    assert got == want and got


# ---------------------------------------------------------------------------
# special tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("patch,start_end", [(True, True), (False, True),
                                             (True, False), (False, False)])
@pytest.mark.parametrize("tied", [False, True])
def test_add_special_tokens_matches_jax(patch, start_end, tied):
    cfg_kw = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                  num_kv_heads=1, head_dim=8, intermediate_size=32,
                  tie_word_embeddings=tied)
    jc, tc = jcfg.Qwen2Config(**cfg_kw), tcfg.Qwen2Config(**cfg_kw)
    jp = jqwen2.init(jax.random.PRNGKey(0), jc)
    tp = qwen2_from_jax(jax.tree.map(np.asarray, jp), 1)

    class Tok:
        def add_tokens(self, toks, special_tokens=True):
            return len(toks)

    jnew, jnc, jn = jtokens.add_special_tokens(
        Tok(), jp, jc, use_im_patch=patch, use_im_start_end=start_end)
    tnew, tnc, tn = tokens.add_special_tokens(
        Tok(), tp, tc, use_im_patch=patch, use_im_start_end=start_end)
    assert tn == jn == patch + 2 * start_end
    assert tnc.vocab_size == jnc.vocab_size
    np.testing.assert_allclose(tnew["embed"].numpy(),
                               np.asarray(jnew["embed"]), rtol=1e-6,
                               atol=1e-7)
    assert ("lm_head" in tnew) == (not tied)
    if not tied:
        np.testing.assert_allclose(tnew["lm_head"]["w"].numpy(),
                                   np.asarray(jnew["lm_head"]["w"]),
                                   rtol=1e-6, atol=1e-7)
