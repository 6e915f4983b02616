"""``vlm.prefill_continue`` of the port (fastvlm_tpu_torch/models/vlm.py)
against the JAX package's and against the port's own full prefill: a prompt
prefilled as a text prefix and then continued with its image-bearing suffix
gives the full prefill's logits and cache, on a dense cache and on a paged
one with shuffled pages (mirrors tests/test_video.py's first test).

f32 at tiny sizes, weights drawn with numpy and bridged by utils/convert.py.
Logits: rtol 1e-4, atol 1e-4 (tests/test_video.py's bound for the JAX
package's own continuation; both sides f32, differing in summation order);
cached keys the same."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu.ops.splice import expand_image_ids as jexpand
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.engine import Engine
from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer
from fastvlm_tpu_torch.models import vlm
from fastvlm_tpu_torch.ops import kv_cache as kv
from fastvlm_tpu_torch.ops.splice import expand_image_ids, pad_batch
from fastvlm_tpu_torch.utils.convert import from_jax_params

RTOL = ATOL = 1e-4
PAGE = 8


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
def models():
    """(JAX config, JAX params, port config, port params): numpy-drawn
    weights of the JAX init's shapes, the decoder's matrices N(0, 0.2)."""
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
    return jc, jax.tree.map(jnp.asarray, params), tc, from_jax_params(params, tc)


def _prompt(tc, n_prefix=13, n_after=9, seed=0):
    """A row of token ids with the image span after ``n_prefix`` text
    tokens: (row, image start)."""
    rng = np.random.RandomState(seed)
    raw = (list(rng.randint(0, 250, n_prefix)) + [-200]
           + list(rng.randint(0, 250, n_after)))
    row, start = expand_image_ids(raw, tc.num_image_tokens)
    return np.asarray(row, np.int32), start


def _image(seed=1):
    return np.random.RandomState(seed).rand(1, 128, 128, 3).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_full(tp, tc, row, start, image, cache):
    ids, lens, starts = pad_batch([row], [start], len(row))
    return vlm.prefill(tp, tc, _t(image), _t(ids), _t(lens), _t(starts), cache)


def _port_split(tp, tc, row, start, image, cache, pad=0):
    """Prefix prefill (no image) then the continuation, the suffix padded
    by ``pad`` tokens."""
    pids, plens, pstarts = pad_batch([row[:start]], [-1], start)
    _, cache = vlm.prefill(tp, tc, None, _t(pids), _t(plens), _t(pstarts),
                           cache)
    suffix = row[start:]
    sids, slens, _ = pad_batch([suffix], [0], len(suffix) + pad)
    return vlm.prefill_continue(tp, tc, _t(image), _t(sids), _t(slens),
                                torch.zeros((1,), dtype=torch.int32), start,
                                cache)


def test_prefill_continue_matches_jax_and_full_prefill_dense(models):
    jc, jp, tc, tp = models
    row, start = _prompt(tc)
    total = len(row)
    image = _image()
    dec = tc.decoder
    new_cache = lambda: kv.init_cache(dec.num_layers, 1, total + 8,
                                      dec.num_kv_heads, dec.head_dim,
                                      torch.float32)
    full_logits, full_cache = _port_full(tp, tc, row, start, image,
                                         new_cache())
    logits, cache = _port_split(tp, tc, row, start, image, new_cache())

    # the JAX package's continuation on its own dense cache
    jcache = jkv.init_cache(dec.num_layers, 1, total + 8, dec.num_kv_heads,
                            dec.head_dim, jnp.float32)
    jids, jlens, jstarts = pad_batch([row[:start]], [-1], start)
    _, jcache = jvlm.prefill(jp, jc, None, jnp.asarray(jids),
                             jnp.asarray(jlens), jnp.asarray(jstarts), jcache)
    sids, slens, _ = pad_batch([row[start:]], [0], total - start)
    jlogits, jcache = jvlm.prefill_continue(
        jp, jc, jnp.asarray(image), jnp.asarray(sids), jnp.asarray(slens),
        jnp.asarray([0], np.int32), start, jcache)

    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert cache.lengths.tolist() == [total] == full_cache.lengths.tolist()
    assert np.asarray(jcache.lengths).tolist() == [total]
    np.testing.assert_allclose(cache.k[:, :, :total].numpy(),
                               np.asarray(jcache.k[:, :, :total]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache.k[:, :, :total].numpy(),
                               full_cache.k[:, :, :total].numpy(),
                               rtol=RTOL, atol=ATOL)


def _paged(tc, pps, seed, extra_pages=3):
    """A paged cache with one row over shuffled pages of a larger pool
    (decoys elsewhere)."""
    dec = tc.decoder
    pool = pps + extra_pages
    cache = kv.init_paged_cache(dec.num_layers, 1, pool, PAGE, pps,
                                dec.num_kv_heads, dec.head_dim, torch.float32)
    cache.k_pages.normal_(generator=torch.Generator().manual_seed(seed))
    cache.v_pages.normal_(generator=torch.Generator().manual_seed(seed + 1))
    perm = np.random.RandomState(seed).permutation(pool)[:pps]
    cache.block_tables = torch.from_numpy(perm[None].astype(np.int32))
    return cache


def test_prefill_continue_matches_jax_paged_shuffled_pages(models):
    """The same continuation over a page pool with shuffled pages: the
    port's logits equal the JAX package's paged continuation and the port's
    dense full prefill, and the row's pages hold the dense cache's keys."""
    jc, jp, tc, tp = models
    row, start = _prompt(tc, n_prefix=17, n_after=11, seed=2)
    total = len(row)
    image = _image(3)
    dec = tc.decoder
    pps = -(-(total + 5) // PAGE)
    cache = _paged(tc, pps, seed=4)
    tables = cache.block_tables.numpy().copy()
    logits, cache = _port_split(tp, tc, row, start, image, cache)

    jcache = jkv.init_paged_cache(dec.num_layers, 1, pps + 3, PAGE, pps,
                                  dec.num_kv_heads, dec.head_dim,
                                  jnp.float32)._replace(
        block_tables=jnp.asarray(tables))
    jids, jlens, jstarts = pad_batch([row[:start]], [-1], start)
    _, jcache = jvlm.prefill(jp, jc, None, jnp.asarray(jids),
                             jnp.asarray(jlens), jnp.asarray(jstarts), jcache)
    sids, slens, _ = pad_batch([row[start:]], [0], total - start)
    jlogits, jcache = jvlm.prefill_continue(
        jp, jc, jnp.asarray(image), jnp.asarray(sids), jnp.asarray(slens),
        jnp.asarray([0], np.int32), start, jcache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)

    dense = kv.init_cache(dec.num_layers, 1, total, dec.num_kv_heads,
                          dec.head_dim, torch.float32)
    full_logits, dense = _port_full(tp, tc, row, start, image, dense)
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert cache.lengths.tolist() == [total]
    got = kv.gather_pages(cache.k_pages[0], cache.block_tables)[:, :total]
    np.testing.assert_allclose(got.numpy(), dense.k[0, :, :total].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_prefill_continue_suffix_as_wide_as_the_table(models):
    """A padded suffix exactly as wide as the cache's virtual capacity
    still attends the cached prefix (it is not an empty-cache prefill):
    the pad positions past the table drop into the sink."""
    _, _, tc, tp = models
    row, start = _prompt(tc, n_prefix=16, n_after=3, seed=5)
    total = len(row)  # 16 + 4 image tokens + 3
    pps = 4  # 32 positions
    width = pps * PAGE
    cache = _paged(tc, pps, seed=6)
    logits, cache = _port_split(tp, tc, row, start, _image(7), cache,
                                pad=width - (total - start))
    dec = tc.decoder
    dense = kv.init_cache(dec.num_layers, 1, total, dec.num_kv_heads,
                          dec.head_dim, torch.float32)
    full_logits, _ = _port_full(tp, tc, row, start, _image(7), dense)
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_engine_prefill_suffix_two_rows(models):
    """``Engine.prefill_suffix`` over two rows of different suffix lengths
    after one shared prefix: each row's logits come from its own last real
    token and equal its full prefill; lengths are offset + suffix length."""
    _, _, tc, tp = models
    eng = Engine(tc, tp, ByteTokenizer(), eos_ids=(2,))
    prefix = list(np.random.RandomState(8).randint(0, 250, 11))
    tails = [[5, 6, 7, 8, 9, 10, 11], [12, 13, 14]]
    rows = [np.asarray(expand_image_ids(prefix + [-200] + t,
                                        tc.num_image_tokens)[0], np.int32)
            for t in tails]
    start = len(prefix)
    images = np.concatenate([_image(9), _image(10)])
    dec = tc.decoder
    cache = kv.init_cache(dec.num_layers, 2, 40, dec.num_kv_heads,
                          dec.head_dim, torch.float32)
    pids, plens, pstarts = pad_batch([prefix, prefix], [-1, -1], start)
    _, cache = vlm.prefill(eng.params, tc, None, _t(pids), _t(plens),
                           _t(pstarts), cache)
    sids, slens, sstarts = pad_batch([r[start:] for r in rows], [0, 0], 16)
    logits, cache = eng.prefill_suffix(_t(images), _t(sids), _t(slens),
                                       _t(sstarts), start, cache)
    assert cache.lengths.tolist() == [len(r) for r in rows]
    for i, r in enumerate(rows):
        dense = kv.init_cache(dec.num_layers, 1, len(r), dec.num_kv_heads,
                              dec.head_dim, torch.float32)
        want, _ = _port_full(eng.params, tc, r, start, images[i:i + 1],
                             dense)
        np.testing.assert_allclose(logits[i:i + 1].numpy(), want.numpy(),
                                   rtol=RTOL, atol=ATOL)


def test_jax_and_port_expand_the_same_row(models):
    """The inputs above are the same on both sides: the sentinel expands to
    the same row and image start."""
    jc, _, tc, _ = models
    raw = [3, 4, 5, -200, 6]
    jrow, jstart = jexpand(raw, jc.num_image_tokens)
    row, start = expand_image_ids(raw, tc.num_image_tokens)
    np.testing.assert_array_equal(np.asarray(jrow), row)
    assert jstart == start == 3
