"""The port's decoder over a paged KV cache (fastvlm_tpu_torch/models/
qwen2.py, the PagedKVCache branches) against the JAX package's and against
the port's own dense cache, in f32 on a tiny decoder: prefill + 5 decode
steps with shuffled page tables, then ``vlm.decode_chunk`` on paged and
dense caches, and a freed row (table all -1) that must stay inert.

The JAX side runs attn_backend="pallas" (its paged kernel K3 in interpret
mode); the port's decode steps go through K3's plain version. Tolerance
rtol=1e-4, atol=1e-5 on logits, as tests/test_torch_qwen2.py: f32 on both
sides, differing in summation order. Port paged vs port dense is exact up to
the same summation-order bound (the same formula over gathered keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import qwen2, vlm
from fastvlm_tpu_torch.ops import kv_cache as kv
from fastvlm_tpu_torch.ops.sampling import SamplingParams
from fastvlm_tpu_torch.utils.convert import qwen2_from_jax

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=8, intermediate_size=64,
            tie_word_embeddings=True)
PAGE = 8


def _params(seed=0, scale=1.0):
    """JAX-initialised tiny decoder weights and their port copy; ``scale``
    multiplies the matrices and embeddings (at the init's 0.02 the tiny
    decoder only echoes its last input token)."""
    jc = jcfg.Qwen2Config(**TINY, attn_backend="pallas")
    jp = jqwen2.init(jax.random.PRNGKey(seed), jc)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, x: x * scale if x.ndim >= 2 else x, jp)
    tp = qwen2_from_jax(jax.tree.map(np.asarray, jp), jc.num_layers)
    return jc, tcfg.Qwen2Config(**TINY), jp, tp


def _tables(b, pps, seed):
    """Shuffled page assignment over a pool one page larger than needed
    (page 0 left to no row, so a clamped -1 reads a decoy)."""
    perm = np.random.default_rng(seed).permutation(b * pps) + 1
    return perm.reshape(b, pps).astype(np.int32)


def _run_port(tp, tc, cache, embeds, seq_lens, tokens):
    """Prefill + teacher-forced decode steps; per-step logits and the
    cache."""
    b, t, _ = embeds.shape
    pos = torch.arange(t)[None].expand(b, t)
    h, cache = qwen2.forward(tp, tc, torch.from_numpy(embeds), pos,
                             cache=cache,
                             mask=qwen2.prefill_mask(torch.from_numpy(seq_lens),
                                                     t, t),
                             prefill=True)
    cache.lengths = torch.from_numpy(seq_lens)
    out = [qwen2.logits_from_hidden(tp, h, tc).numpy()]
    for step in tokens:
        e = qwen2.embed(tp, torch.from_numpy(step)[:, None])
        m = qwen2.decode_mask(cache.lengths, cache.max_len)
        h, cache = qwen2.forward(tp, tc, e, cache.lengths[:, None],
                                 cache=cache, mask=m, prefill=False)
        out.append(qwen2.logits_from_hidden(tp, h, tc).numpy())
    return out, cache


def test_paged_forward_matches_jax_and_dense():
    jc, tc, jp, tp = _params()
    b, t, steps = 2, 12, 5
    pps = -(-(t + steps + 3) // PAGE)
    rng = np.random.RandomState(0)
    embeds = (0.5 * rng.randn(b, t, TINY["hidden_size"])).astype(np.float32)
    seq_lens = np.array([12, 9], np.int32)
    tokens = rng.randint(0, TINY["vocab_size"], (steps, b)).astype(np.int32)
    tables = _tables(b, pps, seed=0)

    # JAX: paged cache, K3 in interpret mode at every decode step
    jcache = jkv.init_paged_cache(2, b, b * pps + 1, PAGE, pps, 2, 8,
                                  jnp.float32)._replace(
        block_tables=jnp.asarray(tables))
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
    jh, jcache = jqwen2.forward(
        jp, jc, jnp.asarray(embeds), pos, cache=jcache,
        mask=jqwen2.prefill_mask(jnp.asarray(seq_lens), t, t), prefill=True)
    jcache = jcache._replace(lengths=jnp.asarray(seq_lens))
    want = [np.asarray(jqwen2.logits_from_hidden(jp, jh, jc))]
    for step in tokens:
        e = jqwen2.embed(jp, jnp.asarray(step)[:, None])
        m = jqwen2.decode_mask(jcache.lengths, jcache.max_len)
        h, jcache = jqwen2.forward(jp, jc, e, jcache.lengths[:, None],
                                   cache=jcache, mask=m, prefill=False)
        want.append(np.asarray(jqwen2.logits_from_hidden(jp, h, jc)))

    paged = kv.init_paged_cache(2, b, b * pps + 1, PAGE, pps, 2, 8,
                                torch.float32)
    paged.block_tables = torch.from_numpy(tables)
    got, paged = _run_port(tp, tc, paged, embeds, seq_lens, tokens)
    dense = kv.init_cache(2, b, pps * PAGE, 2, 8, torch.float32)
    ref, dense = _run_port(tp, tc, dense, embeds, seq_lens, tokens)

    for i, n in enumerate(seq_lens):  # prefill logits at real tokens only
        np.testing.assert_allclose(got[0][i, :n], want[0][i, :n],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[0][i, :n], ref[0][i, :n],
                                   rtol=RTOL, atol=ATOL)
    for step in range(1, steps + 1):
        np.testing.assert_allclose(got[step], want[step], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[step], ref[step], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(paged.lengths.numpy(), seq_lens + steps)
    np.testing.assert_array_equal(paged.lengths.numpy(),
                                  np.asarray(jcache.lengths))
    # the pool holds what JAX's holds at every written position
    for layer in range(2):
        for i, n in enumerate(seq_lens + steps):
            got_k = kv.gather_pages(paged.k_pages[layer],
                                    paged.block_tables)[i, :n].numpy()
            want_k = np.asarray(jkv.gather_pages(
                jcache.k_pages[layer], jcache.block_tables))[i, :n]
            np.testing.assert_allclose(got_k, want_k, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(got_k, dense.k[layer, i, :n].numpy(),
                                       rtol=RTOL, atol=ATOL)


def _vlm_cfg(tc):
    vis = tcfg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                             embed_dims=(8, 16, 24, 32, 40), image_size=256)
    return tcfg.FastVLMConfig(
        vision=vis, decoder=tc,
        projector=tcfg.ProjectorConfig(mm_hidden_size=80, hidden_size=32))


def test_decode_chunk_same_ids_paged_and_dense():
    """vlm.decode_chunk (the scheduler's decode unit) runs unchanged on a
    paged cache and gives the dense path's ids, greedy and with per-row
    sampling knobs (all greedy: no draw)."""
    from fastvlm_tpu_torch.ops.sampling import RowSampling

    _, tc, _, tp = _params(seed=1, scale=10.0)
    cfg = _vlm_cfg(tc)
    params = {"decoder": tp}
    b, t, steps = 2, 16, 8
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 100, (b, t)))
    starts = torch.tensor([-1, -1], dtype=torch.int32)
    pps = -(-(t + steps) // PAGE)
    toks = {}
    for name in ("dense", "paged", "paged-rows"):
        if name == "dense":
            cache = kv.init_cache(2, b, pps * PAGE, 2, 8, torch.float32)
        else:
            cache = kv.init_paged_cache(2, b, b * pps + 1, PAGE, pps, 2, 8,
                                        torch.float32)
            cache.block_tables = torch.from_numpy(_tables(b, pps, seed=3))
        seq_lens = torch.tensor([t, t - 5], dtype=torch.int32)
        logits, cache = vlm.prefill(params, cfg, None, ids, seq_lens, starts,
                                    cache)
        tok = logits.argmax(-1).to(torch.int32)
        done = torch.zeros((b,), dtype=torch.bool)
        gen = torch.Generator().manual_seed(7)
        rows = (RowSampling.build([SamplingParams()] * b, b)
                if name == "paged-rows" else None)
        out, done, tok, cache = vlm.decode_chunk(
            params, cfg, tok, done, cache, gen, k=steps, eos_ids=(127,),
            sampling=SamplingParams(temperature=0.0), row_sampling=rows)
        toks[name] = out.numpy()
        if rows is not None:  # an all-greedy batch draws nothing
            assert torch.equal(gen.get_state(),
                               torch.Generator().manual_seed(7).get_state())
    np.testing.assert_array_equal(toks["paged"], toks["dense"])
    np.testing.assert_array_equal(toks["paged-rows"], toks["dense"])
    assert len(set(toks["dense"].ravel().tolist())) > 3  # not an echo


def test_freed_row_stays_inert():
    """A row whose pages were released (table all -1, as the scheduler
    leaves a finished row) keeps decoding on the device: its writes drop
    (its former pages, now another row's, are untouched), its output stays
    finite, and the live row's logits do not change."""
    _, tc, _, tp = _params(seed=2, scale=10.0)
    b, t, steps = 2, 10, 6
    pps = -(-(t + 2 * steps) // PAGE)
    rng = np.random.RandomState(2)
    embeds = (0.5 * rng.randn(b, t, TINY["hidden_size"])).astype(np.float32)
    seq_lens = np.array([10, 7], np.int32)
    tokens = rng.randint(0, TINY["vocab_size"], (2 * steps, b)).astype(np.int32)
    tables = _tables(b, pps, seed=4)

    runs = {}
    for free in (False, True):
        cache = kv.init_paged_cache(2, b, b * pps + 1, PAGE, pps, 2, 8,
                                    torch.float32)
        cache.block_tables = torch.from_numpy(tables.copy())
        first, cache = _run_port(tp, tc, cache, embeds, seq_lens,
                                 tokens[:steps])
        before = None
        if free:
            cache.block_tables[1] = -1
            before = cache.k_pages[:, tables[1]].clone()
        rest, cache = _run_port_decode(tp, tc, cache, tokens[steps:])
        if free:
            torch.testing.assert_close(cache.k_pages[:, tables[1]], before,
                                       rtol=0, atol=0)
        runs[free] = first + rest
    for a, c in zip(runs[False], runs[True]):
        np.testing.assert_allclose(c[0], a[0], rtol=RTOL, atol=ATOL)
        assert np.isfinite(c).all()


def _run_port_decode(tp, tc, cache, tokens):
    out = []
    for step in tokens:
        e = qwen2.embed(tp, torch.from_numpy(step)[:, None])
        m = qwen2.decode_mask(cache.lengths, cache.max_len)
        h, cache = qwen2.forward(tp, tc, e, cache.lengths[:, None],
                                 cache=cache, mask=m, prefill=False)
        out.append(qwen2.logits_from_hidden(tp, h, tc).numpy())
    return out, cache
