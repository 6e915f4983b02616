"""The port's Qwen2 decoder against the JAX package's, in f32, on the tiny
decoder config: prefill logits over a right-padded batch, then 4 decode steps
over the dense cache.

The JAX side runs with attn_backend="pallas" (its decode-attention kernel in
interpret mode on the CPU); the port's decode step goes through K2's plain
version. Tolerance rtol=1e-4, atol=1e-5 on logits: f32 on both sides,
differing in summation order (and RoPE's pow/cos/sin by an ulp)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import qwen2
from fastvlm_tpu_torch.ops import kv_cache
from fastvlm_tpu_torch.utils.convert import qwen2_from_jax

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=128)


# decoder families: the default is Qwen2; "mpt" (ALiBi, bias-free
# LayerNorm, GELU MLP) and "mistral" (sliding window) take the plain
# attention path on both sides, as the JAX package's Pallas route excludes
# them
FAMILIES = {
    "qwen2": {},
    "mpt": dict(pos_emb="alibi", norm_type="layernorm", mlp_type="gelu",
                qkv_bias=False),
    "mistral": dict(attn_window=4, qkv_bias=False),
}


def _setup(fused, seed=0, family="qwen2"):
    jc = jcfg.Qwen2Config(**TINY, **FAMILIES[family], attn_backend="pallas")
    tc = tcfg.Qwen2Config(**TINY, **FAMILIES[family])
    jp = jqwen2.init(jax.random.PRNGKey(seed), jc)
    if jc.qkv_bias:  # non-zero biases so the QKV-bias path is exercised
        jp["layers"]["q"]["b"] = jp["layers"]["q"]["b"] + 0.1
        jp["layers"]["k"]["b"] = jp["layers"]["k"]["b"] - 0.05
    if fused:
        jp = jqwen2.fuse_decoder_params(jp, jc)
    tp = qwen2_from_jax(jax.tree.map(np.asarray, jp), tc.num_layers)
    return jc, tc, jp, tp


@pytest.mark.parametrize("fused,family", [
    (False, "qwen2"), (True, "qwen2"), (False, "mpt"), (False, "mistral")])
def test_prefill_and_decode_match_jax(fused, family):
    jc, tc, jp, tp = _setup(fused, family=family)
    b, t, s_max, steps = 2, 8, 16, 4
    rng = np.random.RandomState(0)
    embeds = (0.5 * rng.randn(b, t, TINY["hidden_size"])).astype(np.float32)
    seq_lens = np.array([8, 5], np.int32)
    tokens = rng.randint(0, TINY["vocab_size"], size=(steps, b)).astype(np.int32)

    # JAX: prefill over the fresh prompt keys, then dense decode steps
    jcache = jkv.init_cache(2, b, s_max, 2, 16, dtype=jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
    mask = jqwen2.prefill_mask(jnp.asarray(seq_lens), t, t, jc.attn_window)
    jh, jcache = jqwen2.forward(jp, jc, jnp.asarray(embeds), pos, cache=jcache,
                                mask=mask, prefill=True)
    jcache = jcache._replace(lengths=jnp.asarray(seq_lens))
    jlogits = [np.asarray(jqwen2.logits_from_hidden(jp, jh, jc))]
    for step in range(steps):
        e = jqwen2.embed(jp, jnp.asarray(tokens[step])[:, None])
        m = jqwen2.decode_mask(jcache.lengths, s_max, jc.attn_window)
        h, jcache = jqwen2.forward(jp, jc, e, jcache.lengths[:, None],
                                   cache=jcache, mask=m, prefill=False)
        jlogits.append(np.asarray(jqwen2.logits_from_hidden(jp, h, jc)))

    # port
    cache = kv_cache.init_cache(2, b, s_max, 2, 16, dtype=torch.float32)
    tpos = torch.arange(t)[None].expand(b, t)
    # the port's masks hold no window: the decoder windows each windowed
    # layer by position, as JAX's windowed masks do
    tmask = qwen2.prefill_mask(torch.from_numpy(seq_lens), t, t)
    th, cache = qwen2.forward(tp, tc, torch.from_numpy(embeds), tpos,
                              cache=cache, mask=tmask, prefill=True)
    cache = kv_cache.KVCache(cache.k, cache.v, torch.from_numpy(seq_lens))
    tlogits = [qwen2.logits_from_hidden(tp, th, tc).numpy()]
    for step in range(steps):
        e = qwen2.embed(tp, torch.from_numpy(tokens[step])[:, None])
        m = qwen2.decode_mask(cache.lengths, s_max)
        h, cache = qwen2.forward(tp, tc, e, cache.lengths[:, None],
                                 cache=cache, mask=m, prefill=False)
        tlogits.append(qwen2.logits_from_hidden(tp, h, tc).numpy())

    # prefill logits at the real tokens only (padded rows differ by design:
    # neither side promises anything there)
    for i, n in enumerate(seq_lens):
        np.testing.assert_allclose(tlogits[0][i, :n], jlogits[0][i, :n],
                                   rtol=RTOL, atol=ATOL)
    for step in range(1, steps + 1):
        np.testing.assert_allclose(tlogits[step], jlogits[step],
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(cache.lengths.numpy(), seq_lens + steps)
    # the cache holds what JAX's holds at every written position
    for i, n in enumerate(seq_lens + steps):
        np.testing.assert_allclose(cache.k[:, i, :n].numpy(),
                                   np.asarray(jcache.k)[:, i, :n],
                                   rtol=RTOL, atol=ATOL)


def test_fuse_decoder_params_is_exact():
    """Fused and unfused layouts give the same forward."""
    _, tc, _, tp = _setup(fused=False, seed=1)
    fused = qwen2.fuse_decoder_params(tp, tc)
    assert "qkv" in fused["layers"][0] and "gateup" in fused["layers"][0]
    x = torch.from_numpy(np.random.RandomState(1).randn(1, 6, 64)
                         .astype(np.float32))
    pos = torch.arange(6)[None]
    a, _ = qwen2.forward(tp, tc, x, pos)
    b, _ = qwen2.forward(fused, tc, x, pos)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("window", [None, 3])
def test_masks_match_jax(window):
    # the port's masks, windowed by position as a windowed layer does
    lens = np.array([5, 2, 9], np.int32)
    tl = torch.from_numpy(lens)
    pos = torch.arange(7)[None].expand(3, 7)
    got = qwen2.window_mask(qwen2.prefill_mask(tl, 7, 9)[:, None], pos,
                            window)[:, 0]
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jqwen2.prefill_mask(jnp.asarray(lens), 7, 9, window)))
    got = qwen2.window_mask(qwen2.decode_mask(tl, 12)[:, None], tl[:, None],
                            window)[:, 0]
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jqwen2.decode_mask(jnp.asarray(lens), 12, window)))


def test_rope_matches_jax():
    pos = np.array([[0, 1, 7, 300]], np.int32)
    x = np.random.RandomState(2).randn(1, 4, 2, 16).astype(np.float32)
    jc, js = jqwen2.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    want = np.asarray(jqwen2.apply_rope(jnp.asarray(x), jc, js))
    tc_, ts_ = qwen2.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    got = qwen2.apply_rope(torch.from_numpy(x), tc_, ts_).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_alibi_slopes_match_jax():
    for n in (8, 12):
        np.testing.assert_allclose(qwen2.alibi_slopes(n).numpy(),
                                   np.asarray(jqwen2.alibi_slopes(n)),
                                   rtol=1e-6)


def test_write_token_matches_jax():
    rng = np.random.RandomState(3)
    layer = rng.randn(2, 6, 2, 4).astype(np.float32)
    new = rng.randn(2, 1, 2, 4).astype(np.float32)
    lengths = np.array([0, 4], np.int32)
    want, _ = jkv.write_token(jnp.asarray(layer), jnp.asarray(layer),
                              jnp.asarray(new), jnp.asarray(new),
                              jnp.asarray(lengths))
    k = torch.from_numpy(layer.copy())
    kv_cache.write_token(k, k.clone(), torch.from_numpy(new),
                         torch.from_numpy(new), torch.from_numpy(lengths))
    np.testing.assert_array_equal(k.numpy(), np.asarray(want))


def test_config_presets_match_jax():
    for name in ("qwen2_0_5b", "qwen2_1_5b", "qwen2_7b", "llama_7b",
                 "mistral_7b"):
        want = dataclasses.asdict(getattr(jcfg, name)())
        for k in ("attn_backend", "scan_unroll"):
            want.pop(k)
        assert dataclasses.asdict(getattr(tcfg, name)()) == want
