"""The port's beam search (fastvlm_tpu_torch/ops/beam.py,
``Engine.generate_beam``, ``predict --num_beams``) against the JAX
package's.

* ``beam_search`` on the same weights and prompts gives JAX's tokens and
  lengths exactly and its scores within 1e-5, for W in {1, 2, 4}, length
  penalties 1.0 and 0.6, two rows of different prompt lengths, and three
  EOS sets: one no hypothesis reaches, one that ends some mid-search, and
  one of a third of the vocabulary (more than W of the 2W candidates can
  be EOS, so live beams fall to NEG_INF and ties decide the order);
* W = 1 with no length penalty is greedy decoding;
* ``Engine.generate_beam`` gives the JAX engine's text and decode_tokens;
* ``predict --num_beams 3 --random-weights --device cpu`` runs.

f32, tiny configs, CPU (the kernels' plain versions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import beam as jbeam
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine, predict
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.models import vlm as tvlm
from fastvlm_tpu_torch.ops import beam as tbeam
from fastvlm_tpu_torch.ops import kv_cache as tkv
from fastvlm_tpu_torch.utils.convert import from_jax_params, qwen2_from_jax

SCORE_TOL = 1e-5  # summed f32 log-softmax, two implementations
VOCAB = 48
PROMPTS = [[5, 9, 3, 7, 11, 2, 8], [4, 6, 1, 12, 30]]
# EOS sets over the tiny decoder's vocabulary (its greedy answer to
# PROMPTS[0] is 36 20 6 20 43 47 39 16): none reached, some hypotheses
# ending mid-search, a third of the vocabulary
EOS_SETS = {"unreached": (7,), "mid": (43, 6),
            "many": tuple(range(0, VOCAB, 3))}


def _decoder_cfg(pkg):
    dec = pkg.Qwen2Config(vocab_size=VOCAB, hidden_size=32, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=8,
                          intermediate_size=64)
    vis = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                            embed_dims=(8, 16, 24, 32, 40), image_size=256)
    return pkg.FastVLMConfig(
        vision=vis, decoder=dec,
        projector=pkg.ProjectorConfig(mm_hidden_size=80, hidden_size=32))


@pytest.fixture(scope="module")
def decoders():
    """(JAX cfg, JAX params, port cfg, port params): one numpy-drawn
    decoder, matrices N(0, 0.3) so the tiny model does not echo."""
    jc, tc = _decoder_cfg(jcfg), _decoder_cfg(tcfg)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        if path[-1].key in ("ln1", "ln2", "final_norm"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.3 * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jqwen2.init(k, jc.decoder),
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return (jc, {"decoder": jax.tree.map(jnp.asarray, tree)},
            tc, {"decoder": qwen2_from_jax(tree, tc.decoder.num_layers)})


def _batch(rows):
    t = max(len(r) for r in rows) + 1
    ids = np.zeros((len(rows), t), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    return (ids, np.asarray([len(r) for r in rows], np.int32),
            np.full((len(rows),), -1, np.int32))


def _jax_beam(jc, jp, rows, **kw):
    ids, lens, starts = _batch(rows)
    dec = jc.decoder
    cache = jkv.init_cache(dec.num_layers, len(rows),
                           ids.shape[1] + kw["max_new_tokens"],
                           dec.num_kv_heads, dec.head_dim, jnp.float32)
    logits, cache = jvlm.prefill(jp, jc, None, jnp.asarray(ids),
                                 jnp.asarray(lens), jnp.asarray(starts), cache)
    return jbeam.beam_search(jp, jc, logits, cache, **kw)


def _port_beam(tc, tp, rows, **kw):
    ids, lens, starts = _batch(rows)
    dec = tc.decoder
    cache = tkv.init_cache(dec.num_layers, len(rows),
                           ids.shape[1] + kw["max_new_tokens"],
                           dec.num_kv_heads, dec.head_dim, torch.float32)
    logits, cache = tvlm.prefill(tp, tc, None, torch.from_numpy(ids),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(starts), cache)
    return tbeam.beam_search(tp, tc, logits, cache, **kw)


@pytest.mark.parametrize("eos", sorted(EOS_SETS))
@pytest.mark.parametrize("length_penalty", [1.0, 0.6])
@pytest.mark.parametrize("num_beams", [1, 2, 4])
def test_beam_search_matches_jax(decoders, num_beams, length_penalty, eos):
    jc, jp, tc, tp = decoders
    kw = dict(num_beams=num_beams, max_new_tokens=8, eos_ids=EOS_SETS[eos],
              length_penalty=length_penalty)
    want = _jax_beam(jc, jp, PROMPTS, **kw)
    got = _port_beam(tc, tp, PROMPTS, **kw)
    lengths = np.asarray(want.lengths)
    np.testing.assert_array_equal(got.lengths.numpy(), lengths)
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(got.tokens[i, :n].numpy(),
                                      np.asarray(want.tokens)[i, :n])
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=0, atol=SCORE_TOL)
    assert got.tokens.dtype == got.lengths.dtype == torch.int32


def test_eos_sets_end_hypotheses_where_intended(decoders):
    """The EOS sets do what the parametrisation above names them for: the
    "mid" set ends the chosen hypothesis of some width before max_new, the
    "unreached" set never does."""
    _, _, tc, tp = decoders
    ends = {name: [_port_beam(tc, tp, PROMPTS, num_beams=w, max_new_tokens=8,
                              eos_ids=eos).lengths.tolist() for w in (1, 2, 4)]
            for name, eos in EOS_SETS.items()}
    assert all(n == 8 for ls in ends["unreached"] for n in ls)
    assert any(1 < n < 8 for ls in ends["mid"] for n in ls), ends["mid"]


@pytest.mark.parametrize("eos", ["unreached", "mid"])
def test_width_one_is_greedy(decoders, eos):
    """W = 1, length penalty 0: the one live beam is the greedy path
    (``vlm.generate``, argmax). The answer is greedy's tokens through its
    first EOS, or that path cut one token early by an EOS that was the
    runner-up there and whose sum beats the longer path's (the finished set
    holds EOS candidates among the top 2W): with an unreachable EOS, greedy
    exactly."""
    _, _, tc, tp = decoders
    eos_ids = EOS_SETS[eos]
    res = _port_beam(tc, tp, PROMPTS, num_beams=1, max_new_tokens=8,
                     eos_ids=eos_ids, length_penalty=0.0)
    ids, lens, starts = _batch(PROMPTS)
    greedy = tvlm.generate(tp, tc, None, torch.from_numpy(ids),
                           torch.from_numpy(lens), torch.from_numpy(starts),
                           max_new_tokens=8, eos_ids=eos_ids)
    for i, (n, g) in enumerate(zip(res.lengths.tolist(),
                                   greedy.num_generated.tolist())):
        got, want = res.tokens[i, :n].tolist(), greedy.tokens[i, :g].tolist()
        if eos == "unreached" or n == g:
            assert got == want
        else:
            assert n < g and got[:-1] == want[:n - 1] and got[-1] in eos_ids


def test_top_k_puts_lower_index_first_like_lax():
    x = np.array([[0.5, 2.0, 2.0, -1e30, 2.0, -1e30, 0.5]], np.float32)
    vals, idx = tbeam._top_k(torch.from_numpy(x), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert idx.tolist() == [[1, 2, 4, 0, 6]]


def test_replicate_cache_interleaves_rows():
    cache = tkv.init_cache(2, 2, 5, 2, 4, torch.float32)
    cache.k.normal_(generator=torch.Generator().manual_seed(0))
    cache.v.normal_(generator=torch.Generator().manual_seed(1))
    cache.lengths[:] = torch.tensor([3, 4], dtype=torch.int32)
    rep = tbeam._replicate_cache(cache, 3)
    want = jbeam._replicate_cache(
        jkv.KVCache(k=jnp.asarray(cache.k.numpy()),
                    v=jnp.asarray(cache.v.numpy()),
                    lengths=jnp.asarray(cache.lengths.numpy())), 3)
    np.testing.assert_array_equal(rep.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(rep.v.numpy(), np.asarray(want.v))
    assert rep.lengths.tolist() == [3, 3, 3, 4, 4, 4]


# ---------------------------------------------------------------------------
# the engine and the CLI
# ---------------------------------------------------------------------------


class IdTokenizer(preprocessing.ByteTokenizer):
    """Byte tokenizer whose decode spells out the ids."""

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine), tiny VLM, the same numpy-drawn weights."""
    def tiny(pkg, **extra):
        vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                                   embed_dims=(8, 16, 32, 64, 128),
                                   image_size=128, attn_head_dim=16,
                                   **extra.get("vision", {}))
        decoder = pkg.Qwen2Config(vocab_size=258, hidden_size=64,
                                  num_layers=2, num_heads=4, num_kv_heads=2,
                                  head_dim=16, intermediate_size=128,
                                  **extra.get("decoder", {}))
        return pkg.FastVLMConfig(
            vision=vision, decoder=decoder,
            projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                          hidden_size=64))

    jc = tiny(jcfg, vision={"ffn_backend": "pallas"},
              decoder={"attn_backend": "pallas"})
    tc = tiny(tcfg)
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "norm_scale"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        decoder_matrix = path[0].key == "decoder" and leaf.ndim >= 2
        scale = 0.2 if decoder_matrix else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jvlm.init(k, jc), jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    tok = IdTokenizer()
    # EOS: the byte EOS and 48, the 9th token of the tiny model's answer
    # below, so the chosen hypothesis ends before the budget
    eos = (tok.eos_token_id, 48)
    return (jengine.Engine(jc, jax.tree.map(jnp.asarray, params), tok,
                           eos_ids=eos),
            engine.Engine(tc, from_jax_params(params, tc), tok, eos_ids=eos))


@pytest.mark.parametrize("num_beams,length_penalty", [(2, 1.0), (3, 0.6)])
def test_engine_generate_beam_matches_jax(engines, num_beams, length_penalty):
    je, te = engines
    prompt = te.build_prompt("Describe the image.")
    image = np.random.RandomState(2).randint(0, 256, (128, 128, 3),
                                             dtype=np.uint8)
    kw = dict(num_beams=num_beams, max_new_tokens=10,
              length_penalty=length_penalty)
    jtext, jstats = je.generate_beam(prompt, image, **kw)
    ttext, tstats = te.generate_beam(prompt, image, **kw)
    assert ttext == jtext
    assert tstats["decode_tokens"] == jstats["decode_tokens"] < 10
    assert tstats["prompt_tokens"] == jstats["prompt_tokens"]
    assert tstats["ttft_ms"] > 0 and tstats["tok_per_s"] > 0


def test_predict_num_beams_runs(capsys):
    assert predict.main(["--random-weights", "--device", "cpu",
                         "--num_beams", "3", "--max-new-tokens", "4",
                         "--timing"]) == 0
    assert '"tokens"' in capsys.readouterr().err
