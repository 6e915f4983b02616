"""The port's prompt-lookup speculative decoding (fastvlm_tpu_torch/ops/
speculative.py, the ``vlm.spec_*`` functions, ``Engine.generate_spec`` and
``Engine.stream(spec=True)``) against the JAX package's.

* the draft, mask, acceptance and commit primitives equal the JAX functions
  on seeded numpy inputs, including the index clamps JAX's dynamic slices
  apply (a match near the buffer's end, a window start past L - width);
* T-wide decode writes (a verify pass's k+1 keys) land where JAX's
  ``write_token`` and ``write_tokens_paged_rows`` put them, a position past
  the mapped pages in the sink;
* the cases of tests/test_speculative.py, on the port;
* on converted weights (utils/convert.py), ``generate_spec``,
  ``spec_decode_from_tok`` and ``spec_carry_init`` + ``spec_stream_chunk``
  give the JAX functions' tokens, counts, passes, drafts and acceptances.

f32, tiny configs (128-256 px, 2 decoder layers); ids compared for
equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu.ops import speculative as jspec
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine
from fastvlm_tpu_torch.data import preprocessing
from fastvlm_tpu_torch.models import qwen2 as tqwen2
from fastvlm_tpu_torch.models import vlm as tvlm
from fastvlm_tpu_torch.ops import kv_cache as tkv
from fastvlm_tpu_torch.ops.sampling import SamplingParams
from fastvlm_tpu_torch.ops.speculative import (
    accept_counts, masked_window_write, ngram_draft, spec_mask)
from fastvlm_tpu_torch.ops.splice import expand_image_ids, pad_batch
from fastvlm_tpu_torch.utils.convert import from_jax_params


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# primitives against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_draft_matches_jax(seed):
    """Seeded histories over a 4-token vocabulary (matches everywhere), then
    three built rows: the only match near the buffer's end (the draft start
    clamps to L - k and the window shifts left), no match (the last token
    repeated), and the shortest history (hist_len = n)."""
    rng = np.random.RandomState(seed)
    length, k, n = 24, 6, 3
    hist = rng.randint(0, 4, (6, length)).astype(np.int32)
    hist_len = rng.randint(n, length + 1, 6).astype(np.int32)
    end = np.arange(100, 100 + length, dtype=np.int32)
    end[length - 6:] = [7, 8, 9, 7, 8, 9]  # the tail n-gram also at L-6
    no_match = np.arange(200, 200 + length, dtype=np.int32)
    hist = np.concatenate([hist, end[None], no_match[None], hist[:1]])
    hist_len = np.concatenate([hist_len, [length, length, n]]).astype(np.int32)
    got = ngram_draft(_t(hist), _t(hist_len), k, n).numpy()
    want = np.asarray(jspec.ngram_draft(jnp.asarray(hist),
                                        jnp.asarray(hist_len), k, n))
    np.testing.assert_array_equal(got, want)
    # the end row's match at L-6 continues at L-3; the window shifts to L-k
    np.testing.assert_array_equal(got[6], end[length - k:])
    np.testing.assert_array_equal(got[7], [no_match[-1]] * k)


def test_ngram_draft_past_history_end_like_jax():
    """A gap the port keeps: the most recent match of a row that repeats
    one token sits one position back, so its continuation runs past
    hist_len into unwritten slots (zeros) and only its first draft token
    can be accepted. JAX drafts the same."""
    hist = np.array([[7, 7, 7, 7, 7, 0, 0, 0, 0, 0]], np.int32)
    hist_len = np.array([5], np.int32)
    got = ngram_draft(_t(hist), _t(hist_len), 4, 3).numpy()
    np.testing.assert_array_equal(got, [[7, 0, 0, 0]])
    np.testing.assert_array_equal(got, np.asarray(jspec.ngram_draft(
        jnp.asarray(hist), jnp.asarray(hist_len), 4, 3)))


@pytest.mark.parametrize("window", [None, 3])
def test_spec_mask_matches_jax(window):
    # the port's mask, windowed by position as a windowed layer does
    lengths = np.array([0, 3, 7], np.int32)
    pos = _t(lengths)[:, None] + torch.arange(4)[None]
    got = tqwen2.window_mask(spec_mask(_t(lengths), 4, 12)[:, None], pos,
                             window)[:, 0].numpy()
    want = np.asarray(jspec.spec_mask(jnp.asarray(lengths), 4, 12,
                                      window=window))
    np.testing.assert_array_equal(got, want)


def test_accept_counts_matches_jax():
    rng = np.random.RandomState(3)
    draft = rng.randint(0, 2, (16, 5)).astype(np.int32)
    verified = rng.randint(0, 2, (16, 5)).astype(np.int32)
    got = accept_counts(_t(draft), _t(verified))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jspec.accept_counts(jnp.asarray(draft),
                                                    jnp.asarray(verified))))


def test_masked_window_write_matches_jax():
    """Starts inside, at the edge (start + width = L) and past L - width,
    where JAX's dynamic slices clamp the window to end at L."""
    rng = np.random.RandomState(4)
    width = 5
    rows = rng.randint(0, 100, (5, 16)).astype(np.int32)
    vec = rng.randint(100, 200, (5, width)).astype(np.int32)
    start = np.array([0, 5, 11, 14, 13], np.int32)
    count = np.array([0, 2, 5, 3, 5], np.int32)
    got = masked_window_write(_t(rows.copy()), _t(vec), _t(start), _t(count),
                              width).numpy()
    want = np.asarray(jax.vmap(
        lambda r, v, s, c: jspec.masked_window_write(r, v, s, c, width))(
            jnp.asarray(rows), jnp.asarray(vec), jnp.asarray(start),
            jnp.asarray(count)))
    np.testing.assert_array_equal(got, want)
    # row 3: the window clamps to [11, 16), the 3 kept tokens at 11..13
    np.testing.assert_array_equal(got[3, 11:14], vec[3, :3])


def test_t_wide_dense_write_matches_jax():
    """A verify pass's T keys at each row's own offset, one row ending at
    S_max exactly."""
    rng = np.random.RandomState(5)
    layer = rng.randn(3, 12, 2, 4).astype(np.float32)
    new = rng.randn(3, 4, 2, 4).astype(np.float32)
    lengths = np.array([0, 5, 8], np.int32)
    k_t, v_t = tkv.write_token(_t(layer.copy()), _t(layer.copy() + 1),
                               _t(new), _t(new - 1), _t(lengths))
    k_j, v_j = jkv.write_token(jnp.asarray(layer), jnp.asarray(layer + 1),
                               jnp.asarray(new), jnp.asarray(new - 1),
                               jnp.asarray(lengths))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("t", [1, 4])
def test_t_wide_paged_write_matches_jax(t):
    """T tokens per row at per-row offsets through the block tables: JAX
    ``write_tokens_paged_rows`` (``write_token_paged`` at T = 1). Row 0's
    last position falls on an unmapped page and row 1's past the table's
    capacity: JAX drops both, the port writes them to the sink page."""
    rng = np.random.RandomState(6)
    pages, page, h, d = 6, 4, 2, 3
    pool = rng.randn(pages, page, h, d).astype(np.float32)
    tables = np.array([[2, 0, -1], [5, 1, 3]], np.int32)
    lengths = np.array([8 - t + 1, 12 - t + 2], np.int32)
    new = rng.randn(2, t, h, d).astype(np.float32)
    sink = np.zeros((1, page, h, d), np.float32)
    tk = _t(np.concatenate([pool, sink]))
    tv = _t(np.concatenate([pool, sink]) + 1)
    tkv.write_token_paged(tk, tv, _t(new), _t(new + 1), _t(tables),
                          _t(lengths))
    jk, jv = jkv.write_tokens_paged_rows(
        jnp.asarray(pool), jnp.asarray(pool + 1), jnp.asarray(new),
        jnp.asarray(new + 1), jnp.asarray(tables), jnp.asarray(lengths))
    np.testing.assert_array_equal(tk[:pages].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv[:pages].numpy(), np.asarray(jv))
    if t == 1:
        jk1, _ = jkv.write_token_paged(
            jnp.asarray(pool), jnp.asarray(pool + 1), jnp.asarray(new),
            jnp.asarray(new + 1), jnp.asarray(tables), jnp.asarray(lengths))
        np.testing.assert_array_equal(np.asarray(jk1), np.asarray(jk))
    # each dropped position went to the sink's slot pos % page (when two
    # land on one slot, either may be there)
    dropped = {}
    for row in range(2):
        for i in range(t):
            pos = int(lengths[row]) + i
            if pos // page >= tables.shape[1] or tables[row, pos // page] < 0:
                dropped.setdefault(pos % page, []).append(new[row, i])
    assert sum(map(len, dropped.values())) == (2 if t == 1 else 3)
    for col, vals in dropped.items():
        assert any(np.array_equal(tk[pages, col].numpy(), v) for v in vals)


# ---------------------------------------------------------------------------
# tests/test_speculative.py, on the port
# ---------------------------------------------------------------------------


def test_ngram_draft_finds_most_recent_match():
    hist = torch.tensor([[4, 7, 8, 9, 1, 2, 7, 8, 9, 0, 0, 0]],
                        dtype=torch.int32)
    d = ngram_draft(hist, torch.tensor([9], dtype=torch.int32), k=3, n=3)
    np.testing.assert_array_equal(d.numpy(), [[1, 2, 7]])


def test_ngram_draft_prefers_recent_and_handles_no_match():
    h = torch.tensor([[1, 2, 3, 5, 1, 2, 3, 6, 1, 2, 3, 0, 0]],
                     dtype=torch.int32)
    d = ngram_draft(h, torch.tensor([11], dtype=torch.int32), k=2, n=3)
    np.testing.assert_array_equal(d.numpy(), [[6, 1]])
    h2 = torch.tensor([[9, 8, 7, 0, 0, 0, 0, 0]], dtype=torch.int32)
    d2 = ngram_draft(h2, torch.tensor([3], dtype=torch.int32), k=3, n=3)
    np.testing.assert_array_equal(d2.numpy(), [[7, 7, 7]])


def test_accept_counts():
    draft = torch.tensor([[1, 2, 3], [1, 9, 3], [9, 9, 9]])
    model = torch.tensor([[1, 2, 3], [1, 2, 3], [1, 2, 3]])
    np.testing.assert_array_equal(accept_counts(draft, model).numpy(),
                                  [3, 1, 0])


def test_spec_mask_matches_decode_mask_row0():
    lengths = torch.tensor([3, 7], dtype=torch.int32)
    m = spec_mask(lengths, t=4, s_max=12)
    d = tqwen2.decode_mask(lengths, s_max=12)
    np.testing.assert_array_equal(m[:, :1].numpy(), d.numpy())
    np.testing.assert_array_equal(
        m.sum(-1).numpy(), (lengths[:, None] + torch.arange(4)[None] + 1).numpy())


def _tiny_vlm_cfg():
    """tests/test_vlm.py's tiny_vlm_cfg, in the port's config."""
    vision = tcfg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                                embed_dims=(8, 16, 32, 64, 128),
                                image_size=128, attn_head_dim=16)
    decoder = tcfg.Qwen2Config(vocab_size=256, hidden_size=64, num_layers=2,
                               num_heads=4, num_kv_heads=2, head_dim=16,
                               intermediate_size=128)
    return tcfg.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=tcfg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                       hidden_size=decoder.hidden_size))


def _spec_setup(seed, batch_rows, pad_to=24):
    cfg = _tiny_vlm_cfg()
    params = tvlm.init(torch.Generator().manual_seed(seed), cfg)
    images = torch.rand((len(batch_rows), 128, 128, 3),
                        generator=torch.Generator().manual_seed(seed + 1))
    rows, starts = [], []
    for raw in batch_rows:
        r, s = expand_image_ids(raw, cfg.num_image_tokens)
        rows.append(r)
        starts.append(s)
    ids, seq_lens, starts = pad_batch(rows, starts, pad_to=pad_to)
    return cfg, params, images, (_t(ids), _t(seq_lens), _t(starts))


@pytest.mark.parametrize("seed", [0, 3])
def test_spec_matches_greedy_generate(seed):
    rows = [[5, 7, -200, 9, 11], [1, 2, 3, 4, 5, 6, 7]]
    cfg, params, images, (ids, lens, starts) = _spec_setup(seed, rows)
    ref = tvlm.generate(params, cfg, images, ids, lens, starts,
                        max_new_tokens=24, eos_ids=(251,))
    got = tvlm.generate_spec(params, cfg, images, ids, lens, starts,
                             max_new_tokens=24, eos_ids=(251,), draft_k=4)
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  ref.num_generated.numpy())
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    assert got.steps <= 24


def test_spec_eos_stops_rows_like_generate():
    rows = [[5, 7, -200, 9, 11]]
    cfg, params, images, (ids, lens, starts) = _spec_setup(1, rows)
    probe = tvlm.generate(params, cfg, images, ids, lens, starts,
                          max_new_tokens=12, eos_ids=(9999,))
    eos = int(probe.tokens[0, 4])  # a mid-stream EOS
    ref = tvlm.generate(params, cfg, images, ids, lens, starts,
                        max_new_tokens=12, eos_ids=(eos,))
    got = tvlm.generate_spec(params, cfg, images, ids, lens, starts,
                             max_new_tokens=12, eos_ids=(eos,), draft_k=4)
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  ref.num_generated.numpy())


def test_spec_accepts_on_repetitive_prompt():
    rows = [[11, 12, 13, 14] * 5]
    cfg, params, images, (ids, lens, starts) = _spec_setup(2, rows)
    got = tvlm.generate_spec(params, cfg, None, ids, lens,
                             torch.full_like(starts, -1), max_new_tokens=32,
                             eos_ids=(9999,), draft_k=6)
    assert int(got.num_generated[0]) == 32
    assert got.steps < 32
    assert int(got.accepted) > 0


@pytest.fixture(scope="module")
def tiny_engine():
    return engine.build_engine(random_tiny=True, device="cpu")


def test_engine_generate_spec_matches_greedy_stream(tiny_engine):
    eng = tiny_engine
    img = np.zeros((256, 256, 3), np.float32)
    prompt = eng.build_prompt("describe describe describe")
    ref_text, _ = eng.generate(prompt, img, max_new_tokens=16,
                               sampling=SamplingParams())
    got_text, stats = eng.generate_spec(prompt, img, max_new_tokens=16)
    assert got_text == ref_text
    assert stats["spec_steps"] >= 1
    assert 0.0 <= stats["spec_accept_rate"] <= 1.0


def test_engine_stream_spec_matches_greedy_stream(tiny_engine):
    eng = tiny_engine
    img = np.zeros((256, 256, 3), np.float32)
    prompt = eng.build_prompt("describe describe describe")
    ref = list(eng.stream(prompt, img, max_new_tokens=16))
    got = list(eng.stream(prompt, img, max_new_tokens=16, spec=True))
    assert got[-1]["text"] == ref[-1]["text"]
    assert len(got) >= 2
    for c in got:
        assert got[-1]["text"].startswith(c["text"])
    assert got[-1]["stats"]["spec_steps"] >= 1
    small = list(eng.stream(prompt, img, max_new_tokens=3, spec=True))
    assert small[-1]["stats"]["decode_tokens"] <= 3


def test_engine_stream_spec_rejects_sampling(tiny_engine):
    img = np.zeros((256, 256, 3), np.float32)
    with pytest.raises(ValueError, match="greedy"):
        next(tiny_engine.stream(tiny_engine.build_prompt("hi"), img,
                                spec=True,
                                sampling=SamplingParams(temperature=0.7)))


def test_spec_budget_cap_exact():
    rows = [[11, 12, 13, 14] * 5]
    cfg, params, images, (ids, lens, starts) = _spec_setup(2, rows)
    for max_new in (3, 5):
        ref = tvlm.generate(params, cfg, None, ids, lens,
                            torch.full_like(starts, -1),
                            max_new_tokens=max_new, eos_ids=(9999,))
        got = tvlm.generate_spec(params, cfg, None, ids, lens,
                                 torch.full_like(starts, -1),
                                 max_new_tokens=max_new, eos_ids=(9999,),
                                 draft_k=6)
        np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
        assert int(got.num_generated[0]) == max_new


# ---------------------------------------------------------------------------
# the whole spec path against the JAX package, on converted weights
# ---------------------------------------------------------------------------


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
    """(JAX engine, port engine) over the same numpy-drawn weights (as
    tests/test_torch_engine.py: the decoder's matrices N(0, 0.2), so the
    tiny decoder does not just echo)."""
    jc = _tiny(jcfg, vision={"ffn_backend": "pallas"},
               decoder={"attn_backend": "pallas"})
    tc = _tiny(tcfg)
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
    je = jengine.Engine(jc, jax.tree.map(jnp.asarray, params), tok,
                        eos_ids=(tok.eos_token_id,))
    te = engine.Engine(tc, from_jax_params(params, tc), tok,
                       eos_ids=(tok.eos_token_id,))
    return je, te


def _image(seed):
    return np.random.RandomState(seed).randint(0, 256, (128, 128, 3),
                                               dtype=np.uint8)


PROMPT = "a b a b a b a b"  # the tiny model accepts drafts here


def _inputs(je, te, prompt=PROMPT, seed=2):
    full = te.build_prompt(prompt)
    return je.prepare(full, _image(seed)), te.prepare(full, _image(seed))


def _assert_spec_equal(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(want.num_generated))
    assert got.steps == int(want.steps)
    assert int(got.drafted) == int(want.drafted)
    assert int(got.accepted) == int(want.accepted)


@pytest.mark.parametrize("eos", ["unreachable", "mid-stream"])
def test_generate_spec_matches_jax(engines, eos):
    """Tokens, counts, verify passes, drafts and acceptances equal JAX's;
    with an EOS the greedy output emits mid-stream, the EOS cut inside a
    committed span too."""
    je, te = engines
    jin, tin = _inputs(je, te)
    eos_ids = (257,)
    if eos == "mid-stream":
        probe = tvlm.generate(te.params, te.cfg, tin["images"], tin["ids"],
                              tin["lens"], tin["starts"], max_new_tokens=20,
                              eos_ids=eos_ids)
        eos_ids = (int(probe.tokens[0, 9]),)
    kw = dict(max_new_tokens=20, eos_ids=eos_ids, draft_k=4)
    want = jvlm.generate_spec(je.params, je.cfg, jin["images"], jin["ids"],
                              jin["lens"], jin["starts"], **kw)
    got = tvlm.generate_spec(te.params, te.cfg, tin["images"], tin["ids"],
                             tin["lens"], tin["starts"], **kw)
    _assert_spec_equal(got, want)
    assert int(want.accepted) > 0  # the drafts land: not a 1-token crawl
    plain = tvlm.generate(te.params, te.cfg, tin["images"], tin["ids"],
                          tin["lens"], tin["starts"], max_new_tokens=20,
                          eos_ids=eos_ids)
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())


def _prefilled(eng, inputs, cache_len):
    """(logits, cache) of a prefill into a cache of cache_len, on either
    package's engine."""
    cfg = eng.cfg
    dims = (cfg.decoder.num_layers, 1, cache_len, cfg.decoder.num_kv_heads,
            cfg.decoder.head_dim)
    if isinstance(eng, jengine.Engine):
        cache = jkv.init_cache(*dims, dtype=jnp.float32)
        prefill = jvlm._prefill_jit
    else:
        cache = tkv.init_cache(*dims, dtype=torch.float32)
        prefill = tvlm.prefill
    return prefill(eng.params, cfg, inputs["images"], inputs["ids"],
                   inputs["lens"], inputs["starts"], cache)


def test_spec_decode_from_tok_matches_jax(engines):
    """The video path's entry: the first token given, a corpus of the
    prompt then an earlier answer (the draft source)."""
    je, te = engines
    jin, tin = _inputs(je, te)
    t = tin["ids"].shape[1]
    max_new, k = 16, 4
    earlier = tvlm.generate(te.params, te.cfg, tin["images"], tin["ids"],
                            tin["lens"], tin["starts"], max_new_tokens=12,
                            eos_ids=(257,)).tokens[0].numpy()
    corpus = np.zeros((1, t + 12), np.int32)
    n = int(tin["lens"][0])
    corpus[0, :n] = tin["ids"][0, :n].numpy()
    corpus[0, t:] = earlier
    corpus_lens = np.array([t + 12], np.int32)
    size = t + max_new + k + 1
    jl, jc = _prefilled(je, jin, size)
    tl, tc = _prefilled(te, tin, size)
    tok0 = tl.argmax(-1).to(torch.int32)
    assert int(tok0[0]) == int(jnp.argmax(jl, -1)[0])
    kw = dict(max_new_tokens=max_new, eos_ids=(257,), draft_k=k)
    want = jvlm.spec_decode_from_tok(je.params, je.cfg, jnp.argmax(jl, -1),
                                     jc, jnp.asarray(corpus),
                                     jnp.asarray(corpus_lens), **kw)
    got = tvlm.spec_decode_from_tok(te.params, te.cfg, tok0, tc, _t(corpus),
                                    _t(corpus_lens), **kw)
    _assert_spec_equal(got, want)


def test_spec_stream_chunk_matches_jax(engines):
    """spec_carry_init, then dispatches of m = 2 passes: every dispatch's
    tokens and counts, and the carry's counters, equal JAX's."""
    je, te = engines
    jin, tin = _inputs(je, te)
    t = tin["ids"].shape[1]
    max_new, k, m = 20, 4, 2
    size = tvlm.spec_cache_len(t, max_new, k)
    assert size == jvlm.spec_cache_len(t, max_new, k)
    jl, jc = _prefilled(je, jin, size)
    tl, tc = _prefilled(te, tin, size)
    init = dict(max_new_tokens=max_new, draft_k=k, eos_ids=(257,))
    jcarry = jvlm.spec_carry_init(je.cfg, jnp.argmax(jl, -1).astype(jnp.int32),
                                  jc, jin["ids"], jin["lens"], **init)
    tcarry = tvlm.spec_carry_init(te.cfg, tl.argmax(-1), tc, tin["ids"],
                                  tin["lens"], **init)
    np.testing.assert_array_equal(tcarry.hist.numpy(), np.asarray(jcarry.hist))
    kw = dict(m=m, max_new_tokens=max_new, eos_ids=(257,), draft_k=k)
    for _ in range(3):
        jt, jn, jcarry = jvlm.spec_stream_chunk(je.params, je.cfg, jcarry,
                                                **kw)
        tt, tn, tcarry = tvlm.spec_stream_chunk(te.params, te.cfg, tcarry,
                                                **kw)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for name in ("last_tok", "done", "num", "hist", "hist_len"):
        np.testing.assert_array_equal(getattr(tcarry, name).numpy(),
                                      np.asarray(getattr(jcarry, name)))
    np.testing.assert_array_equal(tcarry.cache.lengths.numpy(),
                                  np.asarray(jcarry.cache.lengths))


def test_engine_generate_spec_matches_jax(engines):
    je, te = engines
    full = te.build_prompt(PROMPT)
    jtext, jstats = je.generate_spec(full, _image(2), max_new_tokens=24,
                                     draft_k=4)
    ttext, tstats = te.generate_spec(full, _image(2), max_new_tokens=24,
                                     draft_k=4)
    assert ttext == jtext
    for key in ("decode_tokens", "spec_steps", "spec_accept_rate",
                "prompt_tokens"):
        assert tstats[key] == jstats[key], key
    assert ttext == te.generate(full, _image(2), max_new_tokens=24)[0]


def test_spec_cache_budget_edge(engines, monkeypatch):
    """A prompt that fills its bucket (seq_len = T) and a budget that ends
    the loop: every verify pass's window of k+1 writes ends inside the
    cache of spec_cache_len, so no write reaches the clamp of JAX's
    dynamic_update_slice (the port's indexing would raise there); the
    tokens equal JAX's and plain greedy's."""
    je, te = engines
    cfg = te.cfg
    row, start = expand_image_ids(
        [1] + [ord(c) for c in "repeat repeat repeat"] + [-200, 10, 11],
        cfg.num_image_tokens)
    ids, lens, starts = pad_batch([row], [start], len(row))
    assert int(lens[0]) == ids.shape[1]
    image = te.prepare_array_image(_image(4))
    max_new, k = 12, 4
    ends = []
    write_token = tqwen2.write_token

    def recording(layer_k, layer_v, new_k, new_v, lengths):
        ends.append(int(lengths.max()) + new_k.shape[1])
        return write_token(layer_k, layer_v, new_k, new_v, lengths)

    monkeypatch.setattr(tqwen2, "write_token", recording)
    kw = dict(max_new_tokens=max_new, eos_ids=(257,), draft_k=k)
    got = tvlm.generate_spec(te.params, cfg, image, _t(ids), _t(lens),
                             _t(starts), **kw)
    assert ends and max(ends) <= tvlm.spec_cache_len(len(row), max_new, k)
    assert max(ends) > len(row) + max_new - 1  # past plain decode's end
    monkeypatch.undo()
    want = jvlm.generate_spec(je.params, je.cfg, je.prepare_array_image(
        _image(4)), jnp.asarray(ids), jnp.asarray(lens), jnp.asarray(starts),
        **kw)
    _assert_spec_equal(got, want)
    plain = tvlm.generate(te.params, cfg, image, _t(ids), _t(lens),
                          _t(starts), max_new_tokens=max_new, eos_ids=(257,))
    np.testing.assert_array_equal(got.tokens.numpy(), plain.tokens.numpy())
    assert int(got.num_generated[0]) == max_new
