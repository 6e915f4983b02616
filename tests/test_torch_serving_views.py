"""The port's dense views of the page pool (fastvlm_tpu_torch/ops/kv_cache.py
``gather_pool_view`` / ``write_tokens_paged_rows`` / ``pool_ownership``;
models/vlm.py ``gather_view``, ``sync_pool_from_view``, ``update_view_row``,
``decode_chunk_view``, ``decode_chunk_paged``, ``decode_chunk_pool``)
against the JAX package's functions, in f32 on the CPU.

The same numpy-drawn pool, tables and lengths go through both packages: three
live rows of unequal length and a finished row (table all -1, its length
past the view's width, so its writes clamp in the view and drop on the
way back). The port's pool has one more page, the sink, and its tables are
cut to the page watermark, as the scheduler hands them to the device; JAX's
span the pool. Copies are exact; the decoder's new keys and values are
f32 products on both sides, held to rtol = atol = 1e-5, and the greedy
tokens must be equal. Page 0 is mapped by no row, so a -1 entry that reads
it (both packages clamp -1 to page 0) reads a decoy, and a write that must
drop shows if it lands there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu_torch.models import vlm
from fastvlm_tpu_torch.ops import kv_cache as kv

import torch_tiny as tt

TOL = dict(rtol=1e-5, atol=1e-5)
L, H, D = 2, 2, 16          # the tiny decoder's layers and kv heads
PAGE, P = 8, 16
K = 4                        # decode steps a chunk
# rows: three live ones and a finished one (no pages, length past the view)
LENGTHS = np.array([5, 27, 12, 40], np.int32)
TABLES = [[3, 7], [9, 1, 14, 5], [11, 2], []]


@pytest.fixture(scope="module")
def engines():
    return tt.engines(tt.draw_weights(), eos_ids=(-1,))


def _tables(rows, width):
    t = np.full((len(rows), width), -1, np.int32)
    for i, r in enumerate(rows):
        t[i, :len(r)] = r
    return t


def _pools(seed=0):
    """(JAX (L, P, page, H, D) k, v; the port's (L, P + 1, ...) copies with
    a zero sink)."""
    rng = np.random.RandomState(seed)
    k, v = (0.5 * rng.randn(L, P, PAGE, H, D).astype(np.float32)
            for _ in range(2))
    sink = np.zeros((L, 1, PAGE, H, D), np.float32)
    return (k, v), tuple(torch.from_numpy(np.concatenate([x, sink], 1))
                         for x in (k, v))


def _caches(rows=TABLES, lengths=LENGTHS, seed=0):
    """The same pool as a JAX PagedKVCache (tables over the pool) and a
    port one (tables cut to the widest row's pages)."""
    (k, v), (tk, tv) = _pools(seed)
    jc = jkv.PagedKVCache(k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
                          block_tables=jnp.asarray(_tables(rows, P)),
                          lengths=jnp.asarray(lengths))
    w = max(len(r) for r in rows)
    tc = kv.PagedKVCache(k_pages=tk, v_pages=tv,
                         block_tables=torch.from_numpy(_tables(rows, w)),
                         lengths=torch.from_numpy(lengths.copy()))
    return jc, tc


def _same_pool(jc, tc):
    """The port's pool equals JAX's over the P pages a table may map."""
    for want, got in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        torch.testing.assert_close(got[:, :P], torch.from_numpy(
            np.array(want)), **TOL)


# ---------------------------------------------------------------------------
# ops/kv_cache.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [2, 4, P])
def test_gather_pool_view_matches_jax(width):
    """Rows of unequal length, -1 tails and a row with no page: the port's
    tables cut narrower than the view (2 columns), at the watermark (4) or
    over the pool (16) give JAX's view over its pool-wide tables."""
    rows = [r[:width] for r in TABLES]
    jc, tc = _caches(rows)
    tc = dataclasses.replace(tc, block_tables=torch.from_numpy(
        _tables(rows, width)))
    want = jkv.gather_pool_view(jc, 4 * PAGE)
    got = kv.gather_pool_view(tc, 4 * PAGE)
    for w, g in zip(want, got):
        assert g.shape == (L, 4, 4 * PAGE, H, D)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_write_tokens_paged_rows_matches_jax():
    """Windows of 5 at unequal offsets: one over a page edge, one running
    past its row's mapped pages, one past the table's width, a row with no
    page. JAX drops the unmapped slots; the port sends them to the sink, and
    page 0 (no row's) is untouched. One layer, as JAX's call, and the
    whole pool in one copy give the same pool."""
    rows = [[3, 7], [9, 1], [11], []]
    offsets = np.array([6, 13, 6, 2], np.int32)
    t = 5
    new = np.random.RandomState(1).randn(L, 4, t, H, D).astype(np.float32)
    jc, tc = _caches(rows)
    want = [jkv.write_tokens_paged_rows(
        jc.k_pages[i], jc.v_pages[i], jnp.asarray(new[i]),
        jnp.asarray(-new[i]), jc.block_tables, jnp.asarray(offsets))
        for i in range(L)]
    page0 = tc.k_pages[:, 0].clone()
    per_layer = [t_.clone() for t_ in (tc.k_pages, tc.v_pages)]
    for i in range(L):
        kv.write_tokens_paged_rows(
            per_layer[0][i], per_layer[1][i], torch.from_numpy(new[i]),
            torch.from_numpy(-new[i]), tc.block_tables,
            torch.from_numpy(offsets))
    kv.write_tokens_paged_rows(tc.k_pages, tc.v_pages, torch.from_numpy(new),
                               torch.from_numpy(-new), tc.block_tables,
                               torch.from_numpy(offsets))
    for j, got in enumerate((tc.k_pages, tc.v_pages)):
        np.testing.assert_array_equal(
            got[:, :P].numpy(), np.stack([np.asarray(w[j]) for w in want]))
        torch.testing.assert_close(per_layer[j], got, rtol=0, atol=0)
    assert torch.equal(tc.k_pages[:, 0], page0)
    assert tc.k_pages[:, P].any()  # the dropped slots landed in the sink


def test_pool_ownership_matches_jax():
    jt = jnp.asarray(_tables(TABLES, P))
    want = jkv.pool_ownership(jt, P, PAGE)
    got = kv.pool_ownership(torch.from_numpy(_tables(TABLES, 4)), P, PAGE)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# models/vlm.py
# ---------------------------------------------------------------------------


def _tokens(seed=2):
    tok = np.random.RandomState(seed).randint(0, 258, 4).astype(np.int32)
    done = np.array([False, False, False, True])
    return tok, done


def _both(tok, done):
    return ((jnp.asarray(tok), jnp.asarray(done)),
            (torch.from_numpy(tok), torch.from_numpy(done)))


def test_decode_chunk_paged_matches_jax(engines):
    """The chunk view: gather once, K steps on the dense view, write back.
    Tokens, lengths and the pool after the write-back equal JAX's."""
    je, te = engines
    jc, tc = _caches()
    (jt, jd), (pt, pd) = _both(*_tokens())
    s_bucket = 4 * PAGE
    want = jvlm.decode_chunk_paged(je.params, je.cfg, jt, jd, jc,
                                   jax.random.PRNGKey(0), k=K,
                                   s_bucket=s_bucket, eos_ids=(-1,))
    toks, done, tok, cache = vlm.decode_chunk_paged(
        te.params, te.cfg, pt, pd, tc, None, k=K, s_bucket=s_bucket,
        eos_ids=(-1,))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(want[3].lengths))
    assert (toks[:3] != 0).any() and not toks[3].any()
    _same_pool(want[3], cache)


def test_decode_chunk_view_matches_jax(engines):
    """The persistent view: gather_view, then a chunk on the view with its
    write-back (the finished row's length runs past the view)."""
    je, te = engines
    jc, tc = _caches()
    (jt, jd), (pt, pd) = _both(*_tokens(3))
    vb = 4 * PAGE
    jview = jvlm.gather_view(jc, vb)
    view = vlm.gather_view(tc, vb)
    np.testing.assert_array_equal(view.k.numpy(), np.asarray(jview.k))
    want = jvlm.decode_chunk_view(je.params, je.cfg, jt, jd, jview, jc,
                                  jax.random.PRNGKey(0), k=K, eos_ids=(-1,))
    toks, done, tok, view, pool = vlm.decode_chunk_view(
        te.params, te.cfg, pt, pd, view, tc, None, k=K, eos_ids=(-1,))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(view.lengths.numpy(),
                                  np.asarray(want[3].lengths))
    torch.testing.assert_close(view.k, torch.from_numpy(
        np.array(want[3].k)), **TOL)
    _same_pool(want[4], pool)


def test_only_a_pool_view_clamps_a_write_past_its_width(engines):
    """The finished row (length 40) on a 32-wide view: a decode step writes
    its token at column 31, as JAX's dynamic_update_slice clamps it, and
    keeps its true length. The same planes as a plain dense cache raise
    instead, so an undersized cache cannot overwrite a live row's last
    column."""
    _, te = engines
    _, tc = _caches()
    tok = torch.from_numpy(_tokens()[0])
    view = vlm.gather_view(tc, 4 * PAGE)
    assert view.pool_view and vlm.update_view_row(view, tc, 0).pool_view
    plain = dataclasses.replace(view, k=view.k.clone(), v=view.v.clone(),
                                pool_view=False)
    before = view.k[:, 3, -1].clone()
    _, out = vlm.decode_step(te.params, te.cfg, tok, view)
    np.testing.assert_array_equal(out.lengths.numpy(), LENGTHS + 1)
    assert not torch.equal(view.k[:, 3, -1], before)
    with pytest.raises(IndexError):
        vlm.decode_step(te.params, te.cfg, tok, plain)


@pytest.mark.parametrize("w", [8, 4 * PAGE])
def test_sync_pool_from_view_matches_jax(engines, w):
    """K steps on the view (K2's plain version here; JAX's Pallas kernel in
    interpret mode), then the deferred sync: row 1's window (length 27,
    view 32) starts at the clamp ``view width - w``; a view-wide window
    rewrites every row from 0. Pools equal JAX's, lengths the view's."""
    je, te = engines
    jc, tc = _caches()
    (jt, jd), (pt, pd) = _both(*_tokens(4))
    vb = 4 * PAGE
    jview = jvlm.decode_chunk(je.params, je.cfg, jt, jd,
                              jvlm.gather_view(jc, vb), jax.random.PRNGKey(0),
                              k=K, eos_ids=(-1,))[3]
    view = vlm.decode_chunk(te.params, te.cfg, pt, pd,
                            vlm.gather_view(tc, vb), None, k=K,
                            eos_ids=(-1,))[3]
    synced = np.minimum(LENGTHS, 30)
    want = jvlm.sync_pool_from_view(jview, jc, jnp.asarray(synced), w=w)
    got = vlm.sync_pool_from_view(view, tc, torch.from_numpy(synced), w=w)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    _same_pool(want, got)
    assert got.k_pages is tc.k_pages  # in place


def test_update_view_row_matches_jax():
    """An admission rebinds row 2 to new pages and a new length: its view
    row is copied from the pool, the other rows stay as they were."""
    jc, tc = _caches()
    vb = 4 * PAGE
    jview = jvlm.gather_view(jc, vb)
    view = vlm.gather_view(tc, vb)
    rows = [TABLES[0], TABLES[1], [13, 6, 15], []]
    lengths = LENGTHS.copy()
    lengths[2] = 17
    jc2, tc2 = _caches(rows, lengths)
    before = view.k.clone()
    want = jvlm.update_view_row(jview, jc2, jnp.asarray(2, jnp.int32))
    got = vlm.update_view_row(view, tc2, 2)
    for w, g in ((want.k, got.k), (want.v, got.v)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert got.lengths[2] == 17 and view.lengths[2] == LENGTHS[2]
    assert torch.equal(got.k[:, :2], before[:, :2])
    assert not torch.equal(got.k[:, 2], before[:, 2])


@pytest.mark.parametrize("p_bucket", [None, 15])
def test_decode_chunk_pool_matches_jax(engines, p_bucket):
    """The whole-pool decode under an ownership mask (every mapped page
    below 15 for the bucketed case): tokens and pool equal JAX's; the
    finished row, with no page, decodes zeros."""
    je, te = engines
    rows = [[3, 7], [9, 1, 14, 5], [11, 2], []]
    jc, tc = _caches(rows)
    (jt, jd), (pt, pd) = _both(*_tokens(5))
    want = jvlm.decode_chunk_pool(je.params, je.cfg, jt, jd, jc,
                                  jax.random.PRNGKey(0), k=K, eos_ids=(-1,),
                                  p_bucket=p_bucket)
    toks, done, tok, cache = vlm.decode_chunk_pool(
        te.params, te.cfg, pt, pd, tc, None, k=K, eos_ids=(-1,),
        p_bucket=p_bucket)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(cache.lengths.numpy(),
                                  np.asarray(want[3].lengths))
    _same_pool(want[3], cache)


def test_chunk_view_equals_the_pool_in_place(engines):
    """The chunk view and the persistent view give the in-place decode's
    tokens (kernel K3's plain version over the same pool), and leave the
    pool's live pages as the in-place decode leaves them."""
    _, te = engines
    (_, _), (pt, pd) = _both(*_tokens(6))
    runs = {}
    for name in ("inplace", "chunk", "persist"):
        _, tc = _caches()
        if name == "inplace":
            toks, _, _, tc = vlm.decode_chunk(te.params, te.cfg, pt, pd, tc,
                                              None, k=K, eos_ids=(-1,))
        elif name == "chunk":
            toks, _, _, tc = vlm.decode_chunk_paged(
                te.params, te.cfg, pt, pd, tc, None, k=K, s_bucket=4 * PAGE,
                eos_ids=(-1,))
        else:
            view = vlm.gather_view(tc, 4 * PAGE)
            toks, _, _, view = vlm.decode_chunk(te.params, te.cfg, pt, pd,
                                                view, None, k=K,
                                                eos_ids=(-1,))
            tc = vlm.sync_pool_from_view(view, tc, torch.from_numpy(LENGTHS),
                                         w=K)
        runs[name] = (toks, tc)
    want, ref = runs.pop("inplace")
    live = sorted({p for r in TABLES for p in r})
    for toks, tc in runs.values():
        np.testing.assert_array_equal(toks[:3].numpy(), want[:3].numpy())
        torch.testing.assert_close(tc.k_pages[:, live], ref.k_pages[:, live],
                                   **TOL)
