"""The port's paged KV cache (fastvlm_tpu_torch/ops/kv_cache.py) against the
JAX package's, on the cases of tests/test_paged_cache.py: prompt and token
writes with shuffled page tables, offsets across a page boundary, unmapped
pages and positions past the table's capacity (dropped, never wrapped), a
pool shared across rows, and gather_pages.

The port's pool carries one extra page, the sink, where dropped writes land;
every comparison with JAX covers the P pages a table may map, and the tests
check that nothing else of the pool moved. Writes are copies, so equality is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu.ops import kv_cache as jkv
from fastvlm_tpu_torch.ops import kv_cache as kv


def _tables(batch, pages_per_seq, seed, pool=None):
    """Collision-free shuffled page assignment, like a real allocator."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(pool or batch * pages_per_seq)
    return perm[:batch * pages_per_seq].reshape(batch, pages_per_seq) \
        .astype(np.int32)


def _pool(p, page, h, d, seed):
    """A (P, page, H, D) pool of random values and the port's (P + 1, ...)
    copy of it with a sink page of NaN (so a read of the sink shows)."""
    pool = np.random.RandomState(seed).randn(p, page, h, d).astype(np.float32)
    sink = np.full((1, page, h, d), np.nan, np.float32)
    return pool, torch.from_numpy(np.concatenate([pool, sink]))


def _write_both(kind, pool, tpool, new, tables, arg):
    """The same write on both sides; returns (JAX pool, port pool[:P])."""
    jfn = getattr(jkv, f"write_{kind}_paged")
    tfn = getattr(kv, f"write_{kind}_paged")
    want, _ = jfn(jnp.asarray(pool), jnp.asarray(pool), jnp.asarray(new),
                  jnp.asarray(new), jnp.asarray(tables), jnp.asarray(arg)
                  if kind == "token" else arg)
    tv = tpool.clone()
    tfn(tpool, tv, torch.from_numpy(new), torch.from_numpy(new),
        torch.from_numpy(tables), torch.from_numpy(arg)
        if kind == "token" else arg)
    torch.testing.assert_close(tpool, tv, equal_nan=True, rtol=0, atol=0)
    return np.asarray(want), tpool[:-1].numpy()


@pytest.mark.parametrize("offset", [0, 5])  # 5 crosses a page boundary
def test_prompt_write_matches_jax(offset):
    b, t, h, d, page, pps = 3, 10, 2, 4, 4, 5
    new = np.random.RandomState(1).randn(b, t, h, d).astype(np.float32)
    tables = _tables(b, pps, seed=offset)
    pool, tpool = _pool(b * pps, page, h, d, seed=2)
    want, got = _write_both("prompt", pool, tpool, new, tables, offset)
    np.testing.assert_array_equal(got, want)
    # and the dense view equals a dense cache written the same way
    dense = np.asarray(jkv.gather_pages(jnp.asarray(want), jnp.asarray(tables)))
    np.testing.assert_array_equal(dense[:, offset:offset + t], new)


def test_token_write_matches_jax():
    b, h, d, page, pps = 4, 2, 4, 8, 3
    lengths = np.array([0, 7, 8, 15], np.int32)  # page boundaries included
    new = np.random.RandomState(4).randn(b, 1, h, d).astype(np.float32)
    tables = _tables(b, pps, seed=2)
    pool, tpool = _pool(b * pps, page, h, d, seed=3)
    want, got = _write_both("token", pool, tpool, new, tables, lengths)
    np.testing.assert_array_equal(got, want)


def test_unmapped_pages_are_dropped():
    """A write whose virtual page has no pool page (-1) lands nowhere in the
    pool (the port sends it to the sink): no wrap into the last page."""
    b, t, h, d, page = 1, 8, 1, 2, 4
    tables = np.array([[2, -1]], np.int32)  # second page unmapped
    pool, tpool = _pool(4, page, h, d, seed=5)
    new = np.full((b, t, h, d), 7.0, np.float32)
    want, got = _write_both("token", pool, tpool, new[:, :1], tables,
                            np.array([5], np.int32))
    np.testing.assert_array_equal(want, pool)
    np.testing.assert_array_equal(got, pool)
    pool, tpool = _pool(4, page, h, d, seed=5)
    want, got = _write_both("prompt", pool, tpool, new, tables, 0)
    np.testing.assert_array_equal(got, want)
    assert (got[2] == 7.0).all()  # tokens 0-3 land in page 2
    np.testing.assert_array_equal(got[[0, 1, 3]], pool[[0, 1, 3]])
    assert (tpool[-1] == 7.0).any()  # tokens 4-7 went to the sink


def test_positions_past_capacity_are_dropped():
    """A finished row at full length keeps writing: past the table's
    capacity the write must drop, not alias the last column's page."""
    h, d, page = 1, 2, 4
    tables = np.array([[1, 3], [2, 0]], np.int32)
    lengths = np.array([8, 13], np.int32)  # capacity 8: both past it
    pool, tpool = _pool(4, page, h, d, seed=6)
    new = np.full((2, 1, h, d), 9.0, np.float32)
    want, got = _write_both("token", pool, tpool, new, tables, lengths)
    np.testing.assert_array_equal(want, pool)
    np.testing.assert_array_equal(got, pool)


def test_pool_is_shared_across_rows():
    """Two rows with interleaved page ids do not clobber each other."""
    h, d, page = 1, 2, 4
    tables = np.array([[1, 3], [2, 0]], np.int32)
    pool = np.zeros((4, page, h, d), np.float32)
    tpool = torch.zeros((5, page, h, d))
    new = np.stack([np.full((6, h, d), 1.0), np.full((6, h, d), 2.0)]) \
        .astype(np.float32)
    want, got = _write_both("prompt", pool, tpool, new, tables, 0)
    np.testing.assert_array_equal(got, want)
    dense = kv.gather_pages(tpool, torch.from_numpy(tables)).numpy()
    np.testing.assert_array_equal(dense[0, :6], 1.0)
    np.testing.assert_array_equal(dense[1, :6], 2.0)
    np.testing.assert_array_equal(dense[:, 6:], 0.0)


@pytest.mark.parametrize("with_unmapped", [False, True])
def test_gather_pages_matches_jax(with_unmapped):
    b, h, d, page, pps = 3, 2, 4, 8, 4
    tables = _tables(b, pps, seed=7, pool=b * pps + 2)  # decoy pages
    if with_unmapped:
        tables[0, 2:] = -1
        tables[2, :] = -1  # a pad row: clamps to page 0
    pool, tpool = _pool(b * pps + 2, page, h, d, seed=8)
    want = np.asarray(jkv.gather_pages(jnp.asarray(pool), jnp.asarray(tables)))
    got = kv.gather_pages(tpool, torch.from_numpy(tables)).numpy()
    np.testing.assert_array_equal(got, want)


def test_flat_dest_matches_jax():
    """Mapped positions get JAX's flat index; JAX's dropped ones (2**30)
    go to the sink page's slot of the same offset."""
    page, sink = 4, 6
    tables = np.array([[5, -1, 0], [3, 1, -1]], np.int32)
    pos = np.array([[0, 3, 4, 9, 11, 12, 17], [1, 5, 8, 11, 12, 40, 2]],
                   np.int32)
    want = np.asarray(jkv._flat_dest(jnp.asarray(tables), jnp.asarray(pos),
                                     page))
    got = kv._flat_dest(torch.from_numpy(tables), torch.from_numpy(pos), page,
                        sink).numpy()
    dropped = want == 2 ** 30
    assert dropped.any() and (~dropped).any()
    np.testing.assert_array_equal(got[~dropped], want[~dropped])
    np.testing.assert_array_equal(got[dropped], sink * page + pos[dropped] % page)


def test_init_paged_cache_shapes():
    c = kv.init_paged_cache(num_layers=2, batch=3, num_pages=16, page_size=8,
                            pages_per_seq=4, num_kv_heads=2, head_dim=4,
                            dtype=torch.float32)
    j = jkv.init_paged_cache(num_layers=2, batch=3, num_pages=16, page_size=8,
                             pages_per_seq=4, num_kv_heads=2, head_dim=4)
    assert c.k_pages.shape == (2, 17, 8, 2, 4)  # + the sink page
    assert (c.page_size, c.num_pages, c.max_len, c.num_layers) == \
        (j.page_size, j.num_pages, j.max_len, j.num_layers)
    np.testing.assert_array_equal(c.block_tables.numpy(),
                                  np.asarray(j.block_tables))
    assert c.block_tables.dtype == c.lengths.dtype == torch.int32
