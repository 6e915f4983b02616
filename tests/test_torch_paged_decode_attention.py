"""Kernel K3's plain version
(fastvlm_tpu_torch/ops/cuda/paged_decode_attention.py) against the JAX
package's Pallas kernel run in interpret mode, in f32: the shapes of
tests/test_decode_attention.py's paged test (shuffled pool pages, decoy
pages, unmapped tails), pages 8 to 128, the 0.5B, 1.5B and 7B head
geometries (the shapes the kernel takes on the card, where it is held
against this plain version), a table as wide as the pool, lengths past the
table's capacity, and pad rows whose table is all -1.

Tolerance rtol=atol=2e-5, the JAX package's own bar for its kernels against
a dense reference: the two differ only in summation order (page-blocked
online softmax vs one full softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu.ops.pallas.decode_attention import (
    paged_decode_attention as jax_k3)
from fastvlm_tpu_torch.ops.cuda import paged_decode_attention as k3

RTOL = ATOL = 2e-5


def _case(b, hq, hkv, d, page, pps, lengths, seed, pool=None):
    """q, pools and tables: shuffled pool pages, every page fully past a
    row's length unmapped (-1), as the allocator leaves them."""
    rng = np.random.RandomState(seed)
    p = pool or b * pps + 2  # extra pages are decoys
    q = rng.randn(b, hq, d).astype(np.float32)
    kp = rng.randn(p, page, hkv, d).astype(np.float32)
    vp = rng.randn(p, page, hkv, d).astype(np.float32)
    tables = np.full((b, pps), -1, np.int32)
    perm = rng.permutation(p)
    used = 0
    for i, n in enumerate(lengths):
        need = min(-(-int(n) // page), pps)
        tables[i, :need] = perm[used:used + need]
        used += need
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _both(q, kp, vp, tables, lengths):
    want = np.asarray(jax_k3(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                             jnp.asarray(tables), jnp.asarray(lengths),
                             interpret=True))
    got = k3.paged_decode_attention_reference(
        *(torch.from_numpy(x) for x in (q, kp, vp, tables, lengths)))
    return got.numpy(), want


@pytest.mark.parametrize("b,hq,hkv,d,page,pps", [
    (2, 4, 2, 16, 32, 3),
    (3, 8, 2, 32, 16, 4),   # more rows than a pow2, small pages
    (1, 4, 4, 16, 64, 2),   # MHA (g=1)
    (3, 14, 2, 64, 8, 6),   # page 8, the 0.5B head geometry (G = 7)
    (2, 12, 2, 128, 16, 3),  # the 1.5B head geometry (G = 6)
    (2, 28, 4, 128, 16, 2),  # the 7B head geometry (G = 7, 4 KV heads)
    (2, 4, 2, 16, 128, 2),   # page 128
    (1, 28, 4, 128, 128, 2),  # the 7B heads at page 128
])
def test_reference_matches_pallas(b, hq, hkv, d, page, pps):
    lengths = [page + 3, pps * page, 1][:b]
    got, want = _both(*_case(b, hq, hkv, d, page, pps, lengths, seed=2))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_table_as_wide_as_the_pool():
    """The JAX scheduler's tables span the whole pool (one column per pool
    page), mostly -1; lengths at and around page boundaries."""
    page, pool = 16, 24
    lengths = [1, page - 1, page, page + 1, 77]
    case = _case(5, 8, 2, 16, page, pool, lengths, seed=3, pool=pool)
    got, want = _both(*case)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_pad_rows_are_finite():
    """A pad or finished row (table all -1) reads page 0, masked by its
    length: a finite output, never NaN, as in the Pallas kernel."""
    q, kp, vp, tables, lengths = _case(3, 4, 2, 16, 8, 4, [9, 30, 5], seed=4)
    tables[1:] = -1
    got, want = _both(q, kp, vp, tables, lengths)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_length_past_the_capacity_counts_as_the_capacity():
    """A length past pages_per_seq * page reads every mapped position, as
    the Pallas kernel's grid (one step per table column) does."""
    page, pps = 16, 3
    q, kp, vp, tables, _ = _case(2, 8, 2, 16, page, pps, [pps * page] * 2,
                                 seed=8)
    lengths = np.asarray([pps * page + 5, 4 * pps * page], np.int32)
    got, want = _both(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    at_cap, _ = _both(q, kp, vp, tables, np.full(2, pps * page, np.int32))
    np.testing.assert_array_equal(got, at_cap)


def test_length_one_reads_the_first_slot():
    q, kp, vp, tables, lengths = _case(1, 4, 2, 16, 8, 2, [1], seed=5)
    got, _ = _both(q, kp, vp, tables, lengths)
    # query heads 0-1 read KV head 0; its only key is slot 0 of the row's
    # first page
    np.testing.assert_allclose(got[0, 0], vp[tables[0, 0], 0, 0],
                               rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_reference():
    case = [torch.from_numpy(x)
            for x in _case(2, 4, 2, 16, 8, 3, [5, 24], seed=6)]
    before = k3.paged_decode_attention.launches
    np.testing.assert_array_equal(
        k3.paged_decode_attention(*case).numpy(),
        k3.paged_decode_attention_reference(*case).numpy())
    assert k3.paged_decode_attention.launches == before


def test_no_fallback_on_other_devices():
    q = torch.empty((1, 4, 64), device="meta")
    kv = torch.empty((3, 16, 2, 64), device="meta")
    tables = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k3.paged_decode_attention(q, kv, kv, tables,
                                  torch.ones(1, dtype=torch.int32,
                                             device="meta"))


def _good(dtype=torch.bfloat16, hq=14, hkv=2, d=64, page=64):
    q, kp, vp, tables, lengths = _case(2, hq, hkv, d, page, 3, [5, 150],
                                       seed=7)
    return {"q": torch.from_numpy(q).to(dtype),
            "k_pages": torch.from_numpy(kp).to(dtype),
            "v_pages": torch.from_numpy(vp).to(dtype),
            "block_tables": torch.from_numpy(tables),
            "lengths": torch.from_numpy(lengths)}


BAD_ARGS = {  # name -> (edit of the good arguments, expected message)
    "page_size": (lambda a: _good(page=24), "page size"),
    "head_dim": (lambda a: _good(d=32), "head_dim"),
    "group": (lambda a: _good(hq=34, hkv=2), "Hq / Hkv"),
    "dtype": (lambda a: {k: (x.half() if x.is_floating_point() else x)
                         for k, x in a.items()}, "dtype"),
    "kv_dtype": (lambda a: {**a, "v_pages": a["v_pages"].float()},
                 "expected"),
    "kv_shape": (lambda a: {**a, "v_pages": a["v_pages"][:-1].clone()},
                 "shapes differ"),
    "tables": (lambda a: {**a, "block_tables": a["block_tables"].long()},
               "block_tables"),
    "lengths": (lambda a: {**a, "lengths": a["lengths"].long()}, "int32"),
    "strided": (lambda a: {**a, "k_pages": a["k_pages"].transpose(1, 2)
                           .contiguous().transpose(1, 2)}, "contiguous"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_argument_checks_raise(case):
    """What the CUDA kernel does not take is refused before any launch (the
    checks are device-independent, so they run here on CPU tensors)."""
    good = _good()
    k3._check_cuda_args(**good)
    edit, match = BAD_ARGS[case]
    with pytest.raises((ValueError, TypeError), match=match):
        k3._check_cuda_args(**edit(good))


class _FakeLib:
    """Stands in for the built library's workspace query."""

    @staticmethod
    def fvlm_paged_decode_workspace(*shape):
        return 64


def test_buffers_are_kept_per_stream():
    """Two streams never share K3's workspace or arrival counters, nor does
    K3 share K2's; calls on one stream reuse theirs (the wrapper's
    bookkeeping, device-independent, so it runs here with CPU buffers)."""
    from fastvlm_tpu_torch.ops.cuda import decode_attention as k2

    dev = torch.device("cpu")
    shape = (3, 6, 3, 16, 5, 0)  # a key no real call uses
    try:
        a = k3._workspace(_FakeLib, dev, 101, *shape)
        b = k3._workspace(_FakeLib, dev, 102, *shape)
        assert a == k3._workspace(_FakeLib, dev, 101, *shape)
        assert a[0] != b[0] and a[1] != b[1]
        ws, counters = k3._BUFFERS[(dev, 101)]
        assert ws.numel() >= 64 and counters.numel() >= 9
        assert int(counters.abs().sum()) == 0
        assert (dev, 101) not in k2._BUFFERS
        # a larger call on the stream grows its buffers in place of the old
        big = k3._workspace(_FakeLib, dev, 101, 5, 6, 3, 16, 5, 0)
        assert k3._BUFFERS[(dev, 101)][1].numel() >= 15
        assert big != a
    finally:
        k3._BUFFERS.pop((dev, 101), None)
        k3._BUFFERS.pop((dev, 102), None)
        k3._WS_ELEMS.pop(shape, None)
        k3._WS_ELEMS.pop((5, 6, 3, 16, 5, 0), None)
