"""Kernel K2's plain version (fastvlm_tpu_torch/ops/cuda/decode_attention.py)
against the JAX package's Pallas kernel run in interpret mode, in f32, on the
shapes of tests/test_decode_attention.py.

Tolerance rtol=atol=2e-5, the JAX package's own bar for its kernel against a
dense reference: the two differ only in summation order (blocked online
softmax vs one full softmax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu.ops.pallas.decode_attention import decode_attention as jax_k2
from fastvlm_tpu_torch.ops.cuda import decode_attention as k2

RTOL = ATOL = 2e-5


def _inputs(b, hq, hkv, d, s, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32),
            rng.randn(b, s, hkv, d).astype(np.float32))


def _both(q, k, v, lengths, block):
    want = np.asarray(jax_k2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lengths), block_size=block,
                             interpret=True))
    got = k2.decode_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lengths))
    return got.numpy(), want


@pytest.mark.parametrize("b,hq,hkv,d,s,block", [
    (1, 4, 2, 16, 64, 32),
    (2, 8, 2, 32, 96, 32),   # ragged lengths, non-pow2 block count
    (2, 4, 4, 16, 64, 64),   # MHA (g=1)
    (1, 14, 2, 64, 96, 32),  # the 0.5B head geometry (G = 7)
])
def test_reference_matches_pallas(b, hq, hkv, d, s, block):
    q, k, v = _inputs(b, hq, hkv, d, s, seed=0)
    lengths = np.array([s // 2, s][:b], np.int32)
    got, want = _both(q, k, v, lengths, block)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_length_one_and_full():
    b, hq, hkv, d, s = 2, 4, 2, 16, 32
    q, k, v = _inputs(b, hq, hkv, d, s, seed=1)
    lengths = np.array([1, s], np.int32)
    got, want = _both(q, k, v, lengths, 16)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # a length-1 row attends only to key 0 (query head 0 reads KV head 0)
    np.testing.assert_allclose(got[0, 0], v[0, 0, 0], rtol=RTOL, atol=ATOL)


def test_keys_past_length_are_ignored():
    """Garbage past each row's length (the unwritten cache tail) must not
    change the output."""
    b, hq, hkv, d, s = 2, 4, 2, 16, 48
    q, k, v = _inputs(b, hq, hkv, d, s, seed=2)
    lengths = np.array([5, 30], np.int32)
    base = k2.decode_attention_reference(*(torch.from_numpy(x) for x in
                                           (q, k, v, lengths)))
    k2_, v2_ = k.copy(), v.copy()
    for i, n in enumerate(lengths):
        k2_[i, n:] = 1e4
        v2_[i, n:] = -1e4
    got = k2.decode_attention_reference(*(torch.from_numpy(x) for x in
                                          (q, k2_, v2_, lengths)))
    np.testing.assert_array_equal(got.numpy(), base.numpy())


def test_cpu_tensors_take_the_reference():
    q, k, v = _inputs(2, 4, 2, 16, 32, seed=3)
    args = [torch.from_numpy(x) for x in (q, k, v, np.array([3, 32], np.int32))]
    before = k2.decode_attention.launches
    np.testing.assert_array_equal(k2.decode_attention(*args).numpy(),
                                  k2.decode_attention_reference(*args).numpy())
    assert k2.decode_attention.launches == before


def test_no_fallback_on_other_devices():
    q = torch.empty((1, 4, 64), device="meta")
    kv = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k2.decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32,
                                                  device="meta"))


def _good(dtype=torch.bfloat16, hq=14, hkv=2, d=64):
    q, k, v = _inputs(2, hq, hkv, d, 96, seed=4)
    return {"q": torch.from_numpy(q).to(dtype), "k": torch.from_numpy(k).to(dtype),
            "v": torch.from_numpy(v).to(dtype),
            "lengths": torch.tensor([5, 96], dtype=torch.int32)}


BAD_ARGS = {  # name -> (edit of the good arguments, expected message)
    "head_dim": (lambda a: _good(d=32), "head_dim"),
    "group": (lambda a: _good(hq=34, hkv=2), "Hq / Hkv"),
    "dtype": (lambda a: {k: (x.half() if k != "lengths" else x)
                         for k, x in a.items()}, "dtype"),
    "kv_dtype": (lambda a: {**a, "v": a["v"].float()}, "expected"),
    "kv_shape": (lambda a: {**a, "v": a["v"][:, :-1].clone()}, "shapes differ"),
    "lengths": (lambda a: {**a, "lengths": a["lengths"].long()}, "int32"),
    "strided": (lambda a: {**a, "k": a["k"].transpose(1, 2).contiguous()
                           .transpose(1, 2)}, "contiguous"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_argument_checks_raise(case):
    """What the CUDA kernel does not take is refused before any launch (the
    checks are device-independent, so they run here on CPU tensors)."""
    good = _good()
    k2._check_cuda_args(good["q"], good["k"], good["v"], good["lengths"])
    edit, match = BAD_ARGS[case]
    bad = edit(good)
    with pytest.raises((ValueError, TypeError), match=match):
        k2._check_cuda_args(bad["q"], bad["k"], bad["v"], bad["lengths"])


class _FakeLib:
    """Stands in for the built library's workspace query."""

    @staticmethod
    def fvlm_decode_workspace(*shape):
        return 64


def test_buffers_are_kept_per_stream():
    """Two streams never share K2's workspace or arrival counters; calls on
    one stream reuse theirs (the wrapper's bookkeeping, device-independent,
    so it runs here with CPU buffers)."""
    dev = torch.device("cpu")
    shape = (3, 6, 3, 16, 5, 0)  # a key no real call uses
    try:
        a = k2._workspace(_FakeLib, dev, 101, *shape)
        b = k2._workspace(_FakeLib, dev, 102, *shape)
        assert a == k2._workspace(_FakeLib, dev, 101, *shape)
        assert a[0] != b[0] and a[1] != b[1]
        assert int(k2._BUFFERS[(dev, 101)][1].abs().sum()) == 0
    finally:
        k2._BUFFERS.pop((dev, 101), None)
        k2._BUFFERS.pop((dev, 102), None)
        k2._WS_ELEMS.pop(shape, None)
