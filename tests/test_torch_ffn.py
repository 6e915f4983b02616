"""Kernel K1's plain version (fastvlm_tpu_torch/ops/cuda/ffn.py) against the
JAX package's Pallas kernel run in interpret mode, in f32.

Tolerance rtol=atol=1e-5: both sides do the same f32 arithmetic; they differ
in summation order and in GELU's erf (torch's erf vs the Pallas kernel's
rational approximation, |err| <= 1.5e-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu.ops.pallas import ffn as jax_ffn
from fastvlm_tpu_torch.ops.cuda import ffn

RTOL = ATOL = 1e-5


def _inputs(n, c, seed=0):
    rng = np.random.RandomState(seed)
    ch = 4 * c
    return dict(
        t=rng.randn(n, c).astype(np.float32),
        residual=rng.randn(n, c).astype(np.float32),
        w1=(rng.randn(c, ch) / np.sqrt(c)).astype(np.float32),
        b1=(0.1 * rng.randn(ch)).astype(np.float32),
        w2=(rng.randn(ch, c) / np.sqrt(ch)).astype(np.float32),
        b2=(0.1 * rng.randn(c)).astype(np.float32),
        ls=(1.0 + 0.5 * rng.randn(c)).astype(np.float32),
    )


def _torch(a):
    return {k: torch.from_numpy(v) for k, v in a.items()}


@pytest.mark.parametrize("use_ls", [True, False])
@pytest.mark.parametrize("n,c,block_rows", [(64, 16, 32), (96, 32, 32)])
def test_reference_matches_pallas_fused_ffn(n, c, block_rows, use_ls):
    a = _inputs(n, c)
    ls = a["ls"] if use_ls else np.ones_like(a["ls"])  # JAX passes ones
    want = np.asarray(jax_ffn.fused_ffn(
        jnp.asarray(a["t"]), jnp.asarray(a["residual"]), jnp.asarray(a["w1"]),
        jnp.asarray(a["b1"]), jnp.asarray(a["w2"]), jnp.asarray(a["b2"]),
        jnp.asarray(ls), block_rows=block_rows, interpret=True))
    ta = _torch(a)
    got = ffn.ffn_reference(ta["t"], ta["residual"], ta["w1"], ta["b1"],
                            ta["w2"], ta["b2"], ta["ls"] if use_ls else None)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_ls", [True, False])
def test_block_apply_matches_pallas_block_apply(use_ls):
    """NHWC wrapper: (B, H, W, C) grids, port (C, Ch) matrices vs JAX 1x1
    conv kernels (1, 1, C, Ch)."""
    b, h, w, c = 2, 4, 8, 16
    a = _inputs(b * h * w, c, seed=1)
    t = a["t"].reshape(b, h, w, c)
    res = a["residual"].reshape(b, h, w, c)
    jp = {"fc1": {"w": jnp.asarray(a["w1"][None, None]), "b": jnp.asarray(a["b1"])},
          "fc2": {"w": jnp.asarray(a["w2"][None, None]), "b": jnp.asarray(a["b2"])}}
    ls = a["ls"] if use_ls else np.ones_like(a["ls"])
    want = np.asarray(jax_ffn.ffn_block_apply(
        jnp.asarray(t), jnp.asarray(res), jp, jnp.asarray(ls), block_rows=32,
        interpret=True))
    ta = _torch(a)
    tp = {"fc1": {"w": ta["w1"], "b": ta["b1"]},
          "fc2": {"w": ta["w2"], "b": ta["b2"]}}
    got = ffn.ffn_block_apply(torch.from_numpy(t), torch.from_numpy(res), tp,
                              ta["ls"] if use_ls else None)
    assert got.shape == (b, h, w, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_reference():
    ta = _torch(_inputs(40, 16, seed=2))  # 40 rows: no block-size rule
    args = (ta["t"], ta["residual"], ta["w1"], ta["b1"], ta["w2"], ta["b2"],
            ta["ls"])
    before = ffn.fused_ffn.launches
    np.testing.assert_array_equal(ffn.fused_ffn(*args).numpy(),
                                  ffn.ffn_reference(*args).numpy())
    assert ffn.fused_ffn.launches == before  # no kernel launched on the CPU


def test_bf16_rounds_hidden_before_fc2():
    """The GELU output is rounded to the input dtype before fc2, as in the
    Pallas kernel: in bf16 the result differs from an all-f32 pipeline."""
    ta = _torch(_inputs(32, 16, seed=3))
    bf = {k: v.to(torch.bfloat16) for k, v in ta.items()}
    got = ffn.ffn_reference(bf["t"], bf["residual"], bf["w1"], bf["b1"],
                            bf["w2"], bf["b2"], bf["ls"])
    assert got.dtype == torch.bfloat16
    h = ffn._gelu_erf(bf["t"].float() @ bf["w1"].float() + bf["b1"].float())
    h = h.to(torch.bfloat16).float()
    o = (h @ bf["w2"].float() + bf["b2"].float()) * bf["ls"].float()
    want = (bf["residual"].float() + o).to(torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


def test_no_fallback_on_other_devices():
    t = torch.empty((8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ffn.fused_ffn(t, t, torch.empty((16, 64), device="meta"),
                      torch.empty(64, device="meta"),
                      torch.empty((64, 16), device="meta"),
                      torch.empty(16, device="meta"))


def _good_args(dtype=torch.bfloat16, n=8, c=96):
    ta = _torch(_inputs(n, c, seed=4))
    return {k: v.to(dtype) for k, v in ta.items()}


def _misaligned(x):
    """The same values at a storage offset of one element (2 bytes)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


BAD_ARGS = {  # name -> (edit of the good arguments, expected message)
    "dtype": (lambda a: {**a, "t": a["t"].half(), "residual": a["residual"].half()},
              "dtype"),
    "shape": (lambda a: {**a, "w2": a["w2"][:-64].clone()}, "shape"),
    "mixed": (lambda a: {**a, "b2": a["b2"].float()}, "expected"),
    "strided": (lambda a: {**a, "residual": a["residual"].t().contiguous().t()},
                "contiguous"),
    "misaligned": (lambda a: {**a, "t": _misaligned(a["t"])}, "aligned"),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_kernel_argument_checks_raise(case):
    """What the CUDA kernel does not take is refused before any launch (the
    checks are device-independent, so they run here on CPU tensors)."""
    order = ("t", "residual", "w1", "b1", "w2", "b2", "ls")
    good = _good_args()
    ffn._check_cuda_args(*(good[k] for k in order))
    edit, match = BAD_ARGS[case]
    bad = edit(good)
    with pytest.raises((ValueError, TypeError), match=match):
        ffn._check_cuda_args(*(bad[k] for k in order))


def test_bf16_kernel_refuses_unsupported_widths():
    order = ("t", "residual", "w1", "b1", "w2", "b2", "ls")
    a = _good_args(c=32)  # C % 96 != 0: no bf16 tile width fits
    with pytest.raises(ValueError, match="C % 96"):
        ffn._check_cuda_args(*(a[k] for k in order))
    a = _good_args(torch.float32, c=32)  # the f32 kernel takes any C
    ffn._check_cuda_args(*(a[k] for k in order))


def test_bf16_kernel_refuses_a_hidden_width_other_than_4c():
    order = ("t", "residual", "w1", "b1", "w2", "b2", "ls")
    a = _good_args()
    a["w1"], a["b1"], a["w2"] = a["w1"][:, :192], a["b1"][:192], a["w2"][:192]
    with pytest.raises(ValueError, match="Ch == 4C"):
        ffn._check_cuda_args(*(a[k] for k in order))



def test_workspace_is_kept_per_stream():
    """Two streams never share the two-pass route's workspace; calls on one
    stream reuse it, grown on demand (device-independent bookkeeping, run
    here with CPU buffers)."""
    dev = torch.device("cpu")
    try:
        a = ffn._workspace(dev, 101, 256)
        assert ffn._workspace(dev, 101, 128) == a
        assert ffn._workspace(dev, 102, 256) != a
        ffn._workspace(dev, 101, 4096)
        assert ffn._WORKSPACES[(dev, 101)].numel() == 4096
    finally:
        ffn._WORKSPACES.pop((dev, 101), None)
        ffn._WORKSPACES.pop((dev, 102), None)
