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
ORDER = ("t", "residual", "w1", "b1", "w2", "b2", "ls")  # fused_ffn's


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


@pytest.mark.parametrize("c", [96, 192, 384, 768, 1536])
def test_reference_matches_pallas_at_fastvithd_widths(c):
    """FastViTHD's five stage widths (Ch = 4C), 64 rows, f32: the widths
    the kernel's f32 tensor-core routes take."""
    a = _inputs(64, c, seed=c)
    want = np.asarray(jax_ffn.fused_ffn(
        *(jnp.asarray(a[k]) for k in ORDER), block_rows=64, interpret=True))
    ta = _torch(a)
    got = ffn.ffn_reference(*(ta[k] for k in ORDER))
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


ROUTE_CASES = [  # (C, Ch, route): csrc/ffn.cu's ffn_route
    (96, 384, "fused"), (192, 768, "fused"),
    (128, 512, "two-pass"), (384, 1536, "two-pass"), (768, 3072, "two-pass"),
    (1536, 6144, "two-pass"),
    (8, 32, "general"), (16, 64, "general"), (48, 192, "general"),
    (64, 256, "general"), (100, 400, "general"), (288, 1152, "general"),
    (96, 256, "general"), (192, 512, "general"), (384, 1024, "general"),
]


@pytest.mark.parametrize("c,ch,route", ROUTE_CASES)
def test_kernel_route_by_shape(c, ch, route):
    """The route the kernel takes, by (C, Ch) alone: FastViTHD's widths
    (Ch = 4C) on the tensor-core routes, every other shape on the general
    f32 route (which bf16 refuses). chip_smoke.py holds the library's
    fvlm_ffn_route to this mirror on the card."""
    assert ffn.kernel_route(c, ch) == route
    assert route in ffn.ROUTES


def test_fastvithd_widths_take_tensor_core_routes():
    from fastvlm_tpu_torch.config import FastViTConfig

    v = FastViTConfig()
    routes = [ffn.kernel_route(c, c * r)
              for c, r in zip(v.embed_dims, v.mlp_ratios)]
    assert routes == ["fused", "fused", "two-pass", "two-pass", "two-pass"]


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


class _StubLib:
    """fvlm_ffn_workspace as csrc/ffn.cu answers it, with the f32 route's
    sizes (the f32 hidden N x 4C x 4 bytes on the two-pass route, none on
    the others) and the bf16 route's (N x 4C x 2 bytes; -1 off its
    widths), pass 2 unsplit."""

    def __init__(self):
        self.asked = []

    def fvlm_ffn_workspace(self, n, c, ch, dtype):
        self.asked.append((n, c, ch, dtype))
        route = ffn.kernel_route(c, ch)
        if dtype == 1 and route == "general":
            return -1
        return n * ch * (4 if dtype == 0 else 2) if route == "two-pass" else 0


def test_f32_workspace_is_kept_per_stream():
    """The f32 two-pass route's workspace (the f32 hidden) is sized by the
    library, kept per (device, stream), grown on demand and shared with the
    bf16 route's on one stream; the fused and general routes take none
    (CPU buffers, the library stubbed)."""
    dev = torch.device("cpu")
    lib = _StubLib()
    try:
        a = ffn._kernel_workspace(lib, 1000, 384, 1536, 0, dev, 201)
        assert ffn._WORKSPACES[(dev, 201)].numel() == 1000 * 1536 * 4
        assert ffn._kernel_workspace(lib, 1000, 384, 1536, 0, dev, 201) == a
        assert lib.asked.count((1000, 384, 1536, 0)) == 1  # cached per shape
        assert ffn._kernel_workspace(lib, 1000, 384, 1536, 0, dev, 202) != a
        # the bf16 hidden of the same rows fits in the f32 one: reused
        assert ffn._kernel_workspace(lib, 1000, 384, 1536, 1, dev, 201) == a
        ffn._kernel_workspace(lib, 4000, 768, 3072, 0, dev, 201)  # grows
        assert ffn._WORKSPACES[(dev, 201)].numel() == 4000 * 3072 * 4
        for c in (96, 192, 48):
            assert ffn._kernel_workspace(lib, 1000, c, 4 * c, 0, dev, 203) is None
        assert (dev, 203) not in ffn._WORKSPACES
        with pytest.raises(ValueError, match="no bf16 kernel"):
            ffn._kernel_workspace(lib, 1000, 48, 192, 1, dev, 203)
    finally:
        for s in (201, 202, 203):
            ffn._WORKSPACES.pop((dev, s), None)
        for key in lib.asked:
            ffn._WS_BYTES.pop(key, None)


# ---------------------------------------------------------------------------
# K1 under autograd: FusedFFNFunction (training with the tower unfrozen)
# ---------------------------------------------------------------------------

def _grads_of(fn, a, g, use_ls):
    leaves = {k: v.clone().requires_grad_() for k, v in a.items()}
    if not use_ls:
        leaves["ls"] = None
    out = fn(*(leaves[k] for k in ORDER))
    out.backward(g)
    return out.detach(), {k: v.grad for k, v in leaves.items()
                          if v is not None}


@pytest.mark.parametrize("use_ls", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradients_equal_autograd_through_reference(dtype, use_ls):
    """On the CPU the Function's forward is ffn_reference and its backward
    differentiates ffn_reference: output and every gradient bitwise equal
    to autograd through ffn_reference itself."""
    a = {k: v.to(dtype) for k, v in _torch(_inputs(40, 16, seed=5)).items()}
    g = torch.from_numpy(np.random.RandomState(6).randn(40, 16)
                         .astype(np.float32)).to(dtype)
    out, got = _grads_of(ffn.FusedFFNFunction.apply, a, g, use_ls)
    ref, want = _grads_of(ffn.ffn_reference, a, g, use_ls)
    assert torch.equal(out, ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_function_gradients_equal_jax_grad_through_xla_ffn():
    """JAX trains through XLA's FFN (ffn_backend="xla"): jax.grad of its
    pointwise half (1x1 convs, erf GELU) equals the Function's gradients in
    f32 to 1e-5."""
    import jax

    from fastvlm_tpu.ops.conv import conv2d, gelu

    b, h, w, c = 2, 4, 5, 16
    a = _inputs(b * h * w, c, seed=7)
    g = np.random.RandomState(8).randn(b * h * w, c).astype(np.float32)

    def xla_ffn(t, res, w1, b1, w2, b2, ls):
        t = t.reshape(b, h, w, c)
        y = gelu(conv2d(t, w1.reshape(1, 1, c, -1), b1, padding=0))
        y = conv2d(y, w2.reshape(1, 1, -1, c), b2, padding=0)
        out = res.reshape(b, h, w, c) + ls * y
        return jnp.sum(out.reshape(-1, c) * g)

    want = jax.grad(xla_ffn, argnums=tuple(range(7)))(
        *(jnp.asarray(a[k]) for k in ORDER))
    _, got = _grads_of(ffn.FusedFFNFunction.apply, _torch(a),
                       torch.from_numpy(g), True)
    for k, wk in zip(ORDER, want):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(wk),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_block_apply_routes_through_the_function_under_grad():
    b, h, w, c = 1, 2, 4, 16
    ta = _torch(_inputs(b * h * w, c, seed=9))
    tp = {"fc1": {"w": ta["w1"].requires_grad_(), "b": ta["b1"]},
          "fc2": {"w": ta["w2"], "b": ta["b2"]}}
    t = ta["t"].reshape(b, h, w, c)
    res = ta["residual"].reshape(b, h, w, c)
    out = ffn.ffn_block_apply(t, res, tp, ta["ls"])
    assert "FusedFFNFunction" in type(out.grad_fn.next_functions[0][0]).__name__ \
        or "FusedFFNFunction" in type(out.grad_fn).__name__
    with torch.no_grad():
        plain = ffn.ffn_block_apply(t, res, tp, ta["ls"])
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_kernel_branch_refuses_inputs_that_require_grad():
    """A direct call on a non-CPU tensor that requires grad raises before
    any launch (the ctypes kernel's output would carry no graph); the same
    call without grad reaches the device check. Run on the meta device: the
    guard sits on the kernel branch, ahead of the device dispatch."""
    def meta(*shape, grad=False):
        return torch.empty(shape, device="meta", requires_grad=grad)

    args = (meta(8, 96), meta(8, 96), meta(96, 384), meta(384),
            meta(384, 96), meta(96))
    with pytest.raises(ValueError, match="no kernel"):
        ffn.fused_ffn(*args)
    for i in range(len(args)):
        graded = list(args)
        graded[i] = meta(*args[i].shape, grad=True)
        with pytest.raises(RuntimeError, match="requires grad"):
            ffn.fused_ffn(*graded)
        with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
            ffn.fused_ffn(*graded)
