"""The port's image preprocessing (fastvlm_tpu_torch/ops/image_ops.py)
against the JAX package's (fastvlm_tpu/ops/image_ops.py), mirroring
tests/test_image_ops.py: pad-to-square and crop geometry, the resize against
the host PIL path, and the engine's float-[0, 255] rule on non-native sizes.

The resize is bicubic with antialiasing on both sides (Keys' a = -0.5, the
kernel widened when downsampling, weights renormalised at the borders): the
JAX resize and ``F.interpolate(..., antialias=True)`` compute the same
weights in another order, so they agree to float rounding, not bit for bit.
Tolerance: atol 1e-5 on [0, 1] pixels (measured up to ~2e-6), upsampling and
downsampling, non-square, batched and not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu.ops import image_ops as jops
from fastvlm_tpu_torch.ops import image_ops

ATOL = 1e-5


def _smooth(h, w):
    x = np.linspace(0, 255, w)[None, :, None]
    y = np.linspace(0, 255, h)[:, None, None]
    return np.broadcast_to((x + y) / 2, (h, w, 3)).astype(np.uint8)


def test_pad_to_square_geometry():
    x = np.full((100, 200, 3), 200, np.uint8)
    out = image_ops.pad_to_square(torch.from_numpy(x).float()).numpy()
    assert out.shape == (200, 200, 3)
    assert out[0, 100, 0] == 0 and out[199, 100, 0] == 0  # pad rows
    assert out[100, 100, 0] == 200                        # original content
    want = np.asarray(jops.pad_to_square(jnp.asarray(x, jnp.float32)))
    np.testing.assert_array_equal(out, want)
    # odd padding puts the extra row at the bottom / column at the right,
    # batched input pads every image
    x = np.random.RandomState(0).rand(2, 7, 4, 3).astype(np.float32)
    np.testing.assert_array_equal(
        image_ops.pad_to_square(torch.from_numpy(x)).numpy(),
        np.asarray(jops.pad_to_square(jnp.asarray(x))))


def test_center_crop_and_shortest_edge():
    x = _smooth(100, 160).astype(np.float32)
    r = image_ops.resize_shortest_edge(torch.from_numpy(x), 64)
    assert r.shape == (64, 102, 3)  # 160 * 64/100 = 102.4 -> 102
    c = image_ops.center_crop(r, 64)
    assert c.shape == (64, 64, 3)
    jr = jops.resize_shortest_edge(jnp.asarray(x), 64)
    np.testing.assert_allclose(r.numpy() / 255, np.asarray(jr) / 255,
                               atol=ATOL)
    np.testing.assert_allclose(c.numpy() / 255,
                               np.asarray(jops.center_crop(jr, 64)) / 255,
                               atol=ATOL)


@pytest.mark.parametrize("h,w,oh,ow", [
    (37, 53, 16, 24),    # downsample, non-square
    (20, 30, 64, 48),    # upsample
    (15, 15, 40, 7),     # up one way, down the other
    (100, 300, 64, 64),  # strong downsample along the width
])
def test_resize_bicubic_matches_jax(h, w, oh, ow):
    x = np.random.RandomState(h * w).rand(h, w, 3).astype(np.float32)
    got = image_ops.resize_bicubic(torch.from_numpy(x), oh, ow).numpy()
    want = np.asarray(jops.resize_bicubic(jnp.asarray(x), oh, ow))
    assert got.shape == want.shape == (oh, ow, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("mode", ["pad", "none"])
@pytest.mark.parametrize("shape", [(480, 640, 3), (2, 77, 33, 3),
                                   (300, 200, 3)])
def test_preprocess_matches_jax(mode, shape):
    u8 = np.random.RandomState(sum(shape)).randint(0, 256, shape, np.uint8)
    got = image_ops.preprocess(torch.from_numpy(u8), 64, mode).numpy()
    want = np.asarray(jops.preprocess(jnp.asarray(u8), 64, mode=mode))
    assert got.shape == want.shape
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_preprocess_matches_host_path_closely():
    """Device path vs host PIL path: close on smooth images; both produce
    [0, 1] NHWC."""
    from PIL import Image

    from fastvlm_tpu_torch.data.preprocessing import (
        ImageProcessor, expand2square)

    arr = _smooth(150, 250)
    dev = image_ops.preprocess(torch.from_numpy(arr), 64, mode="pad")[0]
    dev = dev.numpy()
    host = ImageProcessor(64).preprocess(
        expand2square(Image.fromarray(arr), (0, 0, 0)))
    assert dev.shape == host.shape == (64, 64, 3)
    assert 0.0 <= dev.min() and dev.max() <= 1.0
    # same geometry: the padded rows are black in both
    assert dev[0].max() < 0.02 and host[0].max() < 0.02
    # interior agrees to the resamplers' difference
    np.testing.assert_allclose(dev[16:48], host[16:48], atol=0.03)


def test_prepare_array_image_float_255_matches_uint8():
    """[0, 255] floats are rescaled as the uint8 path is, at the native
    size and through the resize, and equal the JAX engine's arrays."""
    from fastvlm_tpu.engine import build_engine as jbuild
    from fastvlm_tpu_torch.engine import build_engine

    engine = build_engine(random_tiny=True, device="cpu")
    jengine = jbuild(random_tiny=True)
    s = engine.cfg.vision.image_size
    assert s == jengine.cfg.vision.image_size
    rng = np.random.RandomState(0)
    u8 = rng.randint(0, 256, (s, s, 3), np.uint8)
    a = engine.prepare_array_image(u8).numpy()
    b = engine.prepare_array_image(u8.astype(np.float32)).numpy()
    np.testing.assert_allclose(a, b, atol=1e-2)
    # non-native sizes go through pad + resize on the device, same rule
    u8s = rng.randint(0, 256, (s // 2, s, 3), np.uint8)
    c = engine.prepare_array_image(u8s).numpy()
    d = engine.prepare_array_image(u8s.astype(np.float32)).numpy()
    assert c.shape == (1, s, s, 3)
    np.testing.assert_allclose(c, d, atol=1e-2)
    for arr, got in ((u8, a), (u8s, c), (u8s.astype(np.float32), d)):
        np.testing.assert_allclose(
            got, np.asarray(jengine.prepare_array_image(arr)), atol=ATOL)
