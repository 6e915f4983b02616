"""The port's FastViTHD encoder against the JAX package's, in f32, on a tiny
config, with weights carried across by utils/convert.py.

The JAX side runs with ffn_backend="pallas" (the Pallas kernel in interpret
mode on the CPU), the port with K1's plain version, so both compute the same
ConvFFN formula. Tolerance rtol=1e-4, atol=1e-5: the JAX package's own bar
between its two encoder paths; the rest is f32 summation order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import fastvit as jfastvit
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import fastvit
from fastvlm_tpu_torch.ops import conv
from fastvlm_tpu_torch.utils.convert import fastvit_from_jax

RTOL, ATOL = 1e-4, 1e-5
TINY = dict(layers=(1, 1, 1, 1, 1), embed_dims=(8, 16, 32, 64, 128),
            image_size=128, attn_head_dim=16)


def _jax_params(seed=0, layers=(1, 1, 1, 1, 1)):
    """Random weights of the JAX init's shapes, drawn with numpy (the JAX
    init run op by op costs ~8 s here): N(0, 0.02), norm scales near 1, and
    non-trivial layer scales so the fold and the ls path are exercised."""
    cfg = jcfg.FastViTConfig(**{**TINY, "layers": layers}, ffn_backend="pallas")
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ls", "ls1", "ls2"):
            return np.broadcast_to(np.linspace(0.5, 2.0, leaf.shape[-1]),
                                   leaf.shape).astype(np.float32)
        base = 1.0 if name == "norm_scale" else 0.0
        return (base + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jfastvit.init(k, cfg),
                            jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return cfg, jax.tree.map(jnp.asarray, params)


def _image(b=2, seed=1):
    return np.random.RandomState(seed).rand(b, 128, 128, 3).astype(np.float32)


@pytest.mark.parametrize("folded", [False, True])
def test_encoder_matches_jax(folded):
    jc, jp = _jax_params(layers=(1, 2, 1, 1, 1))
    tc = tcfg.FastViTConfig(**{**TINY, "layers": (1, 2, 1, 1, 1)})
    if folded:
        jp = jfastvit.fold_layer_scale(jp)
    tp = fastvit_from_jax(jax.tree.map(np.asarray, jp), tc)
    x = _image()
    want = np.asarray(jfastvit.apply(jp, jnp.asarray(x), jc))
    got = fastvit.apply(tp, torch.from_numpy(x), tc)
    assert got.shape == want.shape == (2, tc.num_tokens, tc.out_channels)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_fold_layer_scale_matches_jax_fold():
    """The port's fold on converted unfolded weights equals the JAX fold
    converted, and drops every ls leaf."""
    _, jp = _jax_params(seed=2)
    tc = tcfg.FastViTConfig(**TINY)
    folded = fastvit.fold_layer_scale(
        fastvit_from_jax(jax.tree.map(np.asarray, jp), tc))
    want = fastvit_from_jax(
        jax.tree.map(np.asarray, jfastvit.fold_layer_scale(jp)), tc)
    for st_got, st_want in zip(folded["stages"], want["stages"]):
        for bg, bw in zip(st_got["blocks"], st_want["blocks"]):
            assert not {"ls", "ls1", "ls2"} & set(bg)
            for key in ("ffn", "proj"):
                if key == "ffn":
                    pg, pw = bg["ffn"]["fc2"], bw["ffn"]["fc2"]
                elif "proj" in bg:
                    pg, pw = bg["proj"], bw["proj"]
                else:
                    continue
                for leaf in ("w", "b"):
                    np.testing.assert_allclose(pg[leaf].numpy(),
                                               pw[leaf].numpy(), rtol=1e-6)


def test_features_grid_is_row_major_tokens():
    _, jp = _jax_params()
    tc = tcfg.FastViTConfig(**TINY)
    tp = fastvit_from_jax(jax.tree.map(np.asarray, jp), tc)
    x = torch.from_numpy(_image(b=1))
    tokens = fastvit.apply(tp, x, tc)
    grid = fastvit.features_grid(tp, x, tc)
    g = tc.grid_size
    np.testing.assert_array_equal(tokens.numpy().reshape(1, g, g, -1),
                                  grid.numpy())


@pytest.mark.parametrize("k,stride,groups", [
    (3, 2, 1),   # stem conv on an even input: explicit k//2 padding
    (7, 2, 8),   # depthwise downsampler (RepLK)
    (7, 1, 8),   # ConvFFN depthwise
    (1, 1, 1),   # pointwise
])
def test_conv2d_matches_jax(k, stride, groups):
    from fastvlm_tpu.ops.conv import conv2d as jconv2d

    rng = np.random.RandomState(k + stride)
    cin, cout = 8, 8
    x = rng.randn(2, 10, 10, cin).astype(np.float32)
    w = rng.randn(k, k, cin // groups, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    want = np.asarray(jconv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              stride=stride, groups=groups))
    got = conv.conv2d(torch.from_numpy(x),
                      torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      torch.from_numpy(b), stride=stride, groups=groups)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_dtype_dispatch_matches_jax(dtype):
    """erf in f32, tanh in bf16, as the JAX package's conv.gelu."""
    from fastvlm_tpu.ops.conv import gelu as jgelu

    x = np.linspace(-4, 4, 101).astype(np.float32)
    want = np.asarray(jgelu(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = conv.gelu(torch.from_numpy(x).to(tcfg.resolve_dtype(dtype))).float()
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_config_fields_match_jax():
    """Same field names and defaults, less the three TPU-era knobs."""
    dropped = {"ffn_backend", "attn_backend", "scan_unroll"}
    for jc, tc in ((jcfg.FastViTConfig(), tcfg.FastViTConfig()),
                   (jcfg.ProjectorConfig(), tcfg.ProjectorConfig()),
                   (jcfg.qwen2_1_5b(), tcfg.qwen2_1_5b()),
                   (jcfg.qwen2_7b(), tcfg.qwen2_7b()),
                   (jcfg.mpt_7b(), tcfg.mpt_7b())):
        want = {k: v for k, v in dataclasses.asdict(jc).items()
                if k not in dropped}
        assert dataclasses.asdict(tc) == want


def test_hf_config_ingestion_matches_jax():
    d = {"hidden_size": 1536, "num_hidden_layers": 28,
         "num_attention_heads": 12, "num_key_value_heads": 2,
         "intermediate_size": 8960, "vocab_size": 151936,
         "mm_vision_tower": "mobileclip_l_1536", "mm_hidden_size": 3072,
         "image_aspect_ratio": "pad", "tie_word_embeddings": True}
    jc, tc = jcfg.vlm_config_from_hf_dict(d), tcfg.vlm_config_from_hf_dict(d)
    assert tc.vision.image_size == jc.vision.image_size == 1536
    assert tc.decoder.head_dim == jc.decoder.head_dim == 128
    assert tc.projector == tcfg.ProjectorConfig(**dataclasses.asdict(jc.projector))
    assert tc.context_len == jc.context_len
