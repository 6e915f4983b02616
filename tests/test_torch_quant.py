"""The port's quantization (fastvlm_tpu_torch/ops/quant.py, the quantized
branches of models/qwen2.py, quantized leaves through utils/convert.py)
against the JAX package's fastvlm_tpu/ops/quant.py, mirroring
tests/test_quant_export.py:

* ``_quantize_array`` at 8 and 4 bits (odd cin too): ``w_q`` and ``scale``
  bitwise; ``_unpack_int4`` over all 256 byte values bitwise;
* ``quantized_matmul`` weight-only (8 / 4 bits, with and without bias)
  within 1e-5; W8A8: the int8 activations and the int32 accumulator
  bitwise, the output within 1e-5; the plain version equals the CPU path;
* ``quantize_decoder`` trees, fused and unfused, equal after convert;
* a quantized decoder's logits within 1e-4 of JAX's and its greedy ids
  equal, for int8, int4 and W8A8, and a quantized engine's generated ids.

f32 on the CPU; the tolerances cover f32 summation order (the products
accumulate over at most 128 terms here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.ops import quant as jquant
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import qwen2 as tqwen2
from fastvlm_tpu_torch.ops import quant as tquant
from fastvlm_tpu_torch.utils.convert import _linear_p, qwen2_from_jax

import torch_tiny

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_equal(got, want):
    """Port tree (dicts, lists of layers) == converted JAX tree, bitwise,
    with the same dtypes."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(10, 6), (64, 32), (7, 5), (3, 9, 4)])
def test_quantize_array_bitwise(bits, shape):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w[..., 1] = 0.0  # an all-zero output channel takes scale 1
    jw, js = jquant._quantize_array(jnp.asarray(w), bits)
    tw, ts = tquant._quantize_array(torch.from_numpy(w), bits)
    assert tw.dtype == torch.int8 and tuple(tw.shape) == jw.shape
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("cin", [256, 255])
def test_unpack_int4_all_bytes_bitwise(cin):
    """Every byte value in both nibbles: torch's int8 shifts sign-extend as
    JAX's do (odd cin drops the padding row)."""
    packed = np.arange(256, dtype=np.uint8).view(np.int8).reshape(128, 2)
    want = np.asarray(jquant._unpack_int4(jnp.asarray(packed), cin))
    got = tquant._unpack_int4(torch.from_numpy(packed), cin).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == -8 and got.max() == 7


def _linears(bits, act_quant, bias):
    rng = np.random.RandomState(bits + 2 * act_quant + 4 * bias)
    w = rng.randn(64, 32).astype(np.float32) * 0.1
    p = {"w": w}
    if bias:
        p["b"] = rng.randn(32).astype(np.float32) * 0.1
    jp = jquant.quantize_linear(jax.tree.map(jnp.asarray, p), bits,
                                act_quant=act_quant)
    tp = tquant.quantize_linear({k: torch.from_numpy(v) for k, v in p.items()},
                                bits, act_quant=act_quant)
    return rng.randn(2, 5, 64).astype(np.float32), jp, tp


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bias", [False, True])
def test_weight_only_matmul_matches_jax(bits, bias):
    x, jp, tp = _linears(bits, False, bias)
    _assert_trees_equal(tp, _linear_p(_np_tree(jp)))
    want = np.asarray(jquant.quantized_matmul(jnp.asarray(x), jp))
    got = tquant.quantized_matmul(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = tquant.quantized_matmul_reference(torch.from_numpy(x), tp)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("bias", [False, True])
def test_w8a8_activations_and_accumulator_bitwise(bias):
    x, jp, tp = _linears(8, True, bias)
    assert tp["a8"].shape == (1,) and tp["a8"].dtype == torch.int8
    # JAX's W8A8 steps, written out as quant.quantized_matmul runs them
    xf = jnp.asarray(x).reshape(-1, 64)
    js = jnp.abs(xf).max(axis=-1, keepdims=True) / 127.0
    js = jnp.where(js == 0, 1.0, js)
    jxq = jnp.clip(jnp.round(xf / js), -127, 127).astype(jnp.int8)
    jacc = jnp.einsum("md,df->mf", jxq, jp["w_q"],
                      preferred_element_type=jnp.int32)
    txq, ts = tquant.quantize_activations(torch.from_numpy(x).reshape(-1, 64))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    acc = tquant.int8_matmul(txq, tp["w_q"])
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert torch.equal(acc, tquant.int8_matmul_reference(txq, tp["w_q"]))
    want = np.asarray(jquant.quantized_matmul(jnp.asarray(x), jp))
    got = tquant.quantized_matmul(torch.from_numpy(x), tp)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, tquant.quantized_matmul_reference(
        torch.from_numpy(x), tp))


def test_int8_weight_is_k_major_with_jax_values():
    """The port keeps an 8-bit w_q K-major (the fast torch._int_mm operand
    on the card): the JAX leaf's shape and values, other strides."""
    _, jp, tp = _linears(8, False, False)
    assert tp["w_q"].stride() == (1, 64)
    np.testing.assert_array_equal(tp["w_q"].numpy(), np.asarray(jp["w_q"]))


def _decoder_cfgs(tie=False):
    kw = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
              num_kv_heads=2, head_dim=16, intermediate_size=128,
              tie_word_embeddings=tie)
    return jcfg.Qwen2Config(**kw), tcfg.Qwen2Config(**kw)


@pytest.fixture(scope="module")
def decoder():
    jc, tc = _decoder_cfgs()
    rng = np.random.RandomState(7)

    def draw(path, leaf):
        if path[-1].key in ("ln1", "ln2", "final_norm"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.2 * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jqwen2.init(k, jc),
                            jax.random.PRNGKey(0))
    return jc, tc, jax.tree_util.tree_map_with_path(draw, shapes)


QUANT_CASES = [(8, False), (4, False), (8, True)]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("bits,act_quant", QUANT_CASES)
def test_quantize_decoder_tree_matches_jax(decoder, bits, act_quant, fused):
    """JAX: (fuse, then) quantize_decoder on the stacked tree; the port:
    quantize_decoder on the converted tree (then fuse), and fuse-then-
    quantize too: all bitwise equal after convert."""
    jc, tc, params = decoder
    jp = jax.tree.map(jnp.asarray, params)
    if fused:
        jp = jqwen2.fuse_decoder_params(jp, jc)
    jq = qwen2_from_jax(_np_tree(jquant.quantize_decoder(
        jp, bits, act_quant=act_quant)), tc.num_layers)
    tp = qwen2_from_jax(params, tc.num_layers)
    tq = tquant.quantize_decoder(tp, bits, act_quant=act_quant)
    if fused:
        _assert_trees_equal(
            tquant.quantize_decoder(tqwen2.fuse_decoder_params(tp, tc), bits,
                                    act_quant=act_quant), jq)
        tq = tqwen2.fuse_decoder_params(tq, tc)
    _assert_trees_equal(tq, jq)


@pytest.mark.parametrize("bits,act_quant", QUANT_CASES)
def test_quantized_decoder_logits_and_greedy_ids_match_jax(decoder, bits,
                                                           act_quant):
    """Full-sequence logits of the quantized decoder (untied, so the LM head
    is quantized too) within 1e-4 of JAX's, and 6 greedy steps through a
    dense cache giving JAX's ids."""
    jc, tc, params = decoder
    jq = jquant.quantize_decoder(jax.tree.map(jnp.asarray, params), bits,
                                 act_quant=act_quant)
    tq = qwen2_from_jax(_np_tree(jq), tc.num_layers)
    ids = np.array([[5, 9, 22, 77, 3, 64]], np.int32)
    pos = np.arange(6)[None]
    jh, _ = jqwen2.forward(jq, jc, jqwen2.embed(jq, jnp.asarray(ids)),
                           jnp.asarray(pos))
    want = np.asarray(jqwen2.logits_from_hidden(jq, jh, jc))
    th, _ = tqwen2.forward(tq, tc, tqwen2.embed(tq, torch.from_numpy(ids)),
                           torch.from_numpy(pos))
    got = tqwen2.logits_from_hidden(tq, th, tc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("bits,act_quant", QUANT_CASES)
def test_quantized_engine_generates_jax_ids(bits, act_quant):
    """The tiny VLM with a quantized decoder: the port's Engine gives the
    JAX engine's greedy ids."""
    params = torch_tiny.draw_weights(1)
    params["decoder"] = _np_tree(jquant.quantize_decoder(
        jax.tree.map(jnp.asarray, params["decoder"]), bits,
        act_quant=act_quant))
    je, te = torch_tiny.engines(params)
    for seed, prompt in ((0, "Describe the image."), (1, "What is it?")):
        img = torch_tiny.image(seed)
        want, _ = je.chat(prompt, img, max_new_tokens=8)
        got, _ = te.chat(prompt, img, max_new_tokens=8)
        assert got == want and got


def test_qlora_on_quantized_linear_matches_jax():
    """A LoRA adapter riding a quantized base: the quantized product rounds
    once, the adapter's f32 delta is added, then rounds again (JAX
    ``qwen2._project``)."""
    rng = np.random.RandomState(11)
    p = {"w": rng.randn(64, 32).astype(np.float32) * 0.1,
         "b": rng.randn(32).astype(np.float32) * 0.1,
         "lora_a": rng.randn(64, 4).astype(np.float32) * 0.1,
         "lora_b": rng.randn(4, 32).astype(np.float32) * 0.1,
         "lora_scale": np.float32(0.5)}
    x = rng.randn(2, 3, 64).astype(np.float32)
    jp = jquant.quantize_linear(jax.tree.map(jnp.asarray, p), 8)
    tp = tquant.quantize_linear(
        {k: torch.as_tensor(v) for k, v in p.items()}, 8)
    assert "lora_a" in tp
    want = np.asarray(jqwen2._project(jnp.asarray(x), jp))
    got = tqwen2._project(torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, **TOL)
