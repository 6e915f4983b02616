"""LoRA and QLoRA in the port (fastvlm_tpu_torch/train/lora.py and the
adapter path of models/qwen2._project) against the JAX package.

The adapters are drawn by JAX (``lora.add_lora``) and carried across the
converter, so both packages hold the same tree; ``lora_b`` is drawn
non-zero where a test needs the adapter to act. Tolerances: f32 forwards
rtol / atol 1e-5; bf16 forwards within 4 bf16 ulps of the largest logit
(the same bf16 decoder without adapters reads 2.4 ulps apart between the
two packages on this input: bf16 roundings fall differently in XLA's
fusions); optimizer steps from the same gradients 1e-6 for f32 leaves and,
for bf16 ones (QLoRA's bias-free linears take bf16 adapters, as in JAX),
1 bf16 ulp of the leaf's largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.ops.quant import quantize_decoder as jquantize_decoder
from fastvlm_tpu.train import lora as jlora
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import qwen2 as tqwen2
from fastvlm_tpu_torch.ops.quant import quantize_decoder
from fastvlm_tpu_torch.train import lora as tlora
from fastvlm_tpu_torch.train import step as tstep
from fastvlm_tpu_torch.utils.convert import qwen2_from_jax

from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=8, intermediate_size=64,
          tie_word_embeddings=True)
JCFG, TCFG = jcfg.Qwen2Config(**KW), tcfg.Qwen2Config(**KW)
IDS = np.array([[3, 9, 22, 7, 41, 5]], np.int32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_tree(bits=None, live=True, seed=0, scale=8.0):
    """The JAX decoder with adapters (JAX's draws), optionally on a
    quantized base, with ``lora_b`` drawn non-zero when ``live``; the
    init's matrices are scaled by ``scale`` (at its 0.02 std the tiny
    decoder's logits barely depend on the input)."""
    params = jqwen2.init(jax.random.PRNGKey(seed), JCFG)
    params = jax.tree.map(lambda x: x * scale if x.ndim >= 2 else x, params)
    if bits:
        params = jquantize_decoder(params, bits=bits, skip=("lm_head",))
    params = jlora.add_lora(params, jax.random.PRNGKey(1), r=4, cfg=JCFG)
    if live:
        rng = np.random.RandomState(seed + 7)
        for p in params["layers"].values():
            if isinstance(p, dict) and "lora_b" in p:
                p["lora_b"] = jnp.asarray(
                    0.5 * rng.randn(*p["lora_b"].shape)).astype(
                        p["lora_b"].dtype)
    return params


def _jax_logits(params, cfg=JCFG):
    h, _ = jqwen2.forward(params, cfg, jqwen2.embed(params, jnp.asarray(IDS)),
                          jnp.arange(IDS.shape[1])[None])
    return np.asarray(jqwen2.logits_from_hidden(params, h, cfg), np.float32)


def _port_logits(params, cfg=TCFG):
    ids = torch.from_numpy(IDS)
    with torch.no_grad():
        h, _ = tqwen2.forward(params, cfg, tqwen2.embed(params, ids),
                              torch.arange(IDS.shape[1])[None])
        return tqwen2.logits_from_hidden(params, h, cfg).float().numpy()


# ---------------------------------------------------------------------------
# the repair: a dense linear with adapters adds their delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [None, 8])
def test_lora_forward_equals_jax_f32(bits):
    jp = _jax_tree(bits)
    want = _jax_logits(jp)
    got = _port_logits(qwen2_from_jax(_np(jp), JCFG.num_layers))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the adapters act: the base alone computes other logits
    base = _jax_logits(jlora.merge(_jax_tree(bits, live=False)))
    assert np.abs(want - base).max() > 1e-2


@pytest.mark.parametrize("bits", [None, 8])
def test_lora_forward_equals_jax_bf16(bits):
    """The decoder in bf16 (param and compute dtype), f32 adapters on the
    biased q/k/v of a quantized base: JAX rounds them to the activations'
    dtype before its products, and so does the port."""
    cfg_j = jcfg.Qwen2Config(**KW, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    cfg_t = tcfg.Qwen2Config(**KW, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    jp = _jax_tree(bits)

    def to_bf16(path, x):
        name = path[-1].key
        if not jnp.issubdtype(x.dtype, jnp.floating) or name in (
                "scale", "lora_scale") or (bits and name.startswith("lora")):
            return x  # quantized scales, adapter scales and QLoRA adapters
        return x.astype(jnp.bfloat16)

    jp = jax.tree_util.tree_map_with_path(to_bf16, jp)
    want = _jax_logits(jp, cfg_j)
    got = _port_logits(qwen2_from_jax(_np(jp), KW["num_layers"]), cfg_t)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= 4 * ulp


def test_add_lora_is_the_identity_at_init():
    params = qwen2_from_jax(_np(jqwen2.init(jax.random.PRNGKey(0), JCFG)),
                            JCFG.num_layers)
    gen = torch.Generator()
    gen.manual_seed(0)
    lp = tlora.add_lora(params, gen, r=4)
    np.testing.assert_allclose(_port_logits(lp), _port_logits(params),
                               rtol=1e-6, atol=1e-6)
    layer = lp["layers"][0]
    assert set(layer["q"]) == {"w", "b", "lora_a", "lora_b", "lora_scale"}
    assert layer["q"]["lora_a"].shape == (KW["hidden_size"], 4)
    assert float(layer["q"]["lora_scale"]) == 16.0 / 4
    assert not params["layers"][0]["q"].get("lora_a")  # input untouched


def test_fused_tree_takes_adapters_on_o_and_down_only():
    params = qwen2_from_jax(_np(jqwen2.init(jax.random.PRNGKey(0), JCFG)),
                            JCFG.num_layers)
    fused = tqwen2.fuse_decoder_params(params, TCFG)
    lp = tlora.add_lora(fused, torch.Generator(), r=4)
    with_adapters = {n for n, p in lp["layers"][0].items()
                     if isinstance(p, dict) and "lora_a" in p}
    assert with_adapters == {"o", "down"}


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_merge_equals_jax(bits):
    jp = _jax_tree(bits)
    want = qwen2_from_jax(_np(jlora.merge(jp)), JCFG.num_layers)
    got = tlora.merge(qwen2_from_jax(_np(jp), JCFG.num_layers))
    for (path, g), (_, w) in zip(tstep.named_leaves(got),
                                 tstep.named_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if g.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=path)
        else:
            assert torch.equal(g, w), path
    assert not any("lora" in p for p, _ in tstep.named_leaves(got))
    if bits is None:  # a requantized base computes other logits, as in JAX
        np.testing.assert_allclose(_port_logits(got), _jax_logits(jp),
                                   rtol=2e-5, atol=2e-5)


def test_split_lora_state_equals_jax():
    jp = _jax_tree(8)
    want = _np(jlora.split_lora_state(jp))
    got = tlora.split_lora_state(qwen2_from_jax(_np(jp), JCFG.num_layers))
    assert len(got["layers"]) == JCFG.num_layers
    for i, layer in enumerate(got["layers"]):
        assert sorted(layer) == sorted(want)
        for name, leaves in layer.items():
            assert sorted(leaves) == ["lora_a", "lora_b", "lora_scale"]
            for k, v in leaves.items():
                np.testing.assert_array_equal(
                    v.float().numpy(),
                    np.asarray(want[name][k][i], np.float32))


# ---------------------------------------------------------------------------
# LoRA / QLoRA optimizer steps from the same gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_lora_steps_change_only_adapters_and_equal_jax(bits):
    """Three steps from the same gradients, clipped by the adapters' joint
    norm (it fires at 0.5). A QLoRA group mixes f32 and bf16 adapters, and
    optax's norm over them rounds its bf16 partial sums where XLA's fusion
    puts them (2**-9 relative): its steps are held with the clip off."""
    import optax

    clip = 1e6 if bits else 0.5
    jp = _jax_tree(bits)
    wrapped = {"decoder": jp}
    jtx = jlora.make_lora_optimizer(wrapped, lr=1e-2, weight_decay=0.01,
                                    grad_clip=clip)
    jstate = jtx.init(wrapped)
    tparams = {"decoder": qwen2_from_jax(_np(jp), JCFG.num_layers)}
    before = {p: x.clone() for p, x in tstep.named_leaves(tparams)}
    ttx = tlora.make_lora_optimizer(tparams, lr=1e-2, weight_decay=0.01,
                                    grad_clip=clip)
    state = tstep.make_train_state(tparams, ttx)
    trained = {p for p, x in tstep.named_leaves(state.params)
               if x.requires_grad}
    assert trained and all(tlora.is_lora_path(p) for p in trained)
    rng = np.random.RandomState(3)
    jparams = wrapped
    for _ in range(3):
        g = jax.tree.map(lambda x: (rng.randn(*x.shape)).astype(x.dtype)
                         if jnp.issubdtype(x.dtype, jnp.floating)
                         else np.zeros(x.shape, x.dtype), _np(jparams))
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = dict(tstep.named_leaves(
            {"decoder": qwen2_from_jax(g["decoder"], JCFG.num_layers)}))
        for path, x in tstep.named_leaves(state.params):
            if x.requires_grad:
                x.grad = tg[path].clone()
        ttx.update(state.params, state.opt_state)
    want = dict(tstep.named_leaves(
        {"decoder": qwen2_from_jax(_np(jparams["decoder"]),
                                   JCFG.num_layers)}))
    moved = 0
    for path, x in tstep.named_leaves(state.params):
        x, w = x.detach(), want[path]
        if path not in trained:
            assert torch.equal(x, before[path]), path
            continue
        moved += not torch.equal(x, before[path])
        if x.dtype == torch.bfloat16:
            ulp = 2.0 ** (np.floor(np.log2(float(w.float().abs().max()))) - 7)
            assert float((x.float() - w.float()).abs().max()) <= ulp, path
        else:
            np.testing.assert_allclose(x.numpy(), w.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=path)
    assert moved == len(trained)


def _loss(params, cfg, ids, tgt):
    h, _ = tqwen2.forward(params, cfg, tqwen2.embed(params, ids),
                          torch.arange(ids.shape[1])[None])
    logits = tqwen2.logits_from_hidden(params, h, cfg)
    return tstep.cross_entropy(logits, tgt)


def test_qlora_gradients_track_float_base_and_equal_jax():
    """The adapters' gradients on an int8 base track the float base's
    (within 15% of the largest, as tests/test_lora.py:125 holds JAX; the
    init's weights, adapters as add_lora leaves them) and equal JAX's on the
    same int8 tree."""
    ids = torch.from_numpy(IDS)
    tgt = torch.from_numpy(np.roll(IDS, -1, axis=1).astype(np.int64))
    jq = _jax_tree(8, live=False, seed=2, scale=1.0)
    float_base = _jax_tree(None, live=False, seed=2, scale=1.0)
    grads = {}
    for name, jp in (("q", jq), ("f", float_base)):
        tp = qwen2_from_jax(_np(jp), JCFG.num_layers)
        leaves = {p: x.requires_grad_() for p, x in tstep.named_leaves(tp)
                  if tlora.is_lora_path(p) and x.is_floating_point()}
        _loss(tp, TCFG, ids, tgt).backward()
        grads[name] = {p: x.grad for p, x in leaves.items()}
    for p, gq in grads["q"].items():
        if not p.endswith("lora_b"):  # lora_a's gradient is 0 while B = 0
            continue
        gf = grads["f"][p]
        denom = float(gf.float().abs().max()) + 1e-8
        assert float((gq.float() - gf.float()).abs().max()) / denom < 0.15, p

    def jloss(p):
        h, _ = jqwen2.forward(p, JCFG, jqwen2.embed(p, jnp.asarray(IDS)),
                              jnp.arange(IDS.shape[1])[None])
        logits = jqwen2.logits_from_hidden(p, h, JCFG)
        from fastvlm_tpu.train.step import cross_entropy

        return cross_entropy(logits, jnp.asarray(tgt.numpy()))

    jg = jax.grad(jloss, allow_int=True)(jq)
    want = {}
    for name, p in jg["layers"].items():
        if isinstance(p, dict) and "lora_a" in p:
            for k in ("lora_a", "lora_b"):
                for i in range(JCFG.num_layers):
                    want[f"layers/{i}/{name}/{k}"] = np.asarray(p[k][i],
                                                                np.float32)
    assert sorted(want) == sorted(p for p in grads["q"]
                                  if not p.endswith("lora_scale"))
    for path, w in want.items():
        g = grads["q"][path].float().numpy()
        tol = 1e-5 if grads["q"][path].dtype == torch.float32 else 1e-2
        np.testing.assert_allclose(g, w, rtol=tol,
                                   atol=tol * np.abs(w).max(), err_msg=path)


def test_quantized_add_lora_needs_cfg_and_takes_bias_dtype():
    base = qwen2_from_jax(_np(jqwen2.init(jax.random.PRNGKey(0), JCFG)),
                          JCFG.num_layers)
    q = quantize_decoder(base, bits=4, skip=("lm_head",))
    with pytest.raises(ValueError, match="needs cfg"):
        tlora.add_lora(q, torch.Generator(), r=4)
    lp = tlora.add_lora(q, torch.Generator(), r=4, cfg=TCFG)["layers"][0]
    assert lp["q"]["lora_a"].dtype == torch.float32   # q has an f32 bias
    assert lp["o"]["lora_a"].dtype == torch.bfloat16  # o has none
    assert lp["down"]["lora_a"].shape == (KW["intermediate_size"], 4)
