"""The port's training step (fastvlm_tpu_torch/train/step.py) against the JAX
package's, in f32 on the tiny training config with a live tower:

  * the loss: ``cross_entropy`` (an all-ignored batch gives 0, not nan) and
    ``loss_fn`` on single-image, text-only and anyres batches (rtol 1e-5),
    with ``remat`` on against off;
  * the gradients over the whole tree, tower unfrozen (every leaf within
    1e-5 of the largest |gradient| in the tree: f32 sums that cancel, as a
    depthwise kernel's gradient over every position does, carry their
    summation order's noise at that scale);
  * the optimizer held apart from the gradients: both fed the same
    (converted) gradients for 4 steps, with warmup-cosine, per-group lrs,
    freeze routing, weight decay and a clip that fires in one group but not
    another; params and moments within 1e-6 (relative, and 1e-6 of each
    leaf's largest value absolute)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.data import sft as jsft
from fastvlm_tpu.train import step as jstep
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.train import step as tstep
from fastvlm_tpu_torch.utils.convert import (
    from_jax_params, opt_state_from_jax)

import torch_tiny as tt
from torch_tiny import one_rank_world  # noqa: F401 (fixture)
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)

JC, TC = tt.train_config(jcfg), tt.train_config(tcfg)
UNPAD = "spatial_unpad"
JCA, TCA = tt.train_config(jcfg, UNPAD), tt.train_config(tcfg, UNPAD)


def _batch(seed=0, image=True, b=2, t=48):
    """A collated-shape batch: row 0 with its image span at 3, the other
    rows text-only or imaged; some labels ignored, right padding."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 258, (b, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, :6] = jsft.IGNORE_INDEX
    lens = np.array([t - 5 * i for i in range(b)], np.int32)
    for i, n in enumerate(lens):
        labels[i, n:] = jsft.IGNORE_INDEX
        ids[i, n:] = 0
    batch = {"ids": ids, "labels": labels, "attn_lens": lens,
             "image_starts": np.full((b,), -1, np.int32)}
    if image:
        batch["image_starts"] = np.array([3] + [7] * (b - 1), np.int32)
        batch["images"] = rng.rand(b, 128, 128, 3).astype(np.float32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _weights(merge="flat", seed=0):
    return tt.live_weights(JC if merge == "flat" else JCA, seed)


def _port_params(np_params, cfg):
    """The converted tree with every leaf requiring grad."""
    return tstep.map_leaves(lambda _, x: x.requires_grad_(),
                            from_jax_params(np_params, cfg))


def _jax_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


def test_cross_entropy_equals_jax_and_all_ignored_gives_zero():
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 7, 33)).astype(np.float32)
    labels = rng.randint(0, 33, (2, 7)).astype(np.int32)
    labels[0, :3] = jsft.IGNORE_INDEX
    got = tstep.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    want = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    ignored = np.full_like(labels, jsft.IGNORE_INDEX)
    got = tstep.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(ignored))
    want = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(ignored))
    assert float(got) == float(want) == 0.0


def _anyres_batch(seed=0):
    """Two tall images on the (1, 2) grid through the JAX collate (global
    view + 2 tiles each), with the merge meta."""
    from fastvlm_tpu.data.preprocessing import ByteTokenizer

    rng = np.random.RandomState(seed)
    tok = ByteTokenizer()
    samples = []
    for i in range(2):
        ids, labels = jsft.preprocess_qwen_2(
            [{"from": "human", "value": "<image>\nDescribe."},
             {"from": "gpt", "value": "Tall thing %d." % i}], tok)
        samples.append({"ids": ids, "labels": labels, "has_image": True,
                        "image": rng.rand(3, 128, 128, 3).astype(np.float32),
                        "anyres": ((1, 2), (100, 220))})
    batch = jsft.collate(samples, JCA.num_image_tokens, cfg=JCA)
    return batch, batch.pop("_anyres")


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(cfg, anyres, remat=False):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(p, cfg, b, remat=remat, anyres=anyres)))


@pytest.mark.parametrize("kind", ["single_image", "text_only", "anyres"])
def test_loss_fn_equals_jax(kind):
    anyres = None
    if kind == "anyres":
        batch, anyres = _anyres_batch()
        np_params, jc, tc = _weights(UNPAD), JCA, TCA
    else:
        batch = _batch(image=kind == "single_image")
        np_params, jc, tc = _weights(), JC, TC
    want, _ = _jax_value_and_grad(jc, anyres)(_jax_params(np_params),
                                              _jax_params(batch))
    params = from_jax_params(np_params, tc)
    with torch.no_grad():
        got = tstep.loss_fn(params, tc, _to_torch(batch), remat=False,
                            anyres=anyres)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_remat_on_equals_off():
    batch = _to_torch(_batch())
    out = []
    for remat in (True, False):
        params = _port_params(_weights(), TC)
        loss = tstep.loss_fn(params, TC, batch, remat=remat)
        loss.backward()
        out.append((float(loss.detach()),
                    [p.grad.clone() for _, p in tstep.named_leaves(params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the gradients
# ---------------------------------------------------------------------------


def _assert_grads_equal(got_tree, want_np, cfg):
    want = dict(tstep.named_leaves(from_jax_params(want_np, cfg)))
    got = dict(got_tree)
    assert sorted(got) == sorted(want)
    top = max(float(w.abs().max()) for w in want.values())
    for path, w in want.items():
        g = got[path]
        assert g is not None, path
        err = float((g - w).abs().max())
        assert err <= 1e-5 * top, (path, err, top)


@pytest.mark.parametrize("kind", ["single_image", "anyres"])
def test_gradients_equal_jax_tower_unfrozen(kind):
    anyres = None
    if kind == "anyres":
        batch, anyres = _anyres_batch(1)
        np_params, jc, tc = _weights(UNPAD), JCA, TCA
    else:
        batch = _batch(1)
        np_params, jc, tc = _weights(), JC, TC
    _, jgrads = _jax_value_and_grad(jc, anyres)(_jax_params(np_params),
                                                _jax_params(batch))
    params = _port_params(np_params, tc)
    tstep.loss_fn(params, tc, _to_torch(batch), remat=True,
                  anyres=anyres).backward()
    got = [(p, x.grad) for p, x in tstep.named_leaves(params)]
    _assert_grads_equal(got, jax.tree.map(np.asarray, jgrads), tc)
    vision = [g for p, g in got if p.startswith("vision/")]
    assert all(float(g.abs().max()) > 0 for g in vision)


# ---------------------------------------------------------------------------
# the optimizer, held apart from the gradients
# ---------------------------------------------------------------------------


def _jax_moments(opt_state, params):
    """Full mu / nu numpy trees out of optax's multi_transform state: each
    leaf from the group that trains it, zeros where it is frozen."""
    adams = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]

    def pick(which):
        def leaf(p, *ms):
            for m in ms:
                if not isinstance(m, optax.MaskedNode):
                    return np.asarray(m)
            return np.zeros(p.shape, p.dtype)

        return jax.tree.map(leaf, params, *[getattr(a, which) for a in adams],
                            is_leaf=lambda x: isinstance(x, optax.MaskedNode))

    return adams[0].count, pick("mu"), pick("nu")


def _grads(np_params, rng, scales):
    """Random gradients of the params' shapes, scaled per top-level group."""
    return {k: jax.tree.map(
        lambda p: (scales.get(k, scales["decoder"])
                   * rng.randn(*p.shape)).astype(p.dtype), v)
        for k, v in np_params.items()}


def _assert_close(got, want, what):
    w = want.detach().float()
    g = got.detach().float()
    tol = 1e-6 * (w.abs() + float(w.abs().max()))
    assert bool(((g - w).abs() <= tol).all()), (
        what, float((g - w).abs().max()), float(w.abs().max()))


def _run_optimizers(np_params, jtx, ttx, cfg, scales, steps=4, seed=0):
    rng = np.random.RandomState(seed)
    jparams = _jax_params(np_params)
    jstate = jtx.init(jparams)
    tparams = from_jax_params(np_params, cfg)
    tstate = tstep.make_train_state(tparams, ttx)
    for _ in range(steps):
        g = _grads(np_params, rng, scales)
        updates, jstate = jax.jit(jtx.update)(_jax_params(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = dict(tstep.named_leaves(from_jax_params(g, cfg)))
        for path, p in tstep.named_leaves(tstate.params):
            if p.requires_grad:
                p.grad = tg[path].clone()
        ttx.update(tstate.params, tstate.opt_state)
    return jparams, jstate, tstate


def _assert_state_equal(jparams, jstate, tstate, cfg):
    want = dict(tstep.named_leaves(from_jax_params(
        jax.tree.map(np.asarray, jparams), cfg)))
    for path, p in tstep.named_leaves(tstate.params):
        _assert_close(p, want[path], path)
    count, mu, nu = _jax_moments(jstate, jparams)
    carried = opt_state_from_jax(count, mu, nu, cfg, tstate.opt_state)
    assert int(carried["count"]) == int(tstate.opt_state["count"])
    for which in ("mu", "nu"):
        assert sorted(carried[which]) == sorted(tstate.opt_state[which])
        for path, m in tstate.opt_state[which].items():
            _assert_close(m, carried[which][path], f"{which} {path}")


def test_optimizer_equals_optax_from_the_same_gradients():
    """warmup 2 of 6 steps, decoder / projector / vision at three lrs,
    weight decay, clip 1.0: the decoder's gradients (norm >> 1) are clipped,
    the projector's (norm < 1) are not; image_newline trains with the
    decoder."""
    np_params = dict(_weights(UNPAD))
    kw = dict(weight_decay=0.01, warmup_steps=2, total_steps=6,
              projector_lr=3e-3, vision_lr=5e-4, freeze_vision=False,
              grad_clip=1.0)
    jtx = jstep.make_optimizer(1e-3, **kw)
    ttx = tstep.make_optimizer(1e-3, **kw)
    scales = {"decoder": 0.1, "projector": 1e-4, "vision": 0.01,
              "image_newline": 0.1}
    jparams, jstate, tstate = _run_optimizers(np_params, jtx, ttx, TCA,
                                              scales)
    _assert_state_equal(jparams, jstate, tstate, TCA)
    # the warmup's first lr is 0: a one-step run leaves the params as they
    # were in both packages
    jp1, _, ts1 = _run_optimizers(np_params, jtx, ttx, TCA, scales, steps=1)
    for path, p in tstep.named_leaves(ts1.params):
        ref = dict(tstep.named_leaves(from_jax_params(np_params, TCA)))[path]
        assert torch.equal(p.detach(), ref), path


@pytest.mark.parametrize("freeze", ["vision", "vision_projector", "decoder"])
def test_optimizer_freeze_routing_equals_optax(freeze):
    """Frozen groups never change and hold no state; no warmup (cosine from
    the first step)."""
    np_params = dict(_weights())
    kw = dict(total_steps=5, grad_clip=0.5,
              freeze_vision=True, freeze_projector=freeze == "vision_projector",
              freeze_decoder=freeze == "decoder")
    jtx = jstep.make_optimizer(2e-3, **kw)
    ttx = tstep.make_optimizer(2e-3, **kw)
    scales = {"decoder": 0.05, "projector": 0.05, "vision": 0.05}
    jparams, jstate, tstate = _run_optimizers(np_params, jtx, ttx, TC, scales,
                                              seed=1)
    _assert_state_equal(jparams, jstate, tstate, TC)
    frozen = {"vision"} | ({"projector"} if freeze == "vision_projector"
                           else set()) | ({"decoder"} if freeze == "decoder"
                                          else set())
    before = dict(tstep.named_leaves(from_jax_params(np_params, TC)))
    for path, p in tstep.named_leaves(tstate.params):
        if path.split("/")[0] in frozen:
            assert not p.requires_grad and torch.equal(p, before[path])
            assert path not in tstate.opt_state["mu"]


def test_schedules_equal_optax():
    for w, total in ((0, 10), (3, 10), (3, 3), (0, 1)):
        if w:
            want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, w,
                                                      max(total, w + 1))
            got = tstep.warmup_cosine_schedule(1e-3, w, max(total, w + 1))
        else:
            want = optax.cosine_decay_schedule(1e-3, max(total, 1))
            got = tstep.cosine_schedule(1e-3, max(total, 1))
        for c in range(total + 3):
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                       atol=1e-12)


def test_train_step_runs_and_marks_only_trained_leaves():
    """make_train_state copies the trained leaves (the caller's tree is
    left as it is) and train_step moves them; a frozen tower takes no
    gradient."""
    params = from_jax_params(_weights(), TC)
    before = {p: x.clone() for p, x in tstep.named_leaves(params)}
    tx = tstep.make_optimizer(1e-3, total_steps=4)
    state = tstep.make_train_state(params, tx)
    state, loss = tstep.train_step(state, TC, tx, _to_torch(_batch()))
    assert state.step == 1 and np.isfinite(float(loss))
    assert int(state.opt_state["count"]) == 1
    for path, x in tstep.named_leaves(params):
        assert torch.equal(x, before[path]), path
    moved = [p for p, x in tstep.named_leaves(state.params)
             if not torch.equal(x, before[p])]
    assert moved and not any(p.startswith("vision/") for p in moved)
    assert all(x.grad is None for _, x in tstep.named_leaves(state.params))


def test_parallel_steps_not_yet_ported(one_rank_world):
    """The parallel steps, once refused, run: on a one-rank mesh (every
    collective over one rank) ``train_step_pp`` with 2 microbatches and the
    sequence-parallel ``loss_fn`` give the plain step's loss and params."""
    from fastvlm_tpu_torch.parallel.mesh import seq_sharding
    from fastvlm_tpu_torch.parallel.pipeline import stage_layout

    mesh = one_rank_world
    batch = _to_torch(_batch(b=2))
    tx = tstep.make_optimizer(1e-3, total_steps=4)
    plain, loss = tstep.train_step(tstep.make_train_state(
        from_jax_params(_weights(), TC), tx), TC, tx, batch)
    params = from_jax_params(_weights(), TC)
    layout = stage_layout(params, mesh)
    state = tstep.make_train_state(layout.shard(params), tx, layout)
    state, pp_loss = tstep.train_step_pp(state, TC, tx, batch, mesh,
                                         n_micro=2)
    np.testing.assert_allclose(float(pp_loss), float(loss), rtol=1e-6)
    for (p, a), (_, b) in zip(tstep.named_leaves(state.params),
                              tstep.named_leaves(plain.params)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5, err_msg=p)
    with torch.no_grad():
        sp = tstep.loss_fn(from_jax_params(_weights(), TC), TC, batch,
                           seq_sharding=seq_sharding(mesh))
        want = tstep.loss_fn(from_jax_params(_weights(), TC), TC, batch)
    np.testing.assert_allclose(float(sp), float(want), rtol=1e-6)


@pytest.mark.parametrize("mode", ["tp", "sp", "zero1", "fsdp"])
def test_one_rank_layouts_step_bitwise_like_one_process(one_rank_world,
                                                        mode):
    """On a one-rank mesh every collective is a copy, and the sharded
    steps run the one-process step's ops in its order (the clip's norm
    too): two steps give its params bit for bit, as the card's phase
    parallel holds them at full width."""
    from fastvlm_tpu_torch.parallel import sharding
    from fastvlm_tpu_torch.parallel.mesh import seq_sharding

    mesh = one_rank_world
    batch = _to_torch(_batch(b=2))
    tx = tstep.make_optimizer(1e-3, total_steps=4, freeze_vision=False)
    plain = tstep.make_train_state(from_jax_params(_weights(), TC), tx)
    params = from_jax_params(_weights(), TC)
    layout = (sharding.fsdp_layout(params, mesh, min_size=64)
              if mode == "fsdp" else sharding.tp_layout(params, TC, mesh))
    state = tstep.make_train_state(layout.shard(params), tx, layout)
    if mode == "zero1":
        state = state._replace(opt_state=sharding.shard_opt_state_zero1(
            state.opt_state, mesh, layout))
    for _ in range(2):
        plain, loss = tstep.train_step(plain, TC, tx, batch)
        state, got = tstep.train_step(
            state, TC, tx, batch,
            seq_sharding=seq_sharding(mesh) if mode == "sp" else None)
        assert torch.equal(got, loss)
    want = dict(tstep.named_leaves(plain.params))
    got = dict(tstep.named_leaves(layout.gather(state.params)))
    assert sorted(got) == sorted(want)
    for p, x in got.items():
        assert torch.equal(x, want[p]), p
