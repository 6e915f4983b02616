"""The port's parallel training (fastvlm_tpu_torch/parallel/, the sharded
train_step) in a 4-rank gloo world on the CPU (tests/torch_parallel_worker.py,
one world for the file), held against the port's one-process step and the
JAX package's step on its 8-device virtual CPU mesh, from the same numpy
weights (the tiny training config, live tower) and batches. Tolerances are
JAX's own (tests/test_parallel_train.py): ZeRO-1 params rtol 1e-4 / atol
1e-5 and loss rel 1e-6; FSDP rtol 1e-3 / atol 5e-5 and loss rel 1e-5; SP
(and TP) atol 2e-5 and loss 1e-5; against JAX, each group's params within
1e-4 of its largest |value| as in tests/test_torch_trainer.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.parallel import make_mesh as jmake_mesh
from fastvlm_tpu.parallel import sharding as jsharding
from fastvlm_tpu.parallel.mesh import data_sharding as jdata_sharding
from fastvlm_tpu.parallel.mesh import replicated as jreplicated
from fastvlm_tpu.parallel.mesh import seq_sharding as jseq_sharding
from fastvlm_tpu.train import step as jstep
from fastvlm_tpu_torch.parallel import make_mesh
from fastvlm_tpu_torch.parallel import sharding as tsharding
from fastvlm_tpu_torch.train import step as tstep
from fastvlm_tpu_torch.utils.convert import from_jax_params, qwen2_from_jax

import torch_tiny as tt
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)

JC, TC = tt.JTRAIN, tt.TTRAIN
UNPAD = dataclasses.replace(TC, image_aspect_ratio="anyres",
                            mm_patch_merge_type="spatial_unpad",
                            image_grid_pinpoints=((128, 256), (256, 128),
                                                  (256, 256)))
SCENARIOS = ["mesh_shapes", "placements", "tp_dp", "tp4", "dp_unequal",
             "zero1", "fsdp", "fsdp_zero1", "sp", "freeze", "newline",
             "tower_fsdp"]


def _batch(seed, t=48, lens=None):
    """4 rows, the first two imaged; ``lens`` the real lengths."""
    rng = np.random.RandomState(seed)
    b = 4
    ids = rng.randint(0, 258, (b, t)).astype(np.int32)
    labels = ids.copy()
    labels[:, :6] = -100
    lens = np.array(lens or [t - 3 * i for i in range(b)], np.int32)
    for i, n in enumerate(lens):
        labels[i, n:] = -100
        ids[i, n:] = 0
    return {"ids": ids, "labels": labels, "attn_lens": lens,
            "image_starts": np.array([3, 7, -1, -1], np.int32),
            "images": rng.rand(b, 128, 128, 3).astype(np.float32)}


WEIGHTS = tt.live_weights(JC)
WEIGHTS_UNPAD = tt.live_weights(tt.train_config(jcfg, "spatial_unpad"))
BATCHES = {"batch": _batch(0), "odd": _batch(1, t=47),
           # data ranks of 1 row each hold 42, 2, 37 and 12 label tokens
           "unequal": _batch(2, lens=[48, 8, 43, 18])}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return tt.run_world(str(tmp_path_factory.mktemp("world")), 4, SCENARIOS,
                        {"weights": WEIGHTS, "weights_unpad": WEIGHTS_UNPAD,
                         **BATCHES})


def result(world, name, rank=0):
    res = world[name][rank]
    assert "error" not in res, res["error"]
    return res


def _port_step(batch, cfg=TC, **opt):
    """The one-process step: the whole params after it and the gradient it
    applied (by path), and the loss."""
    params = from_jax_params(WEIGHTS, cfg)
    tx = tstep.make_optimizer(**{"lr": 1e-3, **opt})
    state = tstep.make_train_state(params, tx)
    loss = tstep.loss_fn(state.params, cfg, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    loss.backward()
    grads = {p: x.grad.clone() for p, x in tstep.named_leaves(state.params)
             if x.grad is not None}
    tx.update(state.params, state.opt_state)
    return ({p: x.detach() for p, x in tstep.named_leaves(state.params)},
            grads, float(loss.detach()))


def _jax_step(batch, mesh=None, kind="tp", seq=False):
    """JAX's step, optionally on its virtual mesh."""
    params = jax.tree.map(jnp.asarray, WEIGHTS)
    tx = jstep.make_optimizer(lr=1e-3)
    if kind == "tp" and mesh is not None:
        params = jsharding.shard_vlm(params, JC, mesh)
    elif kind == "fsdp":
        params = jsharding.shard_vlm_fsdp(params, mesh, min_size=64)
    state = jstep.make_train_state(params, tx)
    if kind == "zero1":
        state = state._replace(opt_state=jsharding.shard_opt_state_zero1(
            state.opt_state, mesh))
    state, loss = jstep.train_step(
        state, JC, tx, jax.tree.map(jnp.asarray, batch),
        seq_sharding=jseq_sharding(mesh) if seq else None)
    return jax.device_get(state.params), float(loss)


def _assert_step_close(res, want, rtol=0.0, atol=2e-5):
    """The sharded step against the one-process one: each trained leaf's
    gradient within 1e-5 of its largest |value| (as
    tests/test_torch_train_step.py holds the gradients to JAX's), and the
    params after the step within ``rtol`` / ``atol``, except where the
    gradient lies inside that tolerance of 0: there Adam's first update,
    lr * g / (|g| + 1e-8), turns the rounding of a sum taken in another
    order into a different update (such elements were |g| ~ 1e-7 of a
    leaf's 0.05-0.3)."""
    params, grads, _ = want
    got = res["params"]
    assert sorted(got) == sorted(params)
    assert sorted(res["grads"]) == sorted(grads)
    for p, w in params.items():
        live = torch.ones_like(w, dtype=torch.bool)
        if p in grads:
            g = grads[p]
            top = float(g.abs().max())
            err = float((res["grads"][p] - g).abs().max())
            assert err <= 1e-5 * top, (p, err, top)
            live = g.abs() > 1e-5 * top
        np.testing.assert_allclose(got[p][live].float().numpy(),
                                   w[live].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=p)


def _assert_whole_on_every_rank(world, name):
    ref = result(world, name)["params"]
    for r in range(1, 4):
        for p, x in result(world, name, r)["params"].items():
            assert torch.equal(x, ref[p]), (name, r, p)


def test_mesh_shapes():
    """JAX's make_mesh errors, raised before any process group is used."""
    with pytest.raises(ValueError):
        make_mesh(dp=3, tp=3, devices=range(8))
    with pytest.raises(ValueError, match="not divisible by tp=3"):
        make_mesh(tp=3, devices=range(8))


def test_mesh_shapes_in_the_world(world):
    res = result(world, "mesh_shapes")
    assert res["tp2"] == {"data": 2, "model": 2}
    assert res["tp1"] == {"data": 4, "model": 1}
    assert res["raises"]


def _jax_piece(x, mesh, r):
    """JAX's piece of ``x`` on the device at mesh place (r // tp, r % tp),
    the place of the port's rank r."""
    tp = mesh.devices.shape[1]
    dev = mesh.devices[r // tp, r % tp]
    return next(np.asarray(s.data) for s in x.addressable_shards
                if s.device == dev)


def _jax_mask(x, mesh, r):
    """Ones where JAX's piece of ``x`` for rank r lies, zeros elsewhere."""
    tp = mesh.devices.shape[1]
    dev = mesh.devices[r // tp, r % tp]
    mask = np.zeros(x.shape, np.float32)
    mask[next(s.index for s in x.addressable_shards if s.device == dev)] = 1
    return mask


def test_placements_hold_jaxs_pieces(world):
    """replicated, data_sharding and seq_sharding at (2, 2): each rank's
    piece is the one JAX places on its mesh device."""
    jmesh = jmake_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    x = np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8)
    for name, place in (("replicated", jreplicated),
                        ("data", jdata_sharding), ("seq", jseq_sharding)):
        arr = jax.device_put(x, place(jmesh))
        for r in range(4):
            got = result(world, "placements", r)[name].numpy()
            np.testing.assert_array_equal(got, _jax_piece(arr, jmesh, r),
                                          err_msg=f"{name} rank {r}")


def test_shard_vlm_holds_jaxs_pieces(world):
    """shard_vlm at (2, 2): each rank's decoder pieces are JAX's on its mesh
    device (layers unstacked); the tower and projector stay whole."""
    jmesh = jmake_mesh(dp=2, tp=2, devices=jax.devices()[:4])
    sharded = jsharding.shard_vlm(jax.tree.map(jnp.asarray, WEIGHTS), JC,
                                  jmesh)
    whole = dict(tstep.named_leaves(from_jax_params(WEIGHTS, TC)))
    for r in range(4):
        got = result(world, "placements", r)["tp"]
        pieces = jax.tree.map(lambda x: _jax_piece(x, jmesh, r),
                              sharded["decoder"])
        want = {f"decoder/{p}": x for p, x in tstep.named_leaves(
            qwen2_from_jax(pieces, JC.decoder.num_layers))}
        assert sorted(got) == sorted(whole)
        split = 0
        for p, x in got.items():
            assert torch.equal(x, want.get(p, whole[p])), (r, p)
            split += x.shape != whole[p].shape
        assert split > 0


def test_shard_vlm_fsdp_splits_the_leaves_jax_splits(world):
    """shard_vlm_fsdp at dp = 4 (min_size 64): the decoder's pieces are
    JAX's; across the whole tree the same leaves are split, each rank
    holding a quarter of each. (The tower's converted layout may order a
    tie of dims otherwise, so its pieces are not compared element for
    element.)"""
    jmesh = jmake_mesh(dp=4, tp=1, devices=jax.devices()[:4])
    sharded = jsharding.shard_vlm_fsdp(jax.tree.map(jnp.asarray, WEIGHTS),
                                       jmesh, min_size=64)
    whole = dict(tstep.named_leaves(from_jax_params(WEIGHTS, TC)))
    ones = dict(tstep.named_leaves(from_jax_params(
        jax.tree.map(lambda x: np.ones(x.shape, np.float32), WEIGHTS), TC)))
    for r in range(4):
        got = result(world, "placements", r)["fsdp"]
        pieces = jax.tree.map(lambda x: _jax_piece(x, jmesh, r),
                              sharded["decoder"])
        dec = {f"decoder/{p}": x for p, x in tstep.named_leaves(
            qwen2_from_jax(pieces, JC.decoder.num_layers))}
        masks = dict(tstep.named_leaves(from_jax_params(
            jax.tree.map(lambda x: _jax_mask(x, jmesh, r), sharded), TC)))
        assert sorted(got) == sorted(whole)
        split = 0
        for p, x in got.items():
            jax_split = not torch.equal(masks[p], ones[p])
            assert (x.shape != whole[p].shape) == jax_split, (r, p)
            if jax_split:
                assert x.numel() * 4 == whole[p].numel(), (r, p)
                split += 1
            if p in dec:
                assert torch.equal(x, dec[p]), (r, p)
        assert split > 0


def test_tp_dp_step_equals_the_unsharded_step_and_jax(world):
    """(dp=2, tp=2): the decoder split on heads / columns / vocab, the batch
    over data; JAX at (2, 4)."""
    res = result(world, "tp_dp")
    shapes = res["local_shapes"]
    assert shapes["decoder/layers/0/q/w"] == (64, 32)
    assert shapes["decoder/layers/0/k/w"] == (64, 16)
    assert shapes["decoder/layers/0/o/w"] == (32, 64)
    assert shapes["decoder/layers/0/down/w"] == (64, 64)
    assert shapes["decoder/embed"] == (129, 64)
    assert shapes["vision/stem/0/w"] == (8, 3, 3, 3)
    want = _port_step(BATCHES["batch"])
    _assert_step_close(res, want)
    assert abs(res["loss"] - want[2]) < 1e-5
    _assert_whole_on_every_rank(world, "tp_dp")
    jparams, jloss = _jax_step(BATCHES["batch"], jmake_mesh(dp=2, tp=4))
    np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)
    tt.assert_params_close(_tree(res["params"]), jparams)


def _tree(flat):
    """A whole port tree from its leaves by path."""
    tree = from_jax_params(WEIGHTS, TC)
    return tstep.map_leaves(lambda p, _: flat[p], tree)


def test_tp4_keeps_kv_heads_and_an_odd_vocab_whole(world):
    """(1, 4): 4 q heads split, the 2 kv heads and the 258-row vocab stay
    whole (JAX's fit_spec replicates the vocab too): the whole k/v weights'
    gradients are the sums of the ranks' partial ones."""
    res = result(world, "tp4")
    shapes = res["local_shapes"]
    assert shapes["decoder/layers/0/q/w"] == (64, 16)
    assert shapes["decoder/layers/0/k/w"] == (64, 32)
    assert shapes["decoder/embed"] == (258, 64)
    assert res["specs"]["decoder/embed"] == (None, None)
    want = _port_step(BATCHES["batch"])
    _assert_step_close(res, want)
    assert abs(res["loss"] - want[2]) < 1e-5


def test_dp_takes_the_token_mean_over_the_global_batch(world):
    """Ranks holding 42, 2, 37 and 12 label tokens: the step equals the
    one-process step on all 4 rows, and the mean of per-rank means (what
    averaging each rank's own loss gives) is far from it."""
    res = result(world, "dp_unequal")
    batch = BATCHES["unequal"]
    want = _port_step(batch)
    loss = want[2]
    assert abs(res["loss"] - loss) <= 1e-6 * abs(loss)
    _assert_step_close(res, want)
    params = from_jax_params(WEIGHTS, TC)
    with torch.no_grad():
        per_rank = [float(tstep.loss_fn(params, TC, {
            k: torch.from_numpy(v[r:r + 1]) for k, v in batch.items()}))
            for r in range(4)]
    assert abs(np.mean(per_rank) - loss) > 0.05 * abs(loss), (per_rank,
                                                              loss)
    _, jloss = _jax_step(batch)
    np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)


def test_zero1_matches_the_replicated_step(world):
    res = result(world, "zero1")
    want = _port_step(BATCHES["batch"])
    assert abs(res["loss"] - want[2]) <= 1e-6 * abs(want[2])
    _assert_step_close(res, want, rtol=1e-4, atol=1e-5)
    whole = dict(tstep.named_leaves(from_jax_params(WEIGHTS, TC)))
    sliced = 0
    for r in range(4):
        shapes = result(world, "zero1", r)["moment_shapes"]
        for p, shape in shapes.items():
            full = tuple(whole[p].shape)
            if full[0] % 4 == 0:
                assert shape == (full[0] // 4,) + full[1:], (r, p)
                sliced += 1
            else:
                assert shape == full, (r, p)
    assert sliced > 0
    jparams, jloss = _jax_step(BATCHES["batch"], jmake_mesh(dp=8, tp=1),
                               kind="zero1")
    np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)
    tt.assert_params_close(_tree(res["params"]), jparams)


def test_fsdp_matches_the_replicated_step_at_a_quarter_of_the_bytes(world):
    res = result(world, "fsdp")
    want = _port_step(BATCHES["batch"])
    np.testing.assert_allclose(res["loss"], want[2], rtol=1e-5)
    _assert_step_close(res, want, rtol=1e-3, atol=5e-5)
    whole = dict(tstep.named_leaves(from_jax_params(WEIGHTS, TC)))
    local_bytes = whole_bytes = rep_bytes = 0
    for p, x in whole.items():
        shape = res["local_shapes"][p]
        n = int(np.prod(shape)) * x.element_size()
        local_bytes += n
        whole_bytes += x.numel() * x.element_size()
        if "data" in res["specs"][p]:
            assert n * 4 == x.numel() * x.element_size(), p
        else:
            assert x.numel() < 64 or all(d % 4 for d in x.shape), p
            rep_bytes += n
        if p in res["moment_shapes"]:
            assert res["moment_shapes"][p] == shape, p
    assert local_bytes == (whole_bytes - rep_bytes) // 4 + rep_bytes
    assert rep_bytes < 0.01 * whole_bytes
    jparams, jloss = _jax_step(BATCHES["batch"], jmake_mesh(dp=8, tp=1),
                               kind="fsdp")
    np.testing.assert_allclose(res["loss"], jloss, rtol=1e-5)
    tt.assert_params_close(_tree(res["params"]), jparams)


def test_fsdp_with_zero1_slices_only_the_whole_moments(world):
    """--fsdp --zero1: FSDP's leaves keep their moments as the param's
    pieces; ZeRO-1 slices the moments of the leaves FSDP left whole."""
    res = result(world, "fsdp_zero1")
    want = _port_step(BATCHES["batch"])
    np.testing.assert_allclose(res["loss"], want[2], rtol=1e-5)
    _assert_step_close(res, want, rtol=1e-3, atol=5e-5)
    whole = dict(tstep.named_leaves(from_jax_params(WEIGHTS, TC)))
    sliced = 0
    for p, shape in res["moment_shapes"].items():
        full = tuple(whole[p].shape)
        if "data" in res["specs"][p]:
            assert shape == res["local_shapes"][p], p
        elif full[0] % 4 == 0:
            assert shape == (full[0] // 4,) + full[1:], p
            sliced += 1
    assert sliced > 0


def test_sequence_parallel_with_a_bucket_tp_does_not_divide(world):
    """(2, 2) with T = 47: padded to 48 on the mesh, masked out."""
    res = result(world, "sp")
    want = _port_step(BATCHES["odd"])
    assert abs(res["loss"] - want[2]) < 1e-5
    _assert_step_close(res, want, atol=2e-5)
    jparams, jloss = _jax_step(BATCHES["odd"], jmake_mesh(dp=2, tp=4),
                               seq=True)
    assert abs(res["loss"] - jloss) < 1e-5
    tt.assert_params_close(_tree(res["params"]), jparams)


def test_frozen_tower_and_projector_stay_bitwise_under_a_mesh(world):
    before = dict(tstep.named_leaves(from_jax_params(WEIGHTS, TC)))
    for r in range(4):
        got = result(world, "freeze", r)["params"]
        moved = 0
        for p, x in got.items():
            if p.startswith(("vision/", "projector/")):
                assert torch.equal(x, before[p]), (r, p)
            else:
                moved += not torch.equal(x, before[p])
        assert moved


def test_image_newline_survives_sharding_and_the_optimizer(world):
    res = result(world, "newline")
    assert "image_newline" in res["params"]
    assert res["specs"]["image_newline"] == ()
    assert "image_newline" in res["moment_shapes"]
    assert tsharding.vlm_specs(UNPAD, {"image_newline": torch.zeros(64)}) \
        == {"image_newline": ()}


def test_fsdp_with_the_tower_unfrozen_trains_through_gathered_leaves(world):
    """The tower's FSDP leaves are gathered at use and run the FFN under
    autograd (K1's Function on the card); the step equals the one-process
    step with the tower unfrozen."""
    res = result(world, "tower_fsdp")
    want = _port_step(BATCHES["batch"], freeze_vision=False)
    np.testing.assert_allclose(res["loss"], want[2], rtol=1e-5)
    _assert_step_close(res, want, rtol=1e-3, atol=5e-5)
    before = dict(tstep.named_leaves(from_jax_params(WEIGHTS, TC)))
    fc1 = "vision/stages/0/blocks/0/ffn/fc1/w"
    assert fc1 in before and "data" in res["specs"][fc1]
    assert not torch.equal(res["params"][fc1], before[fc1])
