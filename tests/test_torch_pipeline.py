"""Pipeline parallelism in the port (fastvlm_tpu_torch/parallel/pipeline.py,
train_step_pp) and the trainer's checkpoints across layouts, in a 2-rank
gloo world on the CPU (tests/torch_parallel_worker.py, one world for the
file: S = 2 stages of tests/test_pipeline.py's 4-layer decoder), held
against the port's plain forward and step and the JAX package's (its
train_step_pp on the 8-device virtual mesh); then train_sft under torchrun
at world size 2 with --tp 2 --sp and with --pp-micro 2. Tolerances are
JAX's (tests/test_pipeline.py): the forward within atol 1e-5, gradients
within 2e-5, the step's loss within 1e-5."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvlm_tpu import config as jcfg
from fastvlm_tpu.models import qwen2 as jqwen2
from fastvlm_tpu.ops.splice import expand_image_ids, pad_batch
from fastvlm_tpu.parallel import make_mesh as jmake_mesh
from fastvlm_tpu.parallel.mesh import data_sharding as jdata_sharding
from fastvlm_tpu.parallel.pipeline import shard_decoder_pipeline as jstage
from fastvlm_tpu.train import step as jstep
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import qwen2
from fastvlm_tpu_torch.parallel.pipeline import STAGED, stage_specs
from fastvlm_tpu_torch.train import step as tstep
from fastvlm_tpu_torch.train import trainer as ttrainer
from fastvlm_tpu_torch.utils.checkpoint import NATIVE_FILE
from fastvlm_tpu_torch.utils.convert import from_jax_params, qwen2_from_jax

import torch_tiny as tt
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_tiny import same_image_loader  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JDEC = jcfg.Qwen2Config(vocab_size=64, hidden_size=32, num_layers=4,
                        num_heads=4, num_kv_heads=2, head_dim=8,
                        intermediate_size=64, tie_word_embeddings=True)
TDEC = tcfg.Qwen2Config(vocab_size=64, hidden_size=32, num_layers=4,
                        num_heads=4, num_kv_heads=2, head_dim=8,
                        intermediate_size=64, tie_word_embeddings=True)


def _vlm(pkg, dec):
    vision = pkg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                               embed_dims=(8, 16, 32, 64, 128),
                               image_size=128, attn_head_dim=16)
    return pkg.FastVLMConfig(
        vision=vision, decoder=dec,
        projector=pkg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                      hidden_size=dec.hidden_size))


JVLM, TVLM = _vlm(jcfg, JDEC), _vlm(tcfg, TDEC)


def _decoder_weights(seed=0):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        if path[-1].key in ("ln1", "ln2", "final_norm"):
            return (1 + 0.02 * rng.randn(*leaf.shape)).astype(np.float32)
        scale = 0.2 if leaf.ndim >= 2 else 0.02
        return (scale * rng.randn(*leaf.shape)).astype(np.float32)

    shapes = jax.eval_shape(lambda k: jqwen2.init(k, JDEC),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pp_inputs(m, seed):
    """tests/test_pipeline.py's inputs: M microbatches of 2 rows, T = 8."""
    rng = np.random.RandomState(seed)
    b, t = 2, 8
    ids = rng.randint(0, 64, (m * b, t)).astype(np.int32)
    lens = np.asarray(([t, t - 2, t, t - 1] * m)[: m * b], np.int32)
    q, k = np.arange(t)[:, None], np.arange(t)[None, :]
    mask = (k <= q)[None] & (k[None] < lens[:, None, None])
    return {"ids": ids, "lens": lens, "mask": mask,
            "positions": np.tile(np.arange(t, dtype=np.int32), (m * b, 1)),
            "target": rng.randn(m * b, t, 32).astype(np.float32)}


def _pp_batch():
    """tests/test_pipeline.py's train batch: 4 imaged rows, T = 16."""
    rows, starts = [], []
    for i in range(4):
        row, s = expand_image_ids([5, 7 + i, -200, 9], JVLM.num_image_tokens)
        rows.append(row)
        starts.append(s)
    ids, lens, starts = pad_batch(rows, starts, 16)
    ids = ids % 64
    labels = np.where(np.arange(ids.shape[1])[None] < lens[:, None], ids,
                      -100)
    images = np.random.RandomState(1).rand(4, 128, 128, 3).astype(np.float32)
    return {"images": images, "ids": np.asarray(ids, np.int32),
            "labels": np.asarray(labels, np.int32),
            "image_starts": np.asarray(starts, np.int32),
            "attn_lens": np.asarray(lens, np.int32)}


DEC_W = _decoder_weights()
PP_INPUTS = {m: _pp_inputs(m, seed=m) for m in (2, 4)}
VLM_W = tt.live_weights(JVLM)
PP_BATCH = _pp_batch()
CKPT_ARGS = dict(batch_size=4, max_steps=2, learning_rate=1e-3, log_steps=1,
                 save_steps=0, warmup_ratio=0.0, seed=0)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2-rank world; first, the one-process trainer's checkpoint that
    the FSDP ranks resume."""
    root = tmp_path_factory.mktemp("pp")
    data = tt.sft_records(root)
    one = ttrainer.Trainer(
        tt.TTRAIN, from_jax_params(tt.live_weights(tt.JTRAIN), tt.TTRAIN),
        tt.sft_datasets(data)[0], ttrainer.TrainingArguments(
            output_dir=str(root / "one"), **CKPT_ARGS), device="cpu")
    one.train()
    res = tt.run_world(str(root / "w"), 2,
                       ["pp_forward", "pp_step", "pp_shard", "pp_anyres",
                        "fsdp_checkpoint", "pp_checkpoint"],
                       {"pp_decoder": DEC_W, "pp_inputs": PP_INPUTS,
                        "pp_weights": VLM_W, "pp_batch": PP_BATCH,
                        "weights": tt.live_weights(tt.JTRAIN),
                        "weights_unpad": tt.live_weights(
                            tt.train_config(jcfg, "spatial_unpad")),
                        "records": {"path": data[0], "folder": data[1],
                                    "args": CKPT_ARGS,
                                    "one_process_dir": str(root / "one")}})
    return {"res": res, "one": one, "root": root, "data": data}


def result(world, name, rank=0):
    res = world["res"][name][rank]
    assert "error" not in res, res["error"]
    return res


def _plain_forward(m):
    """The plain port forward and its gradients, and JAX's forward."""
    x = PP_INPUTS[m]
    params = tstep.map_leaves(lambda _, v: v.requires_grad_(),
                              qwen2_from_jax(DEC_W, 4))
    ids = torch.from_numpy(x["ids"])
    h, _ = qwen2.forward(params, TDEC, qwen2.embed(params, ids),
                         torch.from_numpy(x["positions"]),
                         mask=torch.from_numpy(x["mask"]))
    ((h - torch.from_numpy(x["target"])) ** 2).mean().backward()
    grads = {p: v.grad for p, v in tstep.named_leaves(params)}
    jp = jax.tree.map(jnp.asarray, DEC_W)
    jh, _ = jqwen2.forward(jp, JDEC, jqwen2.embed(jp, jnp.asarray(x["ids"])),
                           jnp.asarray(x["positions"]),
                           mask=jnp.asarray(x["mask"]))
    return h.detach(), grads, np.asarray(jh)


@pytest.mark.parametrize("m", [2, 4])
def test_pipelined_forward_and_gradients_match_plain(world, m):
    got = result(world, "pp_forward")[m]
    assert got["stage_layers"] == 2
    want, grads, jax_h = _plain_forward(m)
    np.testing.assert_allclose(got["hidden"].numpy(), want.numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got["hidden"].numpy(), jax_h, atol=1e-5)
    assert sorted(got["grads"]) == sorted(grads)
    for p, g in grads.items():
        np.testing.assert_allclose(got["grads"][p].numpy(), g.numpy(),
                                   atol=2e-5, err_msg=p)
    other = result(world, "pp_forward", 1)[m]
    assert torch.equal(other["hidden"], got["hidden"])


def test_pipelined_train_step_matches_plain_and_jax(world):
    res = result(world, "pp_step")
    assert res["local_layers"] == 2
    params = from_jax_params(VLM_W, TVLM)
    tx = tstep.make_optimizer(lr=1e-3)
    state = tstep.make_train_state(params, tx)
    state, loss = tstep.train_step(
        state, TVLM, tx, {k: torch.from_numpy(v) for k, v in
                          PP_BATCH.items()})
    assert abs(res["loss"] - float(loss)) < 1e-5
    want = {p: x.detach() for p, x in tstep.named_leaves(state.params)}
    for p, x in want.items():
        np.testing.assert_allclose(res["params"][p].numpy(), x.numpy(),
                                   atol=2e-5, err_msg=p)
    # JAX's train_step_pp on its (2, 4) mesh: 4 stages, 2 microbatches
    mesh = jmake_mesh(dp=2, tp=4)
    jp = dict(jax.tree.map(jnp.asarray, VLM_W))
    jp["decoder"] = jstage(jp["decoder"], mesh)
    jtx = jstep.make_optimizer(lr=1e-3)
    jbatch = jax.tree.map(jnp.asarray, PP_BATCH)
    jbatch["images"] = jax.device_put(jbatch["images"], jdata_sharding(mesh))
    _, jloss = jstep.train_step_pp(jstep.make_train_state(jp, jtx), JVLM,
                                   jtx, jbatch, mesh, n_micro=2)
    assert abs(res["loss"] - float(jloss)) < 1e-5


def test_stage_specs_shard_only_the_layers():
    specs = stage_specs(qwen2_from_jax(DEC_W, 4))
    assert specs["embed"] == ()
    assert specs["final_norm"] == ()
    assert specs["layers"] == STAGED == ("model",)


def test_shard_decoder_pipeline_holds_jaxs_stages(world):
    """Each rank's stage is JAX's piece of the stacked layers on its mesh
    device (2 of 4 layers, unstacked); embed and final_norm whole."""
    mesh = jmake_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    sharded = jstage(jax.tree.map(jnp.asarray, DEC_W), mesh)
    for s in range(2):
        dev = mesh.devices[0, s]
        pieces = jax.tree.map(lambda x: next(
            np.asarray(p.data) for p in x.addressable_shards
            if p.device == dev), sharded)
        want = dict(tstep.named_leaves(qwen2_from_jax(pieces, 2)))
        got = result(world, "pp_shard", s)
        assert sorted(got) == sorted(want)
        for p, x in want.items():
            assert torch.equal(got[p], x), (s, p)


def test_anyres_under_pp_micro_raises(world):
    assert "--pp-micro" in (result(world, "pp_anyres")["raised"] or "")


def test_fsdp_checkpoints_resume_bitwise_across_layouts(world):
    """A 2-rank FSDP run's checkpoint-2 (whole tensors) resumes in a
    one-process trainer with its gathered params and moments bitwise; the
    one-process run's checkpoint resumes under FSDP the same way."""
    res = result(world, "fsdp_checkpoint")
    one = world["one"]
    whole = dict(tstep.named_leaves(one.state.params))
    assert any(s != tuple(whole[p].shape)
               for p, s in res["sharded_shapes"].items())
    # one-process -> FSDP
    assert res["step"] == 2
    for p, x in whole.items():
        assert torch.equal(res["resumed_params"][p], x.detach()), p
    opt = dict(tstep.named_leaves(res["resumed_opt"]))
    for p, x in tstep.named_leaves(one.state.opt_state):
        assert torch.equal(opt[p], x), p
    # FSDP -> one-process
    back = ttrainer.Trainer(
        tt.TTRAIN, from_jax_params(tt.live_weights(tt.JTRAIN), tt.TTRAIN),
        tt.sft_datasets(world["data"])[0], ttrainer.TrainingArguments(
            output_dir=str(world["root"] / "w" / "out" / "fsdp_run"),
            **CKPT_ARGS), device="cpu")
    assert back.resume() == 2
    saved = torch.load(os.path.join(
        world["root"], "w", "out", "fsdp_run", "checkpoint-2", "params",
        NATIVE_FILE), weights_only=True)
    for (p, x), (_, y) in zip(tstep.named_leaves(back.state.params),
                              tstep.named_leaves(saved)):
        assert torch.equal(x.detach(), y), p
    # the two runs trained the same 2 steps
    for (p, x), (_, y) in zip(tstep.named_leaves(back.state.params),
                              tstep.named_leaves(one.state.params)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   atol=5e-5, rtol=1e-3, err_msg=p)


def test_pipeline_checkpoint_resumes_bitwise_in_one_process(world):
    """The 2-stage run's checkpoint-2 holds the whole layer list in order:
    a one-process trainer resumes the gathered params and moments
    bitwise, and they are the one-process run's within JAX's FSDP
    tolerance (two Adam steps from gradients summed in another order)."""
    res = result(world, "pp_checkpoint")
    assert res["local_layers"] == 1
    back = ttrainer.Trainer(
        tt.TTRAIN, from_jax_params(tt.live_weights(tt.JTRAIN), tt.TTRAIN),
        tt.sft_datasets(world["data"])[0], ttrainer.TrainingArguments(
            output_dir=str(world["root"] / "w" / "out" / "pp_run"),
            **CKPT_ARGS), device="cpu")
    assert back.resume() == 2
    for p, x in tstep.named_leaves(back.state.params):
        assert torch.equal(x.detach(), res["params"][p]), p
    opt = dict(tstep.named_leaves(res["opt"]))
    for p, x in tstep.named_leaves(back.state.opt_state):
        assert torch.equal(x, opt[p]), p
    for (p, x), (_, y) in zip(tstep.named_leaves(back.state.params),
                              tstep.named_leaves(world["one"].state.params)):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   atol=5e-5, rtol=1e-3, err_msg=p)


def _records(root):
    from PIL import Image

    Image.new("RGB", (64, 64), (10, 200, 30)).save(root / "x.jpg")
    data = [{"id": str(i), "image": "x.jpg", "conversations": [
        {"from": "human", "value": "<image>\nDescribe."},
        {"from": "gpt", "value": "green"}]} for i in range(8)]
    (root / "d.json").write_text(json.dumps(data))
    return str(root / "d.json"), str(root)


@pytest.mark.parametrize("flags", [["--tp", "2", "--sp"],
                                   ["--tp", "2", "--pp-micro", "2"]],
                         ids=["tp2-sp", "pp-micro2"])
def test_train_sft_under_torchrun(tmp_path, flags):
    """tests/test_pipeline.py's CLI run, as 2 gloo ranks under torchrun
    (which replays each rank's output from its own log a line at a time)."""
    path, folder = _records(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--log-dir", str(tmp_path / "logs"),
         "--redirects", "3", "--tee", "3",
         "-m", "fastvlm_tpu_torch.train.train_sft",
         "--multihost", "--device", "cpu", "--random-tiny",
         "--data-path", path, "--image-folder", folder, "--batch-size", "4",
         "--max-steps", "2", "--log-steps", "1", "--save-steps", "0",
         "--output-dir", str(tmp_path / "run"), *flags],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.count("'steps': 2") == 2, out.stdout[-2000:]
    assert sorted(os.listdir(tmp_path / "run" / "checkpoint-2")) == [
        "opt_state", "params"]
