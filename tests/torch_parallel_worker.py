"""One rank of the gloo worlds of tests/test_torch_parallel_train.py and
tests/test_torch_pipeline.py: runs the named scenarios of the port's
parallel training on the tiny training config and writes each one's result
(whole params gathered over the mesh, losses, per-rank facts) to
``<out>/<scenario>.rank<r>.pt``. Imports the port only, never JAX: the
parent test computes the JAX side and passes the inputs as .npy files.

    python tests/torch_parallel_worker.py RANK WORLD STORE IN_DIR OUT_DIR \\
        SCENARIO [SCENARIO ...]
"""

import dataclasses
import os
import sys
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from fastvlm_tpu_torch.parallel import distributed, make_mesh, sharding  # noqa: E402
from fastvlm_tpu_torch.parallel import pipeline as pp  # noqa: E402
from fastvlm_tpu_torch.parallel.mesh import (  # noqa: E402
    data_sharding, replicated, seq_sharding)
from fastvlm_tpu_torch.models import qwen2  # noqa: E402
from fastvlm_tpu_torch.train import step as tstep  # noqa: E402
from fastvlm_tpu_torch.train.train_sft import tiny_config  # noqa: E402
from fastvlm_tpu_torch.utils.convert import from_jax_params  # noqa: E402


def load(in_dir, name):
    return np.load(os.path.join(in_dir, name + ".npy"),
                   allow_pickle=True).item()


def port_config(merge="flat"):
    cfg = tiny_config()
    if merge != "flat":
        cfg = dataclasses.replace(
            cfg, image_aspect_ratio="anyres", mm_patch_merge_type=merge,
            image_grid_pinpoints=((128, 256), (256, 128), (256, 256)))
    return cfg


def local_rows(batch, mesh):
    return {k: data_sharding(mesh).local(torch.from_numpy(v))
            for k, v in batch.items()}


def one_step(cfg, np_params, batch, mesh, opt=None, kind="tp", zero1=False,
             seq=False, min_size=2 ** 14):
    """One train_step on the mesh; returns the whole params after it, the
    global loss and per-rank facts."""
    opt = opt or {}
    params = from_jax_params(np_params, cfg)
    tx = tstep.make_optimizer(**{"lr": 1e-3, **opt})
    if kind == "fsdp":
        layout = sharding.fsdp_layout(params, mesh, min_size)
    elif kind == "dp":
        layout = sharding.replicated_layout(params, mesh)
    else:
        layout = sharding.tp_layout(params, cfg, mesh)
    state = tstep.make_train_state(layout.shard(params), tx, layout)
    if zero1:
        state = state._replace(opt_state=sharding.shard_opt_state_zero1(
            state.opt_state, mesh, layout))
    # train_step written out, to keep the whole gradient it applies
    loss = tstep.loss_fn(state.params, cfg, local_rows(batch, mesh),
                         seq_sharding=seq_sharding(mesh) if seq else None,
                         layout=layout)
    loss.backward()
    grads = {p: x.grad.clone() for p, x in tstep.named_leaves(state.params)
             if x.grad is not None}
    layout.reduce_grads(grads.items())
    grads = {p: layout.gather_leaf(g, p) for p, g in grads.items()}
    tx.update(state.params, state.opt_state, layout)
    loss = tstep._global_loss(loss, layout)
    whole = layout.gather(state.params)
    local = dict(tstep.named_leaves(state.params))
    moments = {p: tuple(x.shape) for p, x in state.opt_state["mu"].items()}
    return {"params": {p: x.detach() for p, x in tstep.named_leaves(whole)},
            "grads": grads, "loss": float(loss),
            "local_shapes": {p: tuple(x.shape) for p, x in local.items()},
            "moment_shapes": moments,
            "specs": dict(layout.specs)}


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def sc_mesh_shapes(ctx):
    out = {}
    for tp in (2, 1):
        m = make_mesh(tp=tp)
        out[f"tp{tp}"] = dict(zip(m.mesh_dim_names, m.mesh.shape))
    try:
        make_mesh(dp=3, tp=3)
        out["raises"] = False
    except ValueError:
        out["raises"] = True
    return out


def sc_placements(ctx):
    """This rank's pieces of the whole tree under shard_vlm at (2, 2) and
    shard_vlm_fsdp at dp = 4 (min_size 64), and of a (4, 6, 8) tensor
    under the replicated, data and seq placements at (2, 2)."""
    cfg = port_config()
    whole = from_jax_params(load(ctx["in"], "weights"), cfg)
    mesh = make_mesh(dp=2, tp=2)
    x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    return {"tp": _named_detached(sharding.shard_vlm(whole, cfg, mesh)),
            "fsdp": _named_detached(sharding.shard_vlm_fsdp(
                whole, make_mesh(dp=4, tp=1), min_size=64)),
            **{name: place(mesh).local(x).clone() for name, place in
               (("replicated", replicated), ("data", data_sharding),
                ("seq", seq_sharding))}}


def _step(dp, tp, batch, weights="weights", merge="flat", **kw):
    def run(ctx):
        return one_step(port_config(merge), load(ctx["in"], weights),
                        load(ctx["in"], batch), make_mesh(dp=dp, tp=tp),
                        **kw)
    return run


# ---------------------------------------------------------------------------
# the pipeline world (tests/test_torch_pipeline.py: 2 ranks, S = 2)
# ---------------------------------------------------------------------------


def pp_decoder_config():
    """tests/test_pipeline.py's CFG: 4 layers over 2 stages, tied head."""
    from fastvlm_tpu_torch.config import Qwen2Config

    return Qwen2Config(vocab_size=64, hidden_size=32, num_layers=4,
                       num_heads=4, num_kv_heads=2, head_dim=8,
                       intermediate_size=64, tie_word_embeddings=True)


def pp_vlm_config():
    cfg = tiny_config()
    return dataclasses.replace(cfg, decoder=pp_decoder_config(),
                               projector=dataclasses.replace(
                                   cfg.projector, hidden_size=32))


def _named_detached(tree):
    return {p: x.detach().clone() for p, x in tstep.named_leaves(tree)}


def sc_pp_forward(ctx):
    """forward_pipelined at M = 2 and 4 microbatches: the hidden states
    and the whole gradients of a mean-square loss."""
    from fastvlm_tpu_torch.utils.convert import qwen2_from_jax

    cfg = pp_decoder_config()
    inputs = load(ctx["in"], "pp_inputs")
    mesh = make_mesh(dp=1, tp=2)
    out = {}
    for m in (2, 4):
        whole = qwen2_from_jax(load(ctx["in"], "pp_decoder"), cfg.num_layers)
        layout = pp.stage_layout({"decoder": whole}, mesh)
        local = layout.shard({"decoder": whole})
        for _, x in tstep.named_leaves(local):
            x.requires_grad_(True)
        x = inputs[m]
        ids, pos, mask, tgt = (torch.from_numpy(x[k]) for k in
                               ("ids", "positions", "mask", "target"))
        dec = local["decoder"]
        emb = qwen2.embed(dec, ids)
        h = pp.forward_pipelined(
            dec, cfg, emb.reshape((m, -1) + tuple(emb.shape[1:])),
            pos.reshape((m, -1) + tuple(pos.shape[1:])),
            mask.reshape((m, -1) + tuple(mask.shape[1:])), mesh)
        h = h.reshape(tgt.shape)
        ((h - tgt) ** 2).mean().backward()
        grads = layout.gather(tstep.map_leaves(lambda _, x: x.grad, local))
        out[m] = {"hidden": h.detach(),
                  "grads": _named_detached(grads["decoder"]),
                  "stage_layers": len(dec["layers"])}
    return out


def sc_pp_shard(ctx):
    """This rank's stage of the 4-layer decoder (shard_decoder_pipeline)."""
    from fastvlm_tpu_torch.utils.convert import qwen2_from_jax

    cfg = pp_decoder_config()
    whole = qwen2_from_jax(load(ctx["in"], "pp_decoder"), cfg.num_layers)
    return _named_detached(pp.shard_decoder_pipeline(
        whole, make_mesh(dp=1, tp=2)))


def sc_pp_step(ctx):
    """One train_step_pp (M = 2) of the VLM with the 4-layer decoder."""
    cfg = pp_vlm_config()
    params = from_jax_params(load(ctx["in"], "pp_weights"), cfg)
    mesh = make_mesh(dp=1, tp=2)
    layout = pp.stage_layout(params, mesh)
    tx = tstep.make_optimizer(lr=1e-3)
    state = tstep.make_train_state(layout.shard(params), tx, layout)
    batch = {k: torch.from_numpy(v)
             for k, v in load(ctx["in"], "pp_batch").items()}
    state, loss = tstep.train_step_pp(state, cfg, tx, batch, mesh, n_micro=2)
    return {"params": _named_detached(layout.gather(state.params)),
            "loss": float(loss),
            "local_layers": len(state.params["decoder"]["layers"])}


def _trainer(ctx, cfg, params, out, mesh=None, merge="flat", **kw):
    from fastvlm_tpu_torch.data.preprocessing import (
        ByteTokenizer, ImageProcessor)
    from fastvlm_tpu_torch.data.sft import DataArguments, SupervisedDataset
    from fastvlm_tpu_torch.train import trainer as ttrainer

    rec = load(ctx["in"], "records")
    ds = SupervisedDataset(DataArguments(
        data_path=rec["path"], image_folder=rec["folder"],
        image_aspect_ratio="anyres" if merge != "flat" else "pad",
        image_grid_pinpoints=cfg.image_grid_pinpoints), ByteTokenizer(),
        ImageProcessor(cfg.vision.image_size))
    args = ttrainer.TrainingArguments(output_dir=out, **{
        **rec["args"], **kw.pop("args", {})})
    return ttrainer.Trainer(cfg, params, ds, args, mesh=mesh, device="cpu",
                            **kw)


def sc_pp_anyres(ctx):
    cfg = port_config("spatial_unpad")
    params = from_jax_params(load(ctx["in"], "weights_unpad"), cfg)
    tr = _trainer(ctx, cfg, params, os.path.join(ctx["out"], "anyres"),
                  make_mesh(dp=1, tp=2), merge="spatial_unpad", pp_micro=2)
    try:
        tr.train()
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def sc_fsdp_checkpoint(ctx):
    """A 2-rank FSDP trainer: 2 steps saved (whole tensors), and a resume of
    the one-process checkpoint the parent wrote; each state gathered."""
    rec = load(ctx["in"], "records")
    cfg = port_config()
    mesh = make_mesh(dp=2, tp=1)

    def fresh(out):
        return _trainer(ctx, cfg, from_jax_params(load(ctx["in"], "weights"),
                                                  cfg), out, mesh,
                        args={"fsdp": True})

    tr = fresh(os.path.join(ctx["out"], "fsdp_run"))
    tr.train()
    sharded = {p: tuple(x.shape) for p, x in
               tstep.named_leaves(tr.state.params)}
    back = fresh(rec["one_process_dir"])
    step = back.resume()
    return {"step": step, "sharded_shapes": sharded,
            "resumed_params": _named_detached(back._whole(back.state.params)),
            "resumed_opt": back._whole_opt_state(back._whole(
                back.state.params))}


def sc_pp_checkpoint(ctx):
    """A 2-stage pipeline trainer (1 layer a stage): 2 steps saved as whole
    tensors; its state gathered."""
    cfg = port_config()
    tr = _trainer(ctx, cfg, from_jax_params(load(ctx["in"], "weights"), cfg),
                  os.path.join(ctx["out"], "pp_run"), make_mesh(dp=1, tp=2),
                  pp_micro=2)
    tr.train()
    whole = tr._whole(tr.state.params)
    return {"local_layers": len(tr.state.params["decoder"]["layers"]),
            "params": _named_detached(whole),
            "opt": tr._whole_opt_state(whole)}


SCENARIOS = {
    "pp_forward": sc_pp_forward,
    "pp_checkpoint": sc_pp_checkpoint,
    "pp_step": sc_pp_step,
    "pp_shard": sc_pp_shard,
    "pp_anyres": sc_pp_anyres,
    "fsdp_checkpoint": sc_fsdp_checkpoint,
    "mesh_shapes": sc_mesh_shapes,
    "placements": sc_placements,
    "tp_dp": _step(2, 2, "batch"),
    "tp4": _step(1, 4, "batch"),
    "dp_unequal": _step(4, 1, "unequal", kind="dp"),
    "zero1": _step(4, 1, "batch", kind="dp", zero1=True),
    "fsdp": _step(4, 1, "batch", kind="fsdp", min_size=64),
    "sp": _step(2, 2, "odd", seq=True),
    "freeze": _step(2, 2, "batch", opt={"lr": 1e-2,
                                        "freeze_projector": True}),
    "newline": _step(2, 2, "batch", weights="weights_unpad",
                     merge="spatial_unpad"),
    # min_size 128 leaves the layers' k/v biases (2 x 32 elements) whole
    # under FSDP, for ZeRO-1 to slice
    "fsdp_zero1": _step(4, 1, "batch", kind="fsdp", min_size=128,
                        zero1=True),
    "tower_fsdp": _step(4, 1, "batch", kind="fsdp", min_size=64,
                        opt={"freeze_vision": False}),
}


def main(argv):
    rank, world, store, in_dir, out_dir = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    distributed.initialize(f"file://{store}", world, rank, device="cpu")
    ctx = {"in": in_dir, "out": out_dir}
    rc = 0
    for name in argv[5:]:
        try:
            res = SCENARIOS[name](ctx)
        except Exception:
            traceback.print_exc()
            res = {"error": traceback.format_exc()}
            rc = 1
        torch.save(res, os.path.join(out_dir, f"{name}.rank{rank}.pt"))
        if rc:
            break
    distributed.shutdown()
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
