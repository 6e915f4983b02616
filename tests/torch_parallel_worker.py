"""One rank of the gloo worlds of tests/test_torch_parallel_train.py,
tests/test_torch_pipeline.py and tests/test_torch_engine_tp*.py: runs the
named scenarios of the port's parallel training on the tiny training
config, or of its tensor-parallel engine, and writes each one's result
(whole params gathered over the mesh, losses, per-rank facts, answers and
device-call logs) to ``<out>/<scenario>.rank<r>.pt``. Imports the port only, never JAX: the
parent test computes the JAX side and passes the inputs as .npy files.

    python tests/torch_parallel_worker.py RANK WORLD STORE IN_DIR OUT_DIR \\
        SCENARIO [SCENARIO ...]
"""

import dataclasses
import os
import sys
import threading
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


# ---------------------------------------------------------------------------
# the tensor-parallel engine (tests/test_torch_engine_tp.py at tp = 2,
# tests/test_torch_engine_tp4.py at tp = 4: the world is the mesh). Every
# rank builds the engine; rank 0 drives it and returns its answers, the
# others follow until rank 0 closes it. Each rank returns the outputs of
# every device call it made (``_record_calls``), for the test to hold the
# followers' to rank 0's.
# ---------------------------------------------------------------------------

TP_PROMPTS = {"chat": "hello mesh", "stream": "stream across the mesh",
              "spec": "repeat after me " * 3,
              "batch": ["alpha mesh", "beta mesh"]}
# new tokens of the persistent-view batch: two 2-chunk groups at chunk 16
TP_PERSIST_TOKENS = 64


def lively_config(kv_cache_dtype=None):
    """tests/torch_tiny.py's ``tiny(tcfg)``: the 128 px training config with
    an untied head."""
    cfg = tiny_config()
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, tie_word_embeddings=False,
        kv_cache_dtype=kv_cache_dtype))


def tp_image(seed=0, size=128):
    return np.random.RandomState(seed).randint(0, 256, (size, size, 3),
                                               dtype=np.uint8)


def _host(x):
    """A call's output on the host, a cache by its lengths only (its
    planes hold this rank's kv heads)."""
    from fastvlm_tpu_torch.ops.kv_cache import KVCache, PagedKVCache

    if isinstance(x, (KVCache, PagedKVCache)):
        return ("cache", x.lengths.cpu().clone())
    if torch.is_tensor(x):
        return x.detach().cpu().clone()
    if isinstance(x, (tuple, list)):
        return [_host(v) for v in x]
    return x


def _record_calls(engine):
    """Wrap the engine's device-call registry (which its lockstep channel
    shares): every call made on this rank appends (name, outputs)."""
    log = []
    for name, fn in list(engine._calls.items()):
        def rec(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            log.append((_name, _host(out)))
            return out
        engine._calls[name] = rec
    return log


def _tp_engine(cfg, np_params, **kw):
    from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer
    from fastvlm_tpu_torch.engine import Engine

    tok = ByteTokenizer()
    mesh = make_mesh(dp=1, tp=torch.distributed.get_world_size())
    engine = Engine(cfg, from_jax_params(np_params, cfg), tok,
                    eos_ids=(tok.eos_token_id,), mesh=mesh, **kw)
    return engine, _record_calls(engine)


def _drive(engine, log, drive):
    """Rank 0 runs ``drive(engine)`` and closes the engine; the others
    follow. Returns this rank's answers (rank 0's) and call log."""
    if not engine.is_leader:
        engine.follow()
        return {"log": log}
    try:
        out = drive(engine)
    finally:
        engine.close()
    return {**out, "log": log}


def tp_pieces(engine):
    """The shapes of layer 0's pieces, the embedding's, and the kv heads a
    dense cache holds."""
    from fastvlm_tpu_torch.parallel.sharding import kv_heads

    dec = engine.params["decoder"]
    lp = dec["layers"][0]
    shapes = {n: tuple(lp[n]["w"].shape) for n in ("q", "k", "v", "o", "gate",
                                                   "up", "down")}
    shapes["embed"] = tuple(dec["embed"].shape)
    return {"shapes": shapes,
            "cache_heads": engine.new_cache(1, 8).k.shape[3],
            "kv_heads": kv_heads(engine.cfg.decoder,
                                 torch.distributed.get_world_size(),
                                 engine.rank)}


def tp_batch(engine, prompts, max_new_tokens=5, counters=None, **knobs):
    """``prompts`` through a BatchScheduler over ``engine``, one thread
    each (tests/test_engine_tp.py's scheduler settings, and ``knobs``);
    ``counters``, a dict, receives the scheduler's."""
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler

    sched = BatchScheduler(engine, window_ms=100, paged=True, page_size=16,
                           pool_tokens=8192, **knobs)
    results = [None] * len(prompts)

    def run(i):
        last = None
        for last in sched.submit(engine.build_prompt(prompts[i]),
                                 max_new_tokens=max_new_tokens):
            pass
        results[i] = last.get("error", last["text"])

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sched.shutdown()
    if counters is not None:
        counters.update(sched.counters)
    return results


TP_SYSTEM = "You are a careful assistant who looks closely at pictures. "
# (question, new tokens): A alone, B admitted while A decodes, C after both
TP_SERVE = (("what is in it?", 40),
            ("and what else can you see in this small picture here?", 8),
            ("what is in it now?", 8))


def _last_text(stream):
    last = {"text": None}
    for last in stream:
        pass
    return last.get("error", last["text"])


def tp_serving(engine, image):
    """TP_SERVE through a BatchScheduler with the prefix cache, 8-token
    chunked admission and spec chunks: A alone (spec chunks), B submitted
    at A's first token (a prefix hit, admitted in chunks while A decodes),
    C once both closed (a prefix hit). Returns the texts and counters."""
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler

    sched = BatchScheduler(engine, window_ms=5, page_size=16,
                           pool_tokens=4096, prefix_cache=True,
                           prefill_chunk=8, spec=True)

    def submit(question, n):
        return sched.submit(engine.build_prompt(question, TP_SYSTEM), image,
                            max_new_tokens=n)

    try:
        a = submit(*TP_SERVE[0])
        first = next(a)
        texts = [None, None]
        # submit() queues the request at its first next(): B's own thread
        tb = threading.Thread(target=lambda: texts.__setitem__(
            1, _last_text(submit(*TP_SERVE[1]))))
        tb.start()
        texts[0] = _last_text([first, *a])
        tb.join(timeout=120)
        texts.append(_last_text(submit(*TP_SERVE[2])))
        return {"texts": texts, "counters": dict(sched.counters)}
    finally:
        sched.shutdown()


def tp_video(engine):
    """VideoQA over frames 1, 2: asked in turn, pipelined, and with spec
    decoding."""
    from fastvlm_tpu_torch.video import VideoQA, qa_over_stream

    frames = [tp_image(s) for s in (1, 2)]
    out = {}
    for name, kw, pipelined in (("ask", {}, False),
                                ("pipelined", {}, True),
                                ("spec", {"spec": True}, False)):
        qa = VideoQA(engine, "what changed?", max_new_tokens=6, **kw)
        out[name] = [t for t, _ in qa_over_stream(qa, frames,
                                                 pipelined=pipelined)]
    return out


def sc_tp_engine(ctx):
    """tests/test_engine_tp.py's requests through the TP engine over the
    JAX tiny engine's weights, a sampled request, and a ModelWorker's
    streamed answer."""
    from fastvlm_tpu_torch.engine import tiny_config as engine_tiny
    from fastvlm_tpu_torch.ops.sampling import SamplingParams
    from fastvlm_tpu_torch.serve.protocol import iter_chunks
    from fastvlm_tpu_torch.serve.worker import ModelWorker

    engine, log = _tp_engine(engine_tiny(), load(ctx["in"], "tiny_weights"))
    pieces = tp_pieces(engine)

    def drive(e):
        p = TP_PROMPTS
        stream_prompt = e.build_prompt(p["stream"])
        persist_counters = {}
        worker = ModelWorker(e, "fastvlm-tiny")
        msgs = list(iter_chunks(worker.generate_stream({
            "prompt": e.build_prompt(p["chat"]), "max_new_tokens": 8,
            "temperature": 0.0})))
        return {
            "chat": e.chat(p["chat"], max_new_tokens=12)[0],
            "stream": [u["text"] for u in e.stream(stream_prompt,
                                                   max_new_tokens=10)],
            "spec": e.generate_spec(e.build_prompt(p["spec"]),
                                    max_new_tokens=16)[0],
            "batch": tp_batch(e, p["batch"]),
            # the JAX scheduler's defaults: the persistent view (its planes
            # cross the lockstep channel by handle), pipelined 2 deep
            "batch_persist": tp_batch(
                e, p["batch"], TP_PERSIST_TOKENS, persist_counters,
                persist_view=True, pipeline_depth=2),
            "persist_counters": persist_counters,
            "sampled": e.chat(p["chat"], max_new_tokens=12, seed=7,
                              sampling=SamplingParams(temperature=0.7))[0],
            "worker": msgs}

    return {**pieces, **_drive(engine, log, drive)}


def sc_tp_lively(ctx):
    """Livelier weights (decoder N(0, 0.2), untied head): prefill logits,
    an image chat, beam search W = 2, a sampled request, VideoQA over two
    frames, the scheduler's prefix cache, chunked admission and spec
    chunks; then an int8-KV engine's image chat and dense batch."""
    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    weights = load(ctx["in"], "lively_weights")
    image = tp_image()
    out = {}
    engine, log = _tp_engine(lively_config(), weights)
    out["pieces"] = tp_pieces(engine)

    def drive(e):
        prompt = e.build_prompt("describe the picture")
        with torch.inference_mode():
            inp = e.prepare(prompt, image)
            cache = e.new_cache(1, inp["ids"].shape[1])
            logits, _ = e.call("prefill", inp["images"], inp["ids"],
                               inp["lens"], inp["starts"], cache)
        return {
            "logits": logits.cpu(),
            "chat": e.chat("describe the picture", image,
                           max_new_tokens=12)[0],
            "beam": e.generate_beam(prompt, image, num_beams=2,
                                    max_new_tokens=8)[0],
            "sampled": e.chat("describe the picture", image,
                              max_new_tokens=12, seed=3,
                              sampling=SamplingParams(temperature=0.7))[0],
            "video": tp_video(e),
            "serving": tp_serving(e, image)}

    out["main"] = _drive(engine, log, drive)
    engine, log = _tp_engine(lively_config("int8"), weights)
    out["int8"] = _drive(engine, log, lambda e: {
        "chat": e.chat("describe the picture", image, max_new_tokens=12)[0],
        "batch": tp_batch(e, TP_PROMPTS["batch"])})
    return out


def sc_tp_unknown_call(ctx):
    """Rank 0 sends a call outside the registry down the lockstep channel:
    the follower raises."""
    from fastvlm_tpu_torch.engine import tiny_config as engine_tiny

    engine, _ = _tp_engine(engine_tiny(), load(ctx["in"], "tiny_weights"))
    ls = engine.lockstep
    if engine.is_leader:
        torch.distributed.broadcast_object_list(
            [("forward", (), {}, False, [])], src=ls.src, group=ls.group)
        return {}
    try:
        engine.follow()
    except ValueError as e:
        return {"raised": str(e)}
    return {"raised": None}


def sc_tp_dead_follower(ctx):
    """Rank 1 builds the engine and exits without following; rank 0's next
    request must raise, not hang (the world's last scenario)."""
    import time

    from fastvlm_tpu_torch.engine import tiny_config as engine_tiny

    engine, _ = _tp_engine(engine_tiny(), load(ctx["in"], "tiny_weights"))
    if not engine.is_leader:
        return {}
    time.sleep(2)  # rank 1 is gone by now
    t0 = time.monotonic()
    try:
        engine.chat(TP_PROMPTS["chat"], max_new_tokens=4)
    except RuntimeError as e:
        return {"raised": f"{type(e).__name__}: {e}"[:300],
                "seconds": time.monotonic() - t0}
    return {"raised": None, "seconds": time.monotonic() - t0}


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
    "tp_engine": sc_tp_engine,
    "tp_lively": sc_tp_lively,
    "tp_unknown_call": sc_tp_unknown_call,
    "tp_dead_follower": sc_tp_dead_follower,
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
