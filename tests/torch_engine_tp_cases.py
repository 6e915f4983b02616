"""The cases of tests/test_torch_engine_tp.py (tp = 2) and
tests/test_torch_engine_tp4.py (tp = 4), each module's ``TP``: the port's
tensor-parallel engine (``Engine(mesh=)``, ``parallel/lockstep.py``) in a
gloo world of TP ranks on the CPU (tests/torch_parallel_worker.py, one
world a file), held against

  * the JAX engine of ``build_engine(random_tiny=True)``, single-device and
    on a (1, TP) mesh of the 8 virtual CPU devices, with tests/
    test_engine_tp.py's requests (greedy ids equal), the batch also through
    the persistent view pipelined 2 deep, the JAX scheduler's defaults;
  * the port's single-rank engine over the same weights: prefill logits
    within 1e-5 of the largest |logit| (f32), and equal ids for an image
    chat, beam search W = 2, VideoQA (in turn, pipelined, speculative),
    the scheduler's prefix cache,
    chunked admission and spec chunks, and an int8-KV chat and dense
    batch;
  * rank 0: every follower's device-call outputs (tokens, logits, lengths;
    greedy and sampled at temperature 0.7) bitwise equal to rank 0's.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from fastvlm_tpu import engine as jengine
from fastvlm_tpu.models import vlm as jvlm
from fastvlm_tpu.parallel.mesh import make_mesh as jmake_mesh
from fastvlm_tpu.serve.batcher import BatchScheduler as JBatchScheduler
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer
from fastvlm_tpu_torch.serve.batcher import BatchScheduler
from fastvlm_tpu_torch.utils.convert import from_jax_params

import torch_parallel_worker as tw
import torch_tiny as tt

LOGITS_REL = 1e-5


def _batch(e, batcher, max_new_tokens):
    """tests/test_engine_tp.py's batch through a ``batcher`` scheduler over
    engine ``e`` at its defaults (the JAX scheduler's: the persistent view,
    pipelined 2 deep)."""
    p = tw.TP_PROMPTS
    sched = batcher(e, window_ms=100, paged=True, page_size=16,
                    pool_tokens=8192)
    results = [None] * len(p["batch"])

    def run(i):
        last = None
        for last in sched.submit(e.build_prompt(p["batch"][i]),
                                 max_new_tokens=max_new_tokens):
            pass
        results[i] = last.get("error", last["text"])

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(p["batch"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
    finally:
        sched.shutdown()
    return results


def _requests(e, batcher):
    """tests/test_engine_tp.py's four requests through engine ``e`` and a
    ``batcher`` scheduler over it, and the batch again at the persistent
    view's length."""
    p = tw.TP_PROMPTS
    return {"chat": e.chat(p["chat"], max_new_tokens=12)[0],
            "stream": [u["text"] for u in e.stream(
                e.build_prompt(p["stream"]), max_new_tokens=10)],
            "spec": e.generate_spec(e.build_prompt(p["spec"]),
                                    max_new_tokens=16)[0],
            "batch": _batch(e, batcher, 5),
            "batch_persist": _batch(e, batcher, tw.TP_PERSIST_TOKENS)}


@pytest.fixture(scope="module")
def tiny_weights():
    """The JAX tiny engine's weights (``build_engine(random_tiny=True)``
    draws them from PRNGKey(0)), as numpy."""
    cfg = jengine.build_engine(random_tiny=True).cfg
    return jax.tree.map(np.asarray, jvlm.init(jax.random.PRNGKey(0), cfg))


@pytest.fixture(scope="module")
def lively_weights():
    return tt.draw_weights(1)


@pytest.fixture(scope="module")
def started_world(request, tmp_path_factory, tiny_weights, lively_weights):
    """The world runs while this process computes the JAX and single-rank
    answers (``world``)."""
    started = tt.start_world(
        str(tmp_path_factory.mktemp("world")), request.module.TP,
        ["tp_engine", "tp_lively",
         *getattr(request.module, "MORE_SCENARIOS", ())],
        {"tiny_weights": tiny_weights, "lively_weights": lively_weights})
    yield started
    tt.stop_world(started)


@pytest.fixture(scope="module")
def world(started_world, jax_answers, port_answers):
    return tt.finish_world(started_world)


@pytest.fixture(scope="module")
def jax_answers(request):
    tp = request.module.TP
    mesh = jmake_mesh(dp=1, tp=tp, devices=jax.devices()[:tp])
    return {"single": _requests(jengine.build_engine(random_tiny=True),
                                JBatchScheduler),
            "mesh": _requests(jengine.build_engine(random_tiny=True,
                                                   mesh=mesh),
                              JBatchScheduler)}


def _port_engine(cfg, np_params):
    tok = ByteTokenizer()
    return tengine.Engine(cfg, from_jax_params(np_params, cfg), tok,
                          eos_ids=(tok.eos_token_id,))


@pytest.fixture(scope="module")
def port_answers(tiny_weights, lively_weights):
    """The single-rank port engine's answers to the world's requests."""
    e = _port_engine(tengine.tiny_config(), tiny_weights)
    out = {"worker": e.generate(e.build_prompt(tw.TP_PROMPTS["chat"]),
                                max_new_tokens=8)[0]}
    e = _port_engine(tw.lively_config(), lively_weights)
    image = tw.tp_image()
    prompt = e.build_prompt("describe the picture")
    with torch.inference_mode():
        inp = e.prepare(prompt, image)
        cache = e.new_cache(1, inp["ids"].shape[1])
        out["logits"], _ = e.call("prefill", inp["images"], inp["ids"],
                                  inp["lens"], inp["starts"], cache)
    out.update(
        chat=e.chat("describe the picture", image, max_new_tokens=12)[0],
        beam=e.generate_beam(prompt, image, num_beams=2, max_new_tokens=8)[0],
        video=tw.tp_video(e))
    out["serving"] = [
        e.generate(e.build_prompt(q, tw.TP_SYSTEM), image,
                   max_new_tokens=n)[0] for q, n in tw.TP_SERVE]
    e = _port_engine(tw.lively_config("int8"), lively_weights)
    out["int8"] = e.chat("describe the picture", image, max_new_tokens=12)[0]
    out["int8_batch"] = tw.tp_batch(e, tw.TP_PROMPTS["batch"])
    return out


def _rank0(world, name):
    res = world[name][0]
    assert "error" not in res, res["error"]
    return res


def test_tp_pieces_really_split(world, request):
    """Each rank holds its q / o / gate / up / down columns; k / v split
    where the kv heads divide tp, else whole, and its caches hold the kv
    heads its q heads read; the vocab splits where tp divides 258."""
    tp = request.module.TP
    for name, dense_head in (("tp_engine", None), ("tp_lively", "pieces")):
        for r in range(tp):
            res = world[name][r]
            assert "error" not in res, res["error"]
            got = res[dense_head] if dense_head else res
            sh = got["shapes"]
            assert sh["q"] == (64, 64 // tp) and sh["o"] == (64 // tp, 64)
            assert sh["gate"] == sh["up"] == (64, 128 // tp)
            assert sh["down"] == (128 // tp, 64)
            kv_split = 2 % tp == 0
            assert sh["k"] == sh["v"] == (64, 32 // tp if kv_split else 32)
            want_heads = [r] if tp == 2 else [r // 2]
            assert got["kv_heads"] == want_heads
            assert got["cache_heads"] == 1
            assert sh["embed"] == ((258 // tp, 64) if 258 % tp == 0
                                   else (258, 64))


@pytest.mark.parametrize("what", ["chat", "stream", "spec", "batch",
                                  "batch_persist"])
def test_tp_matches_jax_engines(world, jax_answers, what):
    """tests/test_engine_tp.py's requests: the port's TP engine gives the
    JAX single-device engine's and the JAX TP engine's greedy ids; its
    scheduler also with the JAX scheduler's defaults (``batch_persist``:
    persistent view, pipelined 2 deep)."""
    got = _rank0(world, "tp_engine")[what]
    assert jax_answers["single"][what] == jax_answers["mesh"][what]
    assert got == jax_answers["single"][what], (got,
                                                jax_answers["single"][what])


def test_tp_persistent_view_ran(world):
    """The persistent-view batch gathered views, synced the pool and
    dispatched pipelined groups on rank 0, the followers making each call
    on their own kv heads (their outputs held to rank 0's in
    test_every_rank_computes_rank0s_outputs)."""
    c = _rank0(world, "tp_engine")["persist_counters"]
    assert c["view_gathers"] >= 1 and c["pipelined_groups"] >= 1, c
    names = {n for n, _ in world["tp_engine"][1]["log"]}
    assert {"gather_view", "decode_chunk"} <= names, names


def test_tp_worker_streams_the_serial_answer(world, port_answers):
    """A ModelWorker over the TP engine streams the serial single-rank
    engine's answer."""
    msgs = _rank0(world, "tp_engine")["worker"]
    assert msgs and all(m["error_code"] == 0 for m in msgs), msgs
    assert msgs[-1]["text"] == port_answers["worker"]


@pytest.mark.parametrize("what", ["chat", "beam", "video"])
def test_tp_matches_single_rank_port(world, port_answers, what):
    got = _rank0(world, "tp_lively")["main"][what]
    assert got == port_answers[what], (got, port_answers[what])


def test_tp_int8_kv_matches_single_rank_port(world, port_answers):
    """An int8-KV engine's chat, and its scheduler's dense per-batch path
    (2 requests), give the single-rank engine's ids."""
    got = _rank0(world, "tp_lively")["int8"]
    assert got["chat"] == port_answers["int8"]
    assert got["batch"] == port_answers["int8_batch"]


def test_tp_scheduler_prefix_chunks_and_spec(world, port_answers):
    """A BatchScheduler over the TP engine with the prefix cache, 8-token
    chunked admission and spec chunks (pool over each rank's kv heads)
    gives each request the serial engine's ids, through a spec chunk, a
    chunked admission and prefix hits."""
    got = _rank0(world, "tp_lively")["main"]["serving"]
    assert got["texts"] == port_answers["serving"]
    c = got["counters"]
    assert c["prefix_hits"] >= 2 and c["chunked_admissions"] >= 1, c
    assert sum(v for k, v in c.items() if k.startswith("disp_spec@")), c


def test_tp_prefill_logits_match_single_rank(world, port_answers):
    got = _rank0(world, "tp_lively")["main"]["logits"]
    want = port_answers["logits"]
    err = float((got - want).abs().max())
    assert err <= LOGITS_REL * float(want.abs().max()), err


def _same(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("where", ["tp_engine", "tp_lively/main",
                                   "tp_lively/int8"])
def test_every_rank_computes_rank0s_outputs(world, request, where):
    """Every device call a follower made gave rank 0's outputs bit for bit:
    the same calls in the same order, the same tokens greedy and sampled
    (the generator's state crosses with each call), the same logits."""
    name, _, part = where.partition("/")
    logs = [world[name][r][part]["log"] if part else world[name][r]["log"]
            for r in range(request.module.TP)]
    names = [n for n, _ in logs[0]]
    assert "decode_chunk" in names and "prefill" in names
    for r in range(1, len(logs)):
        assert [n for n, _ in logs[r]] == names
        for i, ((n, a), (_, b)) in enumerate(zip(logs[0], logs[r])):
            assert _same(a, b), (r, i, n)


def test_tp_sampled_request_ran(world):
    """The sampled requests decoded (their call logs are held to rank 0's
    in test_every_rank_computes_rank0s_outputs)."""
    assert _rank0(world, "tp_engine")["sampled"]
    assert _rank0(world, "tp_lively")["main"]["sampled"]
