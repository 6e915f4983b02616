"""The port's tensor-parallel engine in a 2-rank gloo world on the CPU (the
cases of tests/torch_engine_tp_cases.py at tp = 2: q / k / v, the MLP and
the 258-id vocab all split), then what needs no world or its own: the kv
heads each rank keeps, a world of one against the engine without a mesh,
the layout's refusals, the lockstep channel's, and ``predict --tp 2``
under torchrun."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch import engine as tengine
from fastvlm_tpu_torch import predict
from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer
from fastvlm_tpu_torch.ops import quant
from fastvlm_tpu_torch.ops.kv_cache import KVCache
from fastvlm_tpu_torch.parallel.sharding import kv_heads
from fastvlm_tpu_torch.serve.batcher import BatchScheduler
from fastvlm_tpu_torch.utils.convert import from_jax_params

from torch_engine_tp_cases import *  # noqa: F401,F403
from torch_tiny import one_rank_world, one_torch_thread  # noqa: F401

TP = 2
# after the shared ones: the lockstep channel's refusal, then a rank that
# leaves the world
MORE_SCENARIOS = ("tp_unknown_call", "tp_dead_follower")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_follower_refuses_an_unknown_call(world):
    """A call outside the registry reaching a follower raises there."""
    assert "unknown call 'forward'" in world["tp_unknown_call"][1]["raised"]


def test_a_dead_follower_fails_the_leader(world):
    """Rank 1 leaves the world: rank 0's next request raises at once (the
    gloo pair closes) instead of hanging."""
    res = world["tp_dead_follower"][0]
    assert res["raised"] and res["raised"].startswith("RuntimeError")
    assert res["seconds"] < 60, res


def _decoder(hq, hkv):
    return tcfg.Qwen2Config(num_heads=hq, num_kv_heads=hkv)


@pytest.mark.parametrize("hq,hkv,tp,want", [
    (4, 2, 2, [[0], [1]]),                  # the tiny decoder, kv split
    (4, 2, 4, [[0], [0], [1], [1]]),        # one q head a rank
    (14, 2, 2, [[0], [1]]),                 # Qwen2-0.5B: 7/1 a rank
    (28, 4, 4, [[0], [1], [2], [3]]),       # Qwen2-7B at tp 4: 7/1
    (28, 4, 2, [[0, 1], [2, 3]]),           # Qwen2-7B at tp 2: 14/2
    (8, 2, 4, [[0], [0], [1], [1]]),        # 2 q heads on one kv head
    (12, 4, 3, [[0, 0, 0, 1], [1, 2], [2, 3, 3, 3]]),  # uneven ends
    (14, 2, 4, [[0, 1]] * 4),               # heads do not divide: whole
])
def test_kv_heads(hq, hkv, tp, want):
    """The kv heads each rank keeps: its slice where they divide tp; else
    the ones its q heads read, once each where they form equal groups (the
    decode kernels need Hq_local % Hkv_local == 0), one a q head where
    they do not; every kv head where the q heads do not divide tp."""
    assert [kv_heads(_decoder(hq, hkv), tp, r) for r in range(tp)] == want


def _tiny(np_weights, mesh=None):
    cfg = tengine.tiny_config()
    tok = ByteTokenizer()
    return tengine.Engine(cfg, from_jax_params(np_weights, cfg), tok,
                          eos_ids=(tok.eos_token_id,), mesh=mesh)


def test_world_of_one_equals_no_mesh(one_rank_world, tiny_weights):
    """Engine(mesh=make_mesh(1, 1)) gives the engine without a mesh's ids
    bit for bit, through the engine's paths and the scheduler (the CPU
    counterpart of chip_smoke.py's NCCL world of one)."""
    plain = _tiny(tiny_weights)
    meshed = _tiny(tiny_weights, one_rank_world)
    assert meshed.lockstep is not None and meshed.group is not None
    image = np.random.RandomState(0).randint(0, 256, (256, 256, 3),
                                             dtype=np.uint8)
    answers = []
    for e in (plain, meshed):
        got = [e.chat("hello mesh", image, max_new_tokens=12)[0],
               e.generate_spec(e.build_prompt("a b a b a b a b"), image,
                               max_new_tokens=12)[0],
               e.generate_beam(e.build_prompt("hello"), image, num_beams=2,
                               max_new_tokens=6)[0]]
        sched = BatchScheduler(e, page_size=16, pool_tokens=2048)
        try:
            last = None
            for last in sched.submit(e.build_prompt("alpha mesh"), image,
                                     max_new_tokens=6):
                pass
            got.append(last["text"])
        finally:
            sched.shutdown()
        answers.append(got)
    meshed.close()
    assert answers[1] == answers[0]


def test_quantized_tree_under_a_mesh_raises(one_rank_world, tiny_weights):
    """A reference gap kept: JAX's shard_vlm maps w / b specs over the
    decoder, so a tree with w_q / scale leaves fails; the port refuses it
    with a message instead."""
    e = _tiny(tiny_weights)
    params = {**e.params,
              "decoder": quant.quantize_decoder(e.params["decoder"], bits=8)}
    with pytest.raises(ValueError, match="quantized leaves"):
        tengine.Engine(e.cfg, params, e.tokenizer, mesh=one_rank_world)


def test_mesh_on_another_device_type_raises(tiny_weights):
    """CPU params on a mesh of the card (or the reverse) raise: there is no
    quiet path."""
    e = _tiny(tiny_weights)
    mesh = types.SimpleNamespace(device_type="cuda",
                                 mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros((1, 1)))
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        tengine.Engine(e.cfg, e.params, e.tokenizer, mesh=mesh)


def test_lockstep_refuses_a_view_of_a_cache(one_rank_world, tiny_weights):
    """A rank-local tensor crosses by handle only: a view of a cache's
    planes (other kv heads on every rank) raises, and so does a call
    outside the registry."""
    e = _tiny(tiny_weights, one_rank_world)
    try:
        cache = e.new_cache(1, 8)
        view = KVCache(k=cache.k[:, :, :4], v=cache.v[:, :, :4],
                       lengths=cache.lengths)
        tok = torch.zeros((1,), dtype=torch.int32)
        with torch.inference_mode():
            with pytest.raises(ValueError, match="rank-local"):
                e.call("decode_step", tok, view)
            with pytest.raises(ValueError, match="unknown call"):
                e.call("forward", cache)
            logits, _ = e.call("decode_step", tok, cache)
        assert logits.shape == (1, 258)
    finally:
        e.close()


def _torchrun_predict(tmp_path, tp, extra=()):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    args = ["-m", "fastvlm_tpu_torch.predict", "--random-weights", "--device",
            "cpu", "--tp", str(tp), "--max-new-tokens", "8", "--temperature",
            "0", *extra]
    if tp > 1:
        args = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(tp), "--log-dir",
                str(tmp_path / "logs"), "--redirects", "3", "--tee", "3"] \
            + args
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


def test_predict_tp2_under_torchrun(tmp_path):
    """``predict --tp 2`` under torchrun: rank 0 prints ``--tp 1``'s text,
    the follower prints nothing."""
    one = _torchrun_predict(tmp_path, 1)
    assert one.returncode == 0, one.stderr[-3000:]
    two = _torchrun_predict(tmp_path, 2)
    assert two.returncode == 0, two.stdout[-3000:] + two.stderr[-3000:]
    # torchrun replays each rank's output a line at a time, "[default<r>]:"
    lines = [line.split("]:", 1) for line in two.stdout.splitlines()
             if line.startswith("[default")]
    by_rank = {}
    for tag, text in lines:
        by_rank.setdefault(tag, []).append(text)
    assert by_rank.get("[default0") == one.stdout.splitlines(), two.stdout
    assert "[default1" not in by_rank, two.stdout


def test_predict_tp_must_equal_the_world(monkeypatch, capsys):
    """Under a world of 2, ``--tp 4`` is refused with the torchrun
    message."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert predict.main(["--random-weights", "--device", "cpu", "--tp",
                         "4"]) == 2
    err = capsys.readouterr().err
    assert "torchrun --nproc-per-node 4" in err and "WORLD_SIZE is 2" in err
