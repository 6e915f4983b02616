"""The Mellum2 family (``decoders/mellum2.py``) at a CPU size
(``data/tiny-mellum2.json``: one period of three sliding-window layers and
a full YaRN layer, 8 experts top 2): the port served through the harness's
tiny burst cells is correct against its own family's reference, and not
against the dense Qwen2 family's; its reference's expert layer agrees with
transformers' Qwen3-MoE block; the two new per-layer readers read nothing
outside a traced run.

The tiny cell's limit (0.15) is wider than the Mistral cell's (0.012): with
2 of 8 experts a token, a bf16 near tie between the 2nd and 3rd router
probabilities sends a token to another expert in the port than in the
float32 reference, which moves half of that layer's output for that
token. The port read 0.042 and 0.051 in the two cells (float32 served: 0.0
to rounding; all 8 experts routed: 0.004); the dense family reads 2.6."""

import json
import os
import time

import pytest
import torch

from port_bench import family, harness, loadgen, weights

DATA = os.path.join(os.path.dirname(__file__), "data")
CELLS = ("vqa-shared", "vqa-unshared")
TINY = "port_bench/tests/data/tiny-mellum2.json"


def _bench(cfg_file):
    real = harness.load_json(os.path.join(harness.REPO, "BENCHMARK.json"))
    return {"configs": [{"name": "c", "file": cfg_file}],
            "workloads": [{"name": f"c.{c}", "config": "c",
                           "traffic": f"tiny-{c}", "chips": 1}
                          for c in CELLS],
            "end_to_end": [{k: v for k, v in m.items() if k != "workloads"}
                           for m in real["end_to_end"]],
            "per_layer": []}


def _run(cfg_file, cell, seed=20260102):
    torch.set_num_threads(2)
    served = harness.serve(_bench(cfg_file), f"c.{cell}", seed, 3.0, False,
                           t_process=time.perf_counter(), device="cpu",
                           traffic_dir=os.path.join(DATA, "traffic"),
                           log=lambda m: None)
    return harness.judge(served, seed, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_the_mellum2_family_is_checked_against_its_own_reference(cell,
                                                                 tmp_path):
    own = _run(TINY, cell)
    assert own["correct"], own["limits"]
    assert own["failed"] == 0
    cfg = harness.load_json(os.path.join(harness.REPO, TINY))
    path = tmp_path / "tiny-mellum2-dense.json"
    path.write_text(json.dumps(dict(cfg, decoder=family.DEFAULT)))
    other = _run(str(path), cell)
    assert not other["correct"], other["limits"]
    assert other["limits"]["mean_logit_gap"]["value"] > \
        10 * other["limits"]["mean_logit_gap"]["limit"]


def test_the_reference_expert_layer_is_qwen3_moe():
    from transformers import Qwen3MoeConfig
    from transformers.models.qwen3_moe.modeling_qwen3_moe import (
        Qwen3MoeSparseMoeBlock)

    cfg = harness.load_json(os.path.join(harness.REPO, TINY))
    tree = weights.draw(cfg, 5, "cpu", torch.float32)
    lp = tree["decoder"]["layers"][0]
    c = Qwen3MoeConfig(hidden_size=cfg["hidden_size"],
                       moe_intermediate_size=cfg["moe_intermediate_size"],
                       num_experts=cfg["num_experts"],
                       num_experts_per_tok=cfg["num_experts_per_tok"],
                       norm_topk_prob=True)
    block = Qwen3MoeSparseMoeBlock(c).eval()
    inter = cfg["moe_intermediate_size"]
    with torch.no_grad():
        block.gate.weight.copy_(lp["router"]["w"].t())
        for e, m in enumerate(block.experts):
            m.gate_proj.weight.copy_(lp["experts"]["gateup"][e][:, :inter].t())
            m.up_proj.weight.copy_(lp["experts"]["gateup"][e][:, inter:].t())
            m.down_proj.weight.copy_(lp["experts"]["down"][e].t())
        y = torch.randn(50, cfg["hidden_size"],
                        generator=torch.Generator().manual_seed(1))
        want = block(y[None])[0][0]
        got = family.of(cfg).Reference(cfg, tree).experts(y, lp)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["k5_roofline.burst",
                                  "step.moe_share.burst"])
def test_the_new_readers_read_nothing_without_a_trace(name):
    cfg = harness.load_json(os.path.join(harness.REPO, TINY))
    ctx = harness.Ctx({"name": "c"}, cfg, {}, [], 0.0, 1.0, "cpu")
    assert harness.metric_reader(name)(ctx) is None
    # a dense configuration's family has no K5 bound either
    assert loadgen.module("metrics", name).read(
        harness.Ctx({"name": "c"}, {}, {}, [], 0.0, 1.0, "cpu")) is None
