"""Operation and byte counts of K1, the tower and the decoder,
against hand counts and against torch's own operation counter at tiny
shapes."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import family, flops, weights

DATA = os.path.join(os.path.dirname(__file__), "data")
PEAK = {"bf16_flops": 1e12, "hbm_bytes": 1e9}


def tiny(name="tiny.json"):
    with open(os.path.join(DATA, name)) as f:
        return json.load(f)


def test_k1_call_by_hand():
    # rows 10, c 4, hidden 16: fc1 and fc2 are 10*4*16 multiply-adds each
    f, b = flops.k1_call(10, 4)
    assert f == 2 * 2 * 10 * 4 * 16
    # t, res and out (3 * 10 * 4), w1 and w2 (2 * 64), b1 (16), b2 (4)
    assert b == 2 * (120 + 128 + 16 + 4)
    assert flops.bound_s(f, b, PEAK) == pytest.approx(b / 1e9)


def test_k1_encode_bound_sums_44_calls_at_1024():
    cfg = json.load(open(os.path.join(os.path.dirname(DATA), "..", "configs",
                                      "fastvlm-1.5b.json")))
    stages = flops.tower_stages(cfg)
    assert [n for n, *_ in stages] == [2, 12, 24, 4, 2]
    assert [r for _, _, r, _ in stages] == [65536, 16384, 4096, 1024, 256]
    h100 = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    one = flops.k1_encode_bound_s(cfg, 1, h100)
    assert 0.40e-3 < one < 0.47e-3  # 0.437 ms an image in PERF.md's table
    assert flops.k1_encode_bound_s(cfg, 8, h100) < 8 * one


def test_tower_flops_match_torch_counter():
    cfg = tiny()
    tree = weights.draw(cfg, 1, "cpu", torch.float32)
    ref = family.of(cfg).Reference(cfg, tree)
    img = torch.zeros(cfg["vision"]["image_size"],
                      cfg["vision"]["image_size"], 3, dtype=torch.uint8)
    with FlopCounterMode(display=False) as fc:
        ref.tower(img)
    counted = fc.get_total_flops()
    # torch counts the SE's 1x1 convs at one pixel and the attention's two
    # products the same way: the totals agree
    assert flops.tower_flops(cfg) == pytest.approx(counted, rel=1e-9)


# the Mistral family's 40-key window: 50 tokens, and a token after 100
@pytest.mark.parametrize("name,t,window", [("tiny.json", 12, None),
                                           ("tiny-mistral.json", 50, 40)])
def test_decoder_flops_match_torch_counter_with_causal_keys(name, t, window):
    cfg = tiny(name)
    fam = family.of(cfg)
    tree = weights.draw(cfg, 1, "cpu", torch.float32)
    ref = fam.Reference(cfg, tree)
    x = torch.zeros(t, cfg["hidden_size"])
    with FlopCounterMode(display=False) as fc:
        h = ref.hidden(x)
        ref.head(h[-1:])
    counted = fc.get_total_flops()
    hq, d = cfg["num_attention_heads"], cfg["hidden_size"] // \
        cfg["num_attention_heads"]
    layers = cfg["num_hidden_layers"]
    # the reference's attention products are full (t x t); the count is
    # of the causal keys a token sees, the latest ``window`` of them
    seen = sum(min(i + 1, window or t) for i in range(t))
    full = layers * 2 * 2 * hq * d * t * t
    causal = layers * 2 * 2 * hq * d * seen
    assert fam.flops(cfg, t) == pytest.approx(counted - full + causal,
                                              rel=1e-9)
    # a token after 7 cached ones sees 8 keys, its own included; after
    # 100, the window's
    for cached in (7, 100):
        one = fam.flops(cfg, 1, cached)
        assert one - fam.flops(cfg, 1, 0) == pytest.approx(
            layers * 4 * hq * d * (min(cached + 1, window or cached + 1) - 1))


def test_projector_by_hand():
    cfg = tiny()
    n = flops.image_tokens(cfg)
    assert n == 16
    assert flops.projector_flops(cfg) == 2 * n * (256 * 64 + 64 * 64)
