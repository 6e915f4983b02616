"""Random weights of a configuration, drawn on the device from the seed.

The tree is in the layout the port takes (the FastViTHD inference form,
linears as (in, out) matrices, the decoder's q / k / v and gate / up
apart, layer scales unfolded) and in the dtype the configuration is
served in. Every random leaf is a view of one buffer drawn by a single
``torch.randn`` call on a generator seeded with the seed, so the same seed
gives the same weights; the reference draws them again after the program
is gone, rather than keeping a copy. The tower and the projector are drawn
here; the decoder's leaves by its family's ``draw`` (``family.py``), into
the same ``Plan``, after the projector's.

How each leaf is drawn (the configuration's ``assumed`` repeats it):
  * tower convs and linears: N(0, 1 / fan_in), and a unit centre tap on
    the depthwise convs that stand for x + conv(x) (RepMixer's mixer,
    RepCPE); at the 0.02 std of a fresh FastViTHD the tower's features
    are exactly 0 by stage 2, so the image path would carry nothing;
  * tower layer scales: U(LS_LOW, LS_HIGH), so the ConvFFN (kernel K1)
    moves the features by a visible amount (1e-5 at initialisation leaves
    it nearly out of the result);
  * projector and decoder products: N(0, r), r the configuration's
    ``initializer_range`` (0.02 for Qwen2), the q / k / v biases too;
    norms 1 + N(0, r); biases of the tower 0;
  * but the decoder's q and k weights at N(0, SCORE_STD / hidden)
    (``qk_gain``), so an attention score q.k / sqrt(d) over unit-RMS
    inputs has a std of SCORE_STD: at r alone it is r^2 * hidden (0.36 at
    0.5B), attention is uniform over hundreds of keys, and greedy decoding
    repeats one token from the first step (on the card, 1 distinct token
    of 32 at two seeds of three), which leaves the check nothing to
    compare; at a std of 3 attention picks positions, as trained attention
    does, and the 32 tokens were all distinct.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from port_bench import family

LS_LOW, LS_HIGH = 0.05, 0.5
SCORE_STD = 3.0


class Plan:
    """Leaves to draw: each random leaf takes the next slice of the buffer
    and is scaled by its own factor afterwards."""

    def __init__(self):
        self.numel = 0
        self.leaves: List[Tuple[dict, str, tuple, str, float]] = []

    def add(self, node: dict, key: str, shape: tuple, kind: str,
            scale: float = 1.0):
        """kind: "normal" (scale * N(0, 1)), "tap" (the same plus a unit
        centre tap), "uniform" (U(LS_LOW, LS_HIGH) from the buffer's
        normal draws), "one" (1 + scale * N(0, 1)), "zero"."""
        self.leaves.append((node, key, shape, kind, scale))
        if kind != "zero":
            self.numel += _numel(shape)


def qk_gain(hidden: int, std: float) -> float:
    """The ``gain`` on ``std`` that draws a decoder's q and k weights at
    N(0, SCORE_STD / hidden), for ``linear``."""
    return (SCORE_STD / hidden) ** 0.5 / std


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _conv(plan, node, key, cout, cin, k, tap=False):
    p = node.setdefault(key, {})
    plan.add(p, "w", (cout, cin, k, k), "tap" if tap else "normal",
             1.0 / (cin * k * k) ** 0.5)
    plan.add(p, "b", (cout,), "zero")
    return p


def linear(plan, node, key, cin, cout, std, bias=True, bias_kind="zero",
           gain=1.0):
    """``node[key]``: an (in, out) weight at N(0, (gain * std)^2) and, with
    ``bias``, an (out,) bias of ``bias_kind`` at ``std``."""
    p = node.setdefault(key, {})
    plan.add(p, "w", (cin, cout), "normal", gain * std)
    if bias:
        plan.add(p, "b", (cout,), bias_kind, std)
    return p


def _tower(plan, v: dict) -> dict:
    tree: Dict[str, Any] = {}
    c0 = v["embed_dims"][0]
    stem = [{}, {}, {}]
    _conv(plan, stem[0], "c", c0, 3, 3)
    _conv(plan, stem[1], "c", c0, 1, 3)
    _conv(plan, stem[2], "c", c0, c0, 1)
    tree["stem"] = [s["c"] for s in stem]
    stages = []
    dims = v["embed_dims"]
    for i, (n, c) in enumerate(zip(v["layers"], dims)):
        st: Dict[str, Any] = {}
        if v["pos_embs"][i]:
            _conv(plan, st, "cpe", c, 1, v["pos_emb_kernel"], tap=True)
        h = c * v["mlp_ratio"]
        blocks = []
        for _ in range(n):
            bp: Dict[str, Any] = {}
            if v["token_mixers"][i] == "repmixer":
                _conv(plan, bp, "mixer", c, 1, v["repmixer_kernel"], tap=True)
                scales = ["ls"]
            else:
                plan.add(bp, "norm_scale", (c,), "one", 0.02)
                plan.add(bp, "norm_bias", (c,), "zero")
                linear(plan, bp, "qkv", c, 3 * c, 1.0 / c ** 0.5, bias=False)
                linear(plan, bp, "proj", c, c, 1.0 / c ** 0.5)
                scales = ["ls1", "ls2"]
            ffn: Dict[str, Any] = {}
            _conv(plan, ffn, "dw", c, 1, v["ffn_kernel"])
            linear(plan, ffn, "fc1", c, h, 1.0 / c ** 0.5)
            linear(plan, ffn, "fc2", h, c, 1.0 / h ** 0.5)
            bp["ffn"] = ffn
            for s in scales:
                plan.add(bp, s, (c,), "uniform")
            blocks.append(bp)
        st["blocks"] = blocks
        if i + 1 < len(dims):
            down: Dict[str, Any] = {}
            _conv(plan, down, "lk", dims[i + 1], 1, v["down_patch_size"])
            _conv(plan, down, "pw", dims[i + 1], dims[i + 1], 1)
            st["down"] = down
        stages.append(st)
    tree["stages"] = stages
    c_out = int(dims[-1] * v["cls_ratio"])
    rd = int(c_out * v["se_rd_ratio"])
    exp = _conv(plan, tree, "conv_exp", c_out, 1, 3)
    se: Dict[str, Any] = {}
    plan.add(se, "reduce_w", (rd, c_out, 1, 1), "normal", 1.0 / c_out ** 0.5)
    plan.add(se, "reduce_b", (rd,), "zero")
    plan.add(se, "expand_w", (c_out, rd, 1, 1), "normal", 1.0 / rd ** 0.5)
    plan.add(se, "expand_b", (c_out,), "zero")
    exp["se"] = se
    return tree


def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """{"vision", "projector", "decoder"} weights of ``cfg`` from ``seed``."""
    plan = Plan()
    tree = {"vision": _tower(plan, cfg["vision"])}
    proj: Dict[str, Any] = {}
    layers = [{}, {}]
    linear(plan, layers[0], "l", cfg["mm_hidden_size"], cfg["hidden_size"],
           cfg["initializer_range"])
    linear(plan, layers[1], "l", cfg["hidden_size"], cfg["hidden_size"],
           cfg["initializer_range"])
    proj["layers"] = [x["l"] for x in layers]
    tree["projector"] = proj
    tree["decoder"] = family.of(cfg).draw(plan, cfg)

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    buf = torch.randn(plan.numel, generator=gen, device=device, dtype=dtype)
    at = 0
    for node, key, shape, kind, scale in plan.leaves:
        if kind == "zero":
            node[key] = torch.zeros(shape, device=device, dtype=dtype)
            continue
        n = _numel(shape)
        x = buf[at:at + n].view(shape)
        at += n
        if kind == "uniform":  # the normal draw through its CDF
            x.copy_(LS_LOW + (LS_HIGH - LS_LOW) * 0.5
                    * (1 + torch.erf(x.float() / 2 ** 0.5)))
        else:
            x.mul_(scale)
            if kind == "one":
                x.add_(1.0)
            elif kind == "tap":
                x[:, 0, shape[2] // 2, shape[3] // 2] += 1.0
        node[key] = x
    return tree

