"""Mellum2 (three sliding-window layers to one full YaRN layer, routed
experts) in the port, on the CPU, against the plain float32 reference
``tests/mellum2_reference.py``: the config read from the benchmark's file,
YaRN against transformers, the expert block against transformers'
Qwen3-MoE block, the experts' plain version against a loop over tokens,
prefill / continued prefill / paged decode and the scheduler's served
tokens against the reference's full forward at a tiny Mellum-shaped size,
the windowed K4 / K3 routes and their plain versions, the paths that
refuse such a decoder, and the counts the benchmark keeps beside it."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

import mellum2_reference as ref
from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.engine import Engine
from fastvlm_tpu_torch.models import builder, qwen2, vlm
from fastvlm_tpu_torch.ops.cuda import experts as k5
from fastvlm_tpu_torch.ops.cuda import prefill_attention as k4
from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
    paged_decode_attention_reference)
from fastvlm_tpu_torch.ops.kv_cache import init_paged_cache
from fastvlm_tpu_torch.serve import batcher
from torch_tiny import IdTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "port_bench", "configs", "mellum2-12b-a2.5b.json")
WINDOW = 16


def hf_dict(top_k=2, experts=8, layers=4, head_dim=16):
    """A tiny Mellum-shaped config.json: one period of three sliding
    layers and a full one, ``experts`` experts top ``top_k``."""
    full = json.load(open(CONFIG))
    kinds = (["sliding_attention"] * 3 + ["full_attention"]) * (layers // 4)
    rope = json.loads(json.dumps(full["rope_parameters"]))
    rope["full_attention"]["original_max_position_embeddings"] = 32
    return dict(model_type="mellum", vocab_size=258, hidden_size=64,
                num_hidden_layers=layers, num_attention_heads=4,
                num_key_value_heads=2, head_dim=head_dim,
                intermediate_size=128, moe_intermediate_size=32,
                num_experts=experts, num_experts_per_tok=top_k,
                norm_topk_prob=True, rms_norm_eps=1e-6,
                tie_word_embeddings=False, sliding_window=WINDOW,
                use_sliding_window=True, max_window_layers=0,
                layer_types=kinds, mlp_layer_types=["sparse"] * layers,
                rope_parameters=rope, max_position_embeddings=131072)


def vlm_config(d, dtype="float32"):
    dec = builder.build_decoder_config(d, param_dtype=dtype,
                                       compute_dtype=dtype)
    vision = tcfg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                                embed_dims=(8, 16, 32, 64, 128),
                                image_size=128, attn_head_dim=16,
                                param_dtype=dtype, compute_dtype=dtype)
    return tcfg.FastVLMConfig(
        vision=vision, decoder=dec,
        projector=tcfg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                       hidden_size=64))


def tree(cfg, seed=0):
    """Unfused weights: the init's shapes, the decoder's matrices at
    N(0, 0.2) (at 0.02 a tiny decoder echoes its input), norms near 1."""
    gen = torch.Generator().manual_seed(seed)
    params = vlm.init(gen, cfg)
    dt = tcfg.resolve_dtype(cfg.decoder.param_dtype)

    def redraw(node, name=""):
        if isinstance(node, dict):
            return {k: redraw(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [redraw(v, name) for v in node]
        if name.startswith("ln") or name == "final_norm":
            return (1 + 0.02 * torch.randn(node.shape, generator=gen)).to(dt)
        if node.dim() >= 2:
            return (0.2 * torch.randn(node.shape, generator=gen)).to(dt)
        return node
    params["decoder"] = redraw(params["decoder"])
    return params


def fused(params, cfg):
    return {**params, "decoder": qwen2.fuse_decoder_params(params["decoder"],
                                                           cfg.decoder)}


def reference_logits(params, d, embeds):
    return ref.logits(params["decoder"], d, embeds)


# ------------------------------------------------------------------ config


def test_build_decoder_config_reads_the_mellum2_file():
    d = json.load(open(CONFIG))
    dec = builder.build_decoder_config(d)
    assert (dec.hidden_size, dec.num_layers, dec.num_heads, dec.num_kv_heads,
            dec.head_dim, dec.vocab_size) == (2304, 28, 32, 4, 128, 98304)
    assert not dec.qkv_bias and not dec.tie_word_embeddings
    assert dec.rope_theta == 500000 and dec.attn_window == 1024
    assert dec.layer_types == tuple(d["layer_types"])
    assert [dec.window_of(i) for i in range(8)] == [1024, 1024, 1024, None] * 2
    assert [dec.full_layer(i) for i in range(4)] == [False] * 3 + [True]
    rope = dec.full_rope
    assert (rope.rope_type, rope.theta, rope.factor,
            rope.original_max_position_embeddings, rope.beta_fast,
            rope.beta_slow) == ("yarn", 500000, 16, 8192, 32, 1)
    assert rope.attention_factor == pytest.approx(1.2772588722239782)
    assert (dec.num_experts, dec.num_experts_per_tok,
            dec.moe_intermediate_size, dec.norm_topk_prob) == (64, 8, 896,
                                                               True)
    assert dec.mlp_layer_types is None and all(dec.sparse(i)
                                               for i in range(28))
    assert dec.layered
    # 12.15 B parameters: the scheduler's defaults for >= 1e9
    assert batcher._decoder_param_count(dec) == pytest.approx(12.15e9,
                                                              rel=0.01)


@pytest.mark.parametrize("mwl,want", [
    (0, ["sliding_attention"] * 4),
    (2, ["full_attention"] * 2 + ["sliding_attention"] * 2),
    (4, None),
])
def test_qwen2_windows_the_layers_from_max_window_layers(mwl, want):
    """A qwen2 config.json with ``use_sliding_window``: transformers
    windows the layers from ``max_window_layers`` on; all of them is one
    window everywhere, none is no window."""
    d = dict(model_type="qwen2", vocab_size=64, hidden_size=32,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, intermediate_size=64, sliding_window=8,
             use_sliding_window=True, max_window_layers=mwl)
    dec = builder.build_decoder_config(d)
    if want is None:
        assert dec.attn_window is None and dec.layer_types is None
    elif len(set(want)) == 1:
        assert dec.attn_window == 8 and dec.layer_types is None
    else:
        assert dec.layer_types == tuple(want)
        assert [dec.window_of(i) for i in range(4)] == [None, None, 8, 8]
    assert dec.full_rope is None


def test_layer_types_from_the_file_win_and_agreeing_kinds_collapse():
    d = hf_dict()
    dec = builder.build_decoder_config(d)
    assert dec.layer_types == tuple(d["layer_types"])
    d["layer_types"] = ["sliding_attention"] * 4
    d["rope_parameters"] = {"rope_type": "default", "rope_theta": 1e4}
    dec = builder.build_decoder_config(d)
    assert dec.layer_types is None and dec.attn_window == WINDOW
    assert dec.rope_theta == 1e4
    with pytest.raises(ValueError):
        builder.build_decoder_config(dict(d, layer_types=["linear"] * 4))


# -------------------------------------------------------------------- YaRN


def test_yarn_matches_transformers():
    from transformers import PretrainedConfig
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS

    p = json.load(open(CONFIG))["rope_parameters"]["full_attention"]
    hf = PretrainedConfig(rope_theta=p["rope_theta"], head_dim=128,
                          hidden_size=2304, num_attention_heads=32,
                          max_position_embeddings=131072,
                          rope_scaling={k: v for k, v in p.items()
                                        if k != "rope_theta"})
    want, factor = ROPE_INIT_FUNCTIONS["yarn"](hf, "cpu")
    got, scale = ref.yarn_inv_freq(128, p["rope_theta"], p["factor"],
                                   p["original_max_position_embeddings"],
                                   p["beta_fast"], p["beta_slow"],
                                   p["attention_factor"])
    torch.testing.assert_close(got, want.float(), rtol=1e-6, atol=0)
    assert scale == pytest.approx(factor)
    # without the file's factor, the paper's 0.1 ln(s) + 1
    hf.rope_scaling.pop("attention_factor")
    _, inferred = ROPE_INIT_FUNCTIONS["yarn"](hf, "cpu")
    assert ref.yarn_inv_freq(128, 5e5, 16, 8192)[1] == pytest.approx(inferred)
    # the port's table
    port, port_scale = qwen2.rope_inv_freq(
        128, builder.build_decoder_config(json.load(open(CONFIG))).full_rope)
    torch.testing.assert_close(port, got, rtol=0, atol=0)
    assert port_scale == scale


# ----------------------------------------------------------------- experts


def test_reference_expert_block_matches_qwen3_moe():
    from transformers import Qwen3MoeConfig
    from transformers.models.qwen3_moe.modeling_qwen3_moe import (
        Qwen3MoeSparseMoeBlock)

    c = Qwen3MoeConfig(hidden_size=64, moe_intermediate_size=32,
                       num_experts=8, num_experts_per_tok=3,
                       norm_topk_prob=True)
    torch.manual_seed(0)
    block = Qwen3MoeSparseMoeBlock(c).eval()
    router = block.gate.weight.detach().t()
    gateup = torch.stack([torch.cat([m.gate_proj.weight.t(),
                                     m.up_proj.weight.t()], -1)
                          for m in block.experts]).detach()
    down = torch.stack([m.down_proj.weight.t()
                        for m in block.experts]).detach()
    x = torch.randn(1, 40, 64)
    with torch.no_grad():
        want = block(x)[0][0]
    got = ref.moe(x[0], router, gateup, down, 3, True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _loop(x, router, gateup, down, k, valid):
    """The routed experts one token at a time."""
    inter = gateup.shape[-1] // 2
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        if valid is not None and not valid[t]:
            continue
        p = torch.softmax(x[t] @ router, -1)
        w, ids = p.topk(k)
        w = w / w.sum()
        for e, we in zip(ids.tolist(), w):
            gu = x[t] @ gateup[e]
            out[t] += we * ((torch.nn.functional.silu(gu[:inter])
                             * gu[inter:]) @ down[e])
    return out


@pytest.mark.parametrize("top_k", [2, 8])
def test_experts_reference_against_a_loop(top_k):
    """Padding rows give zeros and are not counted; an expert that gets no
    token (its router column far below the others) costs nothing."""
    g = torch.Generator().manual_seed(top_k)
    e = 16 if top_k == 8 else 8
    x = torch.randn(24, 32, generator=g)
    x[:, 0] = 1.0
    router = torch.randn(32, e, generator=g)
    router[:, 3] = 0.0
    router[0, 3] = -100.0
    gateup = 0.3 * torch.randn(e, 32, 40, generator=g)
    down = 0.3 * torch.randn(e, 20, 32, generator=g)
    valid = torch.ones(24, dtype=torch.bool)
    valid[-5:] = False
    stats = torch.zeros(2, dtype=torch.int64)
    with k5.counting(stats):
        got = k5.routed_experts(x, router, gateup, down, top_k, True, valid)
    want = _loop(x, router, gateup, down, top_k, valid)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool((got[-5:] == 0).all())
    probs = torch.softmax(x[:19] @ router, -1)
    ids = probs.topk(top_k).indices
    assert not bool((ids == 3).any())
    counts = torch.bincount(ids.reshape(-1), minlength=e)
    assert stats.tolist() == [19 * top_k, int(counts.max())]


# Mellum2's experts at a burst's rows (27,200 tokens, top 8 of 64): uneven,
# with experts that get no row and tiles that end ragged
_COUNTS = [0, 3400, 128, 1, 0, 127, 129, 5000, 256, 0, 77, 3400]


@pytest.mark.parametrize("clusters, col_tiles", [(1, 7), (66, 7), (66, 9),
                                                 (5, 3)])
def test_tile_walk_covers_every_tile_once(clusters, col_tiles):
    """The grouped route's walk (csrc/experts.cu's walk_tile, through its
    Python twin): every (expert, row tile, column tile) exactly once over
    the blocks, none for an expert with no rows, the ragged last tile of
    each expert holding its remainder, each tile's compact row the rows of
    the experts before it, and an empty tile only as the second of an
    expert's odd last pair."""
    bm = k5.GROUPED_BM
    blocks = k5.tile_walk(_COUNTS, col_tiles, clusters)
    assert len(blocks) == 2 * clusters
    seen = [t for mine in blocks for t in mine]
    real = [(e, m0, col) for e, m0, rows, _, col in seen if m0 < rows]
    want = {(e, m0, col) for e, c in enumerate(_COUNTS)
            for m0 in range(0, c, bm) for col in range(col_tiles)}
    assert len(real) == len(set(real)) and set(real) == want
    empty = sorted((e, m0, col) for e, m0, rows, _, col in seen if m0 >= rows)
    tiles = [-(-c // bm) for c in _COUNTS]
    assert empty == sorted((e, t * bm, col) for e, t in enumerate(tiles)
                           if t % 2 for col in range(col_tiles))
    starts = np.concatenate([[0], np.cumsum(_COUNTS)])
    for e, m0, rows, start, _ in seen:
        assert _COUNTS[e] > 0 and rows == _COUNTS[e] and start == starts[e]
    for e, c in enumerate(_COUNTS):
        if c:
            last = max(m0 for e2, m0, rows, *_ in seen if e2 == e and m0 < rows)
            assert c - last == (c % bm or bm)


def test_tile_walk_keeps_a_pair_in_step_and_columns_together():
    """The two blocks of a cluster walk the same experts and column tiles
    in step, on vertically adjacent row tiles (they share each weight
    tile); a row tile's column tiles are consecutive, 0 to nt - 1, so the
    blocks running at once share a few row tiles; row tiles go expert by
    expert, rows upward; cluster c takes the one walk's tiles c, c +
    clusters, ..."""
    bm = k5.GROUPED_BM
    one = k5.tile_walk(_COUNTS, 7, 1)
    for a, b in zip(*one):
        assert (a[0], a[4]) == (b[0], b[4]) and b[1] == a[1] + bm
    walk = one[0]
    for i in range(0, len(walk), 7):
        group = walk[i:i + 7]
        assert [t[4] for t in group] == list(range(7))
        assert len({t[:2] for t in group}) == 1
    rows = [t[:2] for t in walk[::7]]
    assert rows == sorted(rows)
    many = k5.tile_walk(_COUNTS, 7, 5)
    for c in range(5):
        for rank in range(2):
            assert many[2 * c + rank] == one[rank][c::5]
    assert k5.tile_walk([0, 0, 0], 7, 2) == [[], [], [], []]


@pytest.mark.parametrize("n, grouped", [(27200, True), (3400, True),
                                        (1024, True), (512, False),
                                        (256, False), (8, False), (1, False)])
def test_grouped_route_by_rows_an_expert(n, grouped):
    """Mellum2's bursts (27,200 tokens) and one-request prefills (3,400)
    take the grouped products, its 256-token admission chunks (32 rows an
    expert) and decode steps (8 tokens) the Triton ones: the route follows
    N k / E against GROUPED_MIN_ROWS, one whole 128-row tile an expert."""
    assert k5.grouped_route(n, 8, 64) is grouped
    assert (n * 8 / 64 >= k5.GROUPED_MIN_ROWS) is grouped


@pytest.mark.parametrize("what", ["width", "inter", "experts", "aligned"])
def test_grouped_route_refuses_what_the_kernel_cannot_take(what):
    """The wrapper's checks refuse, on the grouped route, a width that is
    not a multiple of 256, an expert width not a multiple of 128, more than
    256 experts and an operand off 16 bytes; the Triton route takes them."""
    d, inter, e = 256, 128, 8
    if what == "width":
        d = 320
    elif what == "inter":
        inter = 96
    elif what == "experts":
        e = 512
    bf = torch.bfloat16
    x = torch.zeros(9 * d, dtype=bf)[1:].view(-1)[:8 * d].view(8, d) \
        if what == "aligned" else torch.zeros(8, d, dtype=bf)
    args = (x, torch.zeros(d, e, dtype=bf),
            torch.zeros(e, d, 2 * inter, dtype=bf),
            torch.zeros(e, inter, d, dtype=bf), 2, None)
    k5._check_cuda_args(*args, grouped=False)
    with pytest.raises(ValueError, match="grouped route"):
        k5._check_cuda_args(*args, grouped=True)


# ------------------------------------------------------- the served paths


def _ids(n, seed):
    return np.random.RandomState(seed).randint(3, 250, n).astype(np.int32)


@pytest.mark.parametrize("top_k", [2, 8])
def test_prefill_continue_and_paged_decode_match_the_reference(top_k):
    """Two rows over the page pool: a batched prefill (right-padded), a
    continued prefill past the window, then paged decode steps; each
    row's logits against the reference's full forward over its tokens."""
    d = hf_dict(top_k=top_k, experts=8)
    cfg = vlm_config(d)
    params = tree(cfg)
    eng = Engine(cfg, fused(params, cfg), IdTokenizer())
    p = eng.params
    pool = init_paged_cache(4, 2, 16, 8, 8, 2, 16, torch.float32)
    pool = dataclasses.replace(pool, block_tables=torch.arange(
        16, dtype=torch.int32).view(2, 8))
    rows = [_ids(28, 1), _ids(28, 2)]
    lens = [28, 23]
    ids = np.zeros((2, 32), np.int32)
    for i, r in enumerate(rows):
        ids[i, :lens[i]] = r[:lens[i]]
    logits, pool = vlm.prefill(p, cfg, None, torch.from_numpy(ids),
                               torch.tensor(lens, dtype=torch.int32),
                               torch.tensor([-1, -1]), pool)
    seqs = [list(r[:n]) for r, n in zip(rows, lens)]

    def want(i):
        emb = p["decoder"]["embed"][torch.tensor(seqs[i]).long()]
        return reference_logits(params, d, emb)[-1]
    for i in range(2):
        torch.testing.assert_close(logits[i], want(i), rtol=1e-4, atol=1e-4)
    # row 1's prompt, continued to 28 after its 23 (offset 23 for both:
    # row 0 writes its positions 23.. again with the same tokens)
    sfx = np.zeros((2, 8), np.int32)
    sfx[0, :5] = rows[0][23:28]
    sfx[1, :5] = rows[1][23:28]
    logits, pool = vlm.prefill_continue(
        p, cfg, None, torch.from_numpy(sfx), torch.tensor([5, 5]),
        torch.tensor([-1, -1]), 23, pool)
    seqs = [list(r[:28]) for r in rows]
    for i in range(2):
        torch.testing.assert_close(logits[i], want(i), rtol=1e-4, atol=1e-4)
    for step in range(6):
        tok = torch.tensor([int(_ids(1, 10 + step)[0]), 7 + step])
        logits, pool = vlm.decode_step(p, cfg, tok, pool)
        for i in range(2):
            seqs[i].append(int(tok[i]))
            torch.testing.assert_close(logits[i], want(i), rtol=1e-4,
                                       atol=1e-4)


def test_scheduler_serves_the_reference_tokens():
    """Requests with an image through BatchScheduler (a prefill, an
    admission, paged decode): each served greedy token is the reference's
    best under teacher forcing, to float32 rounding; the routed rows
    counted on the device."""
    d = hf_dict(top_k=2, experts=8)
    cfg = vlm_config(d)
    params = tree(cfg, seed=3)
    tok = IdTokenizer()
    eng = Engine(cfg, fused(params, cfg), tok, eos_ids=(-1,))
    sched = batcher.BatchScheduler(eng, max_batch=4, page_size=8,
                                   pool_tokens=1024, window_ms=50.0)
    img = np.random.RandomState(0).randint(0, 256, (128, 128, 3),
                                           dtype=np.uint8)
    prompts = ["<image>\n" + "describe this picture in detail " * (i + 1)
               for i in range(3)]
    try:
        finals = [list(sched.submit(pr, img, max_new_tokens=6))[-1]
                  for pr in prompts]
    finally:
        sched.shutdown()
    assert sched.counters["moe_routed_tokens"] > 0
    assert 0 < sched.counters["moe_max_expert_tokens"] \
        <= sched.counters["moe_routed_tokens"]
    for pr, fin in zip(prompts, finals):
        served = [int(t) for t in fin["text"].split(",")]
        prep = eng.prepare(pr, img)
        n = prep["prompt_tokens"]
        emb = vlm._spliced_prompt_embeds(eng.params, cfg, prep["images"],
                                         prep["ids"], prep["starts"])[0, :n]
        tail = eng.params["decoder"]["embed"][torch.tensor(served[:-1]).long()]
        got = reference_logits(params, d, torch.cat([emb, tail]))[n - 1:]
        picked = got[torch.arange(len(served)), torch.tensor(served)]
        assert float((got.max(-1).values - picked).max()) < 1e-3, served


def test_windowed_layers_take_the_kernels_in_bf16(monkeypatch):
    """bf16 at head 64: a prefill calls K4 and a paged decode step K3 in
    every layer, with the window in the sliding ones and none in the full
    one; no layer falls to the plain attention."""
    d = hf_dict(top_k=2, experts=8, head_dim=64)
    cfg = vlm_config(d, "bfloat16")
    params = tree(cfg)
    eng = Engine(cfg, fused(params, cfg), IdTokenizer())
    seen = {"k4": [], "k3": []}
    real_k4 = k4.prefill_attention
    real_k3 = qwen2.paged_decode_attention
    monkeypatch.setattr(k4, "prefill_attention", lambda *a, **kw: (
        seen["k4"].append(a[5] if len(a) > 5 else kw.get("window")),
        real_k4(*a, **kw))[1])
    monkeypatch.setattr(qwen2, "paged_decode_attention", lambda *a, **kw: (
        seen["k3"].append(a[5] if len(a) > 5 else kw.get("window")),
        real_k3(*a, **kw))[1])

    def refuse(*a, **kw):
        raise AssertionError("a layer fell to the plain attention")
    monkeypatch.setattr(qwen2, "_attend", refuse)
    monkeypatch.setattr(qwen2, "_attend_pool", refuse)
    pool = init_paged_cache(4, 1, 8, 8, 8, 2, 64, torch.bfloat16)
    pool = dataclasses.replace(pool, block_tables=torch.arange(
        8, dtype=torch.int32).view(1, 8))
    ids = torch.from_numpy(_ids(40, 4))[None]
    _, pool = vlm.prefill(eng.params, cfg, None, ids,
                          torch.tensor([40], dtype=torch.int32),
                          torch.tensor([-1]), pool)
    vlm.decode_step(eng.params, cfg, torch.tensor([5]), pool)
    assert seen["k4"] == [WINDOW] * 3 + [None]
    assert seen["k3"] == [WINDOW] * 3 + [None]


@pytest.mark.parametrize("offset,lens", [(0, [40, 33]), (24, None)])
def test_windowed_prefill_reference_is_the_masked_attention(offset, lens):
    g = torch.Generator().manual_seed(offset)
    t, s = (40, 40) if offset == 0 else (16, 40)
    q = torch.randn(2, t, 4, 16, generator=g)
    k, v = torch.randn(2, s, 2, 16, generator=g), torch.randn(2, s, 2, 16,
                                                              generator=g)
    kl = None if lens is None else torch.tensor(lens)
    got = k4.prefill_attention(q, k, v, offset, kl, WINDOW)
    qp = offset + torch.arange(t)[:, None]
    kp = torch.arange(s)[None]
    m = (kp <= qp) & (qp - kp < WINDOW)
    m = m[None].expand(2, t, s)
    if kl is not None:
        m = m & (kp[None] < kl[:, None, None])
    want = k4.attend(q, k, v, m[:, None])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    full = k4.prefill_attention(q, k, v, offset, kl)
    assert float((full - got).abs().max()) > 1e-3


def test_windowed_paged_decode_reference_masks_below_the_window():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(3, 4, 16, generator=g)
    kp, vp = torch.randn(9, 8, 2, 16, generator=g), torch.randn(9, 8, 2, 16,
                                                                generator=g)
    tables = torch.arange(24, dtype=torch.int32).remainder(9).view(3, 8)
    lengths = torch.tensor([5, 17, 40], dtype=torch.int32)
    got = paged_decode_attention_reference(q, kp, vp, tables, lengths, WINDOW)
    for b, n in enumerate(lengths.tolist()):
        lo = max(0, n - WINDOW)
        keep = paged_decode_attention_reference(
            q[b:b + 1], kp, vp, tables[b:b + 1], torch.tensor([n],
                                                              dtype=torch.int32))
        if lo == 0:
            torch.testing.assert_close(got[b:b + 1], keep)
        else:
            assert float((got[b] - keep[0]).abs().max()) > 1e-4


# ------------------------------------------------------------ refusals


def _refusals():
    from fastvlm_tpu_torch.ops import beam, quant
    from fastvlm_tpu_torch.train import lora, step
    from fastvlm_tpu_torch.utils import hf_export

    def engine(cfg, params, **kw):
        return Engine(cfg, fused(params, cfg), IdTokenizer(), **kw)
    return {
        "training": lambda cfg, p: step.loss_fn(p, cfg, {}),
        "lora": lambda cfg, p: lora.add_lora(p["decoder"],
                                             torch.Generator(),
                                             cfg=cfg.decoder),
        "speculative": lambda cfg, p: batcher.BatchScheduler(
            engine(cfg, p), spec=True),
        "beam": lambda cfg, p: beam.beam_search(p, cfg, None, None),
        "tensor parallel": lambda cfg, p: engine(cfg, p, mesh=object()),
        "int8 kv cache": lambda cfg, p: engine(
            dataclasses.replace(cfg, decoder=dataclasses.replace(
                cfg.decoder, kv_cache_dtype="int8")), p),
        "hf_export": lambda cfg, p: hf_export.export_state_dict(p, cfg),
        "quantize": lambda cfg, p: quant.quantize_decoder(p["decoder"]),
        "chunk view": lambda cfg, p: batcher.BatchScheduler(
            engine(cfg, p), chunk_view=True),
        "persistent view": lambda cfg, p: batcher.BatchScheduler(
            engine(cfg, p), persist_view=True),
    }


@pytest.mark.parametrize("path", sorted(_refusals()))
def test_paths_without_per_layer_kinds_refuse_the_decoder(path):
    cfg = vlm_config(hf_dict())
    params = tree(cfg)
    with pytest.raises(NotImplementedError):
        _refusals()[path](cfg, params)


# ------------------------------------------------- the benchmark's counts


def test_k5_bound_against_a_hand_count():
    """Kernel K5's bound (the benchmark's family): at a burst's tokens the
    products bound it, at one token the weights."""
    import sys
    sys.path.insert(0, REPO)
    from port_bench import family, flops

    cfg = json.load(open(CONFIG))
    fam = family.of(cfg)
    ops, nbytes = fam.k5_layer(cfg, 3400)
    assert ops == 2 * 3 * 2304 * 896 * 8 * 3400
    assert nbytes == 2 * (2304 * 64 + 64 * 3 * 2304 * 896 + 2 * 3400 * 2304)
    ops1, bytes1 = fam.k5_layer(cfg, 1)
    assert bytes1 == pytest.approx(2 * (2304 * 64 + 8 * 3 * 2304 * 896
                                        + 2 * 2304))
    # eight tokens reach 64 (1 - (7/8)^8) = 42.5 experts on average
    assert fam.k5_layer(cfg, 8)[1] == pytest.approx(
        2 * (2304 * 64 + 64 * (1 - (7 / 8) ** 8) * 3 * 2304 * 896
             + 16 * 2304))
    peak = flops.PEAKS["NVIDIA H100 80GB HBM3"]
    info = {"lens": [3400, 3300, 1], "starts": [10, 10, -1], "offset": 0}
    want = 28 * max(2 * 3 * 2304 * 896 * 8 * 6700 / 989e12,
                    2 * (2304 * 64 + 64 * 3 * 2304 * 896 + 2 * 6700 * 2304)
                    / 3.35e12)
    assert fam.k5_call_bound_s(cfg, info, peak) == pytest.approx(want)
    # attention: 21 windowed layers of 32/4/128 and 7 full
    att = fam.attention(cfg)
    assert att.count((32, 4, 128, 1024)) == 21
    assert att.count((32, 4, 128, None)) == 7
    # a token's operations: the active products, 8 of 64 experts
    per_tok = 28 * 2 * (2304 * 5120 + 4096 * 2304 + 2304 * 64
                        + 8 * 3 * 2304 * 896)
    head = 2 * 2304 * 98304
    assert fam.flops(cfg, 1) == pytest.approx(per_tok + head
                                              + 28 * 4 * 32 * 128)
    assert math.isclose(fam.flops(cfg, 2048, 2048) - fam.flops(cfg, 2048,
                                                                1024),
                        7 * 4 * 32 * 128 * 2048 * 1024)
