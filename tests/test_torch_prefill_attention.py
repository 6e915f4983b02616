"""Kernel K4's plain version (fastvlm_tpu_torch/ops/cuda/prefill_attention.py)
and its route in ``qwen2._layer``.

The plain version takes the mask's structure (a query offset, optional
per-row key lengths); it must equal ``qwen2._attend`` under the dense masks
that ``qwen2.prefill_mask`` and ``vlm.prefill_continue`` build, bit for bit
(the same formula over the same booleans), and a float64 softmax over each
query's valid keys within bf16's rounding. The route: ``_layer`` hands a
prefill to the wrapper exactly when it is a bf16 / fp16 prefill over a
cache at head_dim 64 or 128 whose caller gave the mask's structure, with no
ALiBi bias and no sliding window; training, a verify pass, ALiBi and a
window still run ``_attend``. The kernel itself runs only on the card
(chip_smoke.py phase k4)."""

import dataclasses

import numpy as np
import pytest
import torch

from fastvlm_tpu_torch import config as tcfg
from fastvlm_tpu_torch.models import qwen2, vlm
from fastvlm_tpu_torch.ops.cuda import prefill_attention as k4
from fastvlm_tpu_torch.ops.kv_cache import init_cache
from fastvlm_tpu_torch.ops.speculative import spec_mask


def _qkv(b, t, s, hq, hkv, d, seed, dtype=torch.bfloat16):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32))
               for n, h in ((t, hq), (s, hkv), (s, hkv)))
    return (2 * q).to(dtype), (2 * k).to(dtype), v.to(dtype)


def _f64_attention(q, k, v, offset, kv_lens):
    """Each query's softmax over its valid keys, in float64, row by row."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    out = np.zeros((b, t, hq, d))
    qd, kd, vd = (x.double().numpy() for x in (q, k, v))
    for r in range(b):
        for i in range(t):
            n = min(offset + i + 1, s if kv_lens is None else kv_lens[r])
            for h in range(hq):
                kh = h // (hq // hkv)
                sc = kd[r, :n, kh] @ qd[r, i, h] / np.sqrt(d)
                p = np.exp(sc - sc.max())
                out[r, i, h] = p @ vd[r, :n, kh] / p.sum()
    return out.reshape(b, t, hq * d)


@pytest.mark.parametrize("hq,hkv,d,offset,lens", [
    (2, 2, 64, 0, (24, 1, 17)),        # g = 1; a one-token padding row
    (4, 2, 128, 0, (24, 24, 1)),       # g = 2
    (12, 2, 128, 0, (1, 9, 24)),       # g = 6 (the 1.5B decoder's heads)
    (6, 1, 64, 0, (24, 23, 1)),        # g = 6 at 64
    (2, 2, 128, 16, None),             # continued prefill, g = 1
    (4, 2, 64, 16, None),              # g = 2
    (12, 2, 128, 9, None),             # g = 6, an offset off the tiles
])
def test_reference_matches_dense_masks(hq, hkv, d, offset, lens):
    b, t = 3, 24
    if offset == 0:  # vlm.prefill: the prompt's own keys, (B, T, T)
        s = t
        kv_lens = torch.tensor(lens, dtype=torch.int32)
        dense = qwen2.prefill_mask(kv_lens, t, t)
    else:  # vlm.prefill_continue: the whole cache, k <= offset + i
        s = offset + t + 5
        kv_lens = None
        q_pos = offset + torch.arange(t)[:, None]
        dense = (torch.arange(s)[None, :] <= q_pos)[None].expand(b, t, s)
    q, k, v = _qkv(b, t, s, hq, hkv, d, seed=hq + d + offset)
    got = k4.prefill_attention_reference(q, k, v, offset, kv_lens)
    want = qwen2._attend(q, k, v, dense[:, None])
    assert torch.equal(got, want)
    assert torch.equal(k4.prefill_attention(q, k, v, offset, kv_lens), got)
    exact = _f64_attention(q, k, v, offset, lens)
    # bf16: the probabilities and the output are rounded (8 bits each)
    np.testing.assert_allclose(got.double().numpy(), exact, rtol=2e-2,
                               atol=2e-2)


# --------------------------------------------------------------- routing


def _cfg(**decoder):
    dec = tcfg.Qwen2Config(vocab_size=64, hidden_size=128, num_layers=2,
                           num_heads=4, num_kv_heads=2, head_dim=64,
                           intermediate_size=128, param_dtype="bfloat16",
                           compute_dtype="bfloat16")
    dec = dataclasses.replace(dec, **decoder)
    vision = tcfg.FastViTConfig(layers=(1, 1, 1, 1, 1),
                                embed_dims=(8, 16, 32, 64, 128),
                                image_size=128, attn_head_dim=16)
    return tcfg.FastVLMConfig(
        vision=vision, decoder=dec,
        projector=tcfg.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                       hidden_size=128))


def _run(case, dec):
    """Drive one path of the decoder on tiny weights."""
    cfg = _cfg(**dec)
    gen = torch.Generator().manual_seed(0)
    params = {"decoder": qwen2.init(gen, cfg.decoder)}
    d = cfg.decoder
    b, t = 2, 12
    ids = torch.randint(0, 64, (b, t), generator=gen, dtype=torch.int32)
    lens = torch.tensor([t, 5], dtype=torch.int32)
    starts = torch.full((b,), -1, dtype=torch.int32)
    cache = init_cache(d.num_layers, b, 32, d.num_kv_heads, d.head_dim,
                       dtype=torch.bfloat16)
    if case in ("prefill", "alibi", "window", "f32"):
        vlm.prefill(params, cfg, None, ids, lens, starts, cache)
    elif case == "continue":
        _, cache = vlm.prefill(params, cfg, None, ids, lens, starts, cache)
        vlm.prefill_continue(params, cfg, None, ids[:, :4],
                             torch.tensor([4, 2], dtype=torch.int32), starts,
                             t, cache)
    elif case == "train":
        emb = qwen2.embed(params["decoder"], ids).to(torch.bfloat16)
        pos = torch.arange(t)[None].expand(b, t)
        qwen2.forward(params["decoder"], d, emb, pos)
    elif case == "verify":
        _, cache = vlm.prefill(params, cfg, None, ids, lens, starts, cache)
        k = 3
        emb = qwen2.embed(params["decoder"], ids[:, :k + 1]).to(torch.bfloat16)
        pos = cache.lengths[:, None] + torch.arange(k + 1)[None]
        qwen2.forward(params["decoder"], d, emb, pos, cache=cache,
                      mask=spec_mask(cache.lengths, k + 1, cache.max_len),
                      prefill=False)


@pytest.mark.parametrize("case,dec,k4_calls", [
    ("prefill", {}, [(0, True)] * 2),
    ("prefill", {"head_dim": 128, "num_heads": 2, "num_kv_heads": 1},
     [(0, True)] * 2),
    ("continue", {}, [(0, True)] * 2 + [(12, False)] * 2),
    ("train", {}, []),
    ("verify", {}, [(0, True)] * 2),  # the prefill before it only
    ("alibi", {"pos_emb": "alibi"}, []),
    # a window goes to K4 too (its sliding-window route), window and all
    ("window", {"attn_window": 4}, [(0, True)] * 2),
    ("f32", {"param_dtype": "float32", "compute_dtype": "float32"}, []),
    ("prefill", {"head_dim": 32, "num_heads": 8}, []),
])
def test_layer_routes_prefill_to_k4(monkeypatch, case, dec, k4_calls):
    calls, plain, windows = [], [], []
    real_k4, real_plain = k4.prefill_attention, qwen2._attend

    def kernel(q, k, v, offset=0, kv_lens=None, window=None):
        calls.append((offset, kv_lens is not None))
        windows.append(window)
        return real_k4(q, k, v, offset, kv_lens, window)

    def attend(*a, **kw):
        plain.append(a[0].shape[1])
        return real_plain(*a, **kw)

    monkeypatch.setattr(k4, "prefill_attention", kernel)
    monkeypatch.setattr(qwen2, "_attend", attend)
    _run(case, dec)
    assert calls == k4_calls
    assert windows == [dec.get("attn_window")] * len(calls)
    # every attention the route did not take ran the plain version
    layers = 2
    passes = {"prefill": 1, "continue": 2, "train": 1, "verify": 2,
              "alibi": 1, "window": 1, "f32": 1}[case]
    assert len(calls) + len(plain) == layers * passes
