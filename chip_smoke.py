#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fastvlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit's nvcc, and imports nothing of JAX. Phases, each printing one line
and raising on failure (so the exit code is non-zero):

  1. device   the card's name; nvidia-smi's name and power limit
  2. build    nvcc builds kernels K1 and K2 from fastvlm_tpu_torch/csrc/
  3. K1       fused_ffn vs ffn_reference at the five FastViTHD stage shapes
              of a 1024 px image (bf16, with ls and with ls=None), a ragged
              row count, and one f32 shape
  4. K2       decode_attention vs decode_attention_reference at the 0.5B and
              1.5B head geometries, S_max = 576, lengths {1, 77, 576}, bf16
              and f32
  5. main     an Engine at full width (FastViTHD @1024, mlp2x_gelu
              3072->896, Qwen2-0.5B, bf16, random weights from a seed, byte
              tokenizer) answers 3 greedy requests of 32 new tokens; checks
              that the kernels' launch counts are 44 per request (K1) and
              24 per dispatched decode step (K2), that two identical
              requests give identical ids, and that a step-by-step replay
              of a request has finite logits at every step and the
              engine's ids
  6. small    a small f32 model on the card (kernels) agrees with the same
              model on the CPU (plain versions), logits and greedy ids

f32 comparisons run with TF32 off for both matmuls and cuDNN convolutions:
the script sets torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False at start. Kernel times are medians
of CUDA-event timings over repeated launches on warm inputs.

The line before last is a JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# FastViTHD at 1024 px: (tokens, channels) of each stage and its block count
K1_STAGES = [(65536, 96, 2), (16384, 192, 12), (4096, 384, 24),
             (1024, 768, 4), (256, 1536, 2)]
K1_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
K2_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-5, 2e-5)}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def compare(got, want, tol, what):
    """Max abs error, and max of |err| / (atol + rtol |want|) (<= 1 passes)."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite kernel output")
    err = (got - want).abs()
    ratio = float((err / (atol + rtol * want.abs())).max())
    max_abs = float(err.max())
    if ratio > 1.0:
        raise AssertionError(f"{what}: max_abs_err {max_abs:.3e} exceeds "
                             f"atol={atol} rtol={rtol} (ratio {ratio:.2f})")
    return max_abs, ratio


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log("device", f"{name}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(card, flush=True)
    return name, card


def phase_build():
    from fastvlm_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    for name in ("ffn", "decode_attention"):
        _build.load(name)
    secs = time.perf_counter() - t0
    log("build", f"ffn.cu + decode_attention.cu built and loaded in "
                 f"{secs:.1f} s")
    return secs


def _ffn_inputs(n, c, dtype, gen):
    ch = 4 * c
    dev = "cuda"

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(dtype)

    return (r(n, c), r(n, c), r(c, ch, scale=c ** -0.5), r(ch, scale=0.1),
            r(ch, c, scale=ch ** -0.5), r(c, scale=0.1),
            r(c, scale=0.1, shift=1.0))


def phase_k1(gen):
    from fastvlm_tpu_torch.ops.cuda.ffn import ffn_reference, fused_ffn

    cases = [(n, c, torch.bfloat16, use_ls, blocks)
             for n, c, blocks in K1_STAGES for use_ls in (True, False)]
    cases += [(1000, 192, torch.bfloat16, True, 0),   # ragged rows
              (4096, 384, torch.float32, True, 0)]
    max_abs = 0.0
    ms = plain_ms = 0.0  # per 1024 px image: sum over the 44 calls
    for n, c, dtype, use_ls, blocks in cases:
        t, res, w1, b1, w2, b2, ls = _ffn_inputs(n, c, dtype, gen)
        ls = ls if use_ls else None
        got = fused_ffn(t, res, w1, b1, w2, b2, ls)
        want = ffn_reference(t, res, w1, b1, w2, b2, ls)
        torch.cuda.synchronize()
        err, ratio = compare(got, want, K1_TOL[dtype],
                             f"K1 N={n} C={c} {dtype} ls={use_ls}")
        max_abs = max(max_abs, err)
        k_ms = time_ms(lambda: fused_ffn(t, res, w1, b1, w2, b2, ls))
        p_ms = time_ms(lambda: ffn_reference(t, res, w1, b1, w2, b2, ls))
        if not use_ls and dtype == torch.bfloat16:  # the folded main path
            ms += blocks * k_ms
            plain_ms += blocks * p_ms
        tflops = 4 * n * c * 4 * c / (k_ms * 1e-3) / 1e12
        log("K1", f"N={n} C={c} {str(dtype)[6:]} ls={'yes' if use_ls else 'None'}"
                  f": max_abs_err {err:.3e} (tol ratio {ratio:.3f} <= 1); "
                  f"kernel {k_ms:.4f} ms ({tflops:.1f} TFLOP/s), "
                  f"plain {p_ms:.4f} ms")
    log("K1", f"per 1024 px image (44 calls, bf16, ls folded): kernel "
              f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    return max_abs, ms, plain_ms


def phase_k2(gen):
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference)

    s_max = 320 + 256
    lengths = torch.tensor([1, 77, s_max], dtype=torch.int32, device="cuda")
    max_abs = 0.0
    for hq, hkv, d in ((14, 2, 64), (12, 2, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((3, hq, d), generator=gen, device="cuda").to(dtype)
            k = torch.randn((3, s_max, hkv, d), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn((3, s_max, hkv, d), generator=gen,
                            device="cuda").to(dtype)
            got = decode_attention(q, k, v, lengths)
            want = decode_attention_reference(q, k, v, lengths)
            torch.cuda.synchronize()
            err, ratio = compare(got, want, K2_TOL[dtype],
                                 f"K2 {hq}/{hkv}/{d} {dtype}")
            max_abs = max(max_abs, err)
            k_ms = time_ms(lambda: decode_attention(q, k, v, lengths))
            p_ms = time_ms(lambda: decode_attention_reference(q, k, v, lengths))
            log("K2", f"Hq/Hkv/D={hq}/{hkv}/{d} {str(dtype)[6:]} B=3 "
                      f"S_max={s_max} lengths=[1,77,{s_max}]: max_abs_err "
                      f"{err:.3e} (tol ratio {ratio:.3f} <= 1); kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms")
    # the main path's own call: batch 1, 0.5B heads, bf16, a 416-slot cache
    # holding 400 keys
    q = torch.randn((1, 14, 64), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((1, 416, 2, 64), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((1, 416, 2, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ln = torch.tensor([400], dtype=torch.int32, device="cuda")
    ms = time_ms(lambda: decode_attention(q, k, v, ln), reps=50)
    plain_ms = time_ms(lambda: decode_attention_reference(q, k, v, ln), reps=50)
    log("K2", f"main-path call (B=1, 14/2/64 bf16, S_max=416, length 400): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return max_abs, ms, plain_ms


class IdTokenizer:
    """Byte tokenizer whose decode spells out token ids, so the engine's
    text output is its ids."""

    def __init__(self):
        from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer

        self._bytes = ByteTokenizer()
        self.bos_token_id = self._bytes.bos_token_id
        self.eos_token_id = self._bytes.eos_token_id

    def __call__(self, text):
        return self._bytes(text)

    def decode(self, ids, skip_special_tokens=True):
        return ",".join(str(int(i)) for i in ids)


def phase_main(card):
    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import qwen2, vlm
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    decoder = C.qwen2_0_5b(param_dtype="bfloat16", compute_dtype="bfloat16")
    vision = C.FastViTConfig(image_size=1024, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    cfg = C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                    hidden_size=decoder.hidden_size))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = vlm.init(gen, cfg, "cuda")
    params["decoder"] = qwen2.fuse_decoder_params(params["decoder"], decoder)
    engine = Engine(cfg, params, IdTokenizer())
    torch.cuda.synchronize()
    log("main", f"0.5B engine built at full width on the card in "
                f"{time.perf_counter() - t0:.1f} s")
    image = np.random.RandomState(0).randint(0, 256, (1024, 1024, 3),
                                             dtype=np.uint8)
    prompts = ["Describe the image.", "Describe the image.",
               "What is written in the image?"]

    torch.cuda.reset_peak_memory_stats()
    fused_ffn.launches = 0
    decode_attention.launches = 0
    results = [engine.generate(engine.build_prompt(p), image,
                               max_new_tokens=32) for p in prompts]
    k1, k2 = fused_ffn.launches, decode_attention.launches
    steps = sum(stats["decode_steps"] for _, stats in results)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    for i, (text, stats) in enumerate(results):
        log("main", f"request {i}: ttft {stats['ttft_ms']:.2f} ms, "
                    f"{stats['decode_tokens']} tokens at "
                    f"{stats['tok_per_s']:.2f} tok/s, {stats['decode_steps']} "
                    f"steps dispatched, prompt {stats['prompt_tokens']} "
                    f"tokens; ids {text[:60]}...")
    if k1 != 44 * len(prompts):
        raise AssertionError(f"K1 launched {k1} times, expected "
                             f"{44 * len(prompts)} (44 per request)")
    if steps == 0 or k2 != decoder.num_layers * steps:
        raise AssertionError(f"K2 launched {k2} times for {steps} decode "
                             f"steps, expected {decoder.num_layers} per step")
    if results[0][0] != results[1][0]:
        raise AssertionError("identical requests gave different ids")
    log("main", f"launch counts: K1 {k1} = 44 x {len(prompts)} requests; "
                f"K2 {k2} = 24 x {steps} steps; identical requests gave "
                f"identical ids; peak device memory {peak_gb:.2f} GiB")

    # replay request 0 step by step: every logit finite and of the right
    # shape, and the same greedy ids as the engine's
    vocab = decoder.vocab_size
    with torch.inference_mode():
        inputs = engine.prepare(engine.build_prompt(prompts[0]), image)
        t = inputs["ids"].shape[1]
        cache = init_cache(decoder.num_layers, 1, t + 32, decoder.num_kv_heads,
                           decoder.head_dim, torch.bfloat16, "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                    inputs["ids"], inputs["lens"],
                                    inputs["starts"], cache)
        ids = []
        for step in range(32):
            if logits.shape != (1, vocab) or not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"step {step} logits: shape "
                                     f"{tuple(logits.shape)} or non-finite")
            tok = logits.argmax(-1).to(torch.int32)
            ids.append(int(tok[0]))
            if step < 31:
                logits, cache = vlm.decode_step(engine.params, cfg, tok, cache)
    engine_ids = [int(i) for i in results[0][0].split(",") if i]
    if ids[:len(engine_ids)] != engine_ids:
        raise AssertionError("step-by-step replay gave other ids than the "
                             "engine")
    steady = results[1:]
    ttft = statistics.mean(s["ttft_ms"] for _, s in steady)
    tps = statistics.mean(s["tok_per_s"] for _, s in steady)
    log("main", f"replayed request 0: 32 steps of finite (1, {vocab}) "
                f"logits, same ids; warm requests: TTFT {ttft:.2f} ms, "
                f"decode {tps:.2f} tok/s on {card}")
    return {"k1_launches": k1, "k2_launches": k2, "decode_steps": steps,
            "ttft_ms": [s["ttft_ms"] for _, s in results],
            "tok_per_s": [s["tok_per_s"] for _, s in results],
            "peak_gib": peak_gb}


def phase_small():
    from fastvlm_tpu_torch.engine import Engine, tiny_config
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache
    from fastvlm_tpu_torch.utils.convert import to_device

    cfg = tiny_config()
    gen = torch.Generator()
    gen.manual_seed(1)
    cpu_params = vlm.init(gen, cfg, "cpu")
    # at the init's 0.02 std the tiny decoder only echoes its last token
    dec = cpu_params["decoder"]
    dec["embed"] = dec["embed"] * 10
    dec["layers"] = [{k: ({**v, "w": v["w"] * 10} if isinstance(v, dict) else v)
                      for k, v in lp.items()} for lp in dec["layers"]]
    image = np.random.RandomState(1).randint(
        0, 256, (cfg.vision.image_size,) * 2 + (3,), dtype=np.uint8)
    out = {}
    for dev in ("cuda", "cpu"):
        engine = Engine(cfg, to_device(cpu_params, dev), IdTokenizer())
        prompt = engine.build_prompt("Describe the image.")
        with torch.inference_mode():
            inputs = engine.prepare(prompt, image)
            t = inputs["ids"].shape[1]
            cache = init_cache(cfg.decoder.num_layers, 1, t + 1,
                               cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                               torch.float32, dev)
            logits, _ = vlm.prefill(engine.params, cfg, inputs["images"],
                                    inputs["ids"], inputs["lens"],
                                    inputs["starts"], cache)
        text, _ = engine.generate(prompt, image, max_new_tokens=24)
        out[dev] = (logits.cpu(), text)
    err, ratio = compare(out["cuda"][0], out["cpu"][0], (1e-4, 1e-4),
                         "small model prefill logits, card vs CPU")
    if out["cuda"][1] != out["cpu"][1]:
        raise AssertionError(f"greedy ids differ: card {out['cuda'][1]} vs "
                             f"CPU {out['cpu'][1]}")
    log("small", f"tiny f32 model: card (kernels) vs CPU (plain versions) "
                 f"logits max_abs_err {err:.3e} (tol ratio {ratio:.3f} <= 1); "
                 f"24 greedy ids equal: {out['cpu'][1][:50]}...")


def main() -> int:
    # fail before printing anything without a card or outside a checkout
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    sys.path.insert(0, ROOT)
    import fastvlm_tpu_torch  # noqa: F401

    name, card = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    phase_build()
    k1_err, k1_ms, k1_plain = phase_k1(gen)
    k2_err, k2_ms, k2_plain = phase_k2(gen)
    main_res = phase_main(card)
    phase_small()

    kernels = {"kernels": [
        {"name": "fused_ffn", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/ffn.cu",
         "replaces": "fastvlm_tpu/ops/pallas/ffn.py:76",
         "launches": main_res["k1_launches"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain,
         "timed_as": "44 calls of one 1024 px image, bf16, ls folded"},
        {"name": "decode_attention", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/decode_attention.cu",
         "replaces": "fastvlm_tpu/ops/pallas/decode_attention.py:167",
         "launches": main_res["k2_launches"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain,
         "timed_as": "one call, B=1, 14/2/64 bf16, S_max 416, length 400"},
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
