#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fastvlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit's nvcc, and imports nothing of JAX. Phases, each printing lines
tagged with its name and raising on failure (so the exit code is
non-zero):

  1. device   the card's name; nvidia-smi's name and power limit
  2. build    nvcc builds kernels K1, K2 and K3 from fastvlm_tpu_torch/csrc/,
              one process per source, all started together
  3. K1       fused_ffn vs ffn_reference at the five FastViTHD stage shapes
              of a 1024 px image (bf16, with ls and with ls=None), ragged
              row counts on both routes, and one f32 shape; per stage the
              kernel's time, TFLOP/s and share of its bound, the plain
              version's and the bf16 cuBLAS chain's (context)
  4. K2       decode_attention vs decode_attention_reference at the 0.5B,
              1.5B and 7B head geometries, bf16 and f32, lengths at the
              split size's edges (1, split-1, split, split+1, one leaving
              whole splits empty, S_max); then the main-path call timed:
              kernel (profiler), per call by events, the wrapper's host us,
              against scaled_dot_product_attention (library_ms)
  5. K3       paged_decode_attention vs paged_decode_attention_reference at
              the 0.5B, 1.5B and 7B head geometries, bf16 and f32, pages of
              8, 64 and 128: at a 4096-position table, lengths at the split
              size's edges (1, split-1, split, split+1, 2 split+7, 4096) and
              a pad row, one row a call (several splits, the counter merge)
              with each call made twice (the counters reset: bitwise equal)
              and batched; and B = 8 with shuffled pool pages, decoy pages,
              -1 tails, a pad row, lengths {1, page-1, page, page+1, 77,
              1000, 5, 400}, a table as wide as the pool. Then the serving
              call (B = 8, 0.5B heads, bf16, lengths 400-600, page 64):
              kernel (profiler, which must show one kernel a call), per
              call by events, the wrapper's host us, bound and share,
              plain; K2 on a dense cache of the same rows as context;
              both at one and at two 64-key tiles a block (equal bytes)
  6. main     an Engine at full width (FastViTHD @1024, mlp2x_gelu
              3072->896, Qwen2-0.5B, bf16, random weights from a seed, byte
              tokenizer) answers 3 greedy requests of 32 new tokens; checks
              that the kernels' launch counts are 44 per request (K1) and
              24 per dispatched decode step (K2), that two identical
              requests give identical ids, and that a step-by-step replay
              of a request has finite logits at every step and the
              engine's ids
  7. serve    a BatchScheduler over the same full-width engine (paged pool
              of 16384 tokens, 64-token pages, 8-token chunks): 4 requests
              with distinct 1024 px images at once, 32 new tokens, greedy;
              once they decode, 4 more (an identical pair, one sampled at
              temperature 0.7) admitted mid-batch, growing it to 8. The
              traffic runs twice, each time through a fresh scheduler: a
              warm-up round, then the measured and checked one. Checks
              every stream's finish reason, the admission and grow counters,
              K1 = 44 per prefill dispatch, K3 = 24 per decode step, no K2,
              the pool's pages all back, the identical pair's equal ids, and
              a teacher-forced replay of two requests (one of the batched
              prefill, one admitted) through the dense single-request path
              (K2) that ranks the batch's token within a bf16 tie margin of
              the maximum at every step, printing each step's top-1/top-2
              gap. Prints TTFT and queue ms per request, the served tok/s
              (streamed tokens over the wall time from the first batch's
              start to the last stream's close), the token-slot rate of the
              chunks with 8 live rows, and peak memory. Then a steady-state
              decode profile at the same batch and lengths: step ms on the
              paged pool and on a dense cache of the same rows, device ops,
              device ms and K3 (or K2) ms and launches a step
  8. small    a small f32 model on the card (kernels) agrees with the same
              model on the CPU (plain versions), logits and greedy ids; the
              same model through a BatchScheduler on the card and on the CPU
              gives 3 concurrent greedy requests the serial engine's ids

f32 comparisons run with TF32 off for both matmuls and cuDNN convolutions:
the script sets torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False at start. K1's times are CUDA
events around a run of back-to-back calls, over the count; K2's and K3's
per-call times are medians of CUDA events around each call (the wrapper's
host time included). Kernel time alone (kernel_ms) comes from
torch.profiler. Bounds (bound_ms) are computed from this run's shapes: the
larger of the bytes each kernel must move over 3.35 TB/s and its FLOPs
over 989 TFLOP/s (bf16 tensor cores; 67 TFLOP/s for f32).

The line before last is a JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# FastViTHD at 1024 px: (tokens, channels) of each stage and its block count
K1_STAGES = [(65536, 96, 2), (16384, 192, 12), (4096, 384, 24),
             (1024, 768, 4), (256, 1536, 2)]
K1_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (1e-4, 1e-4)}
K2_TOL = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-5, 2e-5)}
HBM_BPS = 3.35e12      # H100 SXM device memory, bytes/s
BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core peak
K3_TOL = K2_TOL  # the same formula, the same summation order per split
# teacher-forced replay: the batch's token must score within this many bf16
# ulps (of the dense maximum's magnitude) of the dense maximum. The logits
# are bf16 values, so gaps come in whole ulps. Random bf16 weights put the
# top logits within a few ulps of each other (the replay prints each step's
# top-1/top-2 gap: 0-26 ulps, median 2, on an H100), and a batch of 8 may
# round its products in other places than a batch of 1. The batch's token
# has read 0 ulps below the maximum at every step replayed so far; 2 ulps
# leaves room for such a rounding flip and still catches a wrong token
# wherever the runner-up sits 3 or more ulps down (about half the steps).
TIE_ULPS = 2
JOIN_S = 600


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


def time_batch_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around reps back-to-back calls,
    over reps (the queue stays ahead of the card)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int = 2000) -> float:
    """Host time of one call: perf_counter over reps calls, one synchronise
    at the end."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def fmt_ms(x) -> str:
    """A time in ms, or "not measured" where the profiler saw none."""
    return "not measured" if x is None else f"{x:.4f} ms"


def fmt_us(x) -> str:
    """A time given in ms, written in us, or "not measured"."""
    return "not measured" if x is None else f"{x * 1e3:.3f} us"


def ffn_bound_ms(n, c):
    """K1's bound: 16 N C^2 FLOPs at the bf16 peak, or t, residual, out,
    W1, W2 and the biases once each over device memory, the larger."""
    flops = 16 * n * c * c
    nbytes = 2 * (3 * n * c + 8 * c * c + 4 * c + 2 * c)
    f_ms, b_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")


def attn_bound_ms(q, lengths, hkv, elem):
    """K2's / K3's bound: the valid keys and values, q and the output once
    each over device memory (the ~4 FLOPs a byte are far below the ridge)."""
    d = q.shape[-1]
    kv = 2 * int(lengths.sum()) * hkv * d * elem
    return (kv + 2 * q.numel() * elem + 4 * lengths.numel()) / HBM_BPS * 1e3


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

    names = ("ffn", "decode_attention", "paged_decode_attention")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.load, names))
    secs = time.perf_counter() - t0
    log("build", f"{', '.join(n + '.cu' for n in names)} built in parallel "
                 f"and loaded in {secs:.1f} s")
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


def _ffn_chain(t, res, w1, b1, w2, b2, ls):
    """The same function as a bf16 cuBLAS chain (context for K1, not its
    yardstick: no single PyTorch call computes it)."""
    o = torch.addmm(b2, torch.nn.functional.gelu(torch.addmm(b1, t, w1)), w2)
    return res + (o if ls is None else ls * o)


def phase_k1(gen):
    from fastvlm_tpu_torch.ops.cuda.ffn import ffn_reference, fused_ffn

    cases = [(n, c, torch.bfloat16, use_ls, blocks)
             for n, c, blocks in K1_STAGES for use_ls in (True, False)]
    cases += [(1000, 192, torch.bfloat16, True, 0),   # ragged rows, fused
              (1000, 768, torch.bfloat16, True, 0),   # ragged rows, two passes
              (4096, 384, torch.float32, True, 0)]
    max_abs = 0.0
    img = dict.fromkeys(("ms", "kernel_ms", "plain_ms", "chain_ms", "bound_ms"), 0.0)
    for n, c, dtype, use_ls, blocks in cases:
        t, res, w1, b1, w2, b2, ls = _ffn_inputs(n, c, dtype, gen)
        ls = ls if use_ls else None
        args = (t, res, w1, b1, w2, b2, ls)
        got = fused_ffn(*args)
        want = ffn_reference(*args)
        torch.cuda.synchronize()
        err, ratio = compare(got, want, K1_TOL[dtype],
                             f"K1 N={n} C={c} {dtype} ls={use_ls}")
        max_abs = max(max_abs, err)
        what = (f"N={n} C={c} {str(dtype)[6:]} "
                f"ls={'yes' if use_ls else 'None'}: max_abs_err {err:.3e} "
                f"(tol ratio {ratio:.3f} <= 1)")
        if dtype == torch.float32:
            k_ms = time_batch_ms(lambda: fused_ffn(*args))
            p_ms = time_batch_ms(lambda: ffn_reference(*args))
            log("K1", f"{what}; kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
            continue
        if use_ls or not blocks:  # the folded main path is timed below
            log("K1", what)
            continue
        k_ms = time_batch_ms(lambda: fused_ffn(*args))
        prof_ms = kernel_time_ms(lambda: fused_ffn(*args))
        p_ms = time_batch_ms(lambda: ffn_reference(*args))
        c_ms = time_batch_ms(lambda: _ffn_chain(*args))
        bound, bound_by = ffn_bound_ms(n, c)
        for key, v in (("ms", k_ms), ("kernel_ms", prof_ms), ("plain_ms", p_ms),
                       ("chain_ms", c_ms), ("bound_ms", bound)):
            img[key] = None if v is None or img[key] is None else img[key] + blocks * v
        tflops = 16 * n * c * c / (k_ms * 1e-3) / 1e12
        log("K1", f"{what}; kernel {k_ms:.4f} ms ({tflops:.1f} TFLOP/s, "
                  f"{bound / k_ms:.3f} of its {bound * 1e3:.2f} us bound, "
                  f"{bound_by}), kernel time {fmt_ms(prof_ms)} (profiler); "
                  f"plain {p_ms:.4f} ms; bf16 cuBLAS chain {c_ms:.4f} ms")
    log("K1", f"per 1024 px image (44 calls, bf16, ls folded): kernel "
              f"{img['ms']:.3f} ms ({fmt_ms(img['kernel_ms'])} kernel time), "
              f"bound {img['bound_ms']:.3f} ms ({img['bound_ms'] / img['ms']:.3f} "
              f"reached), plain {img['plain_ms']:.3f} ms, bf16 cuBLAS chain "
              f"{img['chain_ms']:.3f} ms")
    return max_abs, img


def phase_k2(gen):
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference, split_size)

    def draw(b, hq, hkv, d, s_max, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((b, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d))]

    s_max = 4096
    max_abs = 0.0
    for hq, hkv, d in ((14, 2, 64), (12, 2, 128), (28, 4, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            # a row alone takes several splits (one cluster each) at this
            # cache size; lengths 1 .. 2 split + 7 leave whole splits empty
            split = split_size(1, hkv, d, s_max, dtype)
            lens = [1, split - 1, split, split + 1, 2 * split + 7, s_max]
            q, k, v = draw(len(lens), hq, hkv, d, s_max, dtype)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            want = decode_attention_reference(q, k, v, lengths)
            rows = [decode_attention(q[i:i + 1], k[i:i + 1].contiguous(),
                                     v[i:i + 1].contiguous(), lengths[i:i + 1].clone())
                    for i in range(len(lens))]
            got = decode_attention(q, k, v, lengths)  # all rows: one split each
            torch.cuda.synchronize()
            for name, out in (("one row a call", torch.cat(rows)),
                              (f"B={len(lens)}", got)):
                err, ratio = compare(out, want, K2_TOL[dtype],
                                     f"K2 {hq}/{hkv}/{d} {dtype} {name}")
                max_abs = max(max_abs, err)
                log("K2", f"Hq/Hkv/D={hq}/{hkv}/{d} {str(dtype)[6:]} S_max={s_max}, "
                          f"{name} (a row alone: {-(-s_max // split)} splits of "
                          f"{split} keys), lengths={lens}: max_abs_err {err:.3e} "
                          f"(tol ratio {ratio:.3f} <= 1)")
    # the main path's own call: batch 1, 0.5B heads, bf16, a 416-slot cache
    # holding 400 keys
    q, k, v = draw(1, 14, 2, 64, 416, torch.bfloat16)
    ln = torch.tensor([400], dtype=torch.int32, device="cuda")
    err, ratio = compare(decode_attention(q, k, v, ln),
                         decode_attention_reference(q, k, v, ln),
                         K2_TOL[torch.bfloat16], "K2 main-path call")
    max_abs = max(max_abs, err)
    call = lambda: decode_attention(q, k, v, ln)
    ms = time_ms(call, reps=50)
    k_ms = kernel_time_ms(call, reps=50)
    h_us = host_us(call)
    plain_ms = time_ms(lambda: decode_attention_reference(q, k, v, ln), reps=50)
    mask = (torch.arange(416, device="cuda")[None, :] < ln[:, None])[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.view(1, 14, 1, 64), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    lib_ms = time_ms(sdpa, reps=50)
    lib_k_ms = kernel_time_ms(sdpa, reps=50)
    bound = attn_bound_ms(q, ln, 2, 2)
    log("K2", f"main-path call (B=1, 14/2/64 bf16, S_max=416, length 400, "
              f"split {split_size(1, 2, 64, 416, torch.bfloat16)} keys): "
              f"max_abs_err {err:.3e}; kernel time {fmt_ms(k_ms)} (profiler, one "
              f"launch), {ms:.4f} ms a call by events, wrapper host "
              f"{h_us:.2f} us a call; bound {bound * 1e3:.4f} us (bytes); plain "
              f"{plain_ms:.4f} ms; scaled_dot_product_attention kernel time "
              f"{fmt_ms(lib_k_ms)}, {lib_ms:.4f} ms a call by events")
    return max_abs, dict(ms=ms, kernel_ms=k_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, library_kernel_ms=lib_k_ms,
                         bound_ms=bound, host_us=h_us)


def kernel_profile(fn, reps: int = 20):
    """(device time of one call's kernels, {kernel: launches a call}) by
    torch.profiler (no host time), or (None, {}) where no session shows
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device time
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0]
        # each kernel's mean time, times its launches a call: a session
        # that drops some records still reads one call's kernel time
        us = sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
                 for e in rows)
        if us > 0:
            return us / 1000, {e.key: e.count / reps for e in rows}
    return None, {}


def kernel_time_ms(fn, reps: int = 20):
    """Device time of one call's kernels by torch.profiler, or None."""
    return kernel_profile(fn, reps)[0]


def _k3_case(gen, rng, hq, hkv, d, page, lengths, dtype, pool_pages=None,
             width=None, pad_rows=()):
    """q, a pool (P, page, Hkv, D) and (B, width) tables: each row's pages
    drawn at random from the pool (the rest of the pool decoys), -1 past its
    length, pad rows all -1. width defaults to P, a table as wide as the
    pool."""
    b = len(lengths)
    needs = [-(-int(n) // page) for n in lengths]
    p = pool_pages or sum(needs) + 5
    tables = np.full((b, width or p), -1, np.int32)
    perm = rng.permutation(p)
    used = 0
    for i, n in enumerate(needs):
        if i not in pad_rows:
            tables[i, :n] = perm[used:used + n]
            used += n

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    return (r(b, hq, d), r(p, page, hkv, d), r(p, page, hkv, d),
            torch.from_numpy(tables).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def phase_k3(gen):
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_reference, split_size)
    from fastvlm_tpu_torch.ops.kv_cache import gather_pages

    rng = np.random.RandomState(3)
    max_abs = 0.0

    def check(got, want, dtype, what):
        nonlocal max_abs
        err, ratio = compare(got, want, K3_TOL[dtype], f"K3 {what}")
        max_abs = max(max_abs, err)
        return f"{err:.3e} (ratio {ratio:.3f})"

    s_cap = 4096
    for hq, hkv, d in ((14, 2, 64), (12, 2, 128), (28, 4, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            for page in (8, 64, 128):
                geo = f"{hq}/{hkv}/{d} {str(dtype)[6:]} page {page}"
                # the split's edges at a capacity where a row alone takes
                # several splits (one cluster each); lengths 1 .. 2 split + 7
                # leave whole splits empty; row 6 is a pad row (table all
                # -1, reads page 0)
                split = split_size(1, hkv, d, s_cap, dtype)
                lens = [1, split - 1, split, split + 1, 2 * split + 7, s_cap, 5]
                args = _k3_case(gen, rng, hq, hkv, d, page, lens, dtype,
                                width=s_cap // page, pad_rows=(6,))
                q, kp, vp, tables, lengths = args
                want = paged_decode_attention_reference(*args)
                # one row a call (several splits, the counter merge), each
                # call made twice in a row on the stream: the second finds
                # the counters the first left at zero
                first, again = [], []
                for i in range(len(lens)):
                    row = (q[i:i + 1], kp, vp, tables[i:i + 1], lengths[i:i + 1])
                    first.append(paged_decode_attention(*row))
                    again.append(paged_decode_attention(*row))
                batched = paged_decode_attention(*args)
                torch.cuda.synchronize()
                first, again = torch.cat(first), torch.cat(again)
                errs = [check(out, want, dtype, f"{geo} {name}") for name, out in
                        (("one row a call", first), ("second call", again),
                         ("batched", batched))]
                if not torch.equal(first, again):
                    raise AssertionError(f"K3 {geo}: a second call on the "
                                         f"stream gave another result")
                # the batch at the page's edges, a table as wide as the pool
                plens = [1, page - 1, page, page + 1, 77, 1000, 5, 400]
                pargs = _k3_case(gen, rng, hq, hkv, d, page, plens, dtype,
                                 pad_rows=(6,))
                pool_err = check(paged_decode_attention(*pargs),
                                 paged_decode_attention_reference(*pargs),
                                 dtype, f"{geo} pool-wide table")
                log("K3", f"Hq/Hkv/D={geo}: capacity {s_cap} ({-(-s_cap // split)} "
                          f"splits of {split} for a row alone), lengths {lens} "
                          f"(row 6 unmapped): max_abs_err one row a call "
                          f"{errs[0]}, the same again {errs[1]} (bitwise equal), "
                          f"B=7 {errs[2]}; B=8 lengths {plens} (row 6 "
                          f"unmapped), table {tuple(pargs[3].shape)} spanning "
                          f"the pool: {pool_err}; tol ratios <= 1")
    # the serving call: B=8, 0.5B heads, bf16, lengths 400-600, page 64,
    # the scheduler's pool (256 pages + the sink) and its watermark table
    lengths = [int(n) for n in rng.randint(400, 601, size=8)]
    width = -(-max(lengths) // 64)
    args = _k3_case(gen, rng, 14, 2, 64, 64, lengths, torch.bfloat16,
                    pool_pages=257, width=width)
    call_err = check(paged_decode_attention(*args),
                     paged_decode_attention_reference(*args), torch.bfloat16,
                     "serving call")
    call = lambda: paged_decode_attention(*args)
    ms = time_ms(call, reps=50)
    k_ms, names = kernel_profile(call, reps=50)
    launches = sum(round(n) for n in names.values())
    if launches != 1 or any("merge_kernel" in k for k in names):
        raise AssertionError(f"K3 serving call: the profiler shows {names} "
                             f"a call, expected one kernel")
    h_us = host_us(call)
    plain_ms = time_ms(lambda: paged_decode_attention_reference(*args), reps=50)
    q, kp, vp, tables, lens_t = args
    # context: K2 on a dense cache of the same rows
    kd, vd = gather_pages(kp, tables), gather_pages(vp, tables)
    dense_k_ms = kernel_time_ms(lambda: decode_attention(q, kd, vd, lens_t), reps=50)
    wide = _k3_case(gen, rng, 14, 2, 64, 64, lengths, torch.bfloat16,
                    pool_pages=257, width=256)
    wide_k_ms = kernel_time_ms(lambda: paged_decode_attention(*wide))
    # where the body's time goes at this batch: the same bytes (lengths
    # 400-512) with one 64-key tile a block (a 512-position table) and with
    # two (640 positions), K3 and K2 on a dense cache of the same rows
    tiles = {}
    short = [int(n) for n in rng.randint(400, 513, size=8)]
    for n_tiles, cols in ((1, 8), (2, 10)):
        a = _k3_case(gen, rng, 14, 2, 64, 64, short, torch.bfloat16,
                     pool_pages=257, width=cols)
        kd2, vd2 = gather_pages(a[1], a[3]), gather_pages(a[2], a[3])
        tiles[n_tiles] = (kernel_time_ms(lambda: paged_decode_attention(*a), reps=50),
                          kernel_time_ms(lambda: decode_attention(a[0], kd2, vd2, a[4]),
                                         reps=50))
    log("K3", f"lengths {min(short)}-{max(short)}, B=8, 14/2/64 bf16: one tile a "
              f"block K3 {fmt_us(tiles[1][0])}, K2 dense {fmt_us(tiles[1][1])}; two "
              f"tiles a block K3 {fmt_us(tiles[2][0])}, K2 dense "
              f"{fmt_us(tiles[2][1])} (kernel time, profiler)")
    bound = attn_bound_ms(q, lens_t, 2, 2) + tables.numel() * 4 / HBM_BPS * 1e3
    share = "not measured" if k_ms is None else f"{bound / k_ms:.4f}"
    log("K3", f"serving call (B=8, 14/2/64 bf16, page 64, lengths "
              f"{min(lengths)}-{max(lengths)}, table {width} columns, split "
              f"{split_size(8, 2, 64, width * 64, torch.bfloat16)}): max_abs_err "
              f"{call_err}; kernel time {fmt_us(k_ms)} (profiler: "
              f"{'; '.join(f'{k[:60]} x{n:g}' for k, n in names.items())} a "
              f"call), {ms:.4f} ms a call by events, wrapper host {h_us:.2f} "
              f"us a call; bound {bound * 1e3:.4f} us (bytes), share of the "
              f"bound {share}; plain {plain_ms:.4f} ms; context: K2 on a dense "
              f"cache of the same rows {fmt_us(dense_k_ms)} kernel time; with "
              f"a 256-column table spanning the pool {fmt_us(wide_k_ms)} "
              f"kernel time")
    return max_abs, dict(ms=ms, kernel_ms=k_ms, plain_ms=plain_ms, bound_ms=bound,
                         host_us=h_us, dense_k2_kernel_ms=dense_k_ms)


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
            "peak_gib": peak_gb, "engine": engine}


class Client:
    """One request to a BatchScheduler on its own thread; ``decoding`` is
    set at its second update (a decode chunk landed), ``t_closed`` is the
    host clock when its stream closed."""

    def __init__(self, sched, engine, prompt, image, cap, sampling=None):
        self.updates = []
        self.decoding = threading.Event()
        self.t_closed = None
        self.thread = threading.Thread(target=self._run, args=(
            sched, engine.build_prompt(prompt), image, cap, sampling))
        self.thread.start()

    def _run(self, sched, prompt, image, cap, sampling):
        for u in sched.submit(prompt, image, max_new_tokens=cap,
                              sampling=sampling):
            self.updates.append(u)
            if len(self.updates) >= 2:
                self.decoding.set()
        self.t_closed = time.perf_counter()
        self.decoding.set()

    def result(self, what):
        self.thread.join(timeout=JOIN_S)
        if self.thread.is_alive() or not self.updates:
            raise AssertionError(f"{what}: stream did not close")
        last = self.updates[-1]
        if "error" in last or last["stats"]["finish_reason"] not in (
                "stop", "length"):
            raise AssertionError(f"{what}: {last}")
        return last


def _logit_gaps(row, tok):
    """(batch token's gap below the maximum, top-1 minus top-2), both in
    bf16 ulps of the maximum's magnitude."""
    top2 = row.topk(2).values
    top = float(top2[0])
    ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
    return (top - float(row[tok])) / ulp, (top - float(top2[1])) / ulp


def _dense_replay(engine, prompt, image, ids):
    """Teacher-force ``ids`` through the dense single-request path (kernel
    K2); the (gap, top-1/top-2 gap) of every step, in bf16 ulps."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg = engine.cfg
    gaps = []
    with torch.inference_mode():
        inputs = engine.prepare(engine.build_prompt(prompt), image)
        t = inputs["ids"].shape[1]
        cache = init_cache(cfg.decoder.num_layers, 1, t + len(ids),
                           cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                           torch.bfloat16, "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                    inputs["ids"], inputs["lens"],
                                    inputs["starts"], cache)
        for step, tok in enumerate(ids):
            row = logits[0].float()
            if not bool(torch.isfinite(row).all()):
                raise AssertionError(f"replay step {step}: non-finite logits")
            gaps.append(_logit_gaps(row, tok))
            logits, cache = vlm.decode_step(
                engine.params, cfg,
                torch.tensor([tok], dtype=torch.int32, device="cuda"), cache)
    return gaps


def _step_profile(engine, rng):
    """Steady-state decode at the serve phase's batch and lengths: 8 rows
    of 330-370 tokens, text only, greedy, 8-token chunks; the scheduler's
    pool (256 pages of 64, each row's pages scattered over it) against a
    dense cache of the same rows. Step ms by the host clock from dispatch
    to the host read (the scheduler's own measure), over passes in the
    order paged, dense, dense, paged; then one profiled pass of each:
    kernels, device ms and attention-kernel ms a step (K3 paged, K2
    dense)."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache, init_paged_cache
    from fastvlm_tpu_torch.ops.sampling import RowSampling, SamplingParams

    dec = engine.cfg.decoder
    b, k, page, pool = 8, engine.chunk, 64, 256
    lengths = rng.randint(330, 371, size=b).astype(np.int32)
    span = -(-(int(lengths.max()) + 5 * k) // page)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    paged = init_paged_cache(dec.num_layers, b, pool, page, span,
                             dec.num_kv_heads, dec.head_dim, torch.bfloat16,
                             "cuda")
    tables = rng.permutation(pool)[:b * span].reshape(b, span)
    paged = dataclasses.replace(
        paged, block_tables=torch.from_numpy(tables.astype(np.int32)).cuda())
    dense = init_cache(dec.num_layers, b, span * page, dec.num_kv_heads,
                       dec.head_dim, torch.bfloat16, "cuda")
    for t in (paged.k_pages, paged.v_pages, dense.k, dense.v):
        t.normal_(generator=gen)
    start = torch.from_numpy(lengths).cuda()
    tok0 = torch.randint(0, dec.vocab_size, (b,), generator=gen,
                         device="cuda", dtype=torch.int32)
    rows = RowSampling.build([SamplingParams()] * b, b, "cuda")

    def chunks(cache, n):
        """Reset the rows, one warm chunk, then n chunks; their ms."""
        cache = dataclasses.replace(cache, lengths=start.clone())
        tok, done = tok0, torch.zeros((b,), dtype=torch.bool, device="cuda")
        out = []
        for i in range(n + 1):
            t0 = time.perf_counter()
            toks, done, tok, cache = vlm.decode_chunk(
                engine.params, engine.cfg, tok, done, cache, gen, k=k,
                eos_ids=engine.eos_ids, row_sampling=rows)
            toks.cpu()
            if i:
                out.append((time.perf_counter() - t0) * 1000)
        return out

    caches = {"paged": paged, "dense": dense}
    step_ms = {"paged": [], "dense": []}
    with torch.inference_mode():
        for name in ("paged", "dense", "dense", "paged"):
            step_ms[name].append(statistics.median(chunks(caches[name], 4)) / k)
        prof_out = {}
        for name, cache in caches.items():
            chunks(cache, 0)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                chunks(cache, 1)
                torch.cuda.synchronize()
            rows_ = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
            steps = 2 * k  # the warm chunk and the one after it
            # K3's paged_decode_kernel, K2's decode_kernel
            attn_rows = [e for e in rows_ if "decode_kernel" in e.key]
            attn = sum(e.self_device_time_total for e in attn_rows)
            prof_out[name] = {
                "kernels": sum(e.count for e in rows_) / steps,
                "attn_ops": sum(e.count for e in attn_rows) / steps,
                "device_ms": sum(e.self_device_time_total
                                 for e in rows_) / steps / 1000,
                "attn_ms": attn / steps / 1000}
    return {"lengths": (int(lengths.min()), int(lengths.max())),
            "step_ms": step_ms, "profile": prof_out}


def phase_serve(card, main_engine):
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)
    from fastvlm_tpu_torch.ops.sampling import SamplingParams
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler

    cfg = main_engine.cfg
    layers = cfg.decoder.num_layers
    engine = Engine(cfg, main_engine.params, IdTokenizer(), chunk=8)
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, (1024, 1024, 3), dtype=np.uint8)
              for _ in range(7)]
    first = [("Describe the image.", 0), ("What is in the picture?", 1),
             ("Describe the scene in detail.", 2), ("Read the text.", 3)]
    late = [("Describe the image.", 4, None), ("Describe the image.", 4, None),
            ("What colour dominates?", 5, None),
            ("Write a story about it.", 6, SamplingParams(temperature=0.7))]

    def serve_round(name):
        """The traffic once, through a fresh scheduler; (scheduler, last
        updates, K1/K2/K3 launches)."""
        sched = BatchScheduler(engine, max_batch=8, window_ms=100,
                               page_size=64, pool_tokens=16384)
        sched.trace = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_ffn.launches = 0
        decode_attention.launches = 0
        paged_decode_attention.launches = 0
        try:
            clients = [Client(sched, engine, p, images[i], 32)
                       for p, i in first]
            if not clients[0].decoding.wait(JOIN_S):
                raise AssertionError(f"{name}: the first batch never decoded")
            clients += [Client(sched, engine, p, images[i], 32, sp)
                        for p, i, sp in late]
            last = [c.result(f"{name} request {n}")
                    for n, c in enumerate(clients)]
            launches = (fused_ffn.launches, decode_attention.launches,
                        paged_decode_attention.launches)
        finally:
            sched.shutdown()
        t_end = max(c.t_closed for c in clients)
        return sched, last, launches, t_end

    # a first round meets the batch-4 encoder and batch-8 decoder shapes
    # cold (library set-up); the second is measured and checked
    t0 = time.perf_counter()
    serve_round("warm-up")
    log("serve", f"warm-up round of the same traffic: "
                 f"{time.perf_counter() - t0:.1f} s")
    sched, last, (k1, k2, k3), t_end = serve_round("serve")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    counters = dict(sched.counters)
    for n, u in enumerate(last):
        st = u["stats"]
        log("serve", f"request {n}{' (sampled)' if n == 7 else ''}: ttft "
                     f"{st['ttft_ms']:.3f} ms, queue {st['queue_ms']:.3f} ms, "
                     f"{st['decode_tokens']} tokens, {st['finish_reason']}")
    log("serve", f"counters {counters}")
    if counters.get("admitted", 0) < 1 or counters.get("grown", 0) < 1:
        raise AssertionError("no admission or no grow in the serve phase")
    if k1 != 44 * counters["prefills"]:
        raise AssertionError(f"K1 launched {k1} times for "
                             f"{counters['prefills']} prefill dispatches")
    if k3 == 0 or k3 != layers * counters["decode_steps"]:
        raise AssertionError(f"K3 launched {k3} times for "
                             f"{counters['decode_steps']} decode steps")
    if k2 != 0:
        raise AssertionError(f"K2 launched {k2} times on the paged path")
    if sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError(f"{sched.pool.free_pages} of "
                             f"{sched.pool.num_pages} pages free after serving")
    if last[4]["text"] != last[5]["text"]:
        raise AssertionError("the identical pair gave different ids")
    log("serve", f"launch counts: K1 {k1} = 44 x {counters['prefills']} "
                 f"prefill dispatches; K3 {k3} = {layers} x "
                 f"{counters['decode_steps']} decode steps; K2 0; pool "
                 f"{sched.pool.free_pages}/{sched.pool.num_pages} pages free; "
                 f"identical pair gave identical ids")

    # served rate: every streamed token over the wall time from the first
    # batch's start to the last stream's close (prefills, admissions and
    # grows included)
    t_start = next(e[0] for e in sched.trace if e[1] == "batch_start")
    served = sum(u["stats"]["decode_tokens"] for u in last)
    wall_s = t_end - t_start
    # and the chunks that ran with 8 live rows: k x 8 token slots (slots
    # past a row's cap or EOS included) over dispatch-to-host-read time
    disp = [e for e in sched.trace if e[1] == "disp"]
    at8 = [e for e in disp if e[3] == 8]
    if not at8:
        raise AssertionError(f"no decode chunk ran with 8 live rows: {disp}")
    slots_s = sum(e[4] * e[3] for e in at8) / sum(e[5] for e in at8) * 1000
    step_ms = statistics.median(e[5] / e[4] for e in at8)
    log("serve", f"served {served} tokens in {wall_s * 1000:.3f} ms from "
                 f"the first batch's start to the last stream's close: "
                 f"{served / wall_s:.3f} tok/s; {len(at8)} chunks with 8 "
                 f"live rows: {slots_s:.3f} token slots/s, a decode step "
                 f"{step_ms:.3f} ms (median); peak device memory "
                 f"{peak_gb:.3f} GiB on {card}")

    # teacher-forced replay through the dense single-request path (kernel
    # K2) of request 0 (a row of the batched prefill) and request 6 (an
    # admitted row): every batch token ranks within the tie margin
    for n, (prompt, img) in ((0, first[0]), (6, late[2][:2])):
        ids = [int(t) for t in last[n]["text"].split(",") if t]
        gaps = _dense_replay(engine, prompt, images[img], ids)
        worst = max(g for g, _ in gaps)
        log("serve", f"dense replay of request {n}: {len(ids)} steps, batch "
                     f"tokens within {worst:.2f} bf16 ulps of the dense "
                     f"maximum (limit {TIE_ULPS}); top-1 minus top-2 per "
                     f"step, ulps: {[round(t, 2) for _, t in gaps]}")
        if worst > TIE_ULPS:
            bad = next(s for s, (g, _) in enumerate(gaps) if g > TIE_ULPS)
            raise AssertionError(
                f"replay of request {n}, step {bad}: batch token "
                f"{ids[bad]} scores {gaps[bad][0]:.1f} bf16 ulps below the "
                f"dense maximum (limit {TIE_ULPS})")

    prof = _step_profile(engine, rng)
    lo, hi = prof["lengths"]
    for name in ("paged", "dense"):
        p = prof["profile"][name]
        log("serve", f"steady-state decode, batch 8, lengths {lo}-{hi}, "
                     f"{name} cache: a step {prof['step_ms'][name][0]:.3f} / "
                     f"{prof['step_ms'][name][1]:.3f} ms (two passes); "
                     f"{p['kernels']:.1f} device ops, {p['device_ms']:.4f} "
                     f"ms of device time, attention kernels "
                     f"({'K3' if name == 'paged' else 'K2'}) "
                     f"{p['attn_ms']:.4f} ms in {p['attn_ops']:.1f} launches a "
                     f"step (profiler)")
    p, dn = prof["profile"]["paged"], prof["profile"]["dense"]
    share = p["attn_ms"] / statistics.mean(prof["step_ms"]["paged"])
    ratio = p["attn_ms"] / dn["attn_ms"] if dn["attn_ms"] else float("nan")
    log("serve", f"K3's share of a steady-state paged step: {share:.4f} of "
                 f"the wall time, {p['attn_ms'] / p['device_ms']:.4f} of the "
                 f"device time; K3 over K2 a step (paged / dense attention "
                 f"ms): {ratio:.4f}")
    return {"k3_launches": k3, "tok_s": served / wall_s, "peak_gib": peak_gb}


def phase_small():
    from fastvlm_tpu_torch.engine import Engine, tiny_config
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)
    from fastvlm_tpu_torch.ops.kv_cache import init_cache
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler
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

    # the same model through the scheduler, on the card and on the CPU:
    # 3 concurrent greedy requests, the serial engine's ids
    prompts = ["Describe the image.", "What is in it?", "Name the colours."]
    batched = {}
    for dev in ("cuda", "cpu"):
        engine = Engine(cfg, to_device(cpu_params, dev), IdTokenizer())
        before = paged_decode_attention.launches
        sched = BatchScheduler(engine, window_ms=300, page_size=16)
        try:
            clients = [Client(sched, engine, p, image, 24) for p in prompts]
            batched[dev] = [c.result(f"small {dev} request {n}")["text"]
                            for n, c in enumerate(clients)]
        finally:
            sched.shutdown()
        if dev == "cuda" and paged_decode_attention.launches == before:
            raise AssertionError("the card's scheduler never launched K3")
    serial = [engine.generate(engine.build_prompt(p), image,
                              max_new_tokens=24)[0] for p in prompts]
    if not batched["cuda"] == batched["cpu"] == serial:
        raise AssertionError(f"scheduler ids differ: card {batched['cuda']} "
                             f"CPU {batched['cpu']} serial {serial}")
    log("small", "scheduler, 3 concurrent greedy requests: card (K3) and "
                 "CPU batched ids equal the serial engine's")


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
    k1_err, k1 = phase_k1(gen)
    k2_err, k2 = phase_k2(gen)
    k3_err, k3 = phase_k3(gen)
    main_res = phase_main(card)
    serve_res = phase_serve(card, main_res.pop("engine"))
    phase_small()

    kernels = {"kernels": [
        {"name": "fused_ffn", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/ffn.cu",
         "replaces": "fastvlm_tpu/ops/pallas/ffn.py:76",
         "launches": main_res["k1_launches"], "max_abs_err": k1_err,
         "ms": k1["ms"], "kernel_ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "operations",
         "library_ms": None, "library_chain_ms": k1["chain_ms"],
         "timed_as": "44 calls of one 1024 px image, bf16, ls folded; "
                     "bound_by: the sum is set by the 40 calls of stages "
                     "1-3; library_chain_ms: addmm-gelu-addmm-add in bf16 "
                     "cuBLAS, context only"},
        {"name": "decode_attention", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/decode_attention.cu",
         "replaces": "fastvlm_tpu/ops/pallas/decode_attention.py:167",
         "launches": main_res["k2_launches"], "max_abs_err": k2_err,
         "ms": k2["ms"], "kernel_ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": k2["library_ms"],
         "library_kernel_ms": k2["library_kernel_ms"], "host_us": k2["host_us"],
         "timed_as": "one call, B=1, 14/2/64 bf16, S_max 416, length 400; "
                     "ms by events per call; library: "
                     "scaled_dot_product_attention with enable_gqa"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/paged_decode_attention.cu",
         "replaces": "fastvlm_tpu/ops/pallas/decode_attention.py:215",
         "launches": serve_res["k3_launches"], "max_abs_err": k3_err,
         "ms": k3["ms"], "kernel_ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "host_us": k3["host_us"], "dense_k2_kernel_ms": k3["dense_k2_kernel_ms"],
         "timed_as": "one call, B=8, 14/2/64 bf16, page 64, lengths "
                     "400-600, watermark table; ms by events per call; "
                     "launches from the serve phase; dense_k2_kernel_ms: K2 "
                     "on a dense cache of the same rows, context only"},
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
