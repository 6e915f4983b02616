#!/usr/bin/env python3
"""Smoke run of the PyTorch port (fastvlm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card and the CUDA
toolkit's nvcc, and imports nothing of JAX. Phases, each printing lines
tagged with its name and raising on failure (so the exit code is
non-zero):

  1. device   the card's name; nvidia-smi's name and power limit
  2. build    nvcc builds kernels K1-K5 from fastvlm_tpu_torch/csrc/,
              one process per source, all started together
  3. K1       fused_ffn vs ffn_reference at the five FastViTHD stage shapes
              of a 1024 px image (bf16, with ls and with ls=None) and ragged
              row counts on both routes; per stage the kernel's time,
              TFLOP/s and share of its bound, the plain version's and the
              bf16 cuBLAS chain's (context). The library's route for each
              (C, Ch) against ops/cuda/ffn.py's kernel_route. Then the f32
              route (3xTF32) the same way in f32, with ragged rows on both
              tensor-core routes and C = 48 (the general route): per stage
              and per image the kernel's time beside the 3xTF32 bound, the
              CUDA-core f32 figure, the plain version and an f32 cuBLAS
              chain
  4. K2       decode_attention vs decode_attention_reference at the 0.5B,
              1.5B and 7B head geometries and LLaVA-1.5-7B's 32/32/128
              (one query row a KV head), bf16 and f32, lengths at the
              split size's edges (1, split-1, split, split+1, one leaving
              whole splits empty, S_max); then the main-path call timed:
              kernel (profiler), per call by events, the wrapper's host us,
              against scaled_dot_product_attention (library_ms)
  5. K3       paged_decode_attention vs paged_decode_attention_reference at
              the 0.5B, 1.5B, 7B and 32/32/128 head geometries, bf16 and
              f32, pages of
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
  5b. K4     prefill_attention vs a float64 reference and its plain
              version at the main path's shapes: a burst of 8 (T = 1344,
              lengths 1300-1344, 3 one-token padding rows), a suffix of 320
              after 1024 cached keys (S = 1408), 256-token chunks over
              offsets at B = 1, at 12/2/128, 14/2/64 and 28/4/128, one case
              in fp16; k and v strided views. Its max error must be within
              the plain version's plus half an ulp of the output; then per
              case its kernel time (one kernel a call), by events, bound
              and share, the plain version's time; SDPA as context
  5c. K4w, K3w, K5  Mellum2's kernels at its 32/4/128 heads and expert
              widths: K4 with a window (1024 at the vqa-doc3k burst, a
              chunk far past the window and one across it, rows shorter
              than it; 100; none) against float64 and its plain version,
              as 5b; K3 with a window across its edges at pages 64 and 16
              against its plain version, twice bitwise equal, then the
              serving call with and without it; K5 (routed_experts)
              against experts_reference at a burst's 27,200 tokens, a
              row's, 1024 and 512 tokens, a 256-token chunk's, a decode
              step's, with padding rows and with experts that get no token
              (near-tie tokens routed apart left out), on the route each
              shape takes and, but for the last three, on the other route
              too; each kernel's time beside the call's bound (port_bench's
              counts), torch._grouped_mm as context
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
  7b. serve-view  the JAX scheduler's serving modes over phase 7's engine:
              8 greedy requests of 32 new tokens (4 with distinct 1024 px
              images at once, then 2 and 2 more admitted once the ones
              before decode) through fresh schedulers in place (K3),
              chunk_view=True, persist_view=True and persist_view=True,
              pipeline_depth=2, in turns and back. Checks every stream's
              finish, 4 admissions and (but at depth 2) a grow, K1 = 44 per
              image prefill,
              K3 = 24 a decode step and no K2 in place, K2 = 24 a step and
              no K3 with a view, the persistent view's gathers, syncs and
              row updates, pipelined groups at depth 2, the pool's pages
              all back, and a dense teacher-forced replay of every
              distinct answer within the tie margin. Prints served tok/s,
              a step's ms and the counters of each round; a steady-state
              profile of each mode at batch 8 (step ms, device ops and
              ms, K2 / K3 launches and ms a step: K2 24 and K3 0 on the
              persistent view); then a pool smaller than the prompts: the
              gathered batch served on a dense cache (K1 44, K2 24 a step,
              K3 0, no page mapped, replays). ``--serve-view-only`` runs
              phases main and serve-view alone
  8. serve-1.5b  a BatchScheduler at the JAX scheduler's defaults for a
              1.5B decoder (prefix cache on, 256-token chunked admission,
              2 rows mid-prefill at most) over a full-width engine:
              FastViTHD @1024, mlp2x_gelu 3072->1536, Qwen2-1.5B (28
              layers, 12/2/128), bf16, random weights from a seed; pool
              16384 tokens, 64-token pages, 8-token chunks. Every request
              carries one system prompt that puts 4 full pages before the
              image slot. Wave A: 4 requests with distinct images at once
              (prefix misses); wave B: 4 more once A decodes, admitted mid-
              batch (prefix hits; suffixes of ~300 tokens, so chunked
              admissions); wave C: 4 at once after A and B close (one
              batched suffix prefill over the cached prefix). 32 new tokens
              each, greedy, after a warm-up round through a fresh scheduler.
              Checks every finish reason, prefix hits >= 8, chunked
              admissions >= 1, prefill chunks >= 2, K3 = 28 per decode step,
              K4 = 28 per prefill call (vlm.prefill, prefill_continue),
              no K2, K1 = 44 per prefill dispatch that encodes images, every
              page back but those the prefix registry pins, and a dense
              teacher-forced replay (K2) of a chunked wave-B request and a
              wave-C request within the tie margin. Prints TTFT and queue ms
              per request by wave, the live rows' step time and token
              interval with and without a row mid-prefill, served tok/s,
              peak memory. Then chunked against single-shot admission of
              one late prefix hit into 5 live rows at batch 8, through
              fresh schedulers in turns (chunked, single, single, chunked):
              its TTFT and the live rows' step and token interval
  9. video    VideoQA on phase 6's engine: a fixed question over 6 uint8
              1080x1920 camera frames (resized on the card), 32 new tokens,
              greedy. Checks K1 = 44 per frame and K2 = 24 per decode step,
              that qa_over_stream(pipelined=True) gives the sequential ids,
              and that each frame's answer, replayed teacher-forced through
              the engine's full-prefill path, stays within the tie margin.
              Prints each frame's TTFT (suffix prefill) beside a full
              prefill of the same prompt and frame on the same engine, and
              per-frame total ms, sequential and pipelined
 10. spec     prompt-lookup speculative decoding on phase 6's engine, batch
              1, greedy, 64 new tokens: 3 prompts (the main one, one that
              repeats a phrase, the video question) each through generate,
              generate_spec and stream(spec=True), in turns; checks K1 = 44
              per request, no K2 in a spec request (verify passes take the
              plain attention), stream(spec=True)'s text = generate_spec's,
              each spec answer's dense teacher-forced replay (K2) within the
              tie margin; prints plain and spec tok/s, verify passes, tokens
              a pass, accept rate, and a verify pass's wall ms, device ms
              and launches (profiler, which must show no K2) beside a plain
              step's. Then VideoQA(spec=True) over the video phase's 6
              frames (K1 = 44 a frame, no K2, pipelined == sequential ids,
              replays; frame ms beside a plain VideoQA's). Then a
              BatchScheduler(spec=True) (spec_max_rows 1): one greedy
              request alone in spec chunks, a second admitted, after which
              plain chunks serve both (spec dispatches > 0, K3 = 24 a plain
              step, no K2, pool back, replays of both)
 11. checkpoint  phase 6's weights exported (utils/hf_export) as a bf16
              pytorch_model.bin + config.json in a temporary directory and
              loaded back by build_engine(dir, tokenizer=IdTokenizer()):
              every tensor of the loaded engine equals phase 6's bitwise
              (the decoder fused the same way; phase 6's float32 projector
              after the bf16 cast it gets at use) and the configs are
              equal; two of phase 6's prompts through the loaded engine
              (K1 44 a request, K2 24 a step; each answer's dense replay
              through phase 6's engine within the tie margin; how many
              equal phase 6's ids); verify_checkpoint(dir) on the card
              (no unused key, finite features of (1, 256, 896) and a finite
              (1, 16, 16, 3072) tower grid). Prints the file's size, write
              and load-and-convert seconds
 12. beam     Engine.generate_beam (W = 4, 32 new tokens) on the loaded
              engine, 3 prompts (an identical pair): K1 44 and K2 24 x 31
              a request (at batch 4), identical ids for the pair; K2 at
              the beam's shape (B = 4 equal lengths, the beam cache's
              S_max) against its plain version; the chosen score against a
              dense batch-1 replay's summed log-softmax over the length
              (BEAM_SCORE_TOL); W = 1 against greedy generate (equal ids,
              or a dense replay within the tie margin). Prints each
              request's ms and tok/s, peak memory, and a beam step's wall
              ms, device ms and launches beside a greedy step's
 13. llava15  LLaVA-1.5-7B at full width (CLIP ViT-L/14-336, penultimate
              layer, 576 patch tokens of 1024 channels; mlp2x_gelu 1024 ->
              4096; Vicuna-7B = llama_7b, 32 layers, 32/32/128), bf16,
              random weights from a seed, byte tokenizer, template v1, after
              the anyres and serve-1.5b engines are freed: the tower's
              features finite and non-zero (mean |x|), another image moving
              the first-token logits; 4 greedy requests of 32 tokens with a
              576-token image span (K1 0, K2 32 a step), two of them replayed
              teacher-forced within the tie margin; warm TTFT, decode tok/s,
              tower + projector ms by events and kernel time, a decode
              step's wall / device ms and launches; K2 at 32/32/128 against
              its plain version at the phase's cached length, B = 1 and
              B = 4 (kernel time, bound, SDPA); S2 (336/672/1008, 14 crops,
              3072 channels) ms, its first 1024 channels against the
              single-scale features
 13b. serve-mellum  Mellum2-12B-A2.5B at full width (the benchmark's
              bf16 draw) through the vqa-doc3k cell's scheduler after the
              7B is freed: 12 requests of ~3.4k tokens; every prefill call
              28 K4 (21 windowed) and 28 K5 calls, every decode step 28 K3
              (21 windowed) and 28 K5, nothing through qwen2._attend or
              _attend_pool; a gathered prefill's 28 K5 calls on the
              grouped route, a decode step's on the Triton one; its 12B
              freed before the next phase
 14. worker   serve/worker.ModelWorker in process, pumped through
              generate_stream as the HTTP routes pump it (the card's machine
              has no aiohttp): (a) serially over phase 6's engine: base64
              PNG payloads stream engine.generate's text, a spec payload
              engine.stream(spec=True)'s, spec + temperature one
              CLIENT_ERROR chunk, an OpenAI body with a data: URI image the
              native payload's text; (b) with continuous batching over it:
              BatchScheduler.warmup's count and seconds, then
              scripts/soak_serving.py's plan at n = 16 from threads (mixed
              greedy and sampled, budgets, a shared template prefix, 2
              cancelled through the cancel event at their first token):
              clean closes, cancels counted, the pool whole, status() =
              the counters, K1 44 an image prefill, K3 24 a step, no K2;
              TTFT and served tok/s; (c) with continuous batching over the
              7B: 4 concurrent image requests, each its serial ids, K3 32 a
              step; the batch-4 step's wall / device ms and K3 at that call
              (B = 4, 32/32/128) against its plain version and its bound
 15. quant    FastVLM-7B (FastViTHD @1024 re-drawn live, mlp2x_gelu 3072 ->
              3584, Qwen2-7B: 28 layers, 28/4/128, FFN 18944, untied head,
              vocab 152064) with its decoder drawn in bf16 a layer at a
              time and quantized at once: int8 weight-only (7b-batch8,
              7b-caption), W8A8 (7b-batch8-w8a8: the same int8 weights with
              the a8 marker) and int4 (7b-int4, batch 1). The products at
              7B's widths against their plain versions (the _int_mm
              accumulator and W8A8's output bitwise, weight-only within
              WO_ULPS), _int_mm with a K-major against a row-major weight,
              and each width's ms (bf16 F.linear, int8, W8A8, int4) at
              M = 1, 8 and 2560. Per path: 3 batch-1 requests of 32 tokens
              (TTFT, tok/s; K1 44 a request, K2 28 a step, a replay within
              the tie margin) and, but for int4, a batch-8 prefill of 8
              images (TTFT, K1 44) and 32 decode steps (tok/s, K2 28 a
              step; rows 0 and 7 replayed at batch 1); peak memory. K2 at
              28/4/128, B = 8 against its plain version, its bound and
              SDPA. Then the 0.5B decode at int8 and W8A8 (decode-int8,
              decode-w8a8) beside phase main's bf16 tok/s
 16. kv-int8  the 0.5B with kv_cache_dtype="int8": 2 requests (replays;
              ids beside the bf16 cache's), generate_beam W = 4,
              generate_spec (replay), VideoQA over two 1080x1920 frames
              and the first again (equal ids), a BatchScheduler's dense
              batch of 8 (one prefill, replays of two rows); K2 and K3 0
              throughout; a batch-8 step's wall / device ms and launches
              beside the bf16 cache's
 17. export   the full-width tower exported on the card
              (export.export_vision_encoder, torch.export) and loaded back:
              44 fastvlm::fused_ffn ops, K1 44 launches a call, bitwise
              equal to eager, ms beside eager; a 1.5B int8 bundle
              (export.quantize_checkpoint) written, restored onto the card
              and served: the in-memory quantized engine's ids
 18. train    SFT at FastVLM-0.5B's full width (FastViTHD @1024 re-drawn
              live, mlp2x_gelu 3072 -> 896, Qwen2-0.5B; bf16, random
              weights from a seed) through Trainer.train on 16 synthetic
              qwen_2 records (1024x768 JPEG / PNG images, answers of
              64-256 bytes; byte tokenizer, SupervisedDataset,
              LengthGroupedSampler, collate): 12 steps at batch 4, tower
              frozen (the loss must fall; step ms, trained tokens/s, the
              host's data ms and which image loader ran, peak memory, the
              idle share of two more steps and their top kernels; K1 44 a
              step, one call a block over the batch, no K2 / K3); save and
              resume through save_native / restore_native (params and
              moments bitwise, one more step); LoRA r = 8 for 6 steps (only
              the adapters move; merged against unmerged greedy ids, the
              merged ids replayed through the unmerged adapters within the
              tie margin, the adapters' shift of the first logits); QLoRA
              on an int8 base for 6 steps; K1 through FusedFFNFunction at
              the five widths and a batch's rows against ffn_reference
              (forward and gradients), then the tower unfrozen for 3 steps
              (every tower leaf's gradient non-zero); FastVLM-0.5B in
              float32 (train_sft's default) for 3 steps, tower frozen:
              first K1's f32 route against ffn_reference at the five widths
              and a batch's rows (ls and ls=None, K1_TOL[float32]), beside
              the ratio a TF32 plain version reads as a control; then K1
              44 a step on its f32 tensor-core routes, step ms, K1's kernel
              time and share of a step's kernels, peak memory, the losses
              against the same steps through ffn_reference (TRAIN_F32_REL);
              a tiny f32 model trained 3 steps with its tower unfrozen on
              the card and on the CPU (losses and params within
              TRAIN_SMALL_TOL)
 19. parallel parallel training at world size 1 over NCCL (one card: NCCL
              takes one rank a device): first the multi-process
              launcher's probe (tools/train_multihost --probe, its default
              device: the card) in a one-process torchrun world, which must
              print MULTIHOST_OK 0/1; then parallel/distributed.initialize
              with a one-rank env and a file:// store, make_mesh(1, 1) on
              cuda; each differentiable collective checked exact at size
              1; then phase train's FastVLM-0.5B weights and records
              through Trainer for 3 steps in six modes (mesh TP/DP,
              seq_parallel, zero1, FSDP, pp_micro=2, FSDP with the tower
              unfrozen: K1 through FusedFFNFunction on gathered leaves),
              each against the one-process trainer's 3 losses (max
              relative difference: 0, and the params after the steps
              bitwise, but for pp, held to PARALLEL_PP_REL_TOL, a limit a
              step 10% off in size is checked to exceed), its step wall
              ms and peak memory, K1 44 a step; a 4-step FSDP checkpoint
              written under the mesh
              and resumed by a one-process trainer, params and moments
              bitwise
 20. tp       the tensor-parallel engine (Engine(mesh=)): K2 and K3 at the
              heads a rank holds (7/1/64, 6/1/128, 14/2/128, 7/1/128: the
              0.5B and 1.5B at tp 2, the 7B at tp 2 and 4), bf16, against
              their plain versions at phase K2's / K3's split edges, one row
              a call and B = 8, with each serving call's kernel time, bound
              and plain time (and SDPA's beside K2); then Engine(mesh=
              make_mesh(1, 1)) over NCCL at world size 1 (NCCL takes one
              rank a device, and the machine has one card): phase main's
              three requests give phase main's ids bit for bit (K1 44 a
              request, K2 24 a step); then a world of 2 gloo processes
              sharing the card (this script with --tp-rank, a file://
              store): each draws phase main's weights and keeps its cut
              (7/1/64 heads, half the MLP and the vocab), rank 0 serves
              two Engine.generate requests (1024 px, 32 tokens, greedy)
              and 4 requests at once through a BatchScheduler (K3 at
              7/1/64) while rank 1 follows; checks that every rank made
              rank 0's device calls with bitwise equal outputs, K1 44 a
              prefill and K2 / K3 24 a step on every rank, and replays
              four answers through phase main's engine within the tie
              margin; prints TTFT, step wall ms and collectives a step
              (gloo stages CUDA tensors through the host and both ranks
              share one card's SMs: a correctness run, not TP's speed)
 21. small    a small f32 model on the card (kernels) agrees with the same
              model on the CPU (plain versions), logits and greedy ids,
              spec_decode's tokens, counts, passes and acceptances, and
              beam_search's tokens, lengths and scores (W = 3, K2 at batch
              3); the same model through a BatchScheduler on the card and
              on the CPU gives 3 concurrent greedy requests the serial
              engine's ids, and one greedy request through
              BatchScheduler(spec=True) on the card gives them too

f32 comparisons run with TF32 off for both matmuls and cuDNN convolutions:
the script sets torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 to False at start. K1's times are CUDA
events around a run of back-to-back calls, over the count; K2's and K3's
per-call times are medians of CUDA events around each call (the wrapper's
host time included). Kernel time alone (kernel_ms) comes from
torch.profiler. Bounds (bound_ms) are computed from this run's shapes: the
larger of the bytes each kernel must move over 3.35 TB/s and its FLOPs
over 989 TFLOP/s (bf16 tensor cores; 67 TFLOP/s for K2 / K3 in f32). K1's
f32 bound is 3xTF32's: three TF32 products a product at 494.7 TFLOP/s,
with the CUDA cores' 66.9 TFLOP/s beside it as context.

Other modes: --k1-only (phases device, build, K1); --k4-only (phases
device, build, K4, serve-1.5b); --mellum-only (phases device, build, K4
and K3 with a window at Mellum2's 32/4/128 heads, K5 at its expert
widths); --serve-mellum-only (Mellum2-12B-A2.5B through the scheduler:
every prefill call 28 K4 (21 windowed) and 28 K5, every decode step 28
K3 (21 windowed) and 28 K5, no plain attention, the gathered prefills' K5
on the grouped route); --k1-ab PARENT
(phase K1, bf16 and f32, against the kernel of the checkout at PARENT and
of this one, in turns); --tp-only; --serve-view-only.

The line before last is a JSON object {"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
TF32_FLOPS = 494.7e12  # H100 SXM dense TF32 tensor-core peak
F32_FLOPS = 66.9e12    # H100 SXM f32 peak of the CUDA cores (no tensor cores)
K3_TOL = K2_TOL  # the same formula, the same summation order per split
# (Hq, Hkv, D) of the decoders K2 and K3 serve: Qwen2-0.5B, Qwen2-1.5B,
# Qwen2-7B, and LLaVA-1.5-7B's Vicuna-7B (MHA: one query row a KV head)
K_GEOMETRIES = ((14, 2, 64), (12, 2, 128), (28, 4, 128), (32, 32, 128))
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


def ffn_f32_bound_ms(n, c):
    """K1's f32 bound: f32-accurate products on the tensor cores are three
    TF32 products (3xTF32), so 3 x 16 N C^2 FLOPs at the TF32 peak, or the
    f32 t, residual, out, W1, W2 and biases once each over device memory,
    the larger; with the CUDA cores' time for 16 N C^2 f32 FLOPs (context:
    the rate without the tensor cores)."""
    flops = 16 * n * c * c
    nbytes = 4 * (3 * n * c + 8 * c * c + 4 * c + 2 * c)
    f_ms, b_ms = 3 * flops / TF32_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return (max(f_ms, b_ms), "operations" if f_ms >= b_ms else "bytes",
            flops / F32_FLOPS * 1e3)


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

    names = ("ffn", "decode_attention", "paged_decode_attention",
             "prefill_attention", "experts")
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
    """The same function as a cuBLAS chain in t's dtype (context for K1,
    not its yardstick: no single PyTorch call computes it); in f32 with
    TF32 off."""
    o = torch.addmm(b2, torch.nn.functional.gelu(torch.addmm(b1, t, w1)), w2)
    return res + (o if ls is None else ls * o)


def phase_k1(gen):
    from fastvlm_tpu_torch.ops.cuda.ffn import ffn_reference, fused_ffn

    cases = [(n, c, torch.bfloat16, use_ls, blocks)
             for n, c, blocks in K1_STAGES for use_ls in (True, False)]
    cases += [(1000, 192, torch.bfloat16, True, 0),   # ragged rows, fused
              (1000, 768, torch.bfloat16, True, 0)]   # ragged rows, two passes
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


# f32 shapes beyond the stages: ragged rows on both tensor-core routes, and
# widths only the general route takes (C = 48: not FastViTHD's)
K1_F32_EXTRA = ((1000, 192, True), (1000, 768, True), (4096, 48, True),
                (1000, 48, False))


def phase_k1_f32(gen):
    """K1's f32 route (train_sft's default dtype) against ffn_reference
    within K1_TOL[float32] at the five stage shapes (ls and ls=None), ragged
    rows and general-route widths; per stage (with ls, as training calls
    it) the kernel's time, TFLOP/s, share of its 3xTF32 bound, the plain
    version's and an f32 cuBLAS chain's; and the per-image sums (44 calls).
    Uses only fused_ffn and ffn_reference, so it also times another
    checkout's kernel (--k1-ab)."""
    from fastvlm_tpu_torch.ops.cuda.ffn import ffn_reference, fused_ffn

    cases = [(n, c, use_ls, blocks) for n, c, blocks in K1_STAGES
             for use_ls in (True, False)]
    cases += [(n, c, use_ls, 0) for n, c, use_ls in K1_F32_EXTRA]
    max_abs = 0.0
    img = dict.fromkeys(("ms", "kernel_ms", "plain_ms", "chain_ms",
                         "bound_ms", "cuda_core_ms"), 0.0)
    stages = {}
    for n, c, use_ls, blocks in cases:
        t, res, w1, b1, w2, b2, ls = _ffn_inputs(n, c, torch.float32, gen)
        args = (t, res, w1, b1, w2, b2, ls if use_ls else None)
        got = fused_ffn(*args)
        want = ffn_reference(*args)
        torch.cuda.synchronize()
        err, ratio = compare(got, want, K1_TOL[torch.float32],
                             f"K1 f32 N={n} C={c} ls={use_ls}")
        max_abs = max(max_abs, err)
        what = (f"N={n} C={c} float32 ls={'yes' if use_ls else 'None'}: "
                f"max_abs_err {err:.3e} (tol ratio {ratio:.3f} <= 1)")
        if not (use_ls and blocks):  # the training call (ls) is timed
            log("K1", what)
            continue
        k_ms = time_batch_ms(lambda: fused_ffn(*args))
        prof_ms = kernel_time_ms(lambda: fused_ffn(*args))
        p_ms = time_batch_ms(lambda: ffn_reference(*args))
        c_ms = time_batch_ms(lambda: _ffn_chain(*args))
        bound, bound_by, cc_ms = ffn_f32_bound_ms(n, c)
        row = {"ms": k_ms, "kernel_ms": prof_ms, "plain_ms": p_ms,
               "chain_ms": c_ms, "bound_ms": bound, "cuda_core_ms": cc_ms}
        stages[f"{n}x{c}"] = {**row, "bound_by": bound_by, "blocks": blocks}
        for key, v in row.items():
            img[key] = None if v is None or img[key] is None else img[key] + blocks * v
        tflops = 16 * n * c * c / (k_ms * 1e-3) / 1e12
        log("K1", f"{what}; kernel {k_ms:.4f} ms ({tflops:.1f} TFLOP/s, "
                  f"{bound / k_ms:.3f} of its {bound * 1e3:.2f} us 3xTF32 "
                  f"bound, {bound_by}; CUDA-core f32 figure "
                  f"{cc_ms * 1e3:.2f} us), kernel time {fmt_ms(prof_ms)} "
                  f"(profiler); plain {p_ms:.4f} ms; f32 cuBLAS chain "
                  f"{c_ms:.4f} ms")
    log("K1", f"per 1024 px image (44 calls, f32, with ls): kernel "
              f"{img['ms']:.3f} ms ({fmt_ms(img['kernel_ms'])} kernel time), "
              f"3xTF32 bound {img['bound_ms']:.3f} ms "
              f"({img['bound_ms'] / img['ms']:.3f} reached; CUDA-core f32 "
              f"figure {img['cuda_core_ms']:.3f} ms), plain "
              f"{img['plain_ms']:.3f} ms, f32 cuBLAS chain "
              f"{img['chain_ms']:.3f} ms")
    return {"max_abs": max_abs, "image": img, "stages": stages}


def k1_route_checks():
    """The library's route for each shape equals ops/cuda/ffn.py's mirror
    (kernel_route), which the CPU tests pin."""
    from fastvlm_tpu_torch.ops.cuda import ffn

    lib = ffn._load()
    shapes = [(c, 4 * c) for c in (8, 16, 32, 48, 64, 96, 128, 192, 256,
                                   384, 512, 768, 1536)]
    shapes += [(96, 256), (192, 512), (384, 1024), (100, 400)]
    got = {s: ffn.ROUTES[lib.fvlm_ffn_route(*s)] for s in shapes}
    bad = {s: r for s, r in got.items() if r != ffn.kernel_route(*s)}
    if bad:
        raise AssertionError(f"K1 routes differ from kernel_route: {bad}")
    log("K1", f"routes by (C, Ch) as kernel_route mirrors them: {got}")
    return got


def _k2_point(gen, b, hq, hkv, d, s_max, length):
    """K2 at one decode call (b rows of ``length`` keys in an ``s_max``
    cache, bf16) against its plain version: max abs error, kernel time
    (profiler), ms a call by events, the wrapper's host us a call, plain
    ms, the bound, and SDPA's kernel time and ms a call."""
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference)

    dt = torch.bfloat16
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((b, s_max, hkv, d), generator=gen,
                        device="cuda").to(dt) for _ in range(2))
    ln = torch.full((b,), length, dtype=torch.int32, device="cuda")
    err, ratio = compare(decode_attention(q, k, v, ln),
                         decode_attention_reference(q, k, v, ln),
                         K2_TOL[dt], f"K2 {hq}/{hkv}/{d} B={b}")
    call = lambda: decode_attention(q, k, v, ln)
    mask = (torch.arange(s_max, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q.view(b, hq, 1, d), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)
    return dict(err=err, ratio=ratio, kernel_ms=kernel_time_ms(call, reps=50),
                ms=time_ms(call, reps=50), host_us=host_us(call),
                plain_ms=time_ms(lambda: decode_attention_reference(q, k, v, ln),
                                 reps=50),
                bound_ms=attn_bound_ms(q, ln, hkv, 2),
                library_kernel_ms=kernel_time_ms(sdpa, reps=50),
                library_ms=time_ms(sdpa, reps=50))


def phase_k2(gen):
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference, split_size)

    def draw(b, hq, hkv, d, s_max, dtype):
        return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
                for shape in ((b, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d))]

    s_max = 4096
    max_abs = 0.0
    for hq, hkv, d in K_GEOMETRIES:
        for dtype in (torch.bfloat16, torch.float32):
            # a row alone takes several splits (one cluster each) at this
            # cache size; lengths 1 .. 2 split + 7 leave whole splits empty
            split = split_size(1, hkv, d, s_max, dtype)
            # at 32 KV heads a row alone is one split of the whole cache:
            # the edges past it count as S_max
            lens = [min(n, s_max) for n in
                    (1, split - 1, split, split + 1, 2 * split + 7, s_max)]
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
    pt = _k2_point(gen, 1, 14, 2, 64, 416, 400)
    max_abs = max(max_abs, pt["err"])
    log("K2", f"main-path call (B=1, 14/2/64 bf16, S_max=416, length 400, "
              f"split {split_size(1, 2, 64, 416, torch.bfloat16)} keys): "
              f"max_abs_err {pt['err']:.3e}; kernel time "
              f"{fmt_ms(pt['kernel_ms'])} (profiler, one launch), "
              f"{pt['ms']:.4f} ms a call by events, wrapper host "
              f"{pt['host_us']:.2f} us a call; bound "
              f"{pt['bound_ms'] * 1e3:.4f} us (bytes); plain "
              f"{pt['plain_ms']:.4f} ms; scaled_dot_product_attention kernel "
              f"time {fmt_ms(pt['library_kernel_ms'])}, "
              f"{pt['library_ms']:.4f} ms a call by events")
    return max_abs, {k: pt[k] for k in ("ms", "kernel_ms", "plain_ms",
                                        "library_ms", "library_kernel_ms",
                                        "bound_ms", "host_us")}


def kernel_profile(fn, reps: int = 20, complete: bool = False):
    """(device time of one call's kernels, {kernel: launches a call}) by
    torch.profiler (no host time), or (None, {}) where no session shows
    device time. ``complete``: only a session whose every kernel shows a
    whole number of launches a call counts (a session can drop records:
    on an H100 one held 3 of a call's 50 launches); (None, {}) where five
    sessions hold none."""
    split, launches = kernel_split_ms(fn, reps, complete)
    if not split:
        return None, {}
    return sum(split.values()), launches


def kernel_split_ms(fn, reps: int = 20, complete: bool = False):
    """({kernel: device ms of one call's launches of it}, {kernel: launches
    a call}) by torch.profiler, or ({}, {}); ``complete`` as
    ``kernel_profile``'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5 if complete else 3):
        # a session now and then records no device time, or drops records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0]
        if complete and any(e.count % reps for e in rows):
            continue
        # each kernel's mean time, times its launches a call: a session
        # that drops some records still reads one call's kernel time
        split = {e.key: e.self_device_time_total / e.count
                 * max(1, round(e.count / reps)) / 1000 for e in rows}
        if sum(split.values()) > 0:
            return split, {e.key: e.count / reps for e in rows}
    return {}, {}


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
    for hq, hkv, d in K_GEOMETRIES:
        for dtype in (torch.bfloat16, torch.float32):
            for page in (8, 64, 128):
                geo = f"{hq}/{hkv}/{d} {str(dtype)[6:]} page {page}"
                # the split's edges at a capacity where a row alone takes
                # several splits (one cluster each); lengths 1 .. 2 split + 7
                # leave whole splits empty; row 6 is a pad row (table all
                # -1, reads page 0)
                split = split_size(1, hkv, d, s_cap, dtype)
                lens = [min(n, s_cap) for n in (1, split - 1, split,
                                                split + 1, 2 * split + 7,
                                                s_cap, 5)]
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
    k_ms, names = kernel_profile(call, reps=50, complete=True)
    launches = sum(round(n) for n in names.values())
    if launches != 1 or any("merge_kernel" in k for k in names):
        raise AssertionError(f"K3 serving call: the profiler shows {names} "
                             f"a call (no session complete: {{}}), "
                             f"expected one kernel")
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


# K4's cases: (name, B, T, S, offset, (Hq, Hkv, D), kv lengths or None).
# The burst: 5 real rows of 1300-1344 tokens and 3 one-token padding rows,
# as a gathered batch of 8 pads; the suffix: a prefix-cache hit's ~320
# tokens after 1024 cached; the chunks: a chunked admission's 256-token
# chunks over offsets (one off the 128-key tiles), B = 1.
K4_BURST = [1344, 1300, 1321, 1337, 1310, 1, 1, 1]
K4_CASES = (
    [(f"burst {h[0]}/{h[1]}/{h[2]}", 8, 1344, 1344, 0, h, K4_BURST)
     for h in ((12, 2, 128), (14, 2, 64), (28, 4, 128))]
    + [(f"suffix {h[0]}/{h[1]}/{h[2]}", 8, 320, 1408, 1024, h, None)
       for h in ((12, 2, 128), (14, 2, 64), (28, 4, 128))]
    + [(f"chunk @{o} 12/2/128", 1, 256, 1408, o, (12, 2, 128), None)
       for o in (0, 256, 512, 1100)])


def k4_bound_ms(ns, offset, hq, hkv, d):
    """K4's bound over the rows' real query counts ``ns`` after ``offset``
    cached keys: 4 D Hq keys-seen FLOPs (causal pairs only) at the bf16
    peak, or q, out and each row's k and v moved once, the larger."""
    keys = sum(n * offset + n * (n + 1) // 2 for n in ns)
    flops = 4 * d * hq * keys
    nbytes = 2 * sum(2 * n * hq * d + 2 * (offset + n) * hkv * d for n in ns)
    f_ms, b_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")


def _k4_exact(q, k, v, offset, lens):
    """The attention K4 computes, in float64 from the same 16-bit inputs
    (nothing rounded between), a batch row at a time."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    q_pos = offset + torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    out = []
    for r in range(b):
        m = k_pos <= q_pos
        if lens is not None:
            m = m & (k_pos < lens[r])
        qr = q[r].double().reshape(t, hkv, hq // hkv, d)
        sc = torch.einsum("thgd,shd->hgts", qr, k[r].double()) / math.sqrt(d)
        sc = sc.masked_fill(~m, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out.append(torch.einsum("hgts,shd->thgd", p, v[r].double()).reshape(t, hq * d))
        del sc, p
    return torch.stack(out)


def phase_k4(gen):
    """K4 against its plain version and a float64 reference at the main
    path's shapes, then timed. The tolerance: both round the probabilities
    and the output to the 16-bit type, so each errs by about half an ulp of
    the output; the kernel's max error may exceed the plain version's by at
    most half an ulp of the largest output (the two may round a value near a
    midpoint to opposite neighbours), and a fault in the kernel errs by
    whole units."""
    import torch.nn.functional as F

    from fastvlm_tpu_torch.ops.cuda.prefill_attention import (
        prefill_attention, prefill_attention_reference)

    results = {}
    cases = K4_CASES + [("suffix 12/2/128 fp16", 8, 320, 1408, 1024,
                         (12, 2, 128), None)]
    for name, b, t, s, offset, (hq, hkv, d), lens in cases:
        dtype = torch.float16 if "fp16" in name else torch.bfloat16
        q = (1.5 * torch.randn((b, t, hq, d), generator=gen, device="cuda")).to(dtype)
        # k and v as the fused qkv projection leaves them: views into one
        # (B, S, 2 Hkv D) tensor, strided rows
        kv = torch.randn((b, s, 2 * hkv * d), generator=gen, device="cuda").to(dtype)
        k = kv[..., :hkv * d].reshape(b, s, hkv, d)
        v = kv[..., hkv * d:].reshape(b, s, hkv, d)
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                         device="cuda")
        before = prefill_attention.launches
        got = prefill_attention(q, k, v, offset, kv_lens)
        torch.cuda.synchronize()
        if prefill_attention.launches != before + 1:
            raise AssertionError(f"K4 {name}: {prefill_attention.launches - before} "
                                 f"launches for one call")
        plain = prefill_attention_reference(q, k, v, offset, kv_lens)
        exact = _k4_exact(q, k, v, offset, lens)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K4 {name}: non-finite output")
        k_err = float((got.double() - exact).abs().max())
        p_err = float((plain.double() - exact).abs().max())
        k_mean = float((got.double() - exact).abs().mean())
        p_mean = float((plain.double() - exact).abs().mean())
        top = float(exact.abs().max())
        half_ulp = 2.0 ** (math.floor(math.log2(top)) - (7 if dtype == torch.bfloat16
                                                         else 10)) / 2
        if k_err > p_err + half_ulp:
            raise AssertionError(f"K4 {name}: max_abs_err {k_err:.4e} against "
                                 f"float64, the plain version's {p_err:.4e} "
                                 f"(+ half an ulp {half_ulp:.4e})")
        del plain, exact
        ns = [t] if lens is None else [min(n, t) for n in lens if n > 1]
        if lens is None:
            ns = ns * b
        bound, by = k4_bound_ms(ns, offset, hq, hkv, d)

        def call():
            prefill_attention(q, k, v, offset, kv_lens)

        k_ms, names = kernel_profile(call, reps=20)
        if sum(round(n) for n in names.values()) != 1:
            raise AssertionError(f"K4 {name}: the profiler shows {names} a call, "
                                 f"expected one kernel")
        ms = time_batch_ms(call, reps=20)
        plain_ms = time_batch_ms(
            lambda: prefill_attention_reference(q, k, v, offset, kv_lens), reps=3,
            warmup=1)
        res = dict(max_abs_err=k_err, plain_max_abs_err=p_err, mean_abs_err=k_mean,
                   plain_mean_abs_err=p_mean, kernel_ms=k_ms, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        lib = ""
        if name == "burst 12/2/128":
            # context: the library's fused causal attention over 8 full rows
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            res["library_kernel_ms"] = kernel_time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                       enable_gqa=True))
            res["library_bound_ms"] = k4_bound_ms([t] * b, 0, hq, hkv, d)[0]
            lib = (f"; context: scaled_dot_product_attention(is_causal) over 8 "
                   f"full rows {fmt_ms(res['library_kernel_ms'])} kernel time "
                   f"against a bound of {res['library_bound_ms']:.4f} ms")
        results[name] = res
        share = "not measured" if k_ms is None else f"{100 * bound / k_ms:.2f}%"
        log("K4", f"{name} {str(dtype)[6:]}: B={b} T={t} S={s} offset {offset} "
                  f"lengths {lens}: max_abs_err vs float64 {k_err:.4e} (plain "
                  f"{p_err:.4e}, + half an ulp {half_ulp:.4e} allowed), mean "
                  f"{k_mean:.4e} (plain {p_mean:.4e}); kernel time "
                  f"{fmt_ms(k_ms)} (profiler, one kernel a call), {ms:.4f} ms a "
                  f"call by events; bound {bound:.4f} ms ({by}), share {share}; "
                  f"plain {plain_ms:.4f} ms{lib}")
    return results


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


def main_config():
    """Phase main's FastVLM-0.5B at full width, bf16."""
    from fastvlm_tpu_torch import config as C

    decoder = C.qwen2_0_5b(param_dtype="bfloat16", compute_dtype="bfloat16")
    vision = C.FastViTConfig(image_size=1024, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    return C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                    hidden_size=decoder.hidden_size))


def main_params(cfg):
    """Phase main's random weights (seed 0, drawn on the card), the decoder
    fused (qkv, gateup)."""
    from fastvlm_tpu_torch.models import qwen2, vlm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = vlm.init(gen, cfg, "cuda")
    params["decoder"] = qwen2.fuse_decoder_params(params["decoder"],
                                                  cfg.decoder)
    return params


def phase_main(card):
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg = main_config()
    decoder = cfg.decoder
    t0 = time.perf_counter()
    params = main_params(cfg)
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
            "peak_gib": peak_gb, "engine": engine, "params": params,
            "prompts": prompts,
            "answers": dict(zip(prompts, (text for text, _ in results)))}


class Client:
    """One request to a BatchScheduler on its own thread; ``decoding`` is
    set at its second update (a decode chunk landed); ``t_submit``,
    ``t_first`` and ``t_closed`` are the host clock at its submission, its
    first update and its stream's close."""

    def __init__(self, sched, engine, prompt, image, cap, sampling=None,
                 system=None):
        self.updates = []
        self.decoding = threading.Event()
        self.t_submit = time.perf_counter()
        self.t_first = self.t_closed = None
        self.thread = threading.Thread(target=self._run, args=(
            sched, engine.build_prompt(prompt, system), image, cap, sampling))
        self.thread.start()

    def _run(self, sched, prompt, image, cap, sampling):
        for u in sched.submit(prompt, image, max_new_tokens=cap,
                              sampling=sampling):
            self.updates.append(u)
            if self.t_first is None:
                self.t_first = time.perf_counter()
            if len(self.updates) >= 2:
                self.decoding.set()
        self.t_closed = time.perf_counter()
        self.decoding.set()

    def result(self, what):
        """The last update; a batched stream must have closed with "stop"
        or "length" (the serial path's updates are the engine's, with no
        finish reason)."""
        self.thread.join(timeout=JOIN_S)
        if self.thread.is_alive() or not self.updates:
            raise AssertionError(f"{what}: stream did not close")
        last = self.updates[-1]
        if "error" in last or last["stats"].get("finish_reason", "stop") \
                not in ("stop", "length"):
            raise AssertionError(f"{what}: {last}")
        return last


def _logit_gaps(row, tok):
    """(batch token's gap below the maximum, top-1 minus top-2), both in
    bf16 ulps of the maximum's magnitude."""
    top2 = row.topk(2).values
    top = float(top2[0])
    ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
    return (top - float(row[tok])) / ulp, (top - float(top2[1])) / ulp


def _dense_replay(engine, prompt, image, ids, system=None):
    """Teacher-force ``ids`` through the dense single-request path (full
    prefill, kernel K2; an int8-KV engine's int8 cache, no kernel); the
    (gap, top-1/top-2 gap) of every step, in bf16 ulps."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg = engine.cfg
    gaps = []
    with torch.inference_mode():
        inputs = engine.prepare(engine.build_prompt(prompt, system), image)
        t = inputs["ids"].shape[1]
        cache = init_cache(cfg.decoder.num_layers, 1, t + len(ids),
                           cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                           engine._kv_dtype, "cuda")
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


def _check_replay(phase, what, engine, prompt, image, text, system=None):
    """Replay the ids of ``text`` through the dense full-prefill path and
    fail unless each scores within TIE_ULPS of the dense maximum."""
    ids = [int(t) for t in text.split(",") if t]
    if not ids:  # the first token was EOS: nothing to replay
        log(phase, f"dense replay of {what}: no tokens")
        return
    gaps = _dense_replay(engine, prompt, image, ids, system)
    worst = max(g for g, _ in gaps)
    log(phase, f"dense replay of {what}: {len(ids)} steps, tokens within "
               f"{worst:.2f} bf16 ulps of the dense maximum (limit "
               f"{TIE_ULPS}); top-1 minus top-2 per step, ulps: "
               f"{[round(t, 2) for _, t in gaps]}")
    if worst > TIE_ULPS:
        bad = next(s for s, (g, _) in enumerate(gaps) if g > TIE_ULPS)
        raise AssertionError(
            f"replay of {what}, step {bad}: token {ids[bad]} scores "
            f"{gaps[bad][0]:.1f} bf16 ulps below the dense maximum (limit "
            f"{TIE_ULPS})")


def _step_profile(engine, rng, b=8, lengths=(330, 371), pool=256,
                  n_chunks=4):
    """Steady-state decode at a serving batch: ``b`` rows of ``lengths``
    (low, high + 1) tokens (the serve phase's: 8 rows of 330-370), text
    only, greedy, the engine's chunks; the scheduler's pool (``pool`` pages
    of 64, each row's pages scattered over it) against a dense cache of the
    same rows. Step ms by the host clock from dispatch to the host read
    (the scheduler's own measure), over passes of ``n_chunks`` chunks in
    the order paged, dense, dense, paged; then one profiled pass of each:
    kernels, device ms and attention-kernel ms a step (K3 paged, K2
    dense)."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache, init_paged_cache
    from fastvlm_tpu_torch.ops.sampling import RowSampling, SamplingParams

    dec = engine.cfg.decoder
    k, page = engine.chunk, 64
    lengths = rng.randint(*lengths, size=b).astype(np.int32)
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
            step_ms[name].append(
                statistics.median(chunks(caches[name], n_chunks)) / k)
        prof_out = {}
        for name, cache in caches.items():
            chunks(cache, 0)
            torch.cuda.synchronize()
            before = _launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                chunks(cache, 1)
                torch.cuda.synchronize()
            rows_ = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
            steps = 2 * k  # the warm chunk and the one after it
            # K3's paged_decode_kernel, K2's decode_kernel
            attn_rows = [e for e in rows_ if "decode_kernel" in e.key]
            attn = sum(e.self_device_time_total for e in attn_rows)
            # the wrappers' count against the trace's (see
            # _cuda_step_profile)
            launched = float((_launches() - before)[1:].sum()) / steps
            traced = sum(e.count for e in attn_rows) / steps
            prof_out[name] = {
                "kernels": sum(e.count for e in rows_) / steps,
                "attn_ops": traced,
                "device_ms": sum(e.self_device_time_total
                                 for e in rows_) / steps / 1000,
                "attn_ms": attn / steps / 1000,
                "note": (f" [a short trace, so lower bounds: it held "
                         f"{traced:.3f} of {launched:.1f} K2 / K3 launches "
                         f"a step]" if traced < launched else "")}
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
    from fastvlm_tpu_torch.timeline import Timeline

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
        sched.trace = Timeline(engine.device)
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
    if k1 != 44 * counters["image_prefills"]:
        raise AssertionError(f"K1 launched {k1} times for "
                             f"{counters['image_prefills']} prefill "
                             f"dispatches that encode images")
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
    log("serve", f"launch counts: K1 {k1} = 44 x {counters['image_prefills']} "
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
        _check_replay("serve", f"request {n}", engine, prompt, images[img],
                      last[n]["text"])

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
                     f"step (profiler){p['note']}")
    p, dn = prof["profile"]["paged"], prof["profile"]["dense"]
    share = p["attn_ms"] / statistics.mean(prof["step_ms"]["paged"])
    ratio = p["attn_ms"] / dn["attn_ms"] if dn["attn_ms"] else float("nan")
    log("serve", f"K3's share of a steady-state paged step: {share:.4f} of "
                 f"the wall time, {p['attn_ms'] / p['device_ms']:.4f} of the "
                 f"device time; K3 over K2 a step (paged / dense attention "
                 f"ms): {ratio:.4f}")
    return {"k1_launches": k1, "k3_launches": k3, "tok_s": served / wall_s,
            "peak_gib": peak_gb}


VIEW_MODES = (("in place", {}), ("chunk view", {"chunk_view": True}),
              ("persist view", {"persist_view": True}),
              ("persist depth 2", {"persist_view": True,
                                   "pipeline_depth": 2}))


def _view_step_profile(engine, rng, b=8, lengths=(330, 371), pool=256,
                       n_chunks=4):
    """Steady-state decode at the serving batch in each scheduler mode, on
    one pool (``pool`` pages of 64, each row's pages scattered over it) of
    ``b`` rows of ``lengths`` (low, high + 1) tokens, greedy, the engine's
    chunks: in place (K3), the chunk view (a gather, k dense steps, a
    write-back a chunk), the persistent view (k dense steps a chunk on a
    view gathered once) and the persistent view 2 chunks a host read. Step
    ms by the host clock from dispatch to the host read, over passes of
    ``n_chunks`` chunks (groups for depth 2) in the order of VIEW_MODES
    and back; then one profiled pass of each: device ops, device ms, and
    K2's and K3's launches (the wrappers' counts) and ms a step."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference)
    from fastvlm_tpu_torch.ops.kv_cache import init_paged_cache
    from fastvlm_tpu_torch.ops.sampling import RowSampling, SamplingParams

    dec = engine.cfg.decoder
    k, page = engine.chunk, 64
    lengths = rng.randint(*lengths, size=b).astype(np.int32)
    span = -(-(int(lengths.max()) + 5 * 2 * k) // page)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    base = init_paged_cache(dec.num_layers, b, pool, page, span,
                            dec.num_kv_heads, dec.head_dim, torch.bfloat16,
                            "cuda")
    tables = rng.permutation(pool)[:b * span].reshape(b, span)
    base = dataclasses.replace(
        base, block_tables=torch.from_numpy(tables.astype(np.int32)).cuda())
    for t in (base.k_pages, base.v_pages):
        t.normal_(generator=gen)
    start = torch.from_numpy(lengths).cuda()
    tok0 = torch.randint(0, dec.vocab_size, (b,), generator=gen,
                         device="cuda", dtype=torch.int32)
    rows = RowSampling.build([SamplingParams()] * b, b, "cuda")
    s_bucket = -(-(int(lengths.max()) + 5 * 2 * k) // page) * page

    # K2 at the views' shape: layer 0 of the gathered view, a step's
    # lengths, at the batch buckets the serving rounds decode at
    view = vlm.gather_view(dataclasses.replace(base, lengths=start.clone()),
                           s_bucket)
    k2_check = []
    for nb in (8, 4, 2):
        nb = min(nb, b)
        q = torch.randn((nb, dec.num_heads, dec.head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        kc, vc = view.k[0, :nb], view.v[0, :nb]
        lens = view.lengths[:nb] + 1
        err, ratio = compare(decode_attention(q, kc, vc, lens),
                             decode_attention_reference(q, kc, vc, lens),
                             K2_TOL[torch.bfloat16],
                             f"K2 on the view, B={nb}")
        k2_check.append((nb, err, ratio))
    del view

    def dispatches(mode, n):
        """Reset the rows, one warm dispatch, then n; each one's ms."""
        cache = dataclasses.replace(base, lengths=start.clone())
        tok, done = tok0, torch.zeros((b,), dtype=torch.bool, device="cuda")
        kw = dict(k=k, eos_ids=engine.eos_ids, row_sampling=rows)
        view = None
        if mode.startswith("persist"):
            view = vlm.gather_view(cache, s_bucket)
        depth = 2 if mode == "persist depth 2" else 1
        out = []
        for i in range(n + 1):
            t0 = time.perf_counter()
            group = []
            for _ in range(depth):
                if view is not None:
                    toks, done, tok, view = vlm.decode_chunk(
                        engine.params, engine.cfg, tok, done, view, gen, **kw)
                elif mode == "chunk view":
                    toks, done, tok, cache = vlm.decode_chunk_paged(
                        engine.params, engine.cfg, tok, done, cache, gen,
                        s_bucket=s_bucket, **kw)
                else:
                    toks, done, tok, cache = vlm.decode_chunk(
                        engine.params, engine.cfg, tok, done, cache, gen,
                        **kw)
                group.append(toks)
            torch.cat(group, dim=1).cpu()
            if i:
                out.append((time.perf_counter() - t0) * 1000 / depth)
        return out, depth

    names = [m for m, _ in VIEW_MODES]
    step_ms = {m: [] for m in names}
    out = {}
    with torch.inference_mode():
        for mode in names + names[::-1]:
            ms, _ = dispatches(mode, n_chunks)
            step_ms[mode].append(statistics.median(ms) / k)
        for mode in names:
            dispatches(mode, 0)
            torch.cuda.synchronize()
            before = _launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, depth = dispatches(mode, 1)
                torch.cuda.synchronize()
            launched = (_launches() - before)
            rows_ = [e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA]
            steps = 2 * depth * k  # the warm dispatch and the one after it
            k3 = [e for e in rows_ if "paged_decode_kernel" in e.key]
            k2 = [e for e in rows_ if "decode_kernel" in e.key
                  and "paged" not in e.key]
            out[mode] = {
                "step_ms": step_ms[mode],
                "kernels": sum(e.count for e in rows_) / steps,
                "device_ms": sum(e.self_device_time_total
                                 for e in rows_) / steps / 1000,
                "k2_launches": float(launched[1]) / steps,
                "k3_launches": float(launched[2]) / steps,
                "k2_ms": sum(e.self_device_time_total for e in k2)
                / steps / 1000,
                "k3_ms": sum(e.self_device_time_total for e in k3)
                / steps / 1000}
    return {"lengths": (int(lengths.min()), int(lengths.max())),
            "s_bucket": s_bucket, "modes": out, "k2_check": k2_check}


def phase_serve_view(card, main_engine):
    """The JAX scheduler's serving modes over phase serve's engine and
    traffic shape (8 greedy requests of 32 tokens: 4 gathered, then 2 and
    2 admitted once the ones before decode), each mode through a fresh
    scheduler, the modes in turns (VIEW_MODES, then back); a steady-state
    step profile of each; and one batch whose prompts the pool cannot hold
    (the dense fallback)."""
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference)
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler
    from fastvlm_tpu_torch.timeline import Timeline

    cfg = main_engine.cfg
    layers = cfg.decoder.num_layers
    engine = Engine(cfg, main_engine.params, IdTokenizer(), chunk=8)
    rng = np.random.RandomState(11)
    images = [rng.randint(0, 256, (1024, 1024, 3), dtype=np.uint8)
              for _ in range(8)]
    first = [("Describe the image.", 0), ("What is in the picture?", 1),
             ("Describe the scene in detail.", 2), ("Read the text.", 3)]
    late = [[("What colour dominates?", 4), ("Count the objects.", 5)],
            [("Where was this taken?", 6), ("Describe the lighting.", 7)]]
    jobs = first + late[0] + late[1]

    def serve_round(mode, knobs):
        """The traffic once through a fresh scheduler: (last updates,
        counters, K1/K2/K3 launches, served tok/s, step ms, pool clean)."""
        sched = BatchScheduler(engine, max_batch=8, window_ms=100,
                               page_size=64, pool_tokens=16384, **knobs)
        sched.trace = Timeline(engine.device)
        torch.cuda.synchronize()
        _zero_launches()
        try:
            clients = [Client(sched, engine, p, images[i], 32)
                       for p, i in first]
            for wave in late:
                if not clients[-1].decoding.wait(JOIN_S):
                    raise AssertionError(f"{mode}: a batch never decoded")
                clients += [Client(sched, engine, p, images[i], 32)
                            for p, i in wave]
            last = [c.result(f"{mode} request {n}")
                    for n, c in enumerate(clients)]
            launches = _launches()
        finally:
            sched.shutdown()
        t_start = next(e[0] for e in sched.trace if e[1] == "batch_start")
        served = sum(u["stats"]["decode_tokens"] for u in last)
        wall_s = max(c.t_closed for c in clients) - t_start
        disp = [e for e in sched.trace if e[1] == "disp"]
        return {"last": last, "counters": dict(sched.counters),
                "launches": launches, "tok_s": served / wall_s,
                "step_ms": statistics.median(e[5] / e[4] for e in disp),
                "clean": sched.pool.free_pages == sched.pool.num_pages}

    t0 = time.perf_counter()
    names = [m for m, _ in VIEW_MODES]
    runs = {m: [] for m in names}
    for mode in names + names[::-1]:
        runs[mode].append(serve_round(mode, dict(VIEW_MODES)[mode]))
    replayed = {}
    res = {}
    for mode in names:
        for r in runs[mode]:
            c, (k1, k2, k3) = r["counters"], r["launches"]
            steps = c["decode_steps"]
            log("serve-view", f"{mode}: served {r['tok_s']:.3f} tok/s, a "
                              f"decode step {r['step_ms']:.3f} ms (median of "
                              f"the chunks' dispatch-to-read time); K1 {k1}, "
                              f"K2 {k2}, K3 {k3} for {steps} decode steps; "
                              f"counters {c}")
            if not r["clean"]:
                raise AssertionError(f"{mode}: pages missing after serving")
            # at depth 2 the first rows may close before the late ones
            # arrive (their second group leaves at once): no grow needed
            if c.get("admitted", 0) < 4 or (
                    mode != "persist depth 2" and c.get("grown", 0) < 1):
                raise AssertionError(f"{mode}: admissions {c}")
            if k1 != 44 * c["image_prefills"]:
                raise AssertionError(f"{mode}: K1 {k1} for "
                                     f"{c['image_prefills']} image prefills")
            want = (0, layers * steps) if mode == "in place" else \
                (layers * steps, 0)
            if steps == 0 or (k2, k3) != want:
                raise AssertionError(f"{mode}: K2 / K3 launched {k2} / {k3} "
                                     f"times for {steps} decode steps, "
                                     f"expected {want}")
            if mode.startswith("persist") and not (
                    c.get("view_gathers") and c.get("view_syncs")
                    and c.get("view_row_updates")):
                raise AssertionError(f"{mode}: a view counter is 0: {c}")
            if mode == "persist depth 2" and not c.get("pipelined_groups"):
                raise AssertionError(f"{mode}: no pipelined group: {c}")
            if c.get("view_dropped_stale"):
                raise AssertionError(f"{mode}: a stale view was dropped")
            # every greedy answer within the tie margin of the dense path
            # (each distinct answer replayed once)
            for n, u in enumerate(r["last"]):
                p, img = jobs[n]
                if u["text"] not in replayed.setdefault(n, set()):
                    _check_replay("serve-view", f"{mode} request {n}",
                                  engine, p, images[img], u["text"])
                    replayed[n].add(u["text"])
        res[mode] = {
            "tok_s": [r["tok_s"] for r in runs[mode]],
            "step_ms": [r["step_ms"] for r in runs[mode]],
            "launches": [int(x) for x in runs[mode][1]["launches"]],
            "counters": runs[mode][1]["counters"]}
    differing = sum(len(v) > 1 for v in replayed.values())
    log("serve-view", f"{len(names)} modes x 2 rounds in "
                      f"{time.perf_counter() - t0:.1f} s; {differing} of 8 "
                      f"requests answered differently by some mode (each "
                      f"answer within the tie margin of the dense path)")

    prof = _view_step_profile(engine, rng)
    lo, hi = prof["lengths"]
    for nb, err, ratio in prof["k2_check"]:
        log("serve-view", f"K2 on a gathered view (B={nb}, "
                          f"{cfg.decoder.num_heads}/{cfg.decoder.num_kv_heads}"
                          f"/{cfg.decoder.head_dim} bf16, width "
                          f"{prof['s_bucket']}, lengths {lo + 1}-{hi + 1}): "
                          f"max_abs_err {err:.3e} against the plain version "
                          f"(tol ratio {ratio:.3f} <= 1)")
    for mode in names:
        p = prof["modes"][mode]
        log("serve-view", f"steady state, batch 8, lengths {lo}-{hi}, "
                          f"view {prof['s_bucket']}, {mode}: a step "
                          f"{p['step_ms'][0]:.3f} / {p['step_ms'][1]:.3f} ms "
                          f"(two passes); {p['kernels']:.1f} device ops, "
                          f"{p['device_ms']:.4f} ms of device time, K2 "
                          f"{p['k2_launches']:.1f} launches {p['k2_ms']:.4f} "
                          f"ms, K3 {p['k3_launches']:.1f} launches "
                          f"{p['k3_ms']:.4f} ms a step (profiler, wrappers' "
                          f"counts)")
    for mode in ("persist view", "persist depth 2"):
        p = prof["modes"][mode]
        if (p["k2_launches"], p["k3_launches"]) != (layers, 0):
            raise AssertionError(f"{mode} steady state: K2 / K3 "
                                 f"{p['k2_launches']} / {p['k3_launches']} "
                                 f"a step, expected {layers} / 0")

    # the dense fallback: a pool smaller than either prompt serves the
    # gathered batch on a dense cache of its own (K2), as the JAX scheduler
    page = 64
    need = -(-engine.prepare(engine.build_prompt(first[0][0]),
                             images[0])["prompt_tokens"] // page)
    sched = BatchScheduler(engine, max_batch=8, window_ms=200,
                           page_size=page, pool_tokens=(need - 1) * page)
    _zero_launches()
    try:
        clients = [Client(sched, engine, p, images[i], 16)
                   for p, i in first[:2]]
        last = [c.result(f"dense fallback request {n}")
                for n, c in enumerate(clients)]
        k1, k2, k3 = (int(x) for x in _launches())
    finally:
        sched.shutdown()
    c = dict(sched.counters)
    if c.get("dense_fallbacks") != 1 or c.get("prefills") != 1:
        raise AssertionError(f"dense fallback: counters {c}")
    if (k1, k2, k3) != (44, layers * c["decode_steps"], 0):
        raise AssertionError(f"dense fallback: K1 / K2 / K3 {k1} / {k2} / "
                             f"{k3} for {c['decode_steps']} steps")
    if sched.pool.min_free != sched.pool.num_pages:
        raise AssertionError("dense fallback: the pool was mapped")
    # K2 at the fallback's shape: B = 2 over the dense batch cache (the
    # batch's padded prompt + a chunk past the cap), halfway through
    preps = [engine.prepare(engine.build_prompt(p), images[i])
             for p, i in first[:2]]
    s_max = (max(int(x["ids"].shape[1]) for x in preps)
             + (16 // engine.chunk + 1) * engine.chunk)
    dec = cfg.decoder
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    q, kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in (
            (2, dec.num_heads, dec.head_dim),
            (2, s_max, dec.num_kv_heads, dec.head_dim),
            (2, s_max, dec.num_kv_heads, dec.head_dim)))
    lens = torch.tensor([int(x["prompt_tokens"]) + 9 for x in preps],
                        dtype=torch.int32, device="cuda")
    fb_err, fb_ratio = compare(decode_attention(q, kc, vc, lens),
                               decode_attention_reference(q, kc, vc, lens),
                               K2_TOL[torch.bfloat16],
                               "K2 at the dense fallback's shape")
    log("serve-view", f"K2 at the dense fallback's shape (B=2, "
                      f"{dec.num_heads}/{dec.num_kv_heads}/{dec.head_dim} "
                      f"bf16, S_max {s_max}, lengths {lens.tolist()}): "
                      f"max_abs_err {fb_err:.3e} against the plain version "
                      f"(tol ratio {fb_ratio:.3f} <= 1)")
    for n, (p, i) in enumerate(first[:2]):
        _check_replay("serve-view", f"dense fallback request {n}", engine,
                      p, images[i], last[n]["text"])
    log("serve-view", f"dense fallback: a pool of {need - 1} pages under "
                      f"{need}-page prompts served 2 requests in one dense "
                      f"batch: K1 {k1}, K2 {k2} = {layers} x "
                      f"{c['decode_steps']} steps, K3 0, pool unmapped; "
                      f"phase {time.perf_counter() - t0:.1f} s on {card}")
    return {"modes": res, "profile": prof["modes"],
            "fallback_launches": [k1, k2, k3]}


# one system prompt for every serve-1.5b request: 5 full 64-token pages
# before the image slot (the default template has less than one)
SYSTEM_15B = ("<|im_start|>system\n" + "You are a careful visual assistant: "
              "describe only what the image shows, name every object you "
              "can see, and keep each answer short and plain. " * 2)
WAVES_15B = {
    "A": ["Describe the image.", "What is in the picture?",
          "Describe the scene in detail.", "Read the text."],
    "B": ["What colour dominates?", "Count the objects.",
          "Where was this taken?", "Describe the lighting."],
    "C": ["Describe the image.", "What is unusual here?",
          "Name three objects.", "What time of day is it?"]}


def _median(xs):
    return statistics.median(xs) if xs else float("nan")


def _live_row_timing(trace):
    """The live rows' decode while a row is mid-prefill and while none is,
    by batch size: {(batch, kind): (step ms, token interval ms, chunks)},
    medians. A step is a chunk's dispatch-to-host-read time over k; the
    token interval is the time from one chunk's host read to the next's
    over k, so it includes what the boundary between them did. Kinds:
    "pending" (a prefill chunk ran at the boundary, or a row was
    mid-prefill during the chunk), "admit" (a single-shot admission ran at
    the boundary), "quiet" (neither). Pairs across a grow or a shrink are
    left out."""
    disp = [(n, e) for n, e in enumerate(trace) if e[1] == "disp"]
    out = {}
    for (n0, e0), (n1, e1) in zip(disp, disp[1:]):
        between = {e[1] for e in trace[n0 + 1:n1]}
        if e1[2] != e0[2] or "batch_end" in between:
            continue
        kind = ("pending" if "pchunk" in between or e1[6] > 0 else
                "admit" if "admit" in between else "quiet")
        steps, gaps = out.setdefault((e1[2], kind), ([], []))
        steps.append(e1[5] / e1[4])
        gaps.append((e1[0] - e0[0]) * 1000 / e1[4])
    return {key: (_median(s), _median(g), len(s))
            for key, (s, g) in sorted(out.items())}


def phase_serve_15b(card):
    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import qwen2, vlm
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)
    from fastvlm_tpu_torch.ops.cuda.prefill_attention import prefill_attention
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler
    from fastvlm_tpu_torch.timeline import Timeline

    decoder = C.qwen2_1_5b(param_dtype="bfloat16", compute_dtype="bfloat16")
    vision = C.FastViTConfig(image_size=1024, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    cfg = C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                    hidden_size=decoder.hidden_size))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    t0 = time.perf_counter()
    params = vlm.init(gen, cfg, "cuda")
    params["decoder"] = qwen2.fuse_decoder_params(params["decoder"], decoder)
    engine = Engine(cfg, params, IdTokenizer(), chunk=8)
    torch.cuda.synchronize()
    layers = decoder.num_layers
    log("serve-1.5b", f"1.5B engine ({layers} layers, "
                      f"{decoder.num_heads}/{decoder.num_kv_heads}/"
                      f"{decoder.head_dim} heads) built at full width on the "
                      f"card in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(15)
    images = [rng.randint(0, 256, (1024, 1024, 3), dtype=np.uint8)
              for _ in range(12)]
    waves = {w: [(p, 4 * n + i) for i, p in enumerate(ps)]
             for n, (w, ps) in enumerate(WAVES_15B.items())}
    prep = engine.prepare(engine.build_prompt(WAVES_15B["B"][0], SYSTEM_15B),
                          images[4])
    start0, plen = int(prep["starts"][0]), prep["prompt_tokens"]
    cached = start0 // 64 * 64
    if cached < 256 or plen - cached <= 256:
        raise AssertionError(f"prompt geometry: image slot at {start0}, "
                             f"{plen} tokens; no 4-page prefix or no suffix "
                             f"past one 256-token chunk")
    log("serve-1.5b", f"prompts: image slot at token {start0}, ~{plen} "
                      f"tokens; a prefix hit reuses {cached} and prefills "
                      f"~{plen - cached}")

    def serve_round(name):
        sched = BatchScheduler(engine, max_batch=8, window_ms=100,
                               page_size=64, pool_tokens=16384)
        if (sched.prefix is None or sched.prefill_chunk != 256
                or sched.max_pending != 2):
            raise AssertionError("BatchScheduler(engine) at 1.5B does not "
                                 "take the JAX scheduler's defaults")
        sched.trace = Timeline(engine.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_ffn.launches = 0
        decode_attention.launches = 0
        paged_decode_attention.launches = 0
        prefill_attention.launches = 0
        prefills = [0]
        saved = {n: getattr(vlm, n) for n in ("prefill", "prefill_continue")}

        def counted(fn):
            def call(*a, **kw):
                prefills[0] += 1
                return fn(*a, **kw)
            return call

        for n, fn in saved.items():
            setattr(vlm, n, counted(fn))
        clients = {}
        try:
            def wave(w):
                clients[w] = [Client(sched, engine, p, images[i], 32,
                                     system=SYSTEM_15B) for p, i in waves[w]]

            wave("A")
            if not clients["A"][0].decoding.wait(JOIN_S):
                raise AssertionError(f"{name}: wave A never decoded")
            wave("B")
            last = {w: [c.result(f"{name} wave {w} request {n}")
                        for n, c in enumerate(clients[w])] for w in "AB"}
            # wave C opens a new batch: wait until the first one has ended
            deadline = time.perf_counter() + JOIN_S
            while not any(e[1] == "batch_end" for e in list(sched.trace)):
                if time.perf_counter() > deadline:
                    raise AssertionError(f"{name}: the batch never ended")
                time.sleep(0.01)
            wave("C")
            last["C"] = [c.result(f"{name} wave C request {n}")
                         for n, c in enumerate(clients["C"])]
            launches = (fused_ffn.launches, decode_attention.launches,
                        paged_decode_attention.launches,
                        prefill_attention.launches, prefills[0])
        finally:
            sched.shutdown()
            for n, fn in saved.items():
                setattr(vlm, n, fn)
        t_end = max(c.t_closed for cs in clients.values() for c in cs)
        return sched, last, launches, t_end

    t0 = time.perf_counter()
    serve_round("warm-up")
    log("serve-1.5b", f"warm-up round of the same traffic: "
                      f"{time.perf_counter() - t0:.1f} s")
    sched, last, (k1, k2, k3, k4, n_prefill), t_end = serve_round("serve-1.5b")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    counters = dict(sched.counters)
    for w, ups in last.items():
        for n, u in enumerate(ups):
            st = u["stats"]
            log("serve-1.5b", f"wave {w} request {n}: ttft "
                              f"{st['ttft_ms']:.3f} ms, queue "
                              f"{st['queue_ms']:.3f} ms, cached "
                              f"{st['cached_tokens']} tokens, "
                              f"{st['prefill_chunks']} prefill chunks, "
                              f"{st['decode_tokens']} tokens, "
                              f"{st['finish_reason']}")
    log("serve-1.5b", f"counters {counters}")
    if counters.get("prefix_hits", 0) < 8:
        raise AssertionError(f"{counters.get('prefix_hits', 0)} prefix hits, "
                             f"expected >= 8")
    if counters.get("chunked_admissions", 0) < 1 or \
            counters.get("prefill_chunks", 0) < 2:
        raise AssertionError("no chunked admission of two chunks or more")
    if any(u["stats"]["cached_tokens"] != cached for u in last["C"]):
        raise AssertionError("wave C did not reuse the cached prefix")
    if k1 != 44 * counters["image_prefills"]:
        raise AssertionError(f"K1 launched {k1} times for "
                             f"{counters['image_prefills']} prefill "
                             f"dispatches that encode images")
    if k3 == 0 or k3 != layers * counters["decode_steps"]:
        raise AssertionError(f"K3 launched {k3} times for "
                             f"{counters['decode_steps']} decode steps")
    if k2 != 0:
        raise AssertionError(f"K2 launched {k2} times on the paged path")
    if n_prefill == 0 or k4 != layers * n_prefill:
        raise AssertionError(f"K4 launched {k4} times for {n_prefill} prefill "
                             f"calls")
    pinned = {p for pages in sched.prefix.entries.values() for p in pages}
    if sched.pool.free_pages + len(pinned) != sched.pool.num_pages:
        raise AssertionError(f"{sched.pool.free_pages} free + {len(pinned)} "
                             f"pinned by the registry of "
                             f"{sched.pool.num_pages} pages after serving")
    sched.prefix.clear()
    if sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError("pages still held after clearing the registry")
    log("serve-1.5b", f"launch counts: K1 {k1} = 44 x "
                      f"{counters['image_prefills']} prefill dispatches that "
                      f"encode images (of {counters['prefills']}); K3 {k3} = "
                      f"{layers} x {counters['decode_steps']} decode steps; "
                      f"K4 {k4} = {layers} x {n_prefill} prefill calls; "
                      f"K2 0; pool {sched.pool.num_pages - len(pinned)} pages "
                      f"free + {len(pinned)} pinned by the prefix registry, "
                      f"all free once it clears")

    ttft = {w: [u["stats"]["ttft_ms"] for u in ups] for w, ups in last.items()}
    chunked = [u for u in last["B"] if u["stats"]["prefill_chunks"]]
    single = [u for u in last["B"] if not u["stats"]["prefill_chunks"]]
    log("serve-1.5b", f"TTFT, prefix miss (wave A, one batched prefill of 4 "
                      f"full prompts): {ttft['A'][0]:.3f} ms; prefix hit "
                      f"(wave C, one batched prefill of 4 suffixes after "
                      f"{cached} cached tokens): {ttft['C'][0]:.3f} ms; wave B "
                      f"hits, single-shot 1-row suffix prefill "
                      f"{[round(u['stats']['ttft_ms'], 3) for u in single]} "
                      f"ms, chunked admission (admission to first token, "
                      f"decode chunks between) "
                      f"{[round(u['stats']['ttft_ms'], 3) for u in chunked]} "
                      f"ms; on {card}")
    timing = _live_row_timing(sched.trace.events)
    log("serve-1.5b", "live rows, median decode step / token interval "
                      "(chunks), by batch and what the boundary before the "
                      "chunk did: " + "; ".join(
                          f"b={b} {kind} {s:.3f} / {g:.3f} ms ({n})"
                          for (b, kind), (s, g, n) in timing.items())
        + " (pending: a row mid-prefill, a prefill chunk at the boundary; "
          "admit: a single-shot admission at the boundary)")
    log("serve-1.5b", "what a boundary holds the live rows for: prefill "
                      "chunks [c0, c1) ms " + str(
                          [(e[3], e[4], round(e[5], 3)) for e in sched.trace
                           if e[1] == "pchunk"])
        + "; single-shot suffix admissions ms "
        + str([round(e[4], 3) for e in sched.trace if e[1] == "admit"]))
    t_start = next(e[0] for e in sched.trace if e[1] == "batch_start")
    served = sum(u["stats"]["decode_tokens"] for ups in last.values()
                 for u in ups)
    wall_s = t_end - t_start
    log("serve-1.5b", f"served {served} tokens in {wall_s * 1000:.3f} ms "
                      f"from the first batch's start to the last stream's "
                      f"close: {served / wall_s:.3f} tok/s; peak device "
                      f"memory {peak_gb:.3f} GiB on {card}")

    n = next((n for n, u in enumerate(last["B"])
              if u["stats"]["prefill_chunks"]), None)
    if n is None:
        raise AssertionError("no wave-B request took a chunked admission")
    for what, (prompt, img), u in (
            (f"chunked wave-B request {n}", waves["B"][n], last["B"][n]),
            ("wave-C request 0", waves["C"][0], last["C"][0])):
        _check_replay("serve-1.5b", what, engine, prompt, images[img],
                      u["text"], SYSTEM_15B)
    _admission_ab(engine, images, card)
    return {"k1_launches": k1, "k3_launches": k3, "k4_launches": k4,
            "decode_steps": counters["decode_steps"],
            "ttft_ms": ttft, "tok_s": served / wall_s, "peak_gib": peak_gb}


def _admission_ab(engine, images, card):
    """Chunked (256-token chunks) against single-shot admission of one late
    prefix-hit request (~320 suffix tokens) into 5 live rows at batch 8,
    through fresh schedulers in turns: chunked, single, single, chunked.
    Logs each run's late TTFT and the live rows' decode step and token
    interval by what the boundary before the chunk did."""
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler
    from fastvlm_tpu_torch.timeline import Timeline

    prompts = WAVES_15B["A"] + WAVES_15B["B"][:1]
    for mode in ("chunked", "single", "single", "chunked"):
        sched = BatchScheduler(engine, max_batch=8, window_ms=100,
                               page_size=64, pool_tokens=16384,
                               prefill_chunk=256 if mode == "chunked" else 0)
        sched.trace = Timeline(engine.device)
        try:
            anchors = [Client(sched, engine, p, images[i], 96,
                              system=SYSTEM_15B)
                       for i, p in enumerate(prompts)]
            if not anchors[0].decoding.wait(JOIN_S):
                raise AssertionError("admission A/B: the anchors never "
                                     "decoded")
            late = Client(sched, engine, WAVES_15B["B"][1], images[5], 8,
                          system=SYSTEM_15B).result("admission A/B late")
            for n, c in enumerate(anchors):
                c.result(f"admission A/B anchor {n}")
        finally:
            sched.shutdown()
        st = late["stats"]
        if (st["prefill_chunks"] > 0) != (mode == "chunked") or \
                not st["cached_tokens"]:
            raise AssertionError(f"admission A/B {mode}: the late request "
                                 f"took {st['prefill_chunks']} chunks, "
                                 f"{st['cached_tokens']} cached tokens")
        timing = _live_row_timing(sched.trace.events)
        log("serve-1.5b", f"admission A/B, {mode}: late request (cached "
                          f"{st['cached_tokens']}, {st['prefill_chunks']} "
                          f"chunks) TTFT {st['ttft_ms']:.3f} ms; 5 live rows, "
                          f"median decode step / token interval (chunks): "
            + "; ".join(f"b={b} {kind} {s:.3f} / {g:.3f} ms ({n})"
                        for (b, kind), (s, g, n) in timing.items())
            + f"; on {card}")


def phase_video(card, engine):
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.video import VideoQA, qa_over_stream

    question = "What is happening in this frame?"
    layers = engine.cfg.decoder.num_layers
    rng = np.random.RandomState(9)
    frames = [rng.randint(0, 256, (1080, 1920, 3), dtype=np.uint8)
              for _ in range(6)]
    vq = VideoQA(engine, question, max_new_tokens=32)
    vq.ask(frames[0])  # the resize's first call at this size
    torch.cuda.synchronize()
    fused_ffn.launches = 0
    decode_attention.launches = 0
    seq = [vq.ask(f) for f in frames]
    k1, k2 = fused_ffn.launches, decode_attention.launches
    steps = sum(s["decode_steps"] for _, s in seq)
    if k1 != 44 * len(frames):
        raise AssertionError(f"K1 launched {k1} times for {len(frames)} "
                             f"frames, expected 44 a frame")
    if steps == 0 or k2 != layers * steps:
        raise AssertionError(f"K2 launched {k2} times for {steps} decode "
                             f"steps, expected {layers} a step")
    t0 = time.perf_counter()
    piped = list(qa_over_stream(vq, frames, latest_only=False,
                                pipelined=True))
    pipe_ms = (time.perf_counter() - t0) * 1000
    if [t for t, _ in piped] != [t for t, _ in seq]:
        raise AssertionError("pipelined frames gave other ids than the "
                             "sequential ones")
    log("video", f"launch counts: K1 {k1} = 44 x {len(frames)} frames; K2 "
                 f"{k2} = {layers} x {steps} decode steps; pipelined ids "
                 f"equal the sequential ones")
    # each frame's TTFT, suffix prefill (a VideoQA that stops at its first
    # token) beside a full prefill of the same prompt and frame (both from
    # the image on the card to the first token on the host), in turns:
    # suffix, full, full, suffix on even frames, the other way on odd ones;
    # and the frame's upload + resize on the card
    first_only = VideoQA(engine, question, max_new_tokens=1)
    prompt = engine.build_prompt(question)
    ttft = {"suffix": [], "full": []}
    resize_ms = []
    for n, f in enumerate(frames):
        order = ("suffix", "full") if n % 2 == 0 else ("full", "suffix")
        for how in order + order[::-1]:
            if how == "suffix":
                ttft[how].append(first_only.ask(f)[1]["ttft_ms"])
            else:
                ttft[how].append(engine.generate(prompt, f, max_new_tokens=1)
                                 [1]["ttft_ms"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prepare_array_image(f)
        torch.cuda.synchronize()
        resize_ms.append((time.perf_counter() - t0) * 1000)
    sfx, full = ttft["suffix"], ttft["full"]
    log("video", f"6 frames of 1080x1920 uint8: TTFT suffix prefill after "
                 f"{vq.prefix_len} cached tokens {sfx} ms (median "
                 f"{_median(sfx):.3f}); full prefill of the same prompt "
                 f"{[round(x, 3) for x in full]} ms (median "
                 f"{_median(full):.3f}), two of each a frame in turns; "
                 f"upload + resize {_median(resize_ms):.3f} ms a frame "
                 f"(median); 32 new tokens: TTFT "
                 f"{[s['ttft_ms'] for _, s in seq]} ms and total "
                 f"{[s['total_ms'] for _, s in seq]} ms a frame sequential, "
                 f"{pipe_ms / len(frames):.3f} ms a frame pipelined; on "
                 f"{card}")
    for n, ((text, _), f) in enumerate(zip(seq, frames)):
        _check_replay("video", f"frame {n}", engine, question, f, text)
    return {"k1_launches": k1, "k2_launches": k2, "decode_steps": steps,
            "ttft_ms": sfx, "full_ttft_ms": full}


SPEC_PROMPTS = ["Describe the image.",
                "Say this three times: the red car is fast, the red car is "
                "fast, the red car is fast.",
                "What is happening in this frame?"]


def _spec_pass_profile(engine, image):
    """A verify pass (one pass of spec_stream_chunk, draft 8) against a
    plain decode step, at batch 1 after the main prompt's prefill: wall ms
    from dispatch to the host read (median of 8, in turns pass, step, step,
    pass), then one profiled run of 4 of each: device ms and launches a
    pass / step, and K2's launches in the passes."""
    import dataclasses

    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg, dec = engine.cfg, engine.cfg.decoder
    k, budget = 8, 256
    with torch.inference_mode():
        inputs = engine.prepare(engine.build_prompt(SPEC_PROMPTS[0]), image)
        t = inputs["ids"].shape[1]
        cache = init_cache(dec.num_layers, 1, vlm.spec_cache_len(t, budget, k),
                           dec.num_kv_heads, dec.head_dim, torch.bfloat16,
                           "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                    inputs["ids"], inputs["lens"],
                                    inputs["starts"], cache)
        tok0 = logits.argmax(-1).to(torch.int32)
        start = cache.lengths.clone()
        carry0 = vlm.spec_carry_init(cfg, tok0, cache, inputs["ids"],
                                     inputs["lens"], max_new_tokens=budget,
                                     draft_k=k, eos_ids=(-1,))

        def passes(n):
            """n verify passes from the prefilled state; ms of each and the
            tokens committed."""
            carry = carry0._replace(
                hist=carry0.hist.clone(),
                cache=dataclasses.replace(cache, lengths=start.clone()))
            ms, committed = [], 0
            for _ in range(n):
                t0 = time.perf_counter()
                _, counts, carry = vlm.spec_stream_chunk(
                    engine.params, cfg, carry, m=1, max_new_tokens=budget,
                    eos_ids=(-1,), draft_k=k)
                committed += int(counts[0])
                ms.append((time.perf_counter() - t0) * 1000)
            return ms, committed

        def steps(n):
            c = dataclasses.replace(cache, lengths=start.clone())
            tok, ms = tok0, []
            for _ in range(n):
                t0 = time.perf_counter()
                lg, c = vlm.decode_step(engine.params, cfg, tok, c)
                tok = lg.argmax(-1).to(torch.int32)
                int(tok[0])
                ms.append((time.perf_counter() - t0) * 1000)
            return ms

        wall = {"pass": [], "step": []}
        committed = 0
        passes(2), steps(2)  # warm
        for what in ("pass", "step", "step", "pass"):
            if what == "pass":
                ms, c = passes(8)
                committed += c
            else:
                ms = steps(8)
            wall[what] += ms
        prof = {what: _cuda_step_profile(fn, 4) for what, fn in
                (("pass", lambda: passes(4)), ("step", lambda: steps(4)))}
    return {"wall_ms": {w: statistics.median(v) for w, v in wall.items()},
            "tokens_per_pass": committed / 16, "profile": prof}


def phase_spec(card, engine):
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler
    from fastvlm_tpu_torch.timeline import Timeline
    from fastvlm_tpu_torch.video import VideoQA, qa_over_stream

    layers = engine.cfg.decoder.num_layers
    image = np.random.RandomState(0).randint(0, 256, (1024, 1024, 3),
                                             dtype=np.uint8)
    cap = 64

    # batch-1 generate: per prompt, in turns plain, spec, spec stream,
    # plain; K2 counted around each call
    fused_ffn.launches = 0
    requests, same_ids, res = 0, 0, {}
    for n, p in enumerate(SPEC_PROMPTS):
        prompt = engine.build_prompt(p)
        r = {"plain": []}
        for how in ("plain", "spec", "stream", "plain"):
            before = decode_attention.launches
            if how == "plain":
                text, st = engine.generate(prompt, image, max_new_tokens=cap)
                if decode_attention.launches - before != \
                        layers * st["decode_steps"]:
                    raise AssertionError(f"spec prompt {n}: K2 launched "
                                         f"{decode_attention.launches - before}"
                                         f" times for {st['decode_steps']} "
                                         f"plain steps")
                r["plain"].append((text, st))
            else:
                if how == "spec":
                    text, st = engine.generate_spec(prompt, image,
                                                    max_new_tokens=cap)
                else:
                    last = None
                    for last in engine.stream(prompt, image,
                                              max_new_tokens=cap, spec=True):
                        pass
                    text, st = last["text"], last["stats"]
                if decode_attention.launches != before:
                    raise AssertionError(f"spec prompt {n}: K2 launched "
                                         f"{decode_attention.launches - before}"
                                         f" times in a {how} request")
                r[how] = (text, st)
            requests += 1
        if r["stream"][0] != r["spec"][0]:
            raise AssertionError(f"spec prompt {n}: stream(spec=True) gave "
                                 f"other ids than generate_spec")
        same_ids += r["spec"][0] == r["plain"][0][0]
        res[n] = r
    if fused_ffn.launches != 44 * requests:
        raise AssertionError(f"K1 launched {fused_ffn.launches} times for "
                             f"{requests} requests")
    for n, r in res.items():
        sp, stream = r["spec"][1], r["stream"][1]
        passes = sp["spec_steps"]
        log("spec", f"prompt {n}: plain {r['plain'][0][1]['tok_per_s']:.2f} / "
                    f"{r['plain'][1][1]['tok_per_s']:.2f} tok/s (two runs, "
                    f"{r['plain'][0][1]['decode_tokens']} tokens after the "
                    f"first); stream(spec=True) {stream['tok_per_s']:.2f} "
                    f"tok/s ({stream['decode_tokens']} tokens, "
                    f"{stream['spec_steps']} passes dispatched); generate_spec "
                    f"{sp['decode_tokens']} tokens in {passes} verify passes, "
                    f"{(sp['decode_tokens'] - 1) / max(1, passes):.3f} "
                    f"tokens a pass, accept rate {sp['spec_accept_rate']}, "
                    f"{sp['tok_per_s']:.2f} tok/s from the prefill's start; "
                    f"spec ids {'equal' if r['spec'][0] == r['plain'][0][0] else 'differ from'}"
                    f" the plain ones; ids {r['spec'][0][:48]}...")
    log("spec", f"launch counts: K1 {fused_ffn.launches} = 44 x {requests} "
                f"requests; K2 0 in every spec request, 24 a step in the "
                f"plain ones; stream(spec=True) = generate_spec ids for all "
                f"3 prompts; {same_ids} of 3 spec answers equal the plain "
                f"ids exactly")
    for n, p in enumerate(SPEC_PROMPTS):
        _check_replay("spec", f"prompt {n}'s spec answer", engine, p, image,
                      res[n]["spec"][0])

    prof = _spec_pass_profile(engine, image)
    pp, ps = prof["profile"]["pass"], prof["profile"]["step"]
    if pp["k2"] != 0:
        raise AssertionError(f"{pp['k2']} K2 launches a "
                             f"verify pass")
    log("spec", f"a verify pass (9 tokens, batch 1) against a plain decode "
                f"step: wall {prof['wall_ms']['pass']:.3f} against "
                f"{prof['wall_ms']['step']:.3f} ms (medians of 16, host clock "
                f"dispatch to read, in turns); device time "
                f"{pp['device_ms']:.4f} against {ps['device_ms']:.4f} ms in "
                f"{pp['launches']:.1f} against {ps['launches']:.1f} launches "
                f"(profiler; K2 0 a pass, {ps['k2']:.1f} a step)"
                f"{pp['note']}{ps['note']}; "
                f"{prof['tokens_per_pass']:.3f} tokens a pass there; on {card}")

    # video: plain and spec VideoQA over the video phase's frames
    question = SPEC_PROMPTS[2]
    rng = np.random.RandomState(9)
    frames = [rng.randint(0, 256, (1080, 1920, 3), dtype=np.uint8)
              for _ in range(6)]
    VideoQA(engine, question, max_new_tokens=32, spec=True).ask(frames[0])
    plain_vq = VideoQA(engine, question, max_new_tokens=32)
    plain_seq = [plain_vq.ask(f) for f in frames]
    fused_ffn.launches = 0
    decode_attention.launches = 0
    seq = [t for t in qa_over_stream(
        VideoQA(engine, question, max_new_tokens=32, spec=True), frames,
        latest_only=False)]
    k1, k2 = fused_ffn.launches, decode_attention.launches
    t0 = time.perf_counter()
    piped = list(qa_over_stream(
        VideoQA(engine, question, max_new_tokens=32, spec=True), frames,
        latest_only=False, pipelined=True))
    pipe_ms = (time.perf_counter() - t0) * 1000
    if k1 != 44 * len(frames) or k2 != 0:
        raise AssertionError(f"video spec: K1 {k1} for {len(frames)} frames, "
                             f"K2 {k2}")
    if [t for t, _ in piped] != [t for t, _ in seq]:
        raise AssertionError("video spec: pipelined frames gave other ids "
                             "than the sequential ones")
    log("video-spec", f"6 frames of 1080x1920, 32 new tokens: spec total "
                      f"{[s['total_ms'] for _, s in seq]} ms a frame "
                      f"(median {_median([s['total_ms'] for _, s in seq]):.3f})"
                      f", {pipe_ms / len(frames):.3f} ms a frame pipelined; "
                      f"plain VideoQA {[s['total_ms'] for _, s in plain_seq]} "
                      f"ms (median "
                      f"{_median([s['total_ms'] for _, s in plain_seq]):.3f});"
                      f" verify passes {[s['spec_steps'] for _, s in seq]}, "
                      f"accept rate {[s['spec_accept_rate'] for _, s in seq]}"
                      f"; {sum(a == b for (a, _), (b, _) in zip(seq, plain_seq))}"
                      f" of 6 answers equal the plain ones; K1 {k1} = 44 x 6 "
                      f"frames, K2 0; pipelined ids equal the sequential ones; "
                      f"on {card}")
    for n, ((text, _), f) in enumerate(zip(seq, frames)):
        _check_replay("video-spec", f"frame {n}", engine, question, f, text)

    # the scheduler: one greedy request alone in spec chunks, then a second
    # admitted, after which plain chunks serve both
    sched = BatchScheduler(engine, max_batch=8, window_ms=20, page_size=64,
                           pool_tokens=16384, spec=True)
    sched.trace = Timeline(engine.device)
    fused_ffn.launches = 0
    decode_attention.launches = 0
    paged_decode_attention.launches = 0
    try:
        first = Client(sched, engine, SPEC_PROMPTS[1], image, 96)
        deadline = time.perf_counter() + JOIN_S
        while not sched.counters.get("disp_spec@1"):
            if time.perf_counter() > deadline or first.t_closed:
                raise AssertionError("spec-serve: no spec chunk ran")
            time.sleep(0.002)
        second = Client(sched, engine, SPEC_PROMPTS[0], image, 32)
        last = [first.result("spec-serve request 0"),
                second.result("spec-serve request 1")]
    finally:
        sched.shutdown()
    counters = dict(sched.counters)
    k1, k2, k3 = (fused_ffn.launches, decode_attention.launches,
                  paged_decode_attention.launches)
    events = [e[1] for e in sched.trace]
    if "admit" not in events or "disp" not in events[events.index("admit"):]:
        raise AssertionError(f"spec-serve: no plain chunk after the "
                             f"admission: {counters}")
    if any(e[3] != 1 for e in sched.trace if e[1] == "spec"):
        raise AssertionError("spec-serve: a spec chunk ran with 2 live rows")
    if k3 == 0 or k3 != layers * counters["decode_steps"] or k2 != 0:
        raise AssertionError(f"spec-serve: K3 {k3} for "
                             f"{counters['decode_steps']} plain steps, K2 {k2}")
    if k1 != 44 * counters["image_prefills"]:
        raise AssertionError(f"spec-serve: K1 {k1} for "
                             f"{counters['image_prefills']} image prefills")
    if sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError("spec-serve: pages still held")
    spec_ev = [e for e in sched.trace if e[1] == "spec"]
    plain1 = [e for e in sched.trace if e[1] == "disp" and e[3] == 1]
    log("spec-serve", f"counters {counters}; {len(spec_ev)} spec chunks of "
                      f"{spec_ev[0][4]} passes: "
                      f"{[round(e[5], 3) for e in spec_ev]} ms, committing "
                      f"{[e[6] for e in spec_ev]} tokens; plain chunks at 1 "
                      f"live row {[round(e[5], 3) for e in plain1]} ms for "
                      f"{engine.chunk} tokens; K3 {k3} = {layers} x "
                      f"{counters['decode_steps']} plain steps, K2 0, K1 {k1} "
                      f"= 44 x {counters['image_prefills']}; pool "
                      f"{sched.pool.free_pages}/{sched.pool.num_pages} free; "
                      f"on {card}")
    for n, (p, u) in enumerate(zip(SPEC_PROMPTS[:2][::-1], last)):
        _check_replay("spec-serve", f"request {n}", engine, p, image,
                      u["text"])
    return {"k1_launches": 44 * requests, "video_k1": 44 * len(frames),
            "serve_k1": k1, "serve_k3": k3}


def _leaves(tree, prefix=""):
    """{path: tensor} of a params tree."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def phase_checkpoint(card, main_engine, main_params, main_answers):
    """Phase main's weights written as a HF checkpoint (bf16 pytorch_model.bin
    + config.json in a temporary directory) and loaded back through
    build_engine: the loaded engine's parameters bitwise equal to phase
    main's, two of its prompts answered through the kernels, and
    verify_checkpoint's audit and features."""
    import tempfile

    from fastvlm_tpu_torch.engine import build_engine
    from fastvlm_tpu_torch.models import qwen2
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.utils.checkpoint import verify_checkpoint
    from fastvlm_tpu_torch.utils.hf_export import (
        export_state_dict, vlm_config_to_hf_dict)

    cfg = main_engine.cfg
    with tempfile.TemporaryDirectory(prefix="fastvlm_ckpt_") as ckpt:
        # phase main's tree: decoder fused (export splits it back), layer
        # scales not folded (the Engine folded a copy)
        t0 = time.perf_counter()
        sd = {k: torch.from_numpy(v).to(torch.bfloat16).contiguous()
              for k, v in export_state_dict(main_params, cfg).items()}
        torch.save(sd, os.path.join(ckpt, "pytorch_model.bin"))
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(vlm_config_to_hf_dict(cfg), f)
        write_s = time.perf_counter() - t0
        n_keys = len(sd)
        del sd
        size_gib = os.path.getsize(os.path.join(ckpt, "pytorch_model.bin")) / 2 ** 30

        t0 = time.perf_counter()
        engine = build_engine(ckpt, dtype="bfloat16", device="cuda",
                              tokenizer=IdTokenizer())
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log("checkpoint", f"phase main's weights: {n_keys} tensors, "
                          f"pytorch_model.bin {size_gib:.4f} GiB (bf16) written "
                          f"in {write_s:.3f} s (export + cast + save); "
                          f"build_engine loaded and converted it onto the card "
                          f"in {load_s:.3f} s")

        # the loaded engine's parameters are phase main's (decoder fused the
        # same way; both Engines folded the layer scales from equal trees).
        # Phase main's projector is float32 (projector.init draws f32, as in
        # JAX) and is cast to bf16 at use; the file holds it in bf16.
        got = _leaves({**engine.params, "decoder": qwen2.fuse_decoder_params(
            engine.params["decoder"], cfg.decoder)})
        want = _leaves(main_engine.params)
        if sorted(got) != sorted(want):
            raise AssertionError(f"loaded tree differs: "
                                 f"{sorted(set(got) ^ set(want))[:8]}")
        cast = 0
        for k, w in want.items():
            g = got[k]
            if w.dtype == torch.float32 and g.dtype == torch.bfloat16:
                w, cast = w.to(torch.bfloat16), cast + 1
            if g.dtype != w.dtype or g.device != w.device or not torch.equal(g, w):
                raise AssertionError(f"checkpoint: {k} differs from phase "
                                     f"main's ({g.dtype} vs {w.dtype})")
        if engine.cfg != dataclasses.replace(cfg, context_len=engine.cfg.context_len):
            raise AssertionError(f"checkpoint: loaded config {engine.cfg} is "
                                 f"not phase main's {cfg}")
        log("checkpoint", f"all {len(want)} tensors of the loaded engine equal "
                          f"phase main's bitwise on the card ({cast} float32 "
                          f"projector tensors after the bf16 cast phase main "
                          f"applies at use); configs equal")

        image = np.random.RandomState(0).randint(0, 256, (1024, 1024, 3),
                                                 dtype=np.uint8)
        prompts = ["Describe the image.", "What is written in the image?"]
        fused_ffn.launches = 0
        decode_attention.launches = 0
        results = [engine.generate(engine.build_prompt(p), image,
                                   max_new_tokens=32) for p in prompts]
        k1, k2 = fused_ffn.launches, decode_attention.launches
        steps = sum(st["decode_steps"] for _, st in results)
        layers = cfg.decoder.num_layers
        if k1 != 44 * len(prompts) or steps == 0 or k2 != layers * steps:
            raise AssertionError(f"checkpoint: K1 {k1} for {len(prompts)} "
                                 f"requests, K2 {k2} for {steps} steps")
        same = sum(text == main_answers[p] for p, (text, _) in
                   zip(prompts, results))
        for p, (text, st) in zip(prompts, results):
            log("checkpoint", f"{p!r}: ttft {st['ttft_ms']:.2f} ms, "
                              f"{st['decode_tokens']} tokens at "
                              f"{st['tok_per_s']:.2f} tok/s; ids {text[:48]}...")
        log("checkpoint", f"launch counts: K1 {k1} = 44 x {len(prompts)} "
                          f"requests; K2 {k2} = {layers} x {steps} steps; "
                          f"{same} of {len(prompts)} answers equal phase "
                          f"main's ids exactly (the loaded decoder is unfused: "
                          f"q/k/v and gate/up as separate products)")
        for p, (text, _) in zip(prompts, results):
            _check_replay("checkpoint", f"the loaded engine's answer to {p!r} "
                          f"(replayed through phase main's engine)",
                          main_engine, p, image, text)

        t0 = time.perf_counter()
        report = verify_checkpoint(ckpt, device="cuda")
        verify_s = time.perf_counter() - t0
    s = cfg.vision.image_size // cfg.vision.total_stride
    if (report["unused_keys"] or not report["features_finite"]
            or not report["tower_grid_finite"]
            or report["features_shape"] != [1, s * s, cfg.decoder.hidden_size]
            or report["tower_grid_shape"] != [1, s, s, cfg.vision.out_channels]):
        raise AssertionError(f"verify_checkpoint: {report}")
    log("checkpoint", f"verify_checkpoint (float32 on the card, "
                      f"{verify_s:.3f} s): {report['keys_used']} of "
                      f"{report['keys_total']} keys used, none unused; "
                      f"features {report['features_shape']} finite, mean "
                      f"|x| {report['features_abs_mean']:.6e}; tower grid "
                      f"{report['tower_grid_shape']} finite; on {card}")
    return {"engine": engine, "k1_launches": k1, "k2_launches": k2,
            "write_s": write_s, "load_s": load_s, "size_gib": size_gib}


BEAM_W = 4
BEAM_NEW = 32
# the beam's chosen score (summed f32 log-softmax over the hypothesis,
# over its length) against a dense batch-1 replay of its tokens: the
# beam's logits come from batch-4 steps, the replay's from batch-1 ones,
# and bf16 products of the two widths may round apart by a few ulps
# (~0.004-0.008 a logit here), which moves the per-token mean by less
BEAM_SCORE_TOL = 0.05


def _beam_score_replay(engine, prompt, image, toks):
    """Sum of the dense batch-1 path's f32 log-softmax at each of ``toks``
    (teacher-forced through prefill and decode_step)."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg = engine.cfg
    with torch.inference_mode():
        inputs = engine.prepare(engine.build_prompt(prompt), image)
        t = inputs["ids"].shape[1]
        cache = init_cache(cfg.decoder.num_layers, 1, t + len(toks),
                           cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                           torch.bfloat16, "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                    inputs["ids"], inputs["lens"],
                                    inputs["starts"], cache)
        total = torch.zeros((), device="cuda")
        for i, tok in enumerate(toks):
            total = total + torch.log_softmax(logits[0].float(), -1)[tok]
            if i + 1 < len(toks):
                logits, cache = vlm.decode_step(
                    engine.params, cfg,
                    torch.tensor([tok], dtype=torch.int32, device="cuda"),
                    cache)
    return float(total)


def _greedy_decoder(engine, prompt, image):
    """Batch-1 greedy decoding after ``prompt``'s prefill, as two closures
    (call them under ``torch.inference_mode``): ``prefilled(steps)`` ->
    (logits, cache) with room for ``steps`` more tokens, and
    ``greedy(logits, cache, steps)``, which runs ``steps // engine.chunk``
    decode chunks and reads each chunk's tokens on the host."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache
    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    cfg, dec, k = engine.cfg, engine.cfg.decoder, engine.chunk
    inputs = engine.prepare(prompt, image)
    t = inputs["ids"].shape[1]

    def prefilled(steps):
        cache = init_cache(dec.num_layers, 1, t + steps, dec.num_kv_heads,
                           dec.head_dim, torch.bfloat16, "cuda")
        return vlm.prefill(engine.params, cfg, inputs["images"],
                           inputs["ids"], inputs["lens"], inputs["starts"],
                           cache)

    def greedy(logits, cache, steps):
        tok = logits.argmax(-1).to(torch.int32)
        done = torch.zeros((1,), dtype=torch.bool, device="cuda")
        for _ in range(steps // k):
            toks, done, tok, cache = vlm.decode_chunk(
                engine.params, cfg, tok, done, cache, None, k=k,
                eos_ids=(-1,), sampling=SamplingParams())
            toks.cpu()

    return prefilled, greedy


def _cuda_step_profile(fn, steps):
    """One profiled call of ``fn`` (``steps`` decode steps or passes) on the
    card: launches, device ms, K2 / K3 launches and their ms, each a step.
    "k2" counts the wrappers' launches over the call (exact);
    "k2_profiled" is the profiler's count of their kernels, which can come
    out short (on an H100, one trace held 374 of a greedy chunk's 384).
    A short trace dropped kernels, so its device ms, launches and K2 ms
    are lower bounds: "short" says so, and "note" is the text each log
    line prints after them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = _launches()
    with profile(activities=[ProfilerActivity.CUDA]) as pr:
        fn()
        torch.cuda.synchronize()
    k2_k3 = (_launches() - before)[1:].sum()
    rows = [e for e in pr.key_averages() if e.device_type == DeviceType.CUDA]
    # K2's decode_kernel, K3's paged_decode_kernel
    attn = [e for e in rows if "decode_kernel" in e.key]
    k2, k2_profiled = float(k2_k3) / steps, sum(e.count for e in attn) / steps
    short = k2_profiled < k2
    return {"launches": sum(e.count for e in rows) / steps,
            "device_ms": sum(e.self_device_time_total for e in rows)
            / steps / 1000,
            "k2": k2, "k2_profiled": k2_profiled,
            "k2_ms": sum(e.self_device_time_total for e in attn)
            / steps / 1000, "short": short,
            "note": (f" [a short trace, so lower bounds: it held "
                     f"{k2_profiled:.3f} of {k2:.1f} K2 / K3 launches a "
                     f"step]" if short else "")}


def _beam_step_profile(engine, image):
    """A beam step (W = 4 rows, one decode_step, the top-2W sort, the
    hypothesis updates and the cache reorder) against a greedy step (batch
    1, decode_chunk), after the main prompt's prefill: wall ms a step from
    dispatch to the host read over 32-token runs (in turns beam, greedy,
    greedy, beam, beam, greedy), then one profiled run of 16 steps of each:
    device ms, launches and K2 launches a step."""
    from fastvlm_tpu_torch.ops.beam import beam_search

    with torch.inference_mode():
        prefilled, greedy = _greedy_decoder(
            engine, engine.build_prompt(SPEC_PROMPTS[0]), image)

        def beam(logits, cache, steps):
            res = beam_search(engine.params, engine.cfg, logits, cache,
                              num_beams=BEAM_W, max_new_tokens=steps + 1,
                              eos_ids=engine.eos_ids)
            int(res.lengths[0])

        fns = {"beam": (beam, BEAM_NEW - 1), "greedy": (greedy, BEAM_NEW)}
        wall = {"beam": [], "greedy": []}
        for what in ("beam", "greedy", "greedy", "beam", "beam", "greedy"):
            fn, steps = fns[what]
            logits, cache = prefilled(BEAM_NEW)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(logits, cache, steps)
            wall[what].append((time.perf_counter() - t0) * 1000 / steps)
        prof = {}
        steps = engine.chunk
        for what, (fn, _) in fns.items():
            logits, cache = prefilled(BEAM_NEW)
            prof[what] = _cuda_step_profile(
                lambda: fn(logits, cache, steps), steps)
    return {"wall_ms": {w: statistics.median(v) for w, v in wall.items()},
            "wall_all": wall, "profile": prof}


def phase_beam(card, engine, main_engine):
    """Beam search (W = 4, 32 new tokens) on the loaded engine: launch
    counts, K2 at the beam's shape against its plain version, the chosen
    score against a dense replay, W = 1 against greedy, identical requests;
    a beam step's cost beside a greedy step's."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.beam import beam_search
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference)
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg, dec = engine.cfg, engine.cfg.decoder
    image = np.random.RandomState(0).randint(0, 256, (1024, 1024, 3),
                                             dtype=np.uint8)
    prompts = [SPEC_PROMPTS[0], SPEC_PROMPTS[0], SPEC_PROMPTS[2]]
    engine.generate_beam(engine.build_prompt(prompts[0]), image,
                         num_beams=BEAM_W, max_new_tokens=4)  # warm
    torch.cuda.reset_peak_memory_stats()
    fused_ffn.launches = 0
    decode_attention.launches = 0
    results = []
    for p in prompts:
        k1, k2 = fused_ffn.launches, decode_attention.launches
        results.append(engine.generate_beam(
            engine.build_prompt(p), image, num_beams=BEAM_W,
            max_new_tokens=BEAM_NEW))
        k1, k2 = fused_ffn.launches - k1, decode_attention.launches - k2
        if k1 != 44 or k2 != dec.num_layers * (BEAM_NEW - 1):
            raise AssertionError(f"beam request {p!r}: K1 {k1}, K2 {k2} "
                                 f"(expected 44 and {dec.num_layers} x "
                                 f"{BEAM_NEW - 1})")
    k1_total, k2_total = fused_ffn.launches, decode_attention.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if results[0][0] != results[1][0]:
        raise AssertionError("beam: identical requests gave different ids")
    for p, (text, st) in zip(prompts, results):
        log("beam", f"W={BEAM_W} {p!r}: {st['ttft_ms']:.3f} ms for prefill + "
                    f"search, chosen hypothesis {st['decode_tokens']} tokens "
                    f"({st['tok_per_s']:.2f} tok/s); ids {text[:48]}...")
    log("beam", f"launch counts: K1 {k1_total} = 44 x {len(prompts)} "
                f"requests; K2 {k2_total} = {dec.num_layers} x "
                f"{BEAM_NEW - 1} steps x {len(prompts)} requests at batch "
                f"{BEAM_W}; identical requests gave identical ids; peak "
                f"device memory {peak_gib:.2f} GiB")

    # K2 at the beam's shape: B = W rows of equal length, the beam cache's
    # S_max (prompt bucket + max_new)
    inputs = engine.prepare(engine.build_prompt(prompts[0]), image)
    t, plen = inputs["ids"].shape[1], inputs["prompt_tokens"]
    s_max = t + BEAM_NEW
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    q, kc, vc = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                 for shape in ((BEAM_W, dec.num_heads, dec.head_dim),
                               (BEAM_W, s_max, dec.num_kv_heads, dec.head_dim),
                               (BEAM_W, s_max, dec.num_kv_heads, dec.head_dim)))
    lens = torch.full((BEAM_W,), plen + BEAM_NEW // 2, dtype=torch.int32,
                      device="cuda")
    k2_err, ratio = compare(decode_attention(q, kc, vc, lens),
                            decode_attention_reference(q, kc, vc, lens),
                            K2_TOL[torch.bfloat16], "K2 at the beam's shape")
    call = lambda: decode_attention(q, kc, vc, lens)
    k2_kernel_ms = kernel_time_ms(call, reps=50)
    k2_bound = attn_bound_ms(q, lens, dec.num_kv_heads, 2)
    log("beam", f"K2 at the beam's shape (B={BEAM_W}, {dec.num_heads}/"
                f"{dec.num_kv_heads}/{dec.head_dim} bf16, S_max {s_max}, "
                f"lengths {int(lens[0])}): max_abs_err {k2_err:.3e} (tol "
                f"ratio {ratio:.3f} <= 1); kernel time {fmt_us(k2_kernel_ms)} "
                f"(profiler), bound {k2_bound * 1e3:.4f} us (bytes)")

    # the chosen score against a dense batch-1 replay of its tokens
    with torch.inference_mode():
        cache = init_cache(dec.num_layers, 1, s_max, dec.num_kv_heads,
                           dec.head_dim, torch.bfloat16, "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                    inputs["ids"], inputs["lens"],
                                    inputs["starts"], cache)
        res = beam_search(engine.params, cfg, logits, cache,
                          num_beams=BEAM_W, max_new_tokens=BEAM_NEW,
                          eos_ids=engine.eos_ids)
    n = int(res.lengths[0])
    toks = res.tokens[0, :n].tolist()
    ids = [int(i) for i in results[0][0].split(",") if i]
    if toks[:len(ids)] != ids:
        raise AssertionError("beam_search gave other tokens than "
                             "generate_beam for the same prompt")
    score = float(res.scores[0])
    replay = _beam_score_replay(engine, prompts[0], image, toks) / n
    if not abs(score - replay) <= BEAM_SCORE_TOL:
        raise AssertionError(f"beam score {score:.6f} vs dense replay "
                             f"{replay:.6f} (tolerance {BEAM_SCORE_TOL})")
    log("beam", f"chosen hypothesis of {n} tokens: score {score:.6f} (summed "
                f"log-softmax / length), dense batch-1 replay {replay:.6f}, "
                f"|diff| {abs(score - replay):.3e} (tolerance "
                f"{BEAM_SCORE_TOL})")

    # W = 1 against greedy: the same ids, or a tie within TIE_ULPS wherever
    # they part
    w1, _ = engine.generate_beam(engine.build_prompt(prompts[0]), image,
                                 num_beams=1, max_new_tokens=BEAM_NEW)
    greedy, _ = engine.generate(engine.build_prompt(prompts[0]), image,
                                max_new_tokens=BEAM_NEW)
    if w1 != greedy:
        _check_replay("beam", "the W=1 answer (differs from greedy)", engine,
                      prompts[0], image, w1)
    log("beam", f"W=1 gave {'greedy generate' if w1 == greedy else 'other'}"
                f"'s ids")

    prof = _beam_step_profile(engine, image)
    pb, pg = prof["profile"]["beam"], prof["profile"]["greedy"]
    if round(pb["k2"]) != dec.num_layers or round(pg["k2"]) != dec.num_layers:
        raise AssertionError(f"step profile: K2 {pb['k2']} a beam step, "
                             f"{pg['k2']} a greedy step")
    log("beam", f"a beam step (W={BEAM_W}) against a greedy step (batch 1): "
                f"wall {prof['wall_ms']['beam']:.3f} against "
                f"{prof['wall_ms']['greedy']:.3f} ms (medians of 3 searches / "
                f"chunk runs of {BEAM_NEW} tokens, in turns: beam "
                f"{[round(x, 3) for x in prof['wall_all']['beam']]}, greedy "
                f"{[round(x, 3) for x in prof['wall_all']['greedy']]}); "
                f"device time {pb['device_ms']:.4f} against "
                f"{pg['device_ms']:.4f} ms in {pb['launches']:.1f} against "
                f"{pg['launches']:.1f} launches (profiler, 16 steps of "
                f"each; K2 "
                f"{pb['k2']:.1f} / {pg['k2']:.1f} a step by the wrapper's "
                f"count, {pb['k2_profiled']:.3f} / {pg['k2_profiled']:.3f} "
                f"in the trace){pb['note']}{pg['note']}; on {card}")
    return {"k1_launches": k1_total, "k2_launches": k2_total,
            "k2_max_abs_err": k2_err, "peak_gib": peak_gib}

# phase anyres: FastViTHD @1024 tiles on grids up to 2 x 2 (up to 5 tiles a
# stack with the global view)
ANYRES_PINPOINTS = ((2048, 1024), (1024, 2048), (2048, 2048))
ANYRES_NEW = 32
# serve-fairness: the first request's tokens, so its batch outlives
# fairness_s and a drain is needed for the deferred request
FAIR_LONG_NEW = 128
# the geometry each test image must take: best resolution, tiles a stack
# (global view included), merged tokens (num_merged_tokens, spatial_unpad)
ANYRES_SHOTS = {(1920, 1080): ((2048, 2048), 5, 850),
                (1024, 2048): ((1024, 2048), 3, 800)}
# a tile's grid encoded alone (batch 1) against the same tile inside its
# stack (batch 3 or 5: other convolution batch shapes, other bf16 rounding):
# max |diff| within this share of the stack grid's max |x|
TILE_REL_TOL = 0.05


def _live_tower(tree, gen, centre_taps=True, _branch=False):
    """The tower's conv and linear weights re-drawn N(0, 1/fan_in); with
    ``centre_taps`` the two branches that are x + conv(x) in their
    reparameterised form (RepMixer's mixer, RepCPE) take a unit centre tap
    on top. At fastvit.init's 0.02 std the activations underflow to 0 by
    stage 2; at 1/fan_in alone each of stage 2's 24 mixers scales a channel
    by a random zero-mean filter and the output shrinks toward 0 (the
    phase prints both draws' mean |x|)."""
    if isinstance(tree, list):
        return [_live_tower(v, gen, centre_taps, _branch) for v in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("w", "reduce_w", "expand_w"):
            fan_in = v[0].numel() if v.dim() == 4 else v.shape[0]
            w = torch.randn(v.shape, generator=gen, device=v.device) \
                / fan_in ** 0.5
            if centre_taps and _branch:  # depthwise (C, 1, k, k)
                w[:, 0, v.shape[2] // 2, v.shape[3] // 2] += 1.0
            out[k] = w.to(v.dtype)
        else:
            out[k] = _live_tower(v, gen, centre_taps,
                                 _branch or k in ("mixer", "cpe"))
    return out


def _scene(w, h, seed):
    """A uint8 (h, w, 3) test image with structure at every scale (a
    gradient, stripes, noise), so no two tiles are alike."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r = 127.5 + 127 * np.sin(xx / (23.0 + seed) + yy / 71.0)
    g = 255.0 * yy / h
    b = rng.randint(0, 256, (h, w)).astype(np.float32)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _host_merge(grids, grid_shape, crop_box, newline):
    """merge_spatial with unpad and newline, in numpy on the host."""
    gw, gh = grid_shape
    _, h, w, c = grids.shape
    full = grids[1:].reshape(gh, gw, h, w, c).transpose(0, 2, 1, 3, 4)
    top, bottom, left, right = crop_box
    full = full.reshape(gh * h, gw * w, c)[top:bottom, left:right]
    nl = np.broadcast_to(newline, (full.shape[0], 1, c))
    full = np.concatenate([full, nl], axis=1)
    return np.concatenate([grids[0].reshape(h * w, c), full.reshape(-1, c)])


def _replay_ids(engine, prompt, image, n_new):
    """Greedy ids of prefill (with the prepared vision embeddings) and
    decode_step, one step at a time over a dense cache of the engine's own
    size (prompt bucket + whole chunks), so K2 takes the engine's splits.
    Returns (ids, the prefill's last-position logits in f32)."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg, dec = engine.cfg, engine.cfg.decoder
    ids = []
    with torch.inference_mode():
        inputs = engine.prepare(prompt, image)
        t = inputs["ids"].shape[1]
        cache = init_cache(dec.num_layers, 1,
                           t + -(-n_new // engine.chunk) * engine.chunk,
                           dec.num_kv_heads, dec.head_dim, torch.bfloat16,
                           "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                    inputs["ids"], inputs["lens"],
                                    inputs["starts"], cache,
                                    vision_embeds=inputs["vision_embeds"])
        first = logits[0].float()
        for step in range(n_new):
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"replay step {step}: non-finite logits")
            tok = logits.argmax(-1).to(torch.int32)
            ids.append(int(tok[0]))
            if ids[-1] in engine.eos_ids:
                break
            logits, cache = vlm.decode_step(engine.params, cfg, tok, cache)
    return ids, first


def _text_ids(text):
    return [int(t) for t in text.split(",") if t]


def phase_anyres(card):
    """Anyres tiles and multi-image prompts at full width, and the
    scheduler's serial path, fairness drain and window batching."""
    from PIL import Image

    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.data.preprocessing import (
        process_anyres_image, select_best_resolution, tokenizer_image_token)
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import qwen2, vlm
    from fastvlm_tpu_torch.models.fastvit import fold_layer_scale
    from fastvlm_tpu_torch.ops import anyres
    from fastvlm_tpu_torch.ops.cuda import ffn as ffn_mod
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import ffn_reference, fused_ffn
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler
    from fastvlm_tpu_torch.timeline import Timeline

    t_phase = time.perf_counter()
    decoder = C.qwen2_0_5b(param_dtype="bfloat16", compute_dtype="bfloat16")
    vision = C.FastViTConfig(image_size=1024, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    cfg = C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                    hidden_size=decoder.hidden_size),
        image_aspect_ratio="anyres", image_grid_pinpoints=ANYRES_PINPOINTS,
        mm_patch_merge_type="spatial_unpad")
    layers, hidden, s = decoder.num_layers, decoder.hidden_size, 1024
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    t0 = time.perf_counter()
    params = vlm.init(gen, cfg, "cuda")
    params["vision"] = _live_tower(params["vision"], gen)
    params["decoder"] = qwen2.fuse_decoder_params(params["decoder"], decoder)
    engine = Engine(cfg, params, IdTokenizer())
    torch.cuda.synchronize()
    log("anyres", f"0.5B anyres engine (spatial_unpad, pinpoints "
                  f"{ANYRES_PINPOINTS}, fan-in tower) built in "
                  f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():  # the draws' embeddings on one image
        probe = engine.prepare_array_image(_scene(s, s, seed=0))
        means = []
        for vis in (params["vision"],
                    _live_tower(params["vision"], gen, centre_taps=False)):
            e = vlm.encode_images({**engine.params,
                                   "vision": fold_layer_scale(vis)},
                                  cfg, probe).float()
            means.append(float(e.abs().mean()))
    log("anyres", f"projected embeddings of one 1024 px image, mean |x|: "
                  f"{means[0]:.4g} (fan-in draw with centre taps, used), "
                  f"{means[1]:.4g} (fan-in draw alone)")

    # K1 at a 5-tile stack's stage-2 call: N = 5 x 4096 rows of C = 384, a
    # 63 MB bf16 hidden. On a fresh stream the per-(device, stream)
    # workspace is sized by its first call (one image's rows), then grows
    # to the stack's
    n1, n5, c5 = 4096, 5 * 4096, 384
    t, res, w1, b1, w2, b2, _ = _ffn_inputs(n5, c5, torch.bfloat16, gen)
    lib, code = ffn_mod._load(), ffn_mod._DTYPE_CODES[torch.bfloat16]
    need1, need = (lib.fvlm_ffn_workspace(n, c5, 4 * c5, code)
                   for n in (n1, n5))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        key = (t.device, side.cuda_stream)
        fused_ffn(t[:n1], res[:n1], w1, b1, w2, b2)
        ws1 = ffn_mod._WORKSPACES[key].numel()
        got = fused_ffn(t, res, w1, b1, w2, b2)
        ws5 = ffn_mod._WORKSPACES[key].numel()
    torch.cuda.current_stream().wait_stream(side)
    k1_err, ratio = compare(got, ffn_reference(t, res, w1, b1, w2, b2),
                            K1_TOL[torch.bfloat16], "K1 at a 5-tile stack")
    if not need1 <= ws1 < need <= ws5:
        raise AssertionError(f"K1 workspace {ws1} B at N={n1} ({need1} B "
                             f"needed), {ws5} B at N={n5} ({need} B)")
    log("anyres", f"K1 at the 5-tile stage-2 call (N={n5}, C={c5}, bf16, "
                  f"ls None): max_abs_err {k1_err:.3e} (tol ratio "
                  f"{ratio:.3f} <= 1); a fresh stream's workspace {ws1} B "
                  f"after one image's call ({need1} B needed), {ws5} B "
                  f"after the stack's ({need} B)")

    prompt = engine.build_prompt("Describe the image.")
    shots = {wh: Image.fromarray(_scene(*wh, seed=i + 1))
             for i, wh in enumerate(ANYRES_SHOTS)}
    for img in shots.values():  # warm: the 5- and 3-tile stacks' shapes
        engine.generate(prompt, img, max_new_tokens=2)

    # geometry, live embeddings, the merge against a host assembly, each
    # tile alone against its stack, the stack's encode time
    with torch.inference_mode():
        for wh, img in shots.items():
            best, n_tiles, n_tok = ANYRES_SHOTS[wh]
            got_best = select_best_resolution(img.size, list(ANYRES_PINPOINTS))
            grid = (got_best[0] // s, got_best[1] // s)
            got_n = anyres.num_merged_tokens(grid, vision.grid_size,
                                             cfg.mm_patch_merge_type, img.size)
            if (got_best, 1 + grid[0] * grid[1], got_n) != (best, n_tiles, n_tok):
                raise AssertionError(f"{wh}: best {got_best}, grid {grid}, "
                                     f"{got_n} tokens")
            inputs = engine.prepare(prompt, img)
            text_len = len(tokenizer_image_token(prompt, engine.tokenizer)) - 1
            span = inputs["prompt_tokens"] - text_len
            if tuple(inputs["vision_embeds"].shape) != (1, n_tok, hidden) \
                    or span != n_tok:
                raise AssertionError(
                    f"{wh}: embeddings {tuple(inputs['vision_embeds'].shape)}, "
                    f"expanded span {span}, merged tokens {n_tok}")
            tiles = torch.as_tensor(process_anyres_image(
                img, engine.processor, ANYRES_PINPOINTS)).to("cuda",
                                                             torch.bfloat16)
            grids = vlm.encode_tile_grids(engine.params, cfg, tiles)
            box = vlm.anyres_crop_box(cfg, grid, img.size)
            merged = vlm.merge_tile_grids(engine.params, cfg, grids, grid,
                                          box)[0]
            host = _host_merge(grids.float().cpu().numpy(), grid, box,
                               engine.params["image_newline"].float().cpu()
                               .numpy())
            if not np.array_equal(merged.float().cpu().numpy(), host):
                raise AssertionError(f"{wh}: merge_tile_grids differs from "
                                     f"the host assembly")
            g = grids.float()
            mean_abs = float(g.abs().mean())
            if not bool(torch.isfinite(g).all()) or not mean_abs > 1e-3:
                raise AssertionError(f"{wh}: embeddings finite "
                                     f"{bool(torch.isfinite(g).all())}, mean "
                                     f"|x| {mean_abs:.3e}")
            same = [(i, j) for i in range(n_tiles) for j in range(i + 1, n_tiles)
                    if torch.equal(grids[i], grids[j])]
            if same:
                raise AssertionError(f"{wh}: equal tile grids {same}")
            alone = torch.cat([vlm.encode_images(engine.params, cfg,
                                                 tiles[i:i + 1])
                               for i in range(n_tiles)]).float()
            stack = g.reshape(n_tiles, -1, hidden)
            tile_err = float((alone - stack).abs().max())
            scale = float(stack.abs().max())
            if not tile_err <= TILE_REL_TOL * scale:
                raise AssertionError(f"{wh}: a tile alone differs from its "
                                     f"stack by {tile_err:.4g} (max |x| "
                                     f"{scale:.4g})")
            # the stack's encode against one tile's: events over 10
            # back-to-back calls, then the profiler's kernel time
            enc = {"stack": lambda: vlm.encode_tile_grids(engine.params, cfg,
                                                          tiles),
                   "one": lambda: vlm.encode_images(engine.params, cfg,
                                                    tiles[:1])}
            ev = {k: time_batch_ms(f, reps=10, warmup=2) for k, f in enc.items()}
            kt = {k: kernel_time_ms(f, reps=5) for k, f in enc.items()}
            log("anyres", f"{wh[0]}x{wh[1]}: best {best}, {n_tiles} tiles, "
                          f"{n_tok} merged tokens = the expanded span; merge "
                          f"bitwise equal to the host assembly; embeddings "
                          f"finite, mean |x| {mean_abs:.4g}, no two tiles' "
                          f"grids equal; each tile alone within "
                          f"{tile_err:.4g} of its stack (max |x| {scale:.4g}, "
                          f"limit {TILE_REL_TOL} of it); tower + projector "
                          f"over the stack {ev['stack']:.3f} ms by events, "
                          f"{fmt_ms(kt['stack'])} of kernels, against one "
                          f"tile's {ev['one']:.3f} ms / {fmt_ms(kt['one'])} "
                          f"({ev['stack'] / ev['one']:.2f}x by events) on "
                          f"{card}")

    # two greedy requests of 32 tokens, the first again: K1 44 a request
    # (one tile stack), K2 24 a decode step
    fused_ffn.launches = 0
    decode_attention.launches = 0
    results = []
    for wh in list(ANYRES_SHOTS) + [next(iter(ANYRES_SHOTS))]:
        k1, k2 = fused_ffn.launches, decode_attention.launches
        text, st = engine.generate(prompt, shots[wh], max_new_tokens=ANYRES_NEW)
        k1, k2 = fused_ffn.launches - k1, decode_attention.launches - k2
        if k1 != 44 or k2 != layers * st["decode_steps"]:
            raise AssertionError(f"anyres {wh}: K1 {k1}, K2 {k2} for "
                                 f"{st['decode_steps']} steps")
        results.append((wh, text, st))
    any_k1, any_k2 = fused_ffn.launches, decode_attention.launches
    if results[0][1] != results[2][1]:
        raise AssertionError("anyres: identical requests gave different ids")
    first_logits = []
    for wh, text, st in results:
        replay, first = _replay_ids(engine, prompt, shots[wh], ANYRES_NEW)
        first_logits.append(first)
        if replay[:len(_text_ids(text))] != _text_ids(text):
            raise AssertionError(f"anyres {wh}: the step-by-step replay gave "
                                 f"other ids than the engine")
        log("anyres", f"{wh[0]}x{wh[1]}: TTFT {st['ttft_ms']:.3f} ms (tile "
                      f"encode {st['encode_ms']:.3f} ms of it), "
                      f"{st['decode_tokens']} tokens at {st['tok_per_s']:.2f} "
                      f"tok/s, prompt {st['prompt_tokens']} tokens; replay "
                      f"gave the engine's ids; ids {text[:48]}...; on {card}")
    # the pixels reach the decoder: another 1920x1080 image (the same
    # prompt ids and positions) gives other first-token logits
    wh0 = results[0][0]
    _, other = _replay_ids(engine, prompt, Image.fromarray(
        _scene(*wh0, seed=7)), 1)
    gap = float((first_logits[0] - other).abs().max())
    if not gap > 0:
        raise AssertionError(f"anyres: two {wh0} images gave the same "
                             f"first-token logits")
    log("anyres", f"launch counts: K1 {any_k1} = 44 x 3 requests (one tile "
                  f"stack each); K2 {any_k2} = {layers} x "
                  f"{sum(st['decode_steps'] for _, _, st in results)} steps; "
                  f"identical requests gave identical ids; another "
                  f"{wh0[0]}x{wh0[1]} image's first-token logits differ by "
                  f"up to {gap:.4g}")

    # a two-image prompt: both images in one tower call (K1 44)
    rng = np.random.RandomState(9)
    pair = [rng.randint(0, 256, (s, s, 3), dtype=np.uint8) for _ in range(2)]
    mprompt = engine.build_prompt("Compare <image> with the first one.")
    engine.generate(mprompt, pair, max_new_tokens=2)  # warm: a 2-image batch
    fused_ffn.launches = 0
    decode_attention.launches = 0
    mtext, mst = engine.generate(mprompt, pair, max_new_tokens=ANYRES_NEW)
    multi_k1, multi_k2 = fused_ffn.launches, decode_attention.launches
    if multi_k1 != 44 or multi_k2 != layers * mst["decode_steps"]:
        raise AssertionError(f"multi-image: K1 {multi_k1}, K2 {multi_k2} for "
                             f"{mst['decode_steps']} steps")
    if _replay_ids(engine, mprompt, pair, ANYRES_NEW)[0][:len(
            _text_ids(mtext))] != _text_ids(mtext):
        raise AssertionError("multi-image: the replay gave other ids")
    log("anyres", f"two-image prompt ({mst['prompt_tokens']} tokens, "
                  f"{2 * cfg.num_image_tokens} of them image): K1 {multi_k1} "
                  f"(both images in one tower call), K2 {multi_k2} = {layers} "
                  f"x {mst['decode_steps']} steps; TTFT {mst['ttft_ms']:.3f} "
                  f"ms (encode {mst['encode_ms']:.3f} ms of it), "
                  f"{mst['tok_per_s']:.2f} tok/s; replay gave the engine's "
                  f"ids; on {card}")

    # the scheduler: a steady stream of batchable requests and one
    # multi-image request under fairness_s = 0.5
    fillers = [rng.randint(0, 256, (s, s, 3), dtype=np.uint8) for _ in range(4)]
    sched = BatchScheduler(engine, max_batch=8, window_ms=20, page_size=64,
                           pool_tokens=16384, fairness_s=0.5)
    sched.trace = Timeline(engine.device)
    fused_ffn.launches = 0
    decode_attention.launches = 0
    paged_decode_attention.launches = 0
    stream_clients = []
    try:
        stream_clients.append(Client(sched, engine, "Describe the image.",
                                     fillers[0], FAIR_LONG_NEW))
        if not stream_clients[0].decoding.wait(JOIN_S):
            raise AssertionError("serve-fairness: the first batch never "
                                 "decoded")
        stop = threading.Event()

        def feed():
            while not stop.is_set():
                n = len(stream_clients)
                stream_clients.append(Client(
                    sched, engine, f"Describe image {n}.", fillers[n % 4], 16))
                stop.wait(0.2)

        feeder = threading.Thread(target=feed)
        feeder.start()
        try:
            multi = Client(sched, engine, "Compare <image> with the first one.",
                           pair, ANYRES_NEW)
            mlast = multi.result("serve-fairness multi-image request")
        finally:
            stop.set()
            feeder.join(timeout=JOIN_S)
        flast = [c.result(f"serve-fairness filler {n}")
                 for n, c in enumerate(stream_clients)]
        fair = (fused_ffn.launches, decode_attention.launches,
                paged_decode_attention.launches)
    finally:
        sched.shutdown()
    fc = dict(sched.counters)
    drains = [e for e in sched.trace if e[1] == "drain"]
    if fc.get("drained_for_fairness", 0) < 1 or not drains:
        raise AssertionError(f"serve-fairness: no drain, counters {fc}")
    if mlast["text"] != mtext:
        raise AssertionError("serve-fairness: the multi-image stream gave "
                             "other ids than the engine")
    if sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError(f"serve-fairness: {sched.pool.free_pages} of "
                             f"{sched.pool.num_pages} pages free")
    # the batch gathered after the drain holds the two-image request, so
    # the fillers gathered with it are served serially too (engine.stream:
    # their updates carry no finish reason): a tower call and K2 steps each
    serial = [u for u in flast + [mlast] if "finish_reason" not in u["stats"]]
    serial_steps = sum(u["stats"]["decode_steps"] for u in serial)
    if fair[0] != 44 * (fc["image_prefills"] + len(serial)) \
            or fair[1] != layers * serial_steps \
            or fair[2] != layers * fc["decode_steps"]:
        raise AssertionError(f"serve-fairness: K1/K2/K3 {fair}, "
                             f"{len(serial)} serial requests, counters {fc}")
    wait_ms = (multi.t_first - multi.t_submit) * 1000
    drain_ms = (drains[0][0] - multi.t_submit) * 1000
    log("serve-fairness", f"{len(stream_clients)} batchable requests (one "
                          f"every 0.2 s) and one two-image request: drained "
                          f"{fc['drained_for_fairness']}x; the two-image "
                          f"request's drain {drain_ms:.1f} ms after its "
                          f"submission, its first update after "
                          f"{wait_ms:.1f} ms, its ids the engine's; K1 "
                          f"{fair[0]} = 44 x ({fc['image_prefills']} image "
                          f"prefills + {len(serial)} serial requests), K2 "
                          f"{fair[1]} = {layers} x {serial_steps} serial "
                          f"steps, K3 {fair[2]} = {layers} x "
                          f"{fc['decode_steps']} batched steps; pool "
                          f"{sched.pool.free_pages}/{sched.pool.num_pages} "
                          f"pages free; counters {fc}; on {card}")

    # window batching: 4 requests at once, 4 more while they decode, no
    # admission
    sched = BatchScheduler(engine, max_batch=8, window_ms=100, page_size=64,
                           pool_tokens=16384, continuous=False)
    fused_ffn.launches = 0
    decode_attention.launches = 0
    paged_decode_attention.launches = 0
    try:
        clients = [Client(sched, engine, f"Describe image {i}.", fillers[i],
                          ANYRES_NEW) for i in range(4)]
        if not clients[0].decoding.wait(JOIN_S):
            raise AssertionError("serve-window: the first batch never decoded")
        clients += [Client(sched, engine, f"What is in image {i}?",
                           fillers[i], ANYRES_NEW) for i in range(4)]
        wlast = [c.result(f"serve-window request {n}")
                 for n, c in enumerate(clients)]
        win = (fused_ffn.launches, decode_attention.launches,
               paged_decode_attention.launches)
    finally:
        sched.shutdown()
    wc = dict(sched.counters)
    if wc.get("admitted", 0) != 0 or wc["prefills"] < 2:
        raise AssertionError(f"serve-window: counters {wc}")
    if win[0] != 44 * wc["image_prefills"] or win[1] != 0 \
            or win[2] == 0 or win[2] != layers * wc["decode_steps"]:
        raise AssertionError(f"serve-window: K1/K2/K3 {win}, counters {wc}")
    if sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError(f"serve-window: {sched.pool.free_pages} of "
                             f"{sched.pool.num_pages} pages free")
    late_queue = [u["stats"]["queue_ms"] for u in wlast[4:]]
    log("serve-window", f"8 requests, 4 at once and 4 while they decode, "
                        f"continuous=False: admitted 0, {wc['prefills']} "
                        f"batched prefills; K1 {win[0]} = 44 x "
                        f"{wc['image_prefills']}, K3 {win[2]} = {layers} x "
                        f"{wc['decode_steps']} steps, K2 0; the late four "
                        f"queued {min(late_queue):.1f}-{max(late_queue):.1f} "
                        f"ms; pool {sched.pool.free_pages}/"
                        f"{sched.pool.num_pages} pages free; on {card}")
    log("anyres", f"phases anyres, serve-fairness and serve-window took "
                  f"{time.perf_counter() - t_phase:.1f} s")
    return {"k1_err": k1_err, "anyres_k1": any_k1, "anyres_k2": any_k2,
            "multi_k1": multi_k1, "multi_k2": multi_k2,
            "fair": fair, "window": win,
            "drain_ms": drain_ms, "wait_ms": wait_ms}


# ---------------------------------------------------------------------------
# LLaVA-1.5-7B (CLIP ViT-L/14-336 + mlp2x_gelu + Vicuna-7B) and the worker
# ---------------------------------------------------------------------------

LLAVA_NEW = 32
LLAVA_PROMPTS = ["Describe the image.", "What is in the picture?",
                 "Describe the scene in detail.", "What colour dominates?"]
LLAVA_S2 = (336, 672, 1008)


def _greedy_step_profile(engine, prompt, image, chunks=2):
    """A batch-1 greedy decode step after ``prompt``'s prefill: wall ms a
    step from dispatch to the host read over two runs of ``chunks`` chunks,
    then one profiled chunk (the prefill outside the profile): device ms,
    launches, K2 launches and K2 ms a step."""
    k = engine.chunk
    with torch.inference_mode():
        prefilled, greedy = _greedy_decoder(engine, prompt, image)
        wall = []
        for _ in range(2):
            logits, cache = prefilled(chunks * k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            greedy(logits, cache, chunks * k)
            wall.append((time.perf_counter() - t0) * 1000 / (chunks * k))
        logits, cache = prefilled(k)
        prof = _cuda_step_profile(lambda: greedy(logits, cache, k), k)
    return {"wall_ms": wall, **prof}


def _tree_stats(tree):
    """(parameter count, bytes) of a params tree."""
    ts = list(_leaves(tree).values())
    return sum(t.numel() for t in ts), sum(t.numel() * t.element_size()
                                           for t in ts)


def phase_llava15(card):
    """LLaVA-1.5-7B at full width: CLIP ViT-L/14-336 (penultimate layer,
    576 patch tokens of 1024 channels), mlp2x_gelu 1024 -> 4096 and
    Vicuna-7B (llama_7b: 32 layers, 32/32/128), bf16, random weights from a
    seed, the byte tokenizer, template v1."""
    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import clip_vit, projector, qwen2, vlm

    t_phase = time.perf_counter()
    vision = clip_vit.CLIPViTConfig()
    decoder = C.llama_7b(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(mm_hidden_size=vision.out_hidden_size,
                                    hidden_size=decoder.hidden_size))
    if (cfg.num_image_tokens, vision.out_channels) != (576, 1024):
        raise AssertionError(f"CLIP ViT-L/14-336 geometry: "
                             f"{cfg.num_image_tokens} tokens of "
                             f"{vision.out_channels}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    t0 = time.perf_counter()
    params = {"vision": clip_vit.init(gen, vision, "cuda",
                                      dtype=torch.bfloat16),
              "projector": projector.init(gen, cfg.projector, "cuda"),
              "decoder": qwen2.init(gen, decoder, "cuda")}
    params["decoder"] = qwen2.fuse_decoder_params(params["decoder"], decoder)
    engine = Engine(cfg, params, IdTokenizer(), conv_mode="v1")
    torch.cuda.synchronize()
    counts = {k: _tree_stats(v) for k, v in params.items()}
    log("llava15", f"LLaVA-1.5-7B built on the card in "
                   f"{time.perf_counter() - t0:.1f} s: tower "
                   f"{counts['vision'][0] / 1e6:.1f} M params, projector "
                   f"{counts['projector'][0] / 1e6:.1f} M, decoder "
                   f"{counts['decoder'][0] / 1e9:.3f} B ("
                   f"{counts['decoder'][1] / 2 ** 30:.2f} GiB); device memory "
                   f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
                   f"GiB")
    images = [_scene(336, 336, 40 + i) for i in range(len(LLAVA_PROMPTS) + 1)]
    prompts = [engine.build_prompt(p) for p in LLAVA_PROMPTS]

    # the tower's features are alive (finite, non-zero) and the image
    # moves the answer: another image, other first-token logits
    with torch.inference_mode():
        x = engine.prepare_array_image(images[0])
        feats = clip_vit.features(engine.params["vision"], x, vision)
    if feats.shape != (1, 576, 1024) or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"CLIP features {tuple(feats.shape)} or "
                             f"non-finite")
    mean_abs = float(feats.float().abs().mean())
    if mean_abs == 0.0:
        raise AssertionError("CLIP features are all zero")
    _, first_a = _replay_ids(engine, prompts[0], images[0], 1)
    _, first_b = _replay_ids(engine, prompts[0], images[-1], 1)
    moved = float((first_a - first_b).abs().max())
    if moved == 0.0:
        raise AssertionError("another image left the first-token logits "
                             "unchanged")
    log("llava15", f"tower features (1, 576, 1024) finite, mean |x| "
                   f"{mean_abs:.4f}; another image moves the first-token "
                   f"logits by up to {moved:.4f}")

    # 4 greedy requests of 32 tokens (the first cold)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    results = [engine.generate(p, img, max_new_tokens=LLAVA_NEW)
               for p, img in zip(prompts, images)]
    launches = _launches()
    k1, k2, k3 = (int(n) for n in launches)
    steps = sum(st["decode_steps"] for _, st in results)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for n, (text, st) in enumerate(results):
        log("llava15", f"request {n}: ttft {st['ttft_ms']:.2f} ms, "
                       f"{st['decode_tokens']} tokens at {st['tok_per_s']:.2f} "
                       f"tok/s, {st['decode_steps']} steps, prompt "
                       f"{st['prompt_tokens']} tokens; ids {text[:60]}...")
    if k1 != 0 or k3 != 0 or steps == 0 \
            or k2 != decoder.num_layers * steps:
        raise AssertionError(f"K1 {k1} (expected 0: CLIP has none), K2 {k2} "
                             f"for {steps} steps (expected "
                             f"{decoder.num_layers} a step), K3 {k3} "
                             f"(expected 0: a dense cache)")
    if results[0][1]["prompt_tokens"] < cfg.num_image_tokens:
        raise AssertionError(f"prompt of {results[0][1]['prompt_tokens']} "
                             f"tokens holds no 576-token image span")
    for n in (0, 3):
        _check_replay("llava15", f"request {n}", engine, LLAVA_PROMPTS[n],
                      images[n], results[n][0])
    warm = results[1:]
    ttft = [st["ttft_ms"] for _, st in warm]
    tps = statistics.mean(st["tok_per_s"] for _, st in warm)
    log("llava15", f"launch counts: K1 {k1}, K2 {k2} = {decoder.num_layers} "
                   f"x {steps} steps, K3 {k3}; warm TTFT {[round(t, 3) for t in ttft]} "
                   f"ms (median {statistics.median(ttft):.3f}), decode "
                   f"{tps:.2f} tok/s; peak device memory {peak_gb:.2f} GiB on "
                   f"{card}")

    # tower + projector, one image, by events and kernel time
    with torch.inference_mode():
        enc = lambda: vlm.encode_images(engine.params, cfg, x)
        enc_ms = time_ms(enc, reps=10)
        enc_k_ms = kernel_time_ms(enc, reps=5)
    step = _greedy_step_profile(engine, prompts[0], images[0])
    log("llava15", f"tower + projector (576 tokens -> 4096): {enc_ms:.3f} ms "
                   f"by events, {fmt_ms(enc_k_ms)} of kernels; a decode step: "
                   f"{step['wall_ms'][0]:.3f} / {step['wall_ms'][1]:.3f} ms "
                   f"wall (two runs), {step['device_ms']:.4f} ms of device "
                   f"time, {step['launches']:.1f} launches, K2 "
                   f"{step['k2']:.1f} launches and {step['k2_ms']:.4f} ms "
                   f"(profiler){step['note']} on {card}")

    # K2 at 32/32/128 against its plain version at the phase's cache: B = 1
    # and B = 4 rows of the cached length
    plen = results[0][1]["prompt_tokens"]
    s_max = -(-(plen + 1) // engine.bucket) * engine.bucket + LLAVA_NEW
    k2pts = {}
    for b in (1, 4):
        pt = _k2_point(gen, b, 32, 32, 128, s_max, plen + LLAVA_NEW // 2)
        k2pts[b] = pt
        share = ("not measured" if pt["kernel_ms"] is None
                 else f"{pt['bound_ms'] / pt['kernel_ms']:.4f}")
        log("llava15", f"K2 32/32/128 bf16 B={b}, S_max {s_max}, length "
                       f"{plen + LLAVA_NEW // 2}: max_abs_err {pt['err']:.3e} "
                       f"(tol ratio {pt['ratio']:.3f} <= 1); kernel time "
                       f"{fmt_us(pt['kernel_ms'])}, {pt['ms']:.4f} ms a call "
                       f"by events; bound {pt['bound_ms'] * 1e3:.4f} us "
                       f"(bytes), share {share}; plain {pt['plain_ms']:.4f} "
                       f"ms; scaled_dot_product_attention kernel time "
                       f"{fmt_us(pt['library_kernel_ms'])}, "
                       f"{pt['library_ms']:.4f} ms a call")

    # S2 (336/672/1008): 1 + 4 + 9 crops, 3072 channels; its first scale is
    # the single-scale features
    s2cfg = dataclasses.replace(vision, s2_scales=LLAVA_S2)
    with torch.inference_mode():
        s2 = clip_vit.features_s2(engine.params["vision"], x, s2cfg)
        s2_ms = time_ms(lambda: clip_vit.features_s2(
            engine.params["vision"], x, s2cfg), reps=5, warmup=1)
    if s2.shape != (1, 576, 3072) or not bool(torch.isfinite(s2).all()):
        raise AssertionError(f"S2 features {tuple(s2.shape)} or non-finite")
    s2_err, s2_ratio = compare(s2[..., :1024], feats, K2_TOL[torch.bfloat16],
                               "S2's first scale vs the single-scale features")
    log("llava15", f"S2 {LLAVA_S2}: (1, 576, 3072) finite in {s2_ms:.3f} ms "
                   f"by events (14 crops); its first 1024 channels vs the "
                   f"single-scale features: max_abs_err {s2_err:.3e} "
                   f"(bitwise {bool(torch.equal(s2[..., :1024], feats))}; "
                   f"tol atol=rtol=1e-2, ratio {s2_ratio:.3f}); phase "
                   f"{time.perf_counter() - t_phase:.1f} s")
    return {"engine": engine, "images": images, "launches": launches,
            "k2_err": max(pt["err"] for pt in k2pts.values()), "k2": k2pts,
            "ttft_ms": ttft, "tok_s": tps, "encode_ms": enc_ms,
            "encode_kernel_ms": enc_k_ms, "step": step, "s2_ms": s2_ms}


def _png_b64(arr):
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _pil_of(b64):
    import base64
    import io

    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def _launches():
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)

    return np.array([fused_ffn.launches, decode_attention.launches,
                     paged_decode_attention.launches])


def _zero_launches():
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention
    from fastvlm_tpu_torch.ops.cuda.ffn import fused_ffn
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)

    fused_ffn.launches = 0
    decode_attention.launches = 0
    paged_decode_attention.launches = 0


SOAK_TEMPLATE = ("You are a meticulous visual assistant. Answer precisely "
                 "and cite what you can see. ")


def phase_worker(card, engine, llava, llava_images):
    """ModelWorker in process (no controller, no HTTP: the card's machine
    has no aiohttp), driven through generate_stream as the HTTP routes pump
    it: (a) serially over phase main's 0.5B engine, (b) with continuous
    batching over it (warmup, then the soak plan of
    scripts/soak_serving.py at n = 16), (c) with continuous batching over
    LLaVA-1.5-7B (4 concurrent image requests)."""
    from fastvlm_tpu_torch.serve.protocol import ErrorCode, iter_chunks
    from fastvlm_tpu_torch.serve.worker import (
        ModelWorker, _openai_to_worker_payload)
    from fastvlm_tpu_torch.utils.logging import profile_trace

    t_phase = time.perf_counter()
    layers = engine.cfg.decoder.num_layers
    k1_per = sum(engine.cfg.vision.layers)  # K1 launches an image: 44

    def stream(w, payload, cancel=None):
        return list(iter_chunks(w.generate_stream(payload, cancel=cancel)))

    # (a) serial
    w = ModelWorker(engine, "fastvlm-0.5b")
    b64 = _png_b64(np.random.RandomState(21).randint(0, 256, (1024, 1024, 3),
                                                     dtype=np.uint8))
    image = _pil_of(b64)
    prompt = engine.build_prompt("Describe the image.")
    native = {"prompt": prompt, "images": [b64], "temperature": 0.0,
              "max_new_tokens": 32}
    _zero_launches()
    plain = stream(w, native)
    serial_l = _launches()
    spec = stream(w, {**native, "spec": True})
    spec_l = _launches() - serial_l
    body = {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,"
                                            + b64}},
        {"type": "text", "text": "Describe the image."}]}],
        "max_tokens": 32, "temperature": 0}
    payload = _openai_to_worker_payload(body, w)
    before = _launches()
    openai = stream(w, payload)
    openai_l = _launches() - before
    bad = stream(w, {**native, "spec": True, "temperature": 0.7})
    worker_l = _launches()
    want = engine.generate(prompt, image, max_new_tokens=32)[0]
    want_spec = None
    for u in engine.stream(prompt, image, max_new_tokens=32, spec=True):
        want_spec = u["text"]
    for what, msgs in (("plain", plain), ("spec", spec), ("openai", openai)):
        if not msgs or any(m["error_code"] != ErrorCode.OK for m in msgs):
            raise AssertionError(f"worker {what}: {msgs[-1:]}")
    steps = plain[-1]["stats"]["decode_steps"] \
        + openai[-1]["stats"]["decode_steps"]
    if plain[-1]["text"] != want:
        raise AssertionError("the worker's text differs from "
                             "engine.generate's")
    if spec[-1]["text"] != want_spec:
        raise AssertionError("the spec payload's text differs from "
                             "engine.stream(spec=True)'s")
    if payload["prompt"] != prompt or openai[-1]["text"] != want:
        raise AssertionError("the OpenAI body's text differs from the native "
                             "payload's")
    if len(bad) != 1 or bad[0]["error_code"] != ErrorCode.CLIENT_ERROR:
        raise AssertionError(f"spec with temperature > 0: {bad}")
    if tuple(serial_l) != (k1_per, layers
                           * plain[-1]["stats"]["decode_steps"], 0) \
            or spec_l[0] != k1_per or spec_l[1] != 0 \
            or tuple(openai_l) != (k1_per, layers
                                   * openai[-1]["stats"]["decode_steps"], 0):
        raise AssertionError(f"worker launches: plain {serial_l}, spec "
                             f"{spec_l}, openai {openai_l}")
    log("worker", f"(a) serial over the 0.5B engine: the streamed text of a "
                  f"base64 PNG payload equals engine.generate's ({len(plain)} "
                  f"chunks, ttft {plain[-1]['stats']['ttft_ms']} ms); the "
                  f"spec payload's equals engine.stream(spec=True)'s "
                  f"({spec[-1]['stats'].get('spec_steps')} verify passes; "
                  f"{'the same as' if spec[-1]['text'] == want else 'other than'}"
                  f" the plain text); spec + temperature 0.7 gave one "
                  f"CLIENT_ERROR chunk; the OpenAI body (a data: URI image) "
                  f"gave the native payload's text; launches K1/K2/K3 "
                  f"{tuple(int(n) for n in worker_l)} = {k1_per} x 3 "
                  f"requests, "
                  f"{layers} x {steps} plain steps, 0")

    # utils/logging.profile_trace over one more serial request (outside the
    # counted run): its Chrome trace holds the card's kernels, K2's among
    # them (a profiler session now and then records no device activity:
    # up to 3 tries)
    for _ in range(3):
        with tempfile.TemporaryDirectory() as tmp:
            with profile_trace(tmp) as path:
                traced = stream(w, {**native, "max_new_tokens": 8})
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel"]
        k2_ev = sum("decode_kernel" in e.get("name", "") for e in kern)
        if k2_ev:
            break
    t_steps = traced[-1]["stats"]["decode_steps"]
    if traced[-1]["error_code"] != ErrorCode.OK or not k2_ev:
        raise AssertionError(f"profile_trace: {len(kern)} kernel events, "
                             f"K2 {k2_ev}; last chunk {traced[-1]}")
    log("worker", f"profile_trace over an 8-token request: a Chrome trace of "
                  f"{len(events)} events, {len(kern)} of them kernels on the "
                  f"card, K2 {k2_ev} (expected {layers} x {t_steps} steps = "
                  f"{layers * t_steps})")

    # (b) continuous batching over the 0.5B engine: warmup, then the soak
    w = ModelWorker(engine, "fastvlm-0.5b", continuous_batching=True)
    sched = w.scheduler
    rng = np.random.RandomState(22)
    simg = _png_b64(rng.randint(0, 256, (1024, 1024, 3), dtype=np.uint8))

    def plan(i):
        cancel = i % 7 == 3
        return dict(
            prompt=engine.build_prompt(
                (SOAK_TEMPLATE if i % 2 == 0 else "") + f"describe scene {i}"),
            images=[simg] if i % 4 == 0 else [],
            max_new=96 if cancel else (16, 48, 96)[i % 3],
            temperature=0.8 if i % 5 == 1 else 0.0, cancel=cancel)

    plans = [plan(i) for i in range(16)]
    plen = max(engine.prepare(pl["prompt"], _pil_of(simg) if pl["images"]
                              else None)["prompt_tokens"] for pl in plans)
    t0 = time.perf_counter()
    n_warm = sched.warmup(prompt_len=plen, max_new_tokens=96)
    warm_s = time.perf_counter() - t0
    if n_warm != 7 or sched.counters or \
            sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError(f"warmup: {n_warm} dispatches, counters "
                             f"{dict(sched.counters)}, pool "
                             f"{sched.pool.free_pages}/{sched.pool.num_pages}")
    _zero_launches()
    outs = [None] * len(plans)
    walls = [None] * len(plans)

    def run(i):
        pl = plans[i]
        ev = threading.Event()
        msgs = []
        t_start = time.perf_counter()
        for piece in w.generate_stream(
                {"prompt": pl["prompt"], "images": pl["images"],
                 "temperature": pl["temperature"], "top_p": 0.9,
                 "max_new_tokens": pl["max_new"]}, cancel=ev):
            msgs.extend(iter_chunks([piece]))
            if pl["cancel"]:
                ev.set()  # mid-stream: after its first token
        walls[i] = time.perf_counter() - t_start
        outs[i] = msgs

    threads = [threading.Thread(target=run, args=(i,)) for i in
               range(len(plans))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
        time.sleep(0.15)
    for t in threads:
        t.join(JOIN_S)
        if t.is_alive():
            raise AssertionError("worker soak: a stream did not close")
    makespan = time.perf_counter() - t0
    sched.shutdown()
    status = w.status()
    counters = dict(sched.counters)
    soak_l = _launches()
    n_cancel = 0  # cancels that met a live stream
    ttfts, tokens = [], 0
    for i, (pl, msgs) in enumerate(zip(plans, outs)):
        if not msgs or any(m["error_code"] != ErrorCode.OK for m in msgs):
            raise AssertionError(f"worker soak request {i}: {msgs[-1:]}")
        reason = msgs[-1]["stats"].get("finish_reason")
        tokens += msgs[-1]["stats"]["decode_tokens"]
        if pl["cancel"] and reason in (None, "cancelled"):
            n_cancel += 1
            if len(msgs) > 1:
                raise AssertionError(f"cancelled request {i} streamed on: "
                                     f"{len(msgs)} chunks")
        elif reason not in ("stop", "length", "truncated"):
            raise AssertionError(f"worker soak request {i}: {reason}")
        else:
            ttfts.append(msgs[-1]["stats"]["ttft_ms"])
    # a cancelled row whose chunk ended it (EOS) before the boundary that
    # sweeps the cancel closes as finished, uncounted
    if not 1 <= counters.get("cancelled", 0) <= n_cancel:
        raise AssertionError(f"{n_cancel} cancels, counters {counters}")
    if sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError(f"worker soak: {sched.pool.free_pages} of "
                             f"{sched.pool.num_pages} pages free")
    if status["batching"] != counters or \
            status["kv_pool"]["num_pages"] != sched.pool.num_pages:
        raise AssertionError(f"status() {status} against counters {counters}")
    if soak_l[0] != k1_per * counters["image_prefills"] or soak_l[1] != 0 \
            or soak_l[2] == 0 or soak_l[2] != layers * counters["decode_steps"]:
        raise AssertionError(f"worker soak launches K1/K2/K3 {soak_l}, "
                             f"counters {counters}")
    log("worker", f"(b) continuous batching over the 0.5B engine: warmup("
                  f"prompt_len={plen}) {n_warm} dummy dispatches in "
                  f"{warm_s:.3f} s; soak of {len(plans)} requests (one every "
                  f"0.15 s; 4 with images, 3 sampled, half with a shared "
                  f"template prefix, budgets 16/48/96, "
                  f"{sum(pl['cancel'] for pl in plans)} cancelled "
                  f"at their first token, {n_cancel} of them while live): "
                  f"every uncancelled stream closed with error "
                  f"code 0 and a finish reason, cancels counted "
                  f"{counters['cancelled']}, pool {sched.pool.free_pages}/"
                  f"{sched.pool.num_pages} pages free, min free "
                  f"{sched.pool.min_free}; status() reports the counters; "
                  f"TTFT median {statistics.median(ttfts):.3f} ms, max "
                  f"{max(ttfts):.3f} ms; served {tokens} tokens in "
                  f"{makespan:.3f} s: {tokens / makespan:.3f} tok/s; launches "
                  f"K1/K2/K3 {tuple(int(n) for n in soak_l)} = {k1_per} x "
                  f"{counters['image_prefills']} image prefills, 0, {layers} "
                  f"x {counters['decode_steps']} steps; counters {counters}")

    # (c) continuous batching over LLaVA-1.5-7B: 4 concurrent image
    # requests, each the engine's serial ids
    lcfg = llava.cfg
    llayers = lcfg.decoder.num_layers
    b64s = [_png_b64(img) for img in llava_images[:len(LLAVA_PROMPTS)]]
    lprompts = [llava.build_prompt(p) for p in LLAVA_PROMPTS]
    serial = [llava.generate(p, _pil_of(b), max_new_tokens=LLAVA_NEW)[0]
              for p, b in zip(lprompts, b64s)]
    w = ModelWorker(llava, "llava-1.5-7b", continuous_batching=True,
                    pool_tokens=8192)
    sched = w.scheduler
    sched.window_s = 0.25  # gather all four into one batch
    _zero_launches()
    outs = [None] * 4

    def run7(i):
        outs[i] = list(iter_chunks(w.generate_stream(
            {"prompt": lprompts[i], "images": [b64s[i]], "temperature": 0.0,
             "max_new_tokens": LLAVA_NEW})))

    threads = [threading.Thread(target=run7, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        if t.is_alive():
            raise AssertionError("worker-llava: a stream did not close")
    counters7 = dict(sched.counters)
    sched.shutdown()
    llava_l = _launches()
    for i, msgs in enumerate(outs):
        if not msgs or any(m["error_code"] != ErrorCode.OK for m in msgs):
            raise AssertionError(f"worker-llava request {i}: {msgs[-1:]}")
        if msgs[-1]["text"] != serial[i]:
            raise AssertionError(f"worker-llava request {i}: batched ids "
                                 f"{msgs[-1]['text'][:80]} differ from the "
                                 f"serial {serial[i][:80]}")
    if llava_l[0] != 0 or llava_l[1] != 0 \
            or llava_l[2] != llayers * counters7["decode_steps"]:
        raise AssertionError(f"worker-llava launches K1/K2/K3 {llava_l}, "
                             f"counters {counters7}")
    # the prefix registry (on from 1e9 decoder parameters) pins pages
    pinned = set() if sched.prefix is None else {
        p for pages in sched.prefix.entries.values() for p in pages}
    if sched.pool.free_pages + len(pinned) != sched.pool.num_pages:
        raise AssertionError(f"worker-llava: {sched.pool.free_pages} free + "
                             f"{len(pinned)} pinned of {sched.pool.num_pages}")
    if sched.prefix is not None:
        sched.prefix.clear()
    if sched.pool.free_pages != sched.pool.num_pages:
        raise AssertionError("worker-llava: pages held after clearing the "
                             "prefix registry")
    # the batch-4 step of the 7B on the pool against a dense cache, and K3
    # at that call against its plain version and its bound
    plen7 = llava.prepare(lprompts[0], _pil_of(b64s[0]))["prompt_tokens"]
    prof = _step_profile(llava, np.random.RandomState(23), b=4,
                         lengths=(plen7, plen7 + LLAVA_NEW), pool=64,
                         n_chunks=2)
    p, dn = prof["profile"]["paged"], prof["profile"]["dense"]
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)
    lens = [plen7 + i for i in range(4)]
    args = _k3_case(gen, np.random.RandomState(25), 32, 32, 128, 64, lens,
                    torch.bfloat16, pool_pages=65,
                    width=-(-max(lens) // 64))
    k3_err, k3_ratio = compare(paged_decode_attention(*args),
                               paged_decode_attention_reference(*args),
                               K3_TOL[torch.bfloat16], "K3 32/32/128 B=4")
    call = lambda: paged_decode_attention(*args)
    k3_k_ms = kernel_time_ms(call, reps=50)
    k3_ms = time_ms(call, reps=50)
    k3_plain = time_ms(lambda: paged_decode_attention_reference(*args), reps=20)
    k3_bound = attn_bound_ms(args[0], args[4], 32, 2) \
        + args[3].numel() * 4 / HBM_BPS * 1e3
    share = "not measured" if k3_k_ms is None else f"{k3_bound / k3_k_ms:.4f}"
    log("worker", f"(c) continuous batching over LLaVA-1.5-7B: 4 concurrent "
                  f"image requests of {LLAVA_NEW} greedy tokens, each the "
                  f"engine's serial ids; counters {counters7}; launches "
                  f"K1/K2/K3 {tuple(int(n) for n in llava_l)} = 0, 0, "
                  f"{llayers} x {counters7['decode_steps']} steps")
    log("worker", f"batch-4 7B step, lengths {prof['lengths']}: paged "
                  f"{prof['step_ms']['paged'][0]:.3f} / "
                  f"{prof['step_ms']['paged'][1]:.3f} ms wall, "
                  f"{p['device_ms']:.4f} ms of device time, "
                  f"{p['kernels']:.1f} device ops, K3 {p['attn_ms']:.4f} ms in "
                  f"{p['attn_ops']:.1f} launches a step; dense "
                  f"{dn['device_ms']:.4f} ms of device time, K2 "
                  f"{dn['attn_ms']:.4f} ms a step{p['note']}{dn['note']}; K3 "
                  f"at the call (B=4, "
                  f"32/32/128 bf16, page 64, lengths {lens}): max_abs_err "
                  f"{k3_err:.3e} (tol ratio {k3_ratio:.3f} <= 1), kernel time "
                  f"{fmt_us(k3_k_ms)}, {k3_ms:.4f} ms a call by events; bound "
                  f"{k3_bound * 1e3:.4f} us (bytes), share {share}; plain "
                  f"{k3_plain:.4f} ms; phase {time.perf_counter() - t_phase:.1f}"
                  f" s on {card}")
    return {"worker": tuple(int(n) for n in worker_l),
            "batch": tuple(int(n) for n in soak_l),
            "llava": tuple(int(n) for n in llava_l),
            "k3_err": k3_err, "warmup": (n_warm, warm_s),
            "soak_ttft_ms": statistics.median(ttfts),
            "soak_tok_s": tokens / makespan,
            "k3": dict(kernel_ms=k3_k_ms, ms=k3_ms, plain_ms=k3_plain,
                       bound_ms=k3_bound),
            "step": prof}



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

    # speculative decode of the same model, on the card and on the CPU
    spec = {}
    for dev in ("cuda", "cpu"):
        engine = Engine(cfg, to_device(cpu_params, dev), IdTokenizer())
        with torch.inference_mode():
            inputs = engine.prepare(engine.build_prompt("Say it again: red "
                                                        "car, red car."),
                                    image)
            t = inputs["ids"].shape[1]
            cache = init_cache(cfg.decoder.num_layers, 1,
                               vlm.spec_cache_len(t, 24, 8),
                               cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                               torch.float32, dev)
            logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                        inputs["ids"], inputs["lens"],
                                        inputs["starts"], cache)
            res = vlm.spec_decode(engine.params, cfg, logits, cache,
                                  inputs["ids"], inputs["lens"],
                                  max_new_tokens=24, eos_ids=engine.eos_ids,
                                  draft_k=8)
        spec[dev] = (res.tokens.cpu().tolist(),
                     res.num_generated.cpu().tolist(), res.steps,
                     int(res.drafted), int(res.accepted))
    if spec["cuda"] != spec["cpu"]:
        raise AssertionError(f"spec_decode differs: card {spec['cuda']} vs "
                             f"CPU {spec['cpu']}")
    log("small", f"spec_decode, tiny f32 model: card and CPU give equal "
                 f"tokens, counts {spec['cpu'][1]}, {spec['cpu'][2]} passes, "
                 f"{spec['cpu'][3]} drafted, {spec['cpu'][4]} accepted")

    # beam search of the same model (W = 3, K2 at batch 3 on the card), on
    # the card and on the CPU
    from fastvlm_tpu_torch.ops.beam import beam_search
    from fastvlm_tpu_torch.ops.cuda.decode_attention import decode_attention

    beams = {}
    for dev in ("cuda", "cpu"):
        engine = Engine(cfg, to_device(cpu_params, dev), IdTokenizer())
        before = decode_attention.launches
        with torch.inference_mode():
            inputs = engine.prepare(engine.build_prompt("Describe the image."),
                                    image)
            t = inputs["ids"].shape[1]
            cache = init_cache(cfg.decoder.num_layers, 1, t + 16,
                               cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                               torch.float32, dev)
            logits, cache = vlm.prefill(engine.params, cfg, inputs["images"],
                                        inputs["ids"], inputs["lens"],
                                        inputs["starts"], cache)
            res = beam_search(engine.params, cfg, logits, cache, num_beams=3,
                              max_new_tokens=16, eos_ids=engine.eos_ids,
                              length_penalty=0.6)
        beams[dev] = (res.tokens.cpu(), res.lengths.cpu(), res.scores.cpu())
        if dev == "cuda" and decode_attention.launches - before != \
                cfg.decoder.num_layers * 15:
            raise AssertionError(f"small beam: K2 launched "
                                 f"{decode_attention.launches - before} times")
    n = int(beams["cpu"][1][0])
    if not (torch.equal(beams["cuda"][1], beams["cpu"][1])
            and torch.equal(beams["cuda"][0][:, :n], beams["cpu"][0][:, :n])):
        raise AssertionError(f"beam_search differs: card {beams['cuda'][:2]} "
                             f"vs CPU {beams['cpu'][:2]}")
    score_err = float((beams["cuda"][2] - beams["cpu"][2]).abs().max())
    if score_err > 1e-4:
        raise AssertionError(f"beam_search scores differ by {score_err:.3e}")
    log("small", f"beam_search W=3, 16 tokens, tiny f32 model: card (K2 at "
                 f"batch 3) and CPU give equal tokens and lengths ({n}), "
                 f"scores within {score_err:.3e} (tol 1e-4)")

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
    engine = Engine(cfg, to_device(cpu_params, "cuda"), IdTokenizer())
    sched = BatchScheduler(engine, window_ms=5, page_size=16, spec=True)
    try:
        got = Client(sched, engine, prompts[0], image, 24).result(
            "small spec request")["text"]
    finally:
        sched.shutdown()
    if not sched.counters.get("disp_spec@1") or got != serial[0]:
        raise AssertionError(f"spec scheduler on the card: {got} against "
                             f"serial {serial[0]}, counters "
                             f"{dict(sched.counters)}")
    log("small", "scheduler, 3 concurrent greedy requests: card (K3) and "
                 "CPU batched ids equal the serial engine's; one greedy "
                 "request through BatchScheduler(spec=True) on the card "
                 f"({sched.counters['disp_spec@1']} spec chunks) too")


# ---------------------------------------------------------------------------
# quantized inference, the int8 KV cache, export
# ---------------------------------------------------------------------------

Q7_NEW = 32      # new tokens a 7B request
Q7_B = 8         # the 7b-batch8 cells' batch
Q_PROMPT = "Describe the image."
# the weight-only product on the card (torch.mm with an f32 result) against
# its plain version (an f32 matmul): both sum the same exact products in
# f32, in other orders, then scale and round once to bf16. So they may
# differ by the f32 summation bound, K * 2^-24 * (|x| @ |w_q|) * scale,
# plus one bf16 ulp of the result (the two sums may round to neighbours);
# the check divides each difference by that bound and requires <= 1. Where
# the sum cancels, the bound is many ulps of the result (the phase prints
# the largest difference in ulps too)
WO_ULPS = 1
# prefill rows of a batch-8 7B request (8 prompts of ~330 tokens): the M of
# the matmul timings beside decode's 1 and 8
Q_PREFILL_M = 2560


def _q7_decoder_cfg():
    """Qwen2-7B as FastVLM-7B ships it: 28 layers, 28/4/128, FFN 18944, an
    untied LM head over the published 152064-entry vocabulary."""
    from fastvlm_tpu_torch import config as C

    return C.qwen2_7b(vocab_size=152064, param_dtype="bfloat16",
                      compute_dtype="bfloat16")


def _fastvithd_cfg(decoder, dtype="bfloat16"):
    """FastViTHD @1024 and mlp2x_gelu 3072 -> the decoder's width, in
    ``dtype`` (bf16 unless asked)."""
    from fastvlm_tpu_torch import config as C

    vision = C.FastViTConfig(image_size=1024, param_dtype=dtype,
                             compute_dtype=dtype)
    return C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                    hidden_size=decoder.hidden_size))


def _live_encoder(cfg, seed):
    """(tower, projector) at full width on the card: the tower re-drawn
    with ``_live_tower`` (the init's 0.02 std leaves its features 0)."""
    from fastvlm_tpu_torch.models import fastvit, projector

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    tower = _live_tower(fastvit.init(gen, cfg.vision, "cuda"), gen)
    return tower, projector.init(gen, cfg.projector, "cuda")


def _quantized_decoder(dcfg, seed, bits):
    """The decoder drawn as qwen2.init draws it (bf16, on the card) but a
    layer at a time: each layer fused (qkv, gateup) and quantized at once,
    so the 15.2 GB bf16 decoder never exists whole beside its int8 copy."""
    from fastvlm_tpu_torch.models import qwen2
    from fastvlm_tpu_torch.ops.quant import quantize_linear

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    embed = (torch.randn((dcfg.vocab_size, dcfg.hidden_size), generator=gen,
                         device="cuda") * 0.02).to(bf)
    layers = []
    for _ in range(dcfg.num_layers):
        lp = qwen2._layer_init(gen, dcfg, bf, "cuda")
        lp = qwen2.fuse_decoder_params({"layers": [lp]}, dcfg)["layers"][0]
        layers.append({k: quantize_linear(v, bits) if isinstance(v, dict)
                       else v for k, v in lp.items()})
        del lp
    head = qwen2._dense(gen, dcfg.hidden_size, dcfg.vocab_size, bf, "cuda",
                        bias=False)
    return {"embed": embed, "layers": layers,
            "final_norm": torch.ones((dcfg.hidden_size,), dtype=bf,
                                     device="cuda"),
            "lm_head": quantize_linear(head, bits)}


def _with_a8(dec):
    """The same quantized decoder run W8A8: every quantized linear gains
    the ``a8`` marker (the JAX bench's ``_add_act_quant``); the weights are
    shared."""
    def mark(p):
        if not (isinstance(p, dict) and "w_q" in p):
            return p
        return {**p, "a8": torch.ones(p["scale"].shape[:-1] + (1,),
                                      dtype=torch.int8, device="cuda")}

    out = {**dec, "layers": [{k: mark(v) for k, v in lp.items()}
                             for lp in dec["layers"]]}
    if "lm_head" in dec:
        out["lm_head"] = mark(dec["lm_head"])
    return out


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp(
        min=1e-30))) - 7)


def _wo_error(x, p, got, want):
    """(largest |got - want| over WO_ULPS bf16 ulps plus the f32 summation
    bound, largest |got - want| in bf16 ulps of want)."""
    k = x.shape[-1]
    mag = torch.mm(x.float().abs(), p["w_q"].float().abs()) * p["scale"]
    bound = WO_ULPS * _bf16_ulp(want) + k * 2.0 ** -24 * mag
    err = (got.float() - want.float()).abs()
    return float((err / bound).max()), float((err / _bf16_ulp(want)).max())


def _quant_products(dec, card):
    """The quantized products at 7B's widths against their plain versions
    (the int8 accumulator exactly; the weight-only output within WO_ULPS),
    then each width's ms, bf16 F.linear beside int8 weight-only, W8A8 and
    int4 weight-only, at M = 1, 8 and the batch-8 prefill's rows."""
    from fastvlm_tpu_torch.ops import quant

    gen = torch.Generator(device="cuda")
    gen.manual_seed(33)
    lp = dec["layers"][0]
    widths = {"qkv": lp["qkv"], "o": lp["o"], "gateup": lp["gateup"],
              "down": lp["down"]}
    worst_wo = worst_ulps = 0.0
    for m in (Q7_B, Q_PREFILL_M):
        for name, p in list(widths.items()) + (
                [("lm_head", dec["lm_head"])] if m == Q7_B else []):
            cin = p["w_q"].shape[0]
            x = (torch.randn((m, cin), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
            xq, _ = quant.quantize_activations(x)
            acc = quant.int8_matmul(xq, p["w_q"])
            if not torch.equal(acc, quant.int8_matmul_reference(xq,
                                                                 p["w_q"])):
                raise AssertionError(f"_int_mm accumulator at {name} "
                                     f"(M={m}) differs from the exact one")
            a8 = {**p, "a8": torch.ones((1,), dtype=torch.int8,
                                        device="cuda")}
            if not torch.equal(quant.quantized_matmul(x, a8),
                               quant.quantized_matmul_reference(x, a8)):
                raise AssertionError(f"W8A8 output at {name} (M={m}) "
                                     f"differs from its plain version")
            ratio, ulps = _wo_error(x, p, quant.quantized_matmul(x, p),
                                    quant.quantized_matmul_reference(x, p))
            worst_wo = max(worst_wo, ratio)
            worst_ulps = max(worst_ulps, ulps)
            if ratio > 1.0:
                raise AssertionError(f"weight-only product at {name} (M={m})"
                                     f": error {ratio:.2f} x its bound (f32 "
                                     f"summation + {WO_ULPS} bf16 ulp)")
    log("quant", f"the _int_mm accumulator equals the exact (float64) one "
                 f"and W8A8's output its plain version's bitwise at qkv, o, "
                 f"gateup, down (M = {Q7_B}, {Q_PREFILL_M}) and the LM head "
                 f"(M = {Q7_B}); the weight-only output (torch.mm with an "
                 f"f32 result) is within {worst_wo:.3f} of its bound from "
                 f"its plain version's (f32 summation + {WO_ULPS} bf16 "
                 f"ulp; at most {worst_ulps:.1f} ulps of the result where "
                 f"the sum cancels)")

    # _int_mm's weight layout: the port's K-major w_q against the same
    # values row-major (JAX's layout), at the qkv width
    w_k = widths["qkv"]["w_q"]
    w_r = w_k.contiguous()
    for m in (Q7_B, Q_PREFILL_M):
        xq = torch.randint(-127, 128, (m, w_k.shape[0]), generator=gen,
                           device="cuda", dtype=torch.int8)
        k_ms = time_batch_ms(lambda: quant.int8_matmul(xq, w_k))
        r_ms = time_batch_ms(lambda: quant.int8_matmul(xq, w_r))
        log("quant", f"_int_mm at qkv {tuple(w_k.shape)} M={m}: K-major "
                     f"weight {k_ms:.4f} ms, row-major {r_ms:.4f} ms on "
                     f"{card}")

    table = {}
    for name, p in widths.items():
        cin, cout = p["w_q"].shape
        w = (torch.randn((cin, cout), generator=gen, device="cuda") * 0.02
             ).to(torch.bfloat16)
        wt = w.t().contiguous()  # F.linear's (out, in) weight
        q8 = quant.quantize_linear({"w": w}, 8)
        q4 = quant.quantize_linear({"w": w}, 4)
        a8 = {**q8, "a8": torch.ones((1,), dtype=torch.int8, device="cuda")}
        for m in (1, Q7_B, Q_PREFILL_M):
            x = torch.randn((m, cin), generator=gen, device="cuda").to(
                torch.bfloat16)
            fns = {"bf16": lambda: torch.nn.functional.linear(x, wt)}
            for tag, qp in (("int8", q8), ("w8a8", a8), ("int4", q4)):
                fns[tag] = (lambda qp=qp: quant.quantized_matmul(x, qp))
            row = {tag: (time_batch_ms(fn), kernel_time_ms(fn, reps=5))
                   for tag, fn in fns.items()}
            table[f"{name} {cin}x{cout} M={m}"] = row
            log("quant", f"matmul {name} {cin}x{cout} M={m}, ms by events "
                         f"(kernels): " + ", ".join(
                             f"{tag} {t:.4f} ({fmt_ms(k)})"
                             for tag, (t, k) in row.items())
                + f" on {card}")
        del w, wt, q8, q4, a8
    return table, (worst_wo, worst_ulps)


def _batch_inputs(engine, images, prompt):
    """One prepared row per image, stacked: (images, ids, lens, starts)."""
    rows = [engine.prepare(engine.build_prompt(prompt), im) for im in images]
    return (torch.cat([r["images"] for r in rows]),
            torch.cat([r["ids"] for r in rows]),
            torch.cat([r["lens"] for r in rows]),
            torch.cat([r["starts"] for r in rows]))


def _quant_path(name, engine, images, card, batch8=True):
    """One quantized 7B engine: batch-1 requests (TTFT, decode tok/s), and
    with ``batch8`` a batch-8 prefill (TTFT) and decode (tok/s); the K1 / K2
    launch counts, teacher-forced replays and peak memory."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache
    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    cfg, dec = engine.cfg, engine.cfg.decoder
    layers, k = dec.num_layers, engine.chunk
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    results = [engine.generate(engine.build_prompt(Q_PROMPT), images[0],
                               max_new_tokens=Q7_NEW) for _ in range(3)]
    k1, k2, k3 = (int(n) for n in _launches())
    steps = sum(st["decode_steps"] for _, st in results)
    if k1 != 44 * 3 or k3 != 0 or steps == 0 or k2 != layers * steps:
        raise AssertionError(f"{name} batch 1: K1 {k1} (expected 132), K2 "
                             f"{k2} for {steps} steps (expected {layers} a "
                             f"step), K3 {k3}")
    if len({text for text, _ in results}) != 1:
        raise AssertionError(f"{name}: identical requests gave other ids")
    out["ttft_b1_ms"] = [st["ttft_ms"] for _, st in results]
    out["tok_s_b1"] = [st["tok_per_s"] for _, st in results]
    out["launches"] = [k1, k2, k3]
    log("quant", f"{name} batch 1: TTFT {out['ttft_b1_ms'][0]:.2f} (cold) / "
                 f"{out['ttft_b1_ms'][1]:.2f} / {out['ttft_b1_ms'][2]:.2f} ms,"
                 f" decode {out['tok_s_b1'][1]:.2f} / {out['tok_s_b1'][2]:.2f}"
                 f" tok/s, prompt {results[0][1]['prompt_tokens']} tokens; K1"
                 f" {k1} = 44 x 3 requests, K2 {k2} = {layers} x {steps} "
                 f"steps on {card}")
    _check_replay("quant", f"{name} batch-1 request", engine, Q_PROMPT,
                  images[0], results[1][0])
    if batch8:
        imgs, ids, lens, starts = _batch_inputs(engine, images[:Q7_B],
                                                Q_PROMPT)
        t = ids.shape[1]
        n_chunks = Q7_NEW // k
        ttft = []
        with torch.inference_mode():
            for _ in range(3):
                cache = init_cache(layers, Q7_B, t + Q7_NEW, dec.num_kv_heads,
                                   dec.head_dim, engine._kv_dtype, "cuda")
                _zero_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = vlm.prefill(engine.params, cfg, imgs, ids,
                                            lens, starts, cache)
                tok = logits.argmax(-1).to(torch.int32)
                first = tok.cpu()
                ttft.append((time.perf_counter() - t0) * 1000)
                k1 = int(_launches()[0])
                if k1 != 44:
                    raise AssertionError(f"{name} batch 8: K1 {k1} in one "
                                         f"prefill, expected 44")
            done = torch.zeros((Q7_B,), dtype=torch.bool, device="cuda")
            toks = []
            _zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_chunks):
                chunk, done, tok, cache = vlm.decode_chunk(
                    engine.params, cfg, tok, done, cache, None, k=k,
                    eos_ids=(-1,), sampling=SamplingParams())
                toks.append(chunk.cpu())
            dt = time.perf_counter() - t0
            k2 = int(_launches()[1])
        if k2 != layers * n_chunks * k:
            raise AssertionError(f"{name} batch 8: K2 {k2} for "
                                 f"{n_chunks * k} steps, expected {layers} a "
                                 f"step")
        seq = torch.cat([first[:, None]] + toks, dim=1)
        out["ttft_b8_ms"] = ttft
        out["tok_s_b8"] = Q7_B * n_chunks * k / dt
        out["b8_step_ms"] = dt * 1000 / (n_chunks * k)
        out["b8_prompt"] = int(t)
        log("quant", f"{name} batch 8: TTFT {ttft[0]:.2f} (cold) / "
                     f"{ttft[1]:.2f} / {ttft[2]:.2f} ms for 8 images of "
                     f"{int(lens[0])}-token prompts, K1 44 a prefill; decode "
                     f"{out['tok_s_b8']:.2f} tok/s ({out['b8_step_ms']:.2f} "
                     f"ms a step), K2 {k2} = {layers} x {n_chunks * k} steps"
                     f" on {card}")
        # teacher-forced replay of all 8 rows at batch 8 (step by step,
        # K2): each emitted token within the tie margin of its row's maximum
        gaps = _batch_replay(engine, (imgs, ids, lens, starts), seq)
        worst = max(g for row in gaps for g, _ in row)
        log("quant", f"{name} batch-8 decode replayed step by step at batch "
                     f"8: {seq.shape[1]} steps x 8 rows within {worst:.2f} "
                     f"bf16 ulps of each row's maximum (limit {TIE_ULPS})")
        if worst > TIE_ULPS:
            raise AssertionError(f"{name} batch-8 replay: a token "
                                 f"{worst:.1f} ulps below its maximum")
        # context, not a check: rows 0 and 7 replayed at batch 1, where the
        # tower, the projector and attention see other shapes and may round
        # elsewhere (W8A8's per-token int8 rounding can amplify that)
        cross = [max(g for g, _ in _dense_replay(
            engine, Q_PROMPT, images[r], [int(x) for x in seq[r]]))
            for r in (0, Q7_B - 1)]
        out["b8_vs_b1_ulps"] = cross
        log("quant", f"{name} batch-8 rows 0 and 7 replayed at batch 1 "
                     f"(context): tokens {cross[0]:.2f} / {cross[1]:.2f} "
                     f"bf16 ulps below the batch-1 maximum")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    log("quant", f"{name}: peak device memory {out['peak_gib']:.2f} GiB")
    return out


def _batch_replay(engine, inputs, seq):
    """Teacher-force every row of ``seq`` (B, n) through a batch-B prefill of
    ``inputs`` (images, ids, lens, starts) and n - 1 decode steps; each
    row's (gap, top-1/top-2 gap) a step, in bf16 ulps."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg, dec = engine.cfg, engine.cfg.decoder
    imgs, ids, lens, starts = inputs
    b, n = seq.shape
    gaps = [[] for _ in range(b)]
    with torch.inference_mode():
        cache = init_cache(dec.num_layers, b, ids.shape[1] + n,
                           dec.num_kv_heads, dec.head_dim, engine._kv_dtype,
                           "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, imgs, ids, lens,
                                    starts, cache)
        for step in range(n):
            rows = logits.float().cpu()
            if not bool(torch.isfinite(rows).all()):
                raise AssertionError(f"batch replay step {step}: non-finite "
                                     f"logits")
            for r in range(b):
                gaps[r].append(_logit_gaps(rows[r], int(seq[r, step])))
            if step < n - 1:
                logits, cache = vlm.decode_step(
                    engine.params, cfg, seq[:, step].to(torch.int32).to(
                        "cuda"), cache)
    return gaps


def phase_quant(card, main_engine, main_res, gen):
    """FastVLM-7B int8 weight-only (7b-batch8, 7b-caption), W8A8
    (7b-batch8-w8a8) and int4 (7b-int4, batch 1) at full width, and the
    0.5B decode at int8 and W8A8 (decode-int8, decode-w8a8)."""
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.ops import quant

    t_phase = time.perf_counter()
    dcfg = _q7_decoder_cfg()
    cfg = _fastvithd_cfg(dcfg)
    tower, proj = _live_encoder(cfg, 31)
    images = [_scene(1024, 1024, 60 + i) for i in range(Q7_B)]
    res = {}

    t0 = time.perf_counter()
    dec8 = _quantized_decoder(dcfg, 32, 8)
    torch.cuda.synchronize()
    n_int8 = sum(t.numel() for lp in dec8["layers"] for p in lp.values()
                 if isinstance(p, dict) for t in (p["w_q"],))
    log("quant", f"FastVLM-7B int8 decoder drawn and quantized a layer at a "
                 f"time on the card in {time.perf_counter() - t0:.1f} s: "
                 f"{n_int8 / 1e9:.3f} B int8 layer weights; device memory "
                 f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
                 f"GiB")
    res["products"], res["wo_ulps"] = _quant_products(dec8, card)
    for name, dec in (("7b-int8", dec8), ("7b-w8a8", _with_a8(dec8))):
        engine = Engine(cfg, {"vision": tower, "projector": proj,
                              "decoder": dec}, IdTokenizer())
        res[name] = _quant_path(name, engine, images, card)
        if name == "7b-int8":
            # K2 at this path's call: 28/4/128, B = 8, the batch's lengths
            t = res[name]["b8_prompt"]
            res["k2_7b_b8"] = _k2_point(gen, Q7_B, dcfg.num_heads,
                                        dcfg.num_kv_heads, dcfg.head_dim,
                                        t + Q7_NEW, t + Q7_NEW // 2)
            pt = res["k2_7b_b8"]
            log("quant", f"K2 at 7B's 28/4/128, B = 8, {t + Q7_NEW // 2} "
                         f"keys: kernel {fmt_us(pt['kernel_ms'])}, "
                         f"{fmt_us(pt['ms'])} a call (events), bound "
                         f"{fmt_us(pt['bound_ms'])}, plain "
                         f"{fmt_ms(pt['plain_ms'])}, SDPA kernel "
                         f"{fmt_us(pt['library_kernel_ms'])} "
                         f"({fmt_us(pt['library_ms'])} a call); max abs err "
                         f"{pt['err']:.3e}")
        del engine, dec
    del dec8
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dec4 = _quantized_decoder(dcfg, 32, 4)
    torch.cuda.synchronize()
    log("quant", f"FastVLM-7B int4 decoder drawn and quantized in "
                 f"{time.perf_counter() - t0:.1f} s")
    engine = Engine(cfg, {"vision": tower, "projector": proj,
                          "decoder": dec4}, IdTokenizer())
    res["7b-int4"] = _quant_path("7b-int4", engine, images, card,
                                 batch8=False)
    del engine, dec4
    gc.collect()
    torch.cuda.empty_cache()

    # 0.5B decode at int8 and W8A8 beside phase main's bf16 decode
    q05 = quant.quantize_decoder(main_engine.params["decoder"], 8)
    image = np.random.RandomState(0).randint(0, 256, (1024, 1024, 3),
                                             dtype=np.uint8)
    for name, dec in (("decode-int8", q05), ("decode-w8a8", _with_a8(q05))):
        engine = Engine(main_engine.cfg, {**main_engine.params,
                                          "decoder": dec}, IdTokenizer())
        _zero_launches()
        results = [engine.generate(engine.build_prompt(Q_PROMPT), image,
                                   max_new_tokens=Q7_NEW) for _ in range(3)]
        k1, k2, k3 = (int(n) for n in _launches())
        steps = sum(st["decode_steps"] for _, st in results)
        layers = main_engine.cfg.decoder.num_layers
        if k1 != 44 * 3 or k3 != 0 or steps == 0 or k2 != layers * steps:
            raise AssertionError(f"{name}: K1 {k1}, K2 {k2} for {steps} "
                                 f"steps, K3 {k3}")
        res[name] = {"tok_s": [st["tok_per_s"] for _, st in results],
                     "ttft_ms": [st["ttft_ms"] for _, st in results],
                     "launches": [k1, k2, k3]}
        log("quant", f"{name} (0.5B): decode {results[1][1]['tok_per_s']:.2f}"
                     f" / {results[2][1]['tok_per_s']:.2f} tok/s beside bf16 "
                     f"{main_res['tok_per_s'][1]:.2f} / "
                     f"{main_res['tok_per_s'][2]:.2f} (phase main); TTFT "
                     f"{results[1][1]['ttft_ms']:.2f} ms; K1 {k1}, K2 {k2} = "
                     f"{layers} x {steps} steps")
        _check_replay("quant", f"{name} request", engine, Q_PROMPT, image,
                      results[1][0])
        del engine
    res["tower"], res["cfg"] = tower, cfg
    log("quant", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return res


def _step_ms(engine, images, prompt, steps=16):
    """A batch-8 decode step after a batch-8 prefill of ``images``: wall ms
    a step over one chunk with a host read, then device ms and launches a
    step by the profiler over another."""
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache
    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    cfg, dec = engine.cfg, engine.cfg.decoder
    imgs, ids, lens, starts = _batch_inputs(engine, images, prompt)
    b, t = ids.shape
    with torch.inference_mode():
        cache = init_cache(dec.num_layers, b, t + 3 * steps, dec.num_kv_heads,
                           dec.head_dim, engine._kv_dtype, "cuda")
        logits, cache = vlm.prefill(engine.params, cfg, imgs, ids, lens,
                                    starts, cache)
        tok = logits.argmax(-1).to(torch.int32)
        done = torch.zeros((b,), dtype=torch.bool, device="cuda")

        def chunk():
            nonlocal tok, done, cache
            toks, done, tok, cache = vlm.decode_chunk(
                engine.params, cfg, tok, done, cache, None, k=steps,
                eos_ids=(-1,), sampling=SamplingParams())
            toks.cpu()

        chunk()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        wall = (time.perf_counter() - t0) * 1000 / steps
        prof = _cuda_step_profile(chunk, steps)
    return {"wall_ms": wall, "lengths": int(lens.min()) + steps, **prof}


def phase_kv_int8(card, main_engine):
    """The 0.5B with an int8 KV cache: generate, beam W = 4, spec, two video
    frames and the scheduler's dense batch of 8; no K2 or K3 anywhere (the
    int8 path attends through the plain _attend_quant, as JAX)."""
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler
    from fastvlm_tpu_torch.video import VideoQA

    t_phase = time.perf_counter()
    base = main_engine.cfg
    cfg = dataclasses.replace(base, decoder=dataclasses.replace(
        base.decoder, kv_cache_dtype="int8"))
    engine = Engine(cfg, main_engine.params, IdTokenizer())
    if engine._kv_dtype != torch.int8:
        raise AssertionError("the int8-KV engine's cache is not int8")
    images = [_scene(1024, 1024, 80 + i) for i in range(8)]
    res = {}

    def counted(what, fn, k1_want):
        _zero_launches()
        out = fn()
        k1, k2, k3 = (int(n) for n in _launches())
        if k1 != k1_want or k2 != 0 or k3 != 0:
            raise AssertionError(f"kv-int8 {what}: K1 {k1} (expected "
                                 f"{k1_want}), K2 {k2}, K3 {k3} (expected 0)")
        res.setdefault("launches", {})[what] = [k1, k2, k3]
        return out

    prompts = [Q_PROMPT, "What is in the picture?"]
    gens = counted("generate", lambda: [
        engine.generate(engine.build_prompt(p), images[i],
                        max_new_tokens=Q7_NEW)
        for i, p in enumerate(prompts)], 44 * len(prompts))
    bf16 = [main_engine.generate(main_engine.build_prompt(p), images[i],
                                 max_new_tokens=Q7_NEW)[0]
            for i, p in enumerate(prompts)]
    for i, (p, (text, st)) in enumerate(zip(prompts, gens)):
        same = sum(a == b for a, b in zip(text.split(","), bf16[i].split(",")))
        log("kv-int8", f"generate {i}: TTFT {st['ttft_ms']:.2f} ms, "
                       f"{st['tok_per_s']:.2f} tok/s; {same} of "
                       f"{len(text.split(','))} ids as the bf16 cache's")
        _check_replay("kv-int8", f"generate {i}", engine, p, images[i], text)
    res["generate"] = [st for _, st in gens]

    beam = counted("beam", lambda: engine.generate_beam(
        engine.build_prompt(Q_PROMPT), images[0], num_beams=4,
        max_new_tokens=Q7_NEW), 44)
    if not beam[0]:
        raise AssertionError("kv-int8 beam: empty answer")
    log("kv-int8", f"generate_beam W = 4: {beam[1]['decode_tokens']} tokens "
                   f"in {beam[1]['ttft_ms']:.2f} ms (prefill and search)")
    spec_prompt = "Describe the image. Describe the image. Describe it."
    spec = counted("spec", lambda: engine.generate_spec(
        engine.build_prompt(spec_prompt), images[1], max_new_tokens=64), 44)
    log("kv-int8", f"generate_spec: {spec[1]['decode_tokens']} tokens in "
                   f"{spec[1]['spec_steps']} passes")
    _check_replay("kv-int8", "generate_spec", engine, spec_prompt, images[1],
                  spec[0])

    frames = [_scene(1920, 1080, 90 + i) for i in range(2)]
    vq = VideoQA(engine, "What is happening?", max_new_tokens=16)
    if vq.cache.k.dtype != torch.int8:
        raise AssertionError("VideoQA's prefix cache is not int8")
    answers = counted("video", lambda: [vq.ask(f)[0] for f in frames]
                      + [vq.ask(frames[0])[0]], 44 * 3)
    if answers[2] != answers[0]:
        raise AssertionError("kv-int8 video: the same frame asked again gave"
                             " other ids")
    log("kv-int8", f"VideoQA over 2 1080x1920 frames (+ the first again): "
                   f"K1 44 a frame, no K2 / K3; the repeated frame's ids "
                   f"equal")

    sched = BatchScheduler(engine, max_batch=8, window_ms=500)
    rows = [Q_PROMPT if i % 2 else "What is in the picture?"
            for i in range(8)]

    def serve():
        clients = [Client(sched, engine, p, images[i], Q7_NEW)
                   for i, p in enumerate(rows)]
        for i, c in enumerate(clients):
            c.result(f"kv-int8 dense row {i}")
        return clients

    try:
        if sched.paged or sched.pool is not None:
            raise AssertionError("an int8-KV engine got the paged pool")
        t0 = time.perf_counter()
        clients = counted("serve-dense", serve, 44)
        wall = time.perf_counter() - t0
    finally:
        sched.shutdown()
    texts = [c.updates[-1]["text"] for c in clients]
    tokens = sum(len(t.split(",")) for t in texts)
    ttfts = [c.updates[-1]["stats"]["ttft_ms"] for c in clients]
    if sched.counters["prefills"] != 1 or sched.counters["admitted"]:
        raise AssertionError(f"dense batch: {dict(sched.counters)}")
    log("kv-int8", f"BatchScheduler dense batch of 8 (int8 cache): one "
                   f"prefill, TTFT {statistics.median(ttfts):.2f} ms median, "
                   f"served {tokens / wall:.2f} tok/s, K1 44, no K2 / K3")
    for i in (0, 5):
        _check_replay("kv-int8", f"dense batch row {i}", engine, rows[i],
                      images[i], texts[i])
    res["serve_dense"] = {"ttft_ms": ttfts, "tok_s": tokens / wall}

    step8 = _step_ms(engine, images, Q_PROMPT)
    step16 = _step_ms(main_engine, images, Q_PROMPT)
    res["step"] = {"int8": step8, "bf16": step16}
    log("kv-int8", f"batch-8 decode step at ~{step8['lengths']} keys: int8 "
                   f"cache {step8['wall_ms']:.2f} ms wall, "
                   f"{step8['device_ms']:.3f} ms device, "
                   f"{step8['launches']:.1f} launches, K2 {step8['k2']:.0f};"
                   f" bf16 cache {step16['wall_ms']:.2f} ms wall, "
                   f"{step16['device_ms']:.3f} ms device, "
                   f"{step16['launches']:.1f} launches, K2 "
                   f"{step16['k2']:.0f} ({step16['k2_ms']:.4f} ms) a step"
                   f"{step8['note']}{step16['note']} on {card}")
    log("kv-int8", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return res


def phase_export(card, tower, cfg7):
    """The full-width encoder exported on the card and loaded back (K1 44
    launches, bitwise eager); a 1.5B int8 bundle written and restored,
    serving the in-memory quantized engine's ids."""
    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch import export
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import fastvit, projector, qwen2
    from fastvlm_tpu_torch.ops.quant import quantize_decoder
    from fastvlm_tpu_torch.utils.checkpoint import restore_native

    t_phase = time.perf_counter()
    res = {}
    vcfg = cfg7.vision
    s = vcfg.image_size
    x = torch.from_numpy(_scene(s, s, 99)).to("cuda").to(
        torch.bfloat16)[None] / 255
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        path = export.export_vision_encoder(cfg7, tower, d)
        t_export = time.perf_counter() - t0
        program = export.load_exported_encoder(path)
        with torch.inference_mode():
            want = fastvit.apply(tower, x, vcfg)
            _zero_launches()
            got = program(tower, x)
            torch.cuda.synchronize()
            k1 = int(_launches()[0])
        n_ops = sum("fastvlm.fused_ffn" in str(n.target)
                    for n in torch.export.load(path).graph.nodes)
        size = os.path.getsize(path)
    if k1 != 44 or n_ops != 44:
        raise AssertionError(f"exported encoder: {n_ops} fused_ffn ops, K1 "
                             f"launched {k1} times (expected 44)")
    if not torch.equal(got, want) or float(want.float().abs().mean()) == 0:
        raise AssertionError("the exported encoder differs from eager (or "
                             "its features are zero)")
    with torch.inference_mode():
        eager_ms = time_batch_ms(lambda: fastvit.apply(tower, x, vcfg),
                                 reps=5)
        prog_ms = time_batch_ms(lambda: program(tower, x), reps=5)
        eager_k = kernel_time_ms(lambda: fastvit.apply(tower, x, vcfg),
                                 reps=3)
        prog_k = kernel_time_ms(lambda: program(tower, x), reps=3)
    res["encoder"] = {"export_s": t_export, "ms": prog_ms,
                      "eager_ms": eager_ms, "kernel_ms": prog_k,
                      "eager_kernel_ms": eager_k, "k1": k1}
    log("export", f"FastViTHD @1024 exported on the card in {t_export:.1f} s "
                  f"({size / 2 ** 20:.1f} MiB program, 44 fastvlm::fused_ffn "
                  f"ops); loaded, it launched K1 {k1} times and equals eager "
                  f"bitwise (features mean |x| "
                  f"{float(want.float().abs().mean()):.4f}); "
                  f"{prog_ms:.3f} ms an image by events beside eager "
                  f"{eager_ms:.3f} ms, kernels {fmt_ms(prog_k)} beside "
                  f"{fmt_ms(eager_k)} on {card}")

    # a 1.5B int8 bundle: written, restored, served
    dcfg = C.qwen2_1_5b(param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = _fastvithd_cfg(dcfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(41)
    params = {"vision": tower, "projector": projector.init(gen, cfg.projector,
                                                           "cuda"),
              "decoder": qwen2.init(gen, dcfg, "cuda")}
    image = _scene(1024, 1024, 98)
    prompts = [Q_PROMPT, "What is in the picture?"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        export.quantize_checkpoint(cfg, params, 8, d)
        t_write = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)
        t0 = time.perf_counter()
        restored = restore_native(os.path.join(d, "params"), device="cuda")
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        meta = json.load(open(os.path.join(d, "quantization.json")))
    in_memory = {**params, "decoder": quantize_decoder(params["decoder"], 8)}
    del params
    a = Engine(cfg, restored, IdTokenizer())
    b = Engine(cfg, in_memory, IdTokenizer())
    for p in prompts:
        _zero_launches()
        ta = a.generate(a.build_prompt(p), image, max_new_tokens=16)[0]
        k1, k2, _ = (int(n) for n in _launches())
        tb = b.generate(b.build_prompt(p), image, max_new_tokens=16)[0]
        if ta != tb or not ta:
            raise AssertionError(f"1.5B int8 bundle: {p!r} gave other ids "
                                 f"than the in-memory engine")
        if k1 != 44 or k2 == 0 or k2 % dcfg.num_layers:
            raise AssertionError(f"1.5B int8 bundle: K1 {k1}, K2 {k2}")
    res["bundle"] = {"gib": size / 2 ** 30, "write_s": t_write,
                     "restore_s": t_read}
    log("export", f"1.5B int8 bundle ({meta['bits']}-bit, "
                  f"{size / 2 ** 30:.2f} GiB) written in {t_write:.1f} s and "
                  f"restored to the card in {t_read:.1f} s; its engine gives "
                  f"the in-memory quantized engine's ids for "
                  f"{len(prompts)} prompts (K1 44, K2 28 a step)")
    del a, b, restored, in_memory
    gc.collect()
    torch.cuda.empty_cache()
    log("export", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return res


TRAIN_STEPS = 12
TRAIN_BATCH = 4
# the small f32 model trained on the card (kernels) and on the CPU (plain
# versions), TF32 off: the losses within this relative tolerance and every
# param within it of its group's largest |value| (the CPU parity tests hold
# the port to JAX at the same tolerance)
TRAIN_SMALL_TOL = 1e-4
TRAIN_WORDS = ("red", "green", "stripe", "gradient", "noise", "blue", "left",
               "right", "top", "bottom", "bright", "dark", "wave", "band")


def _sft_data(root, n, size, seed, answer_bytes=(64, 256)):
    """``n`` qwen_2 records under ``root`` with distinct images of ``size``
    (w, h), JPEG and PNG in turns, answers of ``answer_bytes`` spread over
    the records; returns the JSON's path."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    lo, hi = answer_bytes
    records = []
    for i in range(n):
        name = f"{i}.jpg" if i % 2 == 0 else f"{i}.png"
        Image.fromarray(_scene(size[0], size[1], seed + i)).save(
            os.path.join(root, name), quality=90)
        want = lo + (hi - lo) * i // max(n - 1, 1)
        answer = ""
        while len(answer) < want:
            answer += TRAIN_WORDS[rng.randint(len(TRAIN_WORDS))] + " "
        records.append({"id": str(i), "image": name, "conversations": [
            {"from": "human", "value": "<image>\nDescribe the image."},
            {"from": "gpt", "value": answer[:want].strip() + "."}]})
    path = os.path.join(root, "data.json")
    with open(path, "w") as f:
        json.dump(records, f)
    return path


def _train_run(trainer, steps, what):
    """Train ``steps`` steps (log_steps 1: the loss is read, and the device
    synchronised, after every step); returns the step walls, losses, data
    ms, tokens, launches and peak memory. Fails unless K1 ran once a tower
    block a step (44 for FastViTHD: one call a block over the batch's rows)
    and K2 / K3 never."""
    blocks = sum(trainer.cfg.vision.layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    result = trainer.train()
    torch.cuda.synchronize()
    k1, k2, k3 = (int(n) for n in _launches())
    hist = trainer.history[-steps:]
    stamps = [t0] + [h["t"] for h in hist]
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: {len(hist)} steps, losses {losses}")
    if k1 != blocks * steps or k2 or k3:
        raise AssertionError(f"{what}: K1 {k1} (expected {blocks} x "
                             f"{steps}), K2 {k2}, K3 {k3} (expected 0)")
    later = step_ms[1:] or step_ms
    return {"result": result, "losses": losses, "step_ms": step_ms,
            "median_ms": statistics.median(later),
            "tok_s": sum(h["tokens"] for h in hist[1:] or hist)
            / (sum(later) / 1e3),
            "data_ms": statistics.median(h["data_ms"] for h in hist),
            "k1": k1, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _leaf_snapshot(tree, keep):
    from fastvlm_tpu_torch.train.step import named_leaves

    return {p: x.detach().clone() for p, x in named_leaves(tree) if keep(p)}


def _check_only_adapters_moved(tree, frozen_before, what):
    from fastvlm_tpu_torch.train.lora import is_lora_path
    from fastvlm_tpu_torch.train.step import named_leaves

    moved = 0
    for p, x in named_leaves(tree):
        if is_lora_path(p):
            moved += p.endswith("lora_b") and bool((x != 0).any())
        elif not torch.equal(x.detach(), frozen_before[p]):
            raise AssertionError(f"{what}: frozen leaf {p} changed")
    if not moved:
        raise AssertionError(f"{what}: no adapter moved")
    return moved


def _first_logits(engine, prompt, image):
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.ops.kv_cache import init_cache

    cfg = engine.cfg
    with torch.inference_mode():
        inputs = engine.prepare(engine.build_prompt(prompt), image)
        t = inputs["ids"].shape[1]
        cache = init_cache(cfg.decoder.num_layers, 1, t + 1,
                           cfg.decoder.num_kv_heads, cfg.decoder.head_dim,
                           engine._kv_dtype, "cuda")
        logits, _ = vlm.prefill(engine.params, cfg, inputs["images"],
                                inputs["ids"], inputs["lens"],
                                inputs["starts"], cache)
    return logits[0].float()


def _k1_function_checks(gen):
    """K1's forward through FusedFFNFunction against ffn_reference, and its
    gradients against autograd through ffn_reference, at FastViTHD's five
    widths and the rows of a batch of 4 at 1024 px (bf16). Returns the max
    abs errors (forward, gradients)."""
    from fastvlm_tpu_torch.ops.cuda.ffn import FusedFFNFunction, ffn_reference

    fwd_err = grad_err = 0.0
    for n_img, c, _ in K1_STAGES:
        n = TRAIN_BATCH * n_img
        ins = [x.requires_grad_() for x in
               _ffn_inputs(n, c, torch.bfloat16, gen)]
        out = FusedFFNFunction.apply(*ins)
        ref = ffn_reference(*ins)
        err, _ = compare(out.detach(), ref.detach(), K1_TOL[torch.bfloat16],
                         f"FusedFFNFunction forward, N={n} C={c}")
        g = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
        got = torch.autograd.grad(out, ins, g)
        want = torch.autograd.grad(ref, ins, g)
        gerr = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(got, want))
        if not all(bool(torch.isfinite(a).all()) for a in got) or gerr > 0:
            raise AssertionError(f"FusedFFNFunction gradients at N={n} C={c}"
                                 f" differ from autograd through "
                                 f"ffn_reference by {gerr:.3e}")
        fwd_err, grad_err = max(fwd_err, err), max(grad_err, gerr)
        log("train", f"K1 under autograd at N={n} C={c}: forward max_abs_err "
                     f"{err:.3e}, gradients max_abs_err {gerr:.3e} (the "
                     f"plain backward)")
        del ins, out, ref, got, want
    return fwd_err, grad_err


def _idle_share(trainer, cfg, steps=2):
    """(wall ms, kernel ms, top kernels, K1's kernels) of ``steps``
    train_steps on pre-collated batches (no data work), kernel time by
    torch.profiler (CUDA activity only; None where the session shows no
    device time); the top kernels as (name, ms a step, launches a step),
    K1's (csrc/ffn.cu's, named ffn_*) as {name: (ms a step, launches a
    step)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fastvlm_tpu_torch.train import step as step_mod
    from fastvlm_tpu_torch.train.trainer import batches

    it = batches(trainer.dataset, trainer.sampler, TRAIN_BATCH,
                 cfg.num_image_tokens)
    ready = [trainer._to_device(next(it)) for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in ready:
            trainer.state, loss = step_mod.train_step(trainer.state, cfg,
                                                      trainer.tx, b)
        float(loss)
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    us = sum(e.self_device_time_total for e in rows)
    top = [(e.key[:60], round(e.self_device_time_total / 1e3 / steps, 3),
            e.count // steps) for e in rows[:10]]
    k1 = {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
          for e in rows if "::ffn_" in e.key}
    return wall, (us / 1e3 if us > 0 else None), top, k1


def phase_train(card, gen):
    """SFT at FastVLM-0.5B's full width through Trainer.train: full
    fine-tune (tower frozen), save and resume, LoRA and QLoRA, the tower
    unfrozen (K1 through FusedFFNFunction); then a small f32 model trained
    on the card and on the CPU."""
    import shutil

    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.data.preprocessing import (
        ByteTokenizer, ImageProcessor)
    from fastvlm_tpu_torch.data.sft import DataArguments, SupervisedDataset
    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.models import qwen2
    from fastvlm_tpu_torch.train import lora
    from fastvlm_tpu_torch.train import step as step_mod
    from fastvlm_tpu_torch.train.trainer import Trainer, TrainingArguments
    from fastvlm_tpu_torch.utils import native_image

    t_phase = time.perf_counter()
    res = {"k1": {}}
    cfg = _fastvithd_cfg(C.qwen2_0_5b(param_dtype="bfloat16",
                                      compute_dtype="bfloat16"))
    tower, proj = _live_encoder(cfg, 61)
    dgen = torch.Generator(device="cuda")
    dgen.manual_seed(62)
    params = {"vision": tower, "projector": proj,
              "decoder": qwen2.init(dgen, cfg.decoder, "cuda")}
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.perf_counter()
        data_path = _sft_data(work, 16, (1024, 768), 70)
        native = native_image.available()
        res["native_loader"] = native
        log("train", f"16 qwen_2 records with 1024x768 JPEG / PNG images "
                     f"written in {time.perf_counter() - t0:.1f} s; native "
                     f"JPEG loader built and loaded: {native}"
                     + ("" if native else f" ({native_image.load_error})"))

        def dataset():
            return SupervisedDataset(
                DataArguments(data_path=data_path, image_folder=work),
                ByteTokenizer(), ImageProcessor(cfg.vision.image_size))

        def trainer(out, **kw):
            kw = {"batch_size": TRAIN_BATCH, "save_steps": 0, "log_steps": 1,
                  "warmup_ratio": 0.0, "seed": 0, **kw}
            return Trainer(cfg, params, dataset(),
                           TrainingArguments(output_dir=os.path.join(work, out),
                                             **kw), device="cuda")

        # 1. full fine-tune, tower frozen
        tr = trainer("full", max_steps=TRAIN_STEPS, learning_rate=3e-4)
        run = _train_run(tr, TRAIN_STEPS, "train")
        if not run["losses"][-1] < run["losses"][0]:
            raise AssertionError(f"train: the loss did not fall: "
                                 f"{run['losses']}")
        loads = dict(tr.dataset.image_loads)
        res["train"] = {k: run[k] for k in ("losses", "step_ms", "median_ms",
                                            "tok_s", "data_ms", "peak_gib")}
        res["train"]["loads"] = loads
        res["k1"]["train"] = run["k1"]
        log("train", f"FastVLM-0.5B SFT, batch {TRAIN_BATCH}, "
                     f"{TRAIN_STEPS} steps (tower frozen): loss "
                     f"{run['losses'][0]:.4f} at step 1 -> "
                     f"{run['losses'][-1]:.4f} at step {TRAIN_STEPS}; step "
                     f"1 {run['step_ms'][0]:.1f} ms, then median "
                     f"{run['median_ms']:.2f} ms a step (wall, data "
                     f"included; all: {[round(x, 1) for x in run['step_ms']]})"
                     f"; {run['tok_s']:.1f} trained tokens/s (real tokens, "
                     f"the 256-token image spans included); host data "
                     f"{run['data_ms']:.1f} ms a batch (median), image "
                     f"loaders {loads}; peak {run['peak_gib']:.2f} GiB; K1 "
                     f"{run['k1']} = {sum(cfg.vision.layers)} x "
                     f"{TRAIN_STEPS} (one call a block over the batch's "
                     f"{TRAIN_BATCH} images), K2 0, K3 0; on {card}")

        # save, then resume: bitwise, and one more step
        tr2 = trainer("full", max_steps=TRAIN_STEPS + 1, learning_rate=3e-4)
        t0 = time.perf_counter()
        if tr2.resume() != TRAIN_STEPS:
            raise AssertionError("resume did not find checkpoint-12")
        t_restore = time.perf_counter() - t0
        for name in ("params", "opt_state"):
            a = step_mod.named_leaves(getattr(tr.state, name))
            b = dict(step_mod.named_leaves(getattr(tr2.state, name)))
            for p, x in a:
                if not torch.equal(x.detach(), b[p].detach()):
                    raise AssertionError(f"resume: {name} {p} differs")
        ckpt = os.path.join(work, "full", f"checkpoint-{TRAIN_STEPS}")
        gib = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(ckpt) for f in fs) / 2 ** 30
        del tr  # train() resumes tr2 from checkpoint-12 again, then steps
        gc.collect()
        torch.cuda.empty_cache()
        more = _train_run(tr2, 1, "train-resume")
        log("train", f"save / resume: checkpoint-{TRAIN_STEPS} "
                     f"({gib:.2f} GiB: params + opt_state) restored in "
                     f"{t_restore:.1f} s, params and moments bitwise equal; "
                     f"one more step ran (loss {more['losses'][0]:.4f})")
        wall, kern, top, _ = _idle_share(tr2, cfg)
        idle = None if kern is None else 1 - kern / wall
        res["train"].update(idle_wall_ms=wall, idle_kernel_ms=kern,
                            idle=idle, resume_gib=gib)
        log("train", f"two more steps on pre-collated batches: "
                     f"{wall:.1f} ms wall, {fmt_ms(kern)} of kernels: idle "
                     f"share {'not measured' if idle is None else f'{idle:.3f}'}"
                     f"; top kernels (name, ms a step, launches a step): "
                     f"{top}")
        shutil.rmtree(os.path.join(work, "full"))
        del tr2
        gc.collect()
        torch.cuda.empty_cache()

        # 2. LoRA r = 8, merge, and the merged / unmerged engines
        tr = trainer("lora", max_steps=6, lora_enable=True, lora_r=8,
                     learning_rate=2e-3)
        frozen = _leaf_snapshot(tr.state.params,
                                lambda p: not lora.is_lora_path(p))
        run = _train_run(tr, 6, "train-lora")
        moved = _check_only_adapters_moved(tr.state.params, frozen,
                                           "train-lora")
        del frozen
        res["k1"]["train-lora"] = run["k1"]
        res["lora"] = {k: run[k] for k in ("losses", "median_ms", "tok_s",
                                           "peak_gib")}
        image = _scene(1024, 768, 7)
        prompt = "Describe the image."
        adapted = {**tr.state.params}
        merged = {**adapted, "decoder": lora.merge(adapted["decoder"])}
        e_base = Engine(cfg, params, IdTokenizer())
        e_un = Engine(cfg, adapted, IdTokenizer())
        e_m = Engine(cfg, merged, IdTokenizer())
        text_m = e_m.generate(e_m.build_prompt(prompt), image,
                              max_new_tokens=32)[0]
        text_u = e_un.generate(e_un.build_prompt(prompt), image,
                               max_new_tokens=32)[0]
        ids_m = [int(t) for t in text_m.split(",") if t]
        ids_u = [int(t) for t in text_u.split(",") if t]
        same = sum(a == b for a, b in zip(ids_m, ids_u))
        _check_replay("train", "the merged LoRA model's ids through the "
                      "unmerged adapters", e_un, prompt, image, text_m)
        base_row = _first_logits(e_base, prompt, image)
        un_row = _first_logits(e_un, prompt, image)
        top = float(base_row.abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        shift = float((un_row - base_row).abs().max()) / ulp
        if shift <= TIE_ULPS:
            raise AssertionError(f"train-lora: the unmerged adapters move the "
                                 f"first logits by {shift:.1f} bf16 ulps only")
        res["lora"].update(same_ids=same, n_ids=len(ids_m),
                           adapter_shift_ulps=shift)
        log("train", f"LoRA r=8, 6 steps: loss {run['losses'][0]:.4f} -> "
                     f"{run['losses'][-1]:.4f}, median {run['median_ms']:.2f} "
                     f"ms a step, {run['tok_s']:.1f} tokens/s, peak "
                     f"{run['peak_gib']:.2f} GiB; only adapters changed "
                     f"({moved} lora_b leaves moved, every other leaf "
                     f"bitwise); K1 {run['k1']}; merged vs unmerged greedy: "
                     f"{same}/{len(ids_m)} ids equal, the merged ids replayed"
                     f" through the unmerged adapters within the tie margin; "
                     f"the adapters move the first logits by {shift:.1f} "
                     f"bf16 ulps against the base")
        del tr, adapted, merged, e_base, e_un, e_m
        gc.collect()
        torch.cuda.empty_cache()

        tr = trainer("qlora", max_steps=6, lora_enable=True, lora_r=8,
                     bits=8, learning_rate=2e-3)
        frozen = _leaf_snapshot(tr.state.params,
                                lambda p: not lora.is_lora_path(p))
        run = _train_run(tr, 6, "train-qlora")
        _check_only_adapters_moved(tr.state.params, frozen, "train-qlora")
        del frozen
        res["k1"]["train-qlora"] = run["k1"]
        res["qlora"] = {k: run[k] for k in ("losses", "median_ms", "tok_s",
                                            "peak_gib")}
        log("train", f"QLoRA (int8 base) r=8, 6 steps: loss "
                     f"{run['losses'][0]:.4f} -> {run['losses'][-1]:.4f}, "
                     f"median {run['median_ms']:.2f} ms a step, "
                     f"{run['tok_s']:.1f} tokens/s, peak "
                     f"{run['peak_gib']:.2f} GiB; only adapters changed; K1 "
                     f"{run['k1']}")
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        # 3. the tower unfrozen: K1 through FusedFFNFunction
        fwd_err, grad_err = _k1_function_checks(gen)
        res["k1_fwd_err"], res["k1_grad_err"] = fwd_err, grad_err
        tr = trainer("tower", max_steps=3, unfreeze_mm_vision_tower=True,
                     learning_rate=1e-4)
        batch = next(iter_batches(tr, cfg))
        step_mod.loss_fn(tr.state.params, cfg, batch).backward()
        dead = [p for p, x in step_mod.named_leaves(tr.state.params["vision"])
                if x.grad is None or not bool((x.grad != 0).any())]
        n_vis = sum(1 for _ in step_mod.named_leaves(tr.state.params["vision"]))
        for _, x in step_mod.named_leaves(tr.state.params):
            x.grad = None
        if dead:
            raise AssertionError(f"train-tower: {len(dead)} tower leaves got "
                                 f"no gradient: {dead[:5]}")
        run = _train_run(tr, 3, "train-tower")
        res["k1"]["train-tower"] = run["k1"]
        res["tower"] = {k: run[k] for k in ("losses", "step_ms", "median_ms",
                                            "tok_s", "peak_gib")}
        log("train", f"tower unfrozen, 3 steps: all {n_vis} tower leaves "
                     f"take non-zero gradients; loss {run['losses'][0]:.4f} "
                     f"-> {run['losses'][-1]:.4f}; step 1 "
                     f"{run['step_ms'][0]:.1f} ms, then median "
                     f"{run['median_ms']:.2f} ms; peak "
                     f"{run['peak_gib']:.2f} GiB; K1 {run['k1']} through "
                     f"FusedFFNFunction")
        del tr, batch, params, tower, proj
        gc.collect()
        torch.cuda.empty_cache()

        # 4. f32, train_sft's default dtype: K1 on its f32 route
        res["f32"] = _train_f32(card, data_path, work)
        res["k1"]["train-f32"] = res["f32"]["k1"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    res["small"] = _train_small()
    log("train", f"phase took {time.perf_counter() - t_phase:.1f} s")
    return res


PARALLEL_STEPS = 3
PARALLEL_MODES = (  # (name, Trainer keywords, TrainingArguments keywords)
    ("mesh", {}, {}),
    ("sp", {"seq_parallel": True}, {}),
    ("zero1", {}, {"zero1": True}),
    ("fsdp", {}, {"fsdp": True}),
    ("pp", {"pp_micro": 2}, {}),
    ("fsdp-tower", {}, {"fsdp": True, "unfreeze_mm_vision_tower": True}),
)
# at one rank every collective is a copy and these modes run the
# one-process step's ops in its order: losses and params bit for bit
PARALLEL_EXACT = ("mesh", "sp", "zero1", "fsdp", "fsdp-tower")
# pp's 2-row microbatches round other GEMM shapes: its losses read
# 3.971e-05 from the one-process trainer's on the H100; the phase checks
# that a step 10% off in size (the one-process trainer at 1.1x the learning
# rate) reads more than this limit
PARALLEL_PP_REL_TOL = 4e-4
PARALLEL_WRONG_LR = 1.1


def _collectives_at_one_rank(mesh):
    """Each differentiable collective over the mesh's model group on the
    card, forward and backward, equal to the identity at one rank."""
    from fastvlm_tpu_torch.parallel import collectives as coll
    from fastvlm_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group

    group = axis_group(mesh, MODEL_AXIS)
    x = torch.randn(4, 6, 8, device="cuda", requires_grad=True)
    g = torch.randn(4, 6, 8, device="cuda")
    ops = {"copy_to": lambda t: coll.copy_to(t, group),
           "reduce_from": lambda t: coll.reduce_from(t, group),
           "gather_from": lambda t: coll.gather_from(t, 1, group),
           "split_to": lambda t: coll.split_to(t, 1, group),
           "all_gather": lambda t: coll.all_gather(t, 1, group),
           "reduce_scatter": lambda t: coll.reduce_scatter(t, 1, group),
           "broadcast": lambda t: coll.broadcast(t, 0, group)}
    for name, op in ops.items():
        y = op(x)
        (grad,) = torch.autograd.grad(y, x, g)
        if not (torch.equal(y, x) and torch.equal(grad, g)):
            raise AssertionError(f"parallel: {name} over one NCCL rank is "
                                 f"not the identity")
    return sorted(ops)


PROBE_TIMEOUT_S = 300


def _multihost_probe():
    """tools/train_multihost --probe with no --device (the card, NCCL) in
    a one-process torchrun world of its own: its all-reduce and its
    data-parallel AdamW step against the one-process step; returns the
    probe's MULTIHOST_OK line."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=1", "-m",
           "fastvlm_tpu_torch.tools.train_multihost", "--probe"]
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=PROBE_TIMEOUT_S)
    oks = [line for line in proc.stdout.splitlines() if "MULTIHOST_OK" in line]
    if proc.returncode != 0 or len(oks) != 1 or "0/1" not in oks[0]:
        raise AssertionError(f"parallel: train_multihost --probe exited "
                             f"{proc.returncode}: {proc.stdout[-2000:]}"
                             f"{proc.stderr[-2000:]}")
    return oks[0].strip()


def phase_parallel(card, train_res):
    """Parallel training on the card at world size 1 (NCCL); see the
    module docstring."""
    import shutil

    import torch.distributed as dist

    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.data.preprocessing import (
        ByteTokenizer, ImageProcessor)
    from fastvlm_tpu_torch.data.sft import DataArguments, SupervisedDataset
    from fastvlm_tpu_torch.models import qwen2
    from fastvlm_tpu_torch.parallel import distributed, make_mesh
    from fastvlm_tpu_torch.train import step as step_mod
    from fastvlm_tpu_torch.train.trainer import Trainer, TrainingArguments

    t_phase = time.perf_counter()
    probe = _multihost_probe()
    log("parallel", f"tools/train_multihost --probe (default device) in a "
                    f"one-process torchrun world: {probe}")
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    res = {"k1": {}, "modes": {}, "probe": probe}
    try:
        distributed.initialize(f"file://{work}/store", device="cuda")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"parallel: backend {dist.get_backend()}, "
                                 f"world {dist.get_world_size()}")
        mesh = make_mesh(dp=1, tp=1)
        checked = _collectives_at_one_rank(mesh)
        log("parallel", f"torch.distributed up: NCCL, world size 1 (one "
                        f"card), file:// store; mesh {mesh.mesh_dim_names} "
                        f"= {tuple(mesh.mesh.shape)} on cuda; forward and "
                        f"backward exact at one rank: {checked}")
        # phase train's weights and records (the same seeds)
        cfg = _fastvithd_cfg(C.qwen2_0_5b(param_dtype="bfloat16",
                                          compute_dtype="bfloat16"))
        tower, proj = _live_encoder(cfg, 61)
        dgen = torch.Generator(device="cuda")
        dgen.manual_seed(62)
        params = {"vision": tower, "projector": proj,
                  "decoder": qwen2.init(dgen, cfg.decoder, "cuda")}
        data_path = _sft_data(work, 16, (1024, 768), 70)

        def trainer(out, mesh=None, trainer_kw=None, **kw):
            kw = {"batch_size": TRAIN_BATCH, "save_steps": 0, "log_steps": 1,
                  "warmup_ratio": 0.0, "seed": 0, "learning_rate": 3e-4,
                  "max_steps": PARALLEL_STEPS, **kw}
            ds = SupervisedDataset(
                DataArguments(data_path=data_path, image_folder=work),
                ByteTokenizer(), ImageProcessor(cfg.vision.image_size))
            return Trainer(cfg, params, ds, TrainingArguments(
                output_dir=os.path.join(work, out), **kw), mesh=mesh,
                device="cuda", **(trainer_kw or {}))

        def run(tr, what, keep=False):
            out = _train_run(tr, PARALLEL_STEPS, what)
            if keep:  # the whole params after the steps, off the card so
                # that the next runs' peaks hold none of them
                out["params"] = {
                    p: x.detach().to("cpu", copy=True) for p, x in
                    step_mod.named_leaves(tr._whole(tr.state.params))}
            del tr
            gc.collect()
            torch.cuda.empty_cache()
            return out

        def rel_diff(got, ref):
            return max(abs(a - b) / abs(b)
                       for a, b in zip(got["losses"], ref["losses"]))

        refs = {False: run(trainer("ref"), "parallel-ref", keep=True),
                True: run(trainer("ref-tower", unfreeze_mm_vision_tower=True),
                          "parallel-ref-tower", keep=True)}
        wrong = rel_diff(run(trainer(
            "wrong", learning_rate=3e-4 * PARALLEL_WRONG_LR),
            "parallel-wrong-step"), refs[False])
        if not wrong > PARALLEL_PP_REL_TOL:
            raise AssertionError(
                f"parallel: a step {PARALLEL_WRONG_LR}x in size reads "
                f"{wrong:.3e}, within pp's limit {PARALLEL_PP_REL_TOL}")
        res["wrong_step_rel_diff"] = wrong
        log("parallel", f"the one-process trainer at {PARALLEL_WRONG_LR}x "
                        f"the learning rate (a wrong step): losses max rel "
                        f"diff {wrong:.3e} from the reference's, above pp's "
                        f"limit {PARALLEL_PP_REL_TOL}")
        for name, tkw, akw in PARALLEL_MODES:
            what = f"parallel-{name}"
            exact = name in PARALLEL_EXACT
            got = run(trainer(name, mesh, tkw, **akw), what, keep=exact)
            ref = refs[bool(akw.get("unfreeze_mm_vision_tower"))]
            rel = rel_diff(got, ref)
            if exact:
                differ = sorted(set(got["params"]) ^ set(ref["params"])) + [
                    p for p, x in got.pop("params").items()
                    if p in ref["params"] and not torch.equal(
                        x, ref["params"][p])]
                if rel != 0 or differ:
                    raise AssertionError(
                        f"parallel {name}: losses max rel diff {rel:.3e}, "
                        f"params differing from the one-process trainer's "
                        f"after {PARALLEL_STEPS} steps: {differ[:5]} "
                        f"({len(differ)}); expected bit for bit")
            elif rel > PARALLEL_PP_REL_TOL:
                raise AssertionError(f"parallel {name}: losses max rel diff "
                                     f"{rel:.3e} > {PARALLEL_PP_REL_TOL}")
            res["modes"][name] = {
                "losses": got["losses"], "ref_losses": ref["losses"],
                "max_rel_diff": rel, "median_ms": got["median_ms"],
                "ref_median_ms": ref["median_ms"],
                "step_ms": got["step_ms"], "peak_gib": got["peak_gib"],
                "ref_peak_gib": ref["peak_gib"]}
            res["k1"][what] = got["k1"]
            log("parallel", f"{name}: losses {got['losses']} vs the "
                            f"one-process trainer's {ref['losses']} (max rel "
                            f"diff {rel:.3e}); median step "
                            f"{got['median_ms']:.2f} ms vs "
                            f"{ref['median_ms']:.2f} ms one-process "
                            f"(phase train: "
                            f"{train_res['train']['median_ms']:.2f} ms over "
                            f"12 steps); peak {got['peak_gib']:.2f} GiB vs "
                            f"{ref['peak_gib']:.2f}; K1 {got['k1']} = "
                            f"{sum(cfg.vision.layers)} x {PARALLEL_STEPS}"
                            + (" through FusedFFNFunction on gathered "
                               "leaves" if name == "fsdp-tower" else "")
                            + ("; params bitwise equal to the one-process "
                               "trainer's" if exact else
                               f" (limit {PARALLEL_PP_REL_TOL})"))
        del refs

        # an FSDP checkpoint written under the mesh, resumed without one
        tr = trainer("ckpt", mesh, max_steps=4, fsdp=True)
        _zero_launches()
        tr.train()
        whole = tr._whole(tr.state.params)
        opt = tr._whole_opt_state(whole)
        del tr
        one = trainer("ckpt", max_steps=4)
        if one.resume() != 4:
            raise AssertionError("parallel: checkpoint-4 not resumed")
        n = 0
        for a, b in ((one.state.params, whole), (one.state.opt_state, opt)):
            b = dict(step_mod.named_leaves(b))
            for p, x in step_mod.named_leaves(a):
                if not torch.equal(x.detach(), b[p].detach()):
                    raise AssertionError(f"parallel: resumed {p} differs "
                                         f"from the FSDP run's")
                n += 1
        ckpt = os.path.join(work, "ckpt", "checkpoint-4")
        gib = sum(os.path.getsize(os.path.join(r, f))
                  for r, _, fs in os.walk(ckpt) for f in fs) / 2 ** 30
        res["checkpoint"] = {"leaves": n, "gib": gib}
        log("parallel", f"FSDP checkpoint-4 ({gib:.2f} GiB, whole tensors) "
                        f"written under the mesh and resumed by a "
                        f"one-process trainer: {n} params and moments "
                        f"bitwise equal")
        del one, whole, opt, params, tower, proj
    finally:
        distributed.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    res["s"] = time.perf_counter() - t_phase
    log("parallel", f"phase took {res['s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase tp: the tensor-parallel engine
# ---------------------------------------------------------------------------

# (Hq, Hkv, D) of a rank's heads: Qwen2-0.5B and Qwen2-1.5B at tp 2,
# Qwen2-7B at tp 2 and at tp 4
TP_GEOMETRIES = ((7, 1, 64), (6, 1, 128), (14, 2, 128), (7, 1, 128))
TP_RANKS = 2
TP_REQUESTS = (("Describe the image.", 0), ("What is written in the image?", 1))
TP_BATCH = (("Describe the image.", 2), ("What is in the picture?", 3),
            ("Describe the scene in detail.", 4), ("Read the text.", 5))
TP_JOIN_S = 600


def _tp_kernels(gen):
    """K2 and K3 at the heads a tensor-parallel rank holds, bf16, against
    their plain versions at phase K2's / K3's split edges, one row a call
    (B = 1) and batched (B = 8); then each at its serving call (K2: B = 1
    and B = 8 rows of 400 keys in a 416-slot cache; K3: B = 8, lengths
    400-600, pages of 64): kernel time (profiler), plain, bound, and SDPA
    beside K2."""
    from fastvlm_tpu_torch.ops.cuda.decode_attention import (
        decode_attention, decode_attention_reference, split_size)
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_reference)
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        split_size as paged_split_size)

    dt = torch.bfloat16
    rng = np.random.RandomState(13)
    s_cap = 4096
    out = {"k2_err": 0.0, "k3_err": 0.0, "k2": {}, "k3": {}}
    for hq, hkv, d in TP_GEOMETRIES:
        geo = f"{hq}/{hkv}/{d}"
        split = split_size(1, hkv, d, s_cap, dt)
        lens = [min(n, s_cap) for n in (1, split - 1, split, split + 1,
                                         2 * split + 7, s_cap, 77, 1000)]
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dt)
                   for shape in ((8, hq, d), (8, s_cap, hkv, d),
                                 (8, s_cap, hkv, d)))
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = decode_attention_reference(q, k, v, ln)
        rows = torch.cat([decode_attention(
            q[i:i + 1], k[i:i + 1].contiguous(), v[i:i + 1].contiguous(),
            ln[i:i + 1].clone()) for i in range(8)])
        errs = [compare(got, want, K2_TOL[dt], f"tp K2 {geo} {name}")[0]
                for name, got in (("B=1", rows),
                                  ("B=8", decode_attention(q, k, v, ln)))]
        out["k2_err"] = max(out["k2_err"], *errs)
        pts = {b: _k2_point(gen, b, hq, hkv, d, 416, 400) for b in (1, 8)}
        out["k2_err"] = max(out["k2_err"], *(p["err"] for p in pts.values()))
        out["k2"][geo] = {f"B={b}": {key: p[key] for key in (
            "kernel_ms", "ms", "plain_ms", "bound_ms", "library_ms",
            "library_kernel_ms")} for b, p in pts.items()}
        log("tp", f"K2 {geo} bf16: lengths {lens} (a row alone: "
                  f"{-(-s_cap // split)} splits of {split}): max_abs_err B=1 "
                  f"{errs[0]:.3e}, B=8 {errs[1]:.3e}; serving call "
                  + "; ".join(
                      f"B={b}: kernel time {fmt_us(p['kernel_ms'])}, bound "
                      f"{p['bound_ms'] * 1e3:.4f} us (bytes), plain "
                      f"{p['plain_ms']:.4f} ms, SDPA kernel time "
                      f"{fmt_us(p['library_kernel_ms'])}"
                      for b, p in pts.items()))

        psplit = paged_split_size(1, hkv, d, s_cap, dt)
        plens = [min(n, s_cap) for n in (1, psplit - 1, psplit, psplit + 1,
                                          2 * psplit + 7, s_cap, 5, 400)]
        args = _k3_case(gen, rng, hq, hkv, d, 64, plens, dt,
                        width=s_cap // 64, pad_rows=(6,))
        want = paged_decode_attention_reference(*args)
        q, kp, vp, tables, lengths = args
        first = torch.cat([paged_decode_attention(
            q[i:i + 1], kp, vp, tables[i:i + 1], lengths[i:i + 1])
            for i in range(8)])
        again = torch.cat([paged_decode_attention(
            q[i:i + 1], kp, vp, tables[i:i + 1], lengths[i:i + 1])
            for i in range(8)])
        if not torch.equal(first, again):
            raise AssertionError(f"tp K3 {geo}: a second call on the stream "
                                 f"gave another result")
        errs = [compare(got, want, K3_TOL[dt], f"tp K3 {geo} {name}")[0]
                for name, got in (("B=1", first),
                                  ("B=8", paged_decode_attention(*args)))]
        out["k3_err"] = max(out["k3_err"], *errs)
        serve_lens = [int(n) for n in rng.randint(400, 601, size=8)]
        width = -(-max(serve_lens) // 64)
        sargs = _k3_case(gen, rng, hq, hkv, d, 64, serve_lens, dt,
                         pool_pages=257, width=width)
        out["k3_err"] = max(out["k3_err"], compare(
            paged_decode_attention(*sargs),
            paged_decode_attention_reference(*sargs), K3_TOL[dt],
            f"tp K3 {geo} serving call")[0])
        call = lambda: paged_decode_attention(*sargs)  # noqa: E731
        k_ms = kernel_time_ms(call, reps=50)
        bound = (attn_bound_ms(sargs[0], sargs[4], hkv, 2)
                 + sargs[3].numel() * 4 / HBM_BPS * 1e3)
        pt = {"kernel_ms": k_ms, "ms": time_ms(call, reps=50),
              "plain_ms": time_ms(
                  lambda: paged_decode_attention_reference(*sargs), reps=50),
              "bound_ms": bound}
        out["k3"][geo] = {"B=8": pt}
        log("tp", f"K3 {geo} bf16 page 64: lengths {plens} (row 6 unmapped; "
                  f"a row alone: {-(-s_cap // psplit)} splits of {psplit}): "
                  f"max_abs_err B=1 {errs[0]:.3e} (twice, bitwise equal), "
                  f"B=8 {errs[1]:.3e}; serving call B=8 lengths "
                  f"{min(serve_lens)}-{max(serve_lens)}: kernel time "
                  f"{fmt_us(k_ms)}, bound {bound * 1e3:.4f} us (bytes), "
                  f"share {'not measured' if k_ms is None else f'{bound / k_ms:.4f}'}"
                  f", plain {pt['plain_ms']:.4f} ms")
    return out


def _tp_world_of_one(main_engine, prompts, answers):
    """Engine(mesh=make_mesh(1, 1)) over NCCL at world size 1 (one card):
    phase main's three requests give phase main's ids bit for bit, K1 44 a
    request, K2 24 a decode step."""
    import shutil

    import torch.distributed as dist

    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.parallel import distributed, make_mesh

    work = tempfile.mkdtemp(prefix="chip_smoke_tp1_")
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    layers = main_engine.cfg.decoder.num_layers
    n_ffn = sum(main_engine.cfg.vision.layers)  # K1 calls an image: 44
    try:
        distributed.initialize(f"file://{work}/store", device="cuda")
        if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError(f"tp: backend {dist.get_backend()}, world "
                                 f"{dist.get_world_size()}")
        engine = Engine(main_engine.cfg, main_engine.params, IdTokenizer(),
                        mesh=make_mesh(dp=1, tp=1))
        image = np.random.RandomState(0).randint(0, 256, (1024, 1024, 3),
                                                 dtype=np.uint8)
        _zero_launches()
        results = [(p, *engine.generate(engine.build_prompt(p), image,
                                         max_new_tokens=32))
                   for p in prompts]
        k1, k2, k3 = (int(x) for x in _launches())
        engine.close()
        del engine
    finally:
        distributed.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    steps = sum(st["decode_steps"] for _, _, st in results)
    differ = [p for p, text, _ in results if text != answers[p]]
    if differ:
        raise AssertionError(f"tp: the NCCL world of one gave other ids than "
                             f"phase main for {differ}")
    if k1 != n_ffn * len(results) or k2 != layers * steps or k3:
        raise AssertionError(f"tp: NCCL world of one launched K1 {k1}, K2 "
                             f"{k2}, K3 {k3} for {len(results)} requests of "
                             f"{steps} decode steps")
    log("tp", f"NCCL world of one (make_mesh(1, 1) on cuda): "
              f"{len(results)} requests gave phase main's ids bit for bit; "
              f"K1 {k1} = {n_ffn} x {len(results)}, K2 {k2} = {layers} x "
              f"{steps} "
              f"steps, K3 0")
    return {"launches": [k1, k2, k3], "decode_steps": steps}


class _WorldMesh:
    """The (data=1, model=world) mesh of a gloo world whose ranks share one
    card: the members of ``DeviceMesh`` the port reads, on "cuda" with the
    world's process group as "model" (``make_mesh`` lays a gloo world on
    the CPU; NCCL takes one rank a device)."""

    device_type = "cuda"
    mesh_dim_names = ("data", "model")

    def __init__(self, world):
        import torch.distributed as dist

        self._dist = dist
        self.mesh = torch.arange(world).reshape(1, world)

    def get_group(self, axis):
        if axis != "model":
            raise ValueError(f"no group for {axis!r}")
        return self._dist.group.WORLD

    def get_local_rank(self, axis):
        return self._dist.get_rank() if axis == "model" else 0


def tp_rank_main(rank, world, store, out):
    """One rank of phase tp's gloo world on the card (``python3
    chip_smoke.py --tp-rank RANK WORLD STORE OUT``): phase main's weights
    cut by the layout, rank 0 serving TP_REQUESTS through Engine.generate
    and TP_BATCH through a BatchScheduler, the others following. Each
    rank saves its device calls (name, K1 / K2 / K3 launches, collectives,
    wall ms, tokens) to OUT/rank<r>.pt."""
    import datetime

    import torch.distributed as dist

    from fastvlm_tpu_torch.engine import Engine
    from fastvlm_tpu_torch.ops.kv_cache import KVCache, PagedKVCache
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TP_JOIN_S))
    # the engine's collectives (parallel/collectives.py calls these), not
    # the lockstep channel's broadcasts
    collectives = {"n": 0}
    for name in ("all_reduce", "all_gather"):
        def counted(*a, _fn=getattr(dist, name), **kw):
            collectives["n"] += 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    cfg = main_config()
    engine = Engine(cfg, main_params(cfg), IdTokenizer(),
                    mesh=_WorldMesh(world))
    gc.collect()
    torch.cuda.empty_cache()
    calls = []

    def host(x):
        if isinstance(x, (KVCache, PagedKVCache)):
            return None
        if torch.is_tensor(x):
            return x.detach().cpu()
        if isinstance(x, (tuple, list)):
            return [host(v) for v in x]
        return None

    for name, fn in list(engine._calls.items()):
        def rec(*a, _fn=fn, _name=name, **kw):
            before, n0 = _launches(), collectives["n"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = _fn(*a, **kw)
            torch.cuda.synchronize()
            calls.append({"name": _name, "k": kw.get("k"),
                          "ms": (time.perf_counter() - t0) * 1000,
                          "launches": (_launches() - before).tolist(),
                          "collectives": collectives["n"] - n0,
                          "out": host(res)})
            return res
        engine._calls[name] = rec

    result = {"rank": rank, "calls": calls,
              "kv_heads": engine._kv_heads,
              "local_shapes": {n: tuple(engine.params["decoder"]["layers"][0]
                                        [n]["w"].shape)
                               for n in ("q", "k", "o", "gate", "down")}}
    if engine.is_leader:
        rng = np.random.RandomState(11)
        images = [rng.randint(0, 256, (1024, 1024, 3), dtype=np.uint8)
                  for _ in range(6)]
        try:
            result["generate"] = [
                engine.generate(engine.build_prompt(p), images[i],
                                max_new_tokens=32) for p, i in TP_REQUESTS]
            sched = BatchScheduler(engine, max_batch=8, window_ms=100,
                                   page_size=64, pool_tokens=16384)
            try:
                clients = [Client(sched, engine, p, images[i], 32)
                           for p, i in TP_BATCH]
                result["batch"] = [c.result(f"tp batch request {n}")
                                   for n, c in enumerate(clients)]
                result["batch_counters"] = dict(sched.counters)
            finally:
                sched.shutdown()
        finally:
            engine.close()
    else:
        engine.follow()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _tp_two_ranks(card, main_engine):
    """Phase tp's gloo world of TP_RANKS processes sharing the card
    (``tp_rank_main``); checks and prints what they saved."""
    import shutil

    layers = main_engine.cfg.decoder.num_layers
    n_ffn = sum(main_engine.cfg.vision.layers)  # K1 calls an image: 44
    work = tempfile.mkdtemp(prefix="chip_smoke_tp2_")
    t0 = time.perf_counter()
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+")
            for r in range(TP_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         str(TP_RANKS), os.path.join(work, "store"), work],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(TP_RANKS)]
    try:
        deadline = time.monotonic() + TP_JOIN_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    try:
        if any(p.returncode for p in procs):
            tails = []
            for f in logs:
                f.seek(0)
                tails.append(f.read()[-4000:])
            raise AssertionError("tp: the gloo world failed:\n" + "\n".join(
                f"[rank {r} rc {p.returncode}] {tail}"
                for r, (p, tail) in enumerate(zip(procs, tails))))
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(TP_RANKS)]
    finally:
        for f in logs:
            f.close()
        shutil.rmtree(work, ignore_errors=True)
    lead = ranks[0]
    names = [c["name"] for c in lead["calls"]]
    for res in ranks[1:]:
        if [c["name"] for c in res["calls"]] != names:
            raise AssertionError(f"tp: rank {res['rank']} made other calls "
                                 f"than rank 0")
        for i, (a, b) in enumerate(zip(lead["calls"], res["calls"])):
            if not _tp_same(a["out"], b["out"]):
                raise AssertionError(f"tp: rank {res['rank']}'s call {i} "
                                     f"({a['name']}) gave other outputs than "
                                     f"rank 0's")
    totals = []
    for res in ranks:
        for c in res["calls"]:
            k1, k2, k3 = c["launches"]
            steps = c["k"] or 0
            if c["name"] == "prefill" and k1 != n_ffn:
                raise AssertionError(f"tp rank {res['rank']}: a prefill "
                                     f"launched K1 {k1} times, expected "
                                     f"{n_ffn}")
            if c["name"] == "decode_chunk" and \
                    (k2 + k3 != layers * steps or min(k2, k3) != 0):
                raise AssertionError(f"tp rank {res['rank']}: a {steps}-step "
                                     f"chunk launched K2 {k2}, K3 {k3}")
        totals.append(np.sum([c["launches"] for c in res["calls"]],
                             axis=0).tolist())
    gens = [c for c in lead["calls"] if c["name"] == "decode_chunk"]
    dense = [c for c in gens if c["launches"][1]]
    paged = [c for c in gens if c["launches"][2]]
    if not dense or not paged:
        raise AssertionError("tp: no dense (K2) or no paged (K3) decode "
                             "chunk ran")
    requests = [(p, i, text, st) for (p, i), (text, st) in
                zip(TP_REQUESTS, lead["generate"])]
    rng = np.random.RandomState(11)
    images = [rng.randint(0, 256, (1024, 1024, 3), dtype=np.uint8)
              for _ in range(6)]
    for p, i, text, st in requests:
        _check_replay("tp", f"TP request {p!r}", main_engine, p, images[i],
                      text)
    for (p, i), last in list(zip(TP_BATCH, lead["batch"]))[:2]:
        _check_replay("tp", f"TP batched request {p!r}", main_engine, p,
                      images[i], last["text"])
    per_step = [c["collectives"] / c["k"] for c in gens]
    step_ms = [c["ms"] / c["k"] for c in dense]
    log("tp", f"gloo world of {TP_RANKS} ranks sharing {card} "
              f"({wall:.1f} s with start-up): each rank holds q/k/o/gate/down "
              f"{lead['local_shapes']} and {lead['kv_heads']} kv head(s); "
              f"every rank made rank 0's {len(names)} device calls with "
              f"bitwise equal outputs (tokens, logits, lengths); launches "
              f"K1/K2/K3 by rank {totals} (K1 {n_ffn} a prefill, K2 or K3 "
              f"{layers} a step)")
    log("tp", f"Engine.generate: TTFT "
              f"{[round(st['ttft_ms'], 2) for *_, st in requests]} ms, "
              f"{[st['decode_tokens'] for *_, st in requests]} tokens at "
              f"{[round(st['tok_per_s'], 2) for *_, st in requests]} tok/s; "
              f"dense step wall {statistics.median(step_ms):.2f} ms (median "
              f"over {len(dense)} chunks, host clock with a synchronise); "
              f"BatchScheduler: 4 requests at once, TTFT "
              f"{[round(u['stats']['ttft_ms'], 2) for u in lead['batch']]} ms, "
              f"paged step wall "
              f"{statistics.median(c['ms'] / c['k'] for c in paged):.2f} ms; "
              f"collective calls a decode step {sorted(set(per_step))} "
              f"(all_reduce + all_gather)")
    return {"launches_by_rank": totals, "wall_s": wall,
            "ttft_ms": [st["ttft_ms"] for *_, st in requests],
            "tok_per_s": [st["tok_per_s"] for *_, st in requests],
            "dense_step_ms": statistics.median(step_ms),
            "paged_step_ms": statistics.median(c["ms"] / c["k"]
                                               for c in paged),
            "collectives_per_step": sorted(set(per_step))}


def _tp_launches(tp_res, kernel):
    """Phase tp's launches of kernel 0 (K1), 1 (K2) or 2 (K3) by path."""
    out = {"tp-nccl-1": tp_res["nccl1"]["launches"][kernel]}
    for r, launches in enumerate(tp_res["gloo"]["launches_by_rank"]):
        out[f"tp-gloo-2-rank{r}"] = launches[kernel]
    return out


def _tp_same(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and torch.equal(a, b)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            _tp_same(x, y) for x, y in zip(a, b))
    return a == b


def phase_tp(card, main_engine, prompts, answers, gen):
    """The tensor-parallel engine on the card; see the module docstring."""
    t0 = time.perf_counter()
    res = {"kernels": _tp_kernels(gen)}
    res["nccl1"] = _tp_world_of_one(main_engine, prompts, answers)
    res["gloo"] = _tp_two_ranks(card, main_engine)
    res["s"] = time.perf_counter() - t0
    log("tp", f"phase took {res['s']:.1f} s")
    return res


TRAIN_F32_STEPS = 3
# the f32 steps with the tower's FFN through the kernel and through
# ffn_reference: the losses within this relative difference (3xTF32 sums
# differ from cuBLAS's f32 ones by ~1e-6 of the FFN's output; the decoder
# and the optimizer run the same ops in both)
TRAIN_F32_REL = 1e-5


def _plain_ffn_block(t_grid, residual_grid, ffn_params, ls=None):
    """fastvit's ffn_block_apply with ffn_reference in place of the kernel
    (the tower frozen: no grad through it)."""
    from fastvlm_tpu_torch.ops.cuda.ffn import ffn_reference

    b, h, w, c = t_grid.shape
    dt = t_grid.dtype
    fc1, fc2 = ffn_params["fc1"], ffn_params["fc2"]
    out = ffn_reference(t_grid.reshape(-1, c), residual_grid.reshape(-1, c),
                        fc1["w"].to(dt), fc1["b"].to(dt), fc2["w"].to(dt),
                        fc2["b"].to(dt), None if ls is None else ls.to(dt))
    return out.reshape(b, h, w, c)


def _k1_f32_train_checks():
    """K1's f32 route at the rows train-f32 gives it (TRAIN_BATCH images at
    1024 px, each FastViTHD width, with ls and ls=None) against
    ffn_reference on the same inputs within K1_TOL[float32]: at C = 768 /
    1536 these rows split pass 2's depth (ffn_reduce_kernel) or run the
    unsplit epilogue at grids phase K1's one-image rows do not reach. Beside
    each, as a control, the tolerance ratio that the plain version with
    TF32 products reads against the same f32 reference. Returns the max abs
    error and the readings by shape."""
    from fastvlm_tpu_torch.ops.cuda.ffn import ffn_reference, fused_ffn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(63)  # its own: later phases' inputs stay as they were
    atol, rtol = K1_TOL[torch.float32]
    max_abs, rows = 0.0, {}
    for n_img, c, _ in K1_STAGES:
        n = TRAIN_BATCH * n_img
        t, res, w1, b1, w2, b2, ls = _ffn_inputs(n, c, torch.float32, gen)
        for use_ls in (True, False):
            args = (t, res, w1, b1, w2, b2, ls if use_ls else None)
            want = ffn_reference(*args)
            got = fused_ffn(*args)
            torch.cuda.synchronize()
            err, ratio = compare(got, want, K1_TOL[torch.float32],
                                 f"K1 f32 at train-f32's N={n} C={c} "
                                 f"ls={use_ls}")
            del got
            keep = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = ffn_reference(*args)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = keep
            tf32_ratio = float(((tf32 - want).abs()
                                / (atol + rtol * want.abs())).max())
            del tf32, want
            max_abs = max(max_abs, err)
            rows[f"{n}x{c}{'' if use_ls else ' ls=None'}"] = {
                "max_abs_err": err, "ratio": ratio, "tf32_ratio": tf32_ratio}
            log("train", f"K1 f32 at train-f32's rows N={n} C={c} ls="
                         f"{'yes' if use_ls else 'None'}: max_abs_err "
                         f"{err:.3e} (tol ratio {ratio:.3f} <= 1); control: "
                         f"the plain version with TF32 products reads ratio "
                         f"{tf32_ratio:.2f}")
        del t, res, w1, b1, w2, b2, ls
    torch.cuda.empty_cache()
    return max_abs, rows


def _train_f32(card, data_path, work):
    """FastVLM-0.5B at full width in float32 (train_sft's default), tower
    frozen, TRAIN_F32_STEPS steps: first K1's f32 route against
    ffn_reference at the steps' rows (_k1_f32_train_checks); then K1 44 a
    step, every call's (C, Ch) on a tensor-core route (the library's
    fvlm_ffn_route) and no general-route kernel in the profile; the step's wall ms, K1's kernel time a step and its share of
    the step's kernels (profiler, 2 more steps), peak memory; then the same
    steps from the same weights with the tower's FFN through ffn_reference
    on the card: losses within TRAIN_F32_REL."""
    import shutil

    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.data.preprocessing import (
        ByteTokenizer, ImageProcessor)
    from fastvlm_tpu_torch.data.sft import DataArguments, SupervisedDataset
    from fastvlm_tpu_torch.models import fastvit, qwen2
    from fastvlm_tpu_torch.ops.cuda import ffn
    from fastvlm_tpu_torch.train.trainer import Trainer, TrainingArguments

    k1_max_abs, k1_rows = _k1_f32_train_checks()
    cfg = _fastvithd_cfg(C.qwen2_0_5b(param_dtype="float32",
                                      compute_dtype="float32"), "float32")
    v = cfg.vision
    lib = ffn._load()
    routes = {ffn.ROUTES[lib.fvlm_ffn_route(c, c * r)]
              for c, r in zip(v.embed_dims, v.mlp_ratios)}
    if "general" in routes:
        raise AssertionError(f"train-f32: a FastViTHD width takes K1's "
                             f"general route: {routes}")
    tower, proj = _live_encoder(cfg, 61)
    dgen = torch.Generator(device="cuda")
    dgen.manual_seed(62)
    params = {"vision": tower, "projector": proj,
              "decoder": qwen2.init(dgen, cfg.decoder, "cuda")}

    def trainer(out):  # train() ends with a checkpoint, removed after
        ds = SupervisedDataset(
            DataArguments(data_path=data_path, image_folder=work),
            ByteTokenizer(), ImageProcessor(v.image_size))
        args = TrainingArguments(
            output_dir=os.path.join(work, out), batch_size=TRAIN_BATCH,
            max_steps=TRAIN_F32_STEPS, save_steps=0, log_steps=1,
            warmup_ratio=0.0, seed=0, learning_rate=3e-4)
        return Trainer(cfg, params, ds, args, device="cuda")

    tr = trainer("f32")
    run = _train_run(tr, TRAIN_F32_STEPS, "train-f32")
    shutil.rmtree(os.path.join(work, "f32"), ignore_errors=True)
    wall, kern, top, k1_rows = _idle_share(tr, cfg)  # 2 steps
    general = [k for k in k1_rows if "ffn_f32_kernel" in k]
    if general:
        raise AssertionError(f"train-f32: the general f32 kernel ran: {general}")
    k1_ms = sum(ms for ms, _ in k1_rows.values())
    kern = None if kern is None else kern / 2
    share = None if kern is None else k1_ms / kern
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    keep = fastvit.ffn_block_apply
    fastvit.ffn_block_apply = _plain_ffn_block
    try:
        ref = trainer("f32-plain")
        _zero_launches()
        ref.train()
        ref_k1 = int(_launches()[0])
    finally:
        fastvit.ffn_block_apply = keep
        shutil.rmtree(os.path.join(work, "f32-plain"), ignore_errors=True)
    ref_losses = [h["loss"] for h in ref.history]
    del ref, params, tower, proj
    gc.collect()
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref_losses))
    if ref_k1 or len(ref_losses) != TRAIN_F32_STEPS or rel > TRAIN_F32_REL:
        raise AssertionError(f"train-f32: kernel losses {run['losses']} vs "
                             f"ffn_reference's {ref_losses} (rel {rel:.2e}, "
                             f"tol {TRAIN_F32_REL}); K1 {ref_k1} in the plain "
                             f"run")
    by_kernel = {k.split("::", 1)[-1].split("(")[0]: (round(ms, 4), n)
                 for k, (ms, n) in k1_rows.items()}
    log("train", f"FastVLM-0.5B SFT in float32 (train_sft's default), batch "
                 f"{TRAIN_BATCH}, {TRAIN_F32_STEPS} steps (tower frozen): "
                 f"losses {[round(x, 6) for x in run['losses']]}; through "
                 f"ffn_reference {[round(x, 6) for x in ref_losses]} (max "
                 f"rel diff {rel:.2e}, tol {TRAIN_F32_REL}); step 1 "
                 f"{run['step_ms'][0]:.1f} ms, then median "
                 f"{run['median_ms']:.2f} ms a step (wall, data included); "
                 f"peak {run['peak_gib']:.2f} GiB; K1 {run['k1']} = "
                 f"{sum(v.layers)} x {TRAIN_F32_STEPS}, routes {sorted(routes)}; "
                 f"2 more steps on pre-collated batches: {wall / 2:.1f} ms "
                 f"wall a step, {fmt_ms(kern)} of kernels, K1 {k1_ms:.3f} ms "
                 f"(share {'not measured' if share is None else f'{share:.3f}'}"
                 f"), K1's kernels (ms, launches a step): {by_kernel}; top "
                 f"kernels (name, ms a step, launches a step): {top[:6]}; on "
                 f"{card}")
    return {"losses": run["losses"], "plain_losses": ref_losses,
            "loss_rel_diff": rel, "step_ms": run["step_ms"],
            "median_ms": run["median_ms"], "peak_gib": run["peak_gib"],
            "k1": run["k1"], "k1_max_abs": k1_max_abs, "k1_checks": k1_rows,
            "profile_wall_ms": wall / 2,
            "profile_kernel_ms": kern,
            "k1_kernel_ms": k1_ms, "k1_share": share, "k1_kernels": by_kernel,
            "top_kernels": top}


def iter_batches(trainer, cfg):
    """The trainer's batches, on the card."""
    from fastvlm_tpu_torch.train.trainer import batches

    for b in batches(trainer.dataset, trainer.sampler, TRAIN_BATCH,
                     cfg.num_image_tokens):
        yield trainer._to_device(b)


def _train_small():
    """The tiny f32 model (train_sft --random-tiny's, tower re-drawn live)
    trained 3 steps with the tower unfrozen on the card (K1 through
    FusedFFNFunction) and on the CPU (plain): losses and params within
    TRAIN_SMALL_TOL."""
    import shutil

    from fastvlm_tpu_torch.data.preprocessing import (
        ByteTokenizer, ImageProcessor)
    from fastvlm_tpu_torch.data.sft import DataArguments, SupervisedDataset
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.train.step import named_leaves
    from fastvlm_tpu_torch.train.train_sft import tiny_config
    from fastvlm_tpu_torch.train.trainer import Trainer, TrainingArguments

    cfg = tiny_config()
    gen = torch.Generator()
    gen.manual_seed(5)
    params = vlm.init(gen, cfg)
    params["vision"] = _live_tower(params["vision"], gen)
    work = tempfile.mkdtemp(prefix="chip_smoke_small_")
    out = {}
    try:
        data_path = _sft_data(work, 8, (160, 120), 80, answer_bytes=(16, 48))
        for i, dev in enumerate(("cuda", "cpu")):
            ds = SupervisedDataset(
                DataArguments(data_path=data_path, image_folder=work),
                ByteTokenizer(), ImageProcessor(cfg.vision.image_size))
            args = TrainingArguments(
                output_dir=os.path.join(work, f"run{i}"), batch_size=4,
                max_steps=3, log_steps=1, save_steps=0, warmup_ratio=0.0,
                learning_rate=1e-3, unfreeze_mm_vision_tower=True)
            tr = Trainer(cfg, params, ds, args, device=dev)
            _zero_launches()
            tr.train()
            out[i] = (tr, int(_launches()[0]))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    (card_tr, k1), (cpu_tr, _) = out[0], out[1]
    lc = [h["loss"] for h in card_tr.history]
    lp = [h["loss"] for h in cpu_tr.history]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lc, lp))
    worst = 0.0
    for group in cpu_tr.state.params:
        want = dict(named_leaves(cpu_tr.state.params[group]))
        top = max(float(x.detach().abs().max()) for x in want.values())
        for p, x in named_leaves(card_tr.state.params[group]):
            err = float((x.detach().cpu() - want[p].detach()).abs().max())
            worst = max(worst, err / top)
    n_blocks = sum(cfg.vision.layers)
    if loss_err > TRAIN_SMALL_TOL or worst > TRAIN_SMALL_TOL:
        raise AssertionError(f"small model training, card vs CPU: losses "
                             f"{lc} vs {lp} (rel {loss_err:.2e}), params "
                             f"{worst:.2e} of their group's largest (tol "
                             f"{TRAIN_SMALL_TOL})")
    if k1 != n_blocks * 3:
        raise AssertionError(f"small model training: K1 {k1}, expected "
                             f"{n_blocks} x 3")
    log("train", f"tiny f32 model, 3 steps, tower unfrozen: card (K1 "
                 f"{k1} = {n_blocks} x 3 through FusedFFNFunction) vs CPU "
                 f"(plain) losses {[round(x, 6) for x in lc]}, rel err "
                 f"{loss_err:.2e}; params within {worst:.2e} of their "
                 f"group's largest (tol {TRAIN_SMALL_TOL})")
    return {"loss_rel_err": loss_err, "param_rel_err": worst, "k1": k1}


# ---------------------------------------------------------------------------
# Mellum2-12B-A2.5B: K4 and K3 under a window, K5, and the served path
# ---------------------------------------------------------------------------

MELLUM_CFG = os.path.join(ROOT, "port_bench", "configs",
                          "mellum2-12b-a2.5b.json")
MELLUM_HEADS = (32, 4, 128)
MELLUM_WINDOW = 1024
# the vqa-doc3k cell's burst of 8: rows of ~3.4k tokens (a 3072-token
# document, 256 image tokens, the question); a chunked admission's chunk
# far past the window; rows shorter than the window
K4W_BURST = [3400, 3361, 3380, 3395, 3372, 3410, 3350, 3388]
K4W_CASES = (
    ("burst w1024", 8, 3410, 3410, 0, K4W_BURST, MELLUM_WINDOW),
    ("chunk @3072 w1024", 1, 256, 3328, 3072, None, MELLUM_WINDOW),
    ("chunk @1100 w1024", 1, 256, 1356, 1100, None, MELLUM_WINDOW),
    ("short w1024", 2, 700, 700, 0, [700, 650], MELLUM_WINDOW),
    ("burst w100", 2, 1000, 1000, 0, [1000, 937], 100),
    ("burst full", 8, 3410, 3410, 0, K4W_BURST, None),
)


def k4w_bound_ms(ns, offset, hq, hkv, d, window):
    """K4's bound under a window: 4 D Hq FLOPs a key seen at the bf16 peak,
    or q, out and the keys each row reads moved once, the larger (the
    benchmark's counts, port_bench/flops.py)."""
    from port_bench import flops as pb_flops

    flops = 4 * d * hq * sum(pb_flops.causal_pairs(n, offset, window)
                             for n in ns)
    nbytes = 2 * sum(2 * n * hq * d
                     + 2 * pb_flops.keys_read(n, offset, window) * hkv * d
                     for n in ns)
    f_ms, b_ms = flops / BF16_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return max(f_ms, b_ms), ("operations" if f_ms >= b_ms else "bytes")


def _k4w_exact(q, k, v, offset, lens, window):
    """The windowed attention in float64 from the same 16-bit inputs."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    q_pos = offset + torch.arange(t, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    out = []
    for r in range(b):
        m = k_pos <= q_pos
        if window is not None:
            m = m & (q_pos - k_pos < window)
        if lens is not None:
            m = m & (k_pos < lens[r])
        o = torch.empty((t, hq * d), dtype=torch.float64, device=q.device)
        for h0 in range(0, hkv):
            qr = q[r, :, h0 * (hq // hkv):(h0 + 1) * (hq // hkv)].double()
            sc = torch.einsum("tgd,sd->gts", qr, k[r, :, h0].double()) / math.sqrt(d)
            sc = sc.masked_fill(~m, float("-inf"))
            pr = torch.softmax(sc, dim=-1).nan_to_num(0.0)
            g = hq // hkv
            o[:, h0 * g * d:(h0 + 1) * g * d] = torch.einsum(
                "gts,sd->tgd", pr, v[r, :, h0].double()).reshape(t, g * d)
            del sc, pr
        out.append(o)
    return torch.stack(out)


def phase_k4_window(gen):
    """K4 with a window against its plain version and float64 at
    Mellum2's 32/4/128 heads and the vqa-doc3k cell's shapes, on the real
    queries of each row; tolerance as phase K4's; then timed beside its
    bound (the causal pairs the window keeps)."""
    from fastvlm_tpu_torch.ops.cuda.prefill_attention import (
        prefill_attention, prefill_attention_reference)

    hq, hkv, d = MELLUM_HEADS
    results = {}
    for name, b, t, s, offset, lens, window in K4W_CASES:
        dtype = torch.bfloat16
        q = (1.5 * torch.randn((b, t, hq, d), generator=gen, device="cuda")).to(dtype)
        kv = torch.randn((b, s, 2 * hkv * d), generator=gen, device="cuda").to(dtype)
        k = kv[..., :hkv * d].reshape(b, s, hkv, d)
        v = kv[..., hkv * d:].reshape(b, s, hkv, d)
        kv_lens = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                         device="cuda")
        before = (prefill_attention.launches, prefill_attention.window_launches)
        got = prefill_attention(q, k, v, offset, kv_lens, window)
        torch.cuda.synchronize()
        if (prefill_attention.launches - before[0],
                prefill_attention.window_launches - before[1]) != \
                (1, int(window is not None)):
            raise AssertionError(f"K4 window {name}: launch counts")
        plain = prefill_attention_reference(q, k, v, offset, kv_lens, window)
        exact = _k4w_exact(q, k, v, offset, lens, window)
        real = torch.ones((b, t), dtype=torch.bool, device="cuda")
        if lens is not None:
            real = torch.arange(t, device="cuda")[None] < kv_lens[:, None]
        real = real[..., None]
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K4 window {name}: non-finite output")
        k_err = float(((got.double() - exact).abs() * real).max())
        p_err = float(((plain.double() - exact).abs() * real).max())
        top = float((exact.abs() * real).max())
        half_ulp = 2.0 ** (math.floor(math.log2(top)) - 7) / 2
        if k_err > p_err + half_ulp:
            raise AssertionError(f"K4 window {name}: max_abs_err {k_err:.4e} "
                                 f"against float64, the plain version's "
                                 f"{p_err:.4e} (+ half an ulp {half_ulp:.4e})")
        del plain, exact
        ns = [t] * b if lens is None else [min(n, t) for n in lens]
        bound, by = k4w_bound_ms(ns, offset, hq, hkv, d, window)

        def call():
            prefill_attention(q, k, v, offset, kv_lens, window)

        k_ms, names = kernel_profile(call, reps=10)
        ms = time_batch_ms(call, reps=10)
        results[name] = dict(max_abs_err=k_err, plain_max_abs_err=p_err,
                             kernel_ms=k_ms, ms=ms, bound_ms=bound, bound_by=by)
        share = "not measured" if k_ms is None else f"{100 * bound / k_ms:.2f}%"
        log("K4w", f"{name}: B={b} T={t} S={s} offset {offset} window {window}: "
                   f"max_abs_err vs float64 {k_err:.4e} (plain {p_err:.4e}, + "
                   f"half an ulp {half_ulp:.4e} allowed); kernel time "
                   f"{fmt_ms(k_ms)} ({names}), {ms:.4f} ms a call by events; "
                   f"bound {bound:.4f} ms ({by}), share {share}")
    return results


def phase_k3_window(gen):
    """K3 with a window against its plain version at 32/4/128: rows across
    the window's edges (shorter, equal, longer, far past), page 64 and 16,
    bf16; then the serving call's time (batch 8 at ~3.4k keys) beside the
    same call without a window."""
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention, paged_decode_attention_reference)

    hq, hkv, d = MELLUM_HEADS
    w = MELLUM_WINDOW
    rng = np.random.RandomState(5)
    out = {}
    for page in (64, 16):
        lens = [1, w - 1, w, w + 1, 2 * w + 7, 3411, 5, 4096]
        args = _k3_case(gen, rng, hq, hkv, d, page, lens, torch.bfloat16,
                        pad_rows=(6,))
        before = paged_decode_attention.window_launches
        got = paged_decode_attention(*args, window=w)
        again = paged_decode_attention(*args, window=w)
        torch.cuda.synchronize()
        if paged_decode_attention.window_launches != before + 2:
            raise AssertionError("K3 window: launch count")
        if not torch.equal(got, again):
            raise AssertionError("K3 window: a second call gave another result")
        want = paged_decode_attention_reference(*args, window=w)
        err, ratio = compare(got, want, K3_TOL[torch.bfloat16],
                             f"K3 window page {page}")
        full = paged_decode_attention_reference(*args)
        differs = float((full.float() - want.float()).abs().max())
        out[f"page {page}"] = dict(max_abs_err=err, ratio=ratio)
        log("K3w", f"page {page} lengths {lens} (row 6 unmapped) window {w}: "
                   f"max_abs_err {err:.3e} (ratio {ratio:.3f}), second call "
                   f"bitwise equal; the window moves the result by {differs:.3e}")
    lens = [3400, 3361, 3380, 3395, 3372, 3410, 3350, 3388]
    args = _k3_case(gen, rng, hq, hkv, d, 64, lens, torch.bfloat16,
                    width=4096 // 64)
    for tag, win in (("window", w), ("no window", None)):
        def call():
            paged_decode_attention(*args, window=win)
        k_ms, names = kernel_profile(call, reps=20)
        keys = sum(min(n, win or n) for n in lens)
        nbytes = 2 * keys * hkv * d * 2 + 2 * 2 * len(lens) * hq * d
        bound = nbytes / HBM_BPS * 1e3
        share = "not measured" if k_ms is None else f"{100 * bound / k_ms:.2f}%"
        out[f"serving {tag}"] = dict(kernel_ms=k_ms, bound_ms=bound)
        log("K3w", f"serving call B=8 ~3.4k keys {tag}: kernel time "
                   f"{fmt_ms(k_ms)} ({names}); bound {bound:.5f} ms (bytes), "
                   f"share {share}")
    return out


def _k5_split(split):
    """A K5 call's kernel times by kernel: {moe_k5_*: ms}, the count fill
    as "fill"."""
    out = {}
    for name, ms in split.items():
        m = re.search(r"moe_k5_[a-z_]+", name)
        key = m.group(0) if m else "fill"
        out[key] = out.get(key, 0.0) + ms
    return out


def phase_k5(gen):
    """K5 (routed experts) against experts_reference at Mellum2's widths (D
    2304, 64 experts of 896, top 8) in bf16: a burst's 27,200 tokens, one
    row's 3,400, an admission chunk's 256, a decode step's 8, with padding
    rows, with three experts (the first, one inside, the last) that get no
    token, and a tiny call. A token whose top 8 differ between the two (the
    router's products summed in another order) is a near tie: its 8th and
    9th probabilities must lie within 1e-3 of each other, relative, and it
    is left out of the comparison; the others within 1e-2 of the largest
    output. Each case records the route its products took (grouped:
    csrc/experts.cu; triton) and its kernel times kernel by kernel beside
    its bound (the benchmark's, port_bench/decoders/mellum2.py's
    k5_layer); at the burst, one row, 1024 and 512 tokens (128 and 64 rows
    an expert), chunk and decode shapes the other route too, held to the
    same checks and timed (the threshold's evidence); torch._grouped_mm's
    products as context."""
    from fastvlm_tpu_torch.ops.cuda import experts as k5
    from port_bench import family, harness

    cfg = harness.load_json(MELLUM_CFG)
    fam = family.of(cfg)
    d, _, _, _, e, top, inter, _ = fam.dims(cfg)
    res = {}

    def r(*shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(
            torch.bfloat16)

    router = r(d, e, std=0.02)
    gateup = r(e, d, 2 * inter, std=0.02)
    down = r(e, inter, d, std=0.02)
    no_rows = (0, 31, e - 1)
    for name, n, pad, both in (("burst", 27200, 0, True),
                               ("one row", 3400, 0, True),
                               ("1024", 1024, 0, True), ("512", 512, 0, True),
                               ("chunk", 256, 0, True), ("decode", 8, 0, True),
                               ("padded", 4096, 700, False),
                               ("no rows", 4096, 0, False),
                               ("tiny", 3, 1, False)):
        x = r(n, d, std=1.0)
        rw = router
        if name == "no rows":  # three experts' logits at -100
            x[:, 0] = 1.0
            rw = router.clone()
            rw[:, list(no_rows)] = 0.0
            rw[0, list(no_rows)] = -100.0
        valid = None
        if pad:
            valid = torch.ones((n,), dtype=torch.bool, device="cuda")
            valid[-pad:] = False
        before = (k5.routed_experts.launches, k5.routed_experts.grouped)
        got = k5.routed_experts(x, rw, gateup, down, top, True, valid)
        torch.cuda.synchronize()
        if k5.routed_experts.launches != before[0] + 1:
            raise AssertionError("K5: launch count")
        route = "grouped" if k5.routed_experts.grouped > before[1] else "triton"
        if (route == "grouped") != k5.grouped_route(n, top, e):
            raise AssertionError(f"K5 {name}: took the {route} route")
        want = k5.experts_reference(x, rw, gateup, down, top, True, valid)
        probs = torch.softmax(x.float() @ rw.float(), -1)
        srt = probs.sort(-1, descending=True)
        ref_ids = srt.indices[:, :top]
        gap = (srt.values[:, top - 1] - srt.values[:, top]) / srt.values[:, top - 1]
        real = n - pad
        flops, nbytes = fam.k5_layer(cfg, real)
        bound = max(flops / BF16_FLOPS, nbytes / HBM_BPS) * 1e3
        by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BPS else "bytes"
        item = dict(route=route, bound_ms=bound, bound_by=by)
        routes = [route] + ([{"grouped": "triton", "triton": "grouped"}[route]]
                            if both else [])
        for rt in routes:
            grouped = rt == "grouped"
            out, ids, _ = k5.launch(x, rw, gateup, down, top, True, valid,
                                    grouped)
            torch.cuda.synchronize()
            if rt == route and not torch.equal(out, got):
                raise AssertionError(f"K5 {name}: two calls differ")
            ids = ids.view(n, top).long()
            same = (ids.sort(-1).values == ref_ids.sort(-1).values).all(-1)
            if valid is not None:
                if bool((ids[~valid] != -1).any()):
                    raise AssertionError("K5: a padding token was routed")
                same = same | ~valid
            if name == "no rows" and bool(
                    (ids[..., None] == torch.tensor(no_rows, device="cuda")).any()):
                raise AssertionError("K5: a token reached an expert at -100")
            flips = ~same
            if bool((gap[flips] > 1e-3).any()):
                raise AssertionError(f"K5 {name} ({rt}): {int(flips.sum())} "
                                     f"tokens routed apart, some without a "
                                     f"near tie")
            keep = same[:, None]
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"K5 {name} ({rt}): non-finite output")
            err = float(((out.float() - want.float()).abs() * keep).max())
            top_out = float((want.float().abs() * keep).max())
            if err > 1e-2 * top_out:
                raise AssertionError(f"K5 {name} ({rt}): max_abs_err {err:.4e} "
                                     f"against the plain version (largest "
                                     f"{top_out:.4e})")
            if valid is not None and bool(out[~valid].abs().max() > 0):
                raise AssertionError("K5: a padding token's output is not zero")
            split = _k5_split(kernel_split_ms(
                lambda: k5.launch(x, rw, gateup, down, top, True, valid,
                                  grouped), reps=5)[0])
            k_ms = sum(split.values()) if split else None
            item[rt] = dict(max_abs_err=err, largest=top_out,
                            near_tie_flips=int(flips.sum()), kernel_ms=k_ms,
                            split_ms=split)
            share = "not measured" if k_ms is None else f"{100 * bound / k_ms:.2f}%"
            parts = ", ".join(f"{k} {v:.4f}" for k, v in split.items())
            log("K5", f"{name}: N={n} ({pad} padding), {rt} route"
                      f"{' (taken)' if rt == route else ''}: max_abs_err "
                      f"{err:.4e} (largest {top_out:.4e}), {int(flips.sum())} "
                      f"near-tie tokens routed apart; kernel time "
                      f"{fmt_ms(k_ms)} ({parts}); bound {bound:.4f} ms ({by}), "
                      f"share {share}")
        item.update(max_abs_err=max(item[rt]["max_abs_err"] for rt in routes),
                    kernel_ms=item[route]["kernel_ms"])
        grouped_mm = getattr(torch, "_grouped_mm", None)
        if grouped_mm is not None and name in ("burst", "one row"):
            try:
                counts = torch.bincount(ref_ids.reshape(-1), minlength=e)
                offs = counts.cumsum(0).to(torch.int32)
                rows = x[torch.argsort(ref_ids.reshape(-1), stable=True) // top]
                item["grouped_mm_ms"] = kernel_time_ms(lambda: grouped_mm(
                    grouped_mm(rows, gateup, offs=offs)[:, :inter].contiguous(),
                    down, offs=offs), reps=5)
                log("K5", f"{name}: context: torch._grouped_mm gate/up then "
                          f"down {fmt_ms(item['grouped_mm_ms'])}")
            except Exception as exc:  # context only: its API varies by release
                log("K5", f"{name}: context: torch._grouped_mm not run "
                          f"({type(exc).__name__})")
        res[name] = item
    return res


def phase_serve_mellum(card):
    """Mellum2-12B-A2.5B at full width (random bf16 weights from the
    benchmark's draw) through Engine + BatchScheduler with the vqa-doc3k
    mix's settings: 12 requests of ~3.4k tokens (8 at once, 4 admitted
    later). Every prefill call launches 28 K4 kernels (21 windowed) and 28
    K5 calls, every decode step 28 K3 kernels (21 windowed) and 28 K5
    calls, and nothing reaches qwen2._attend or qwen2._attend_pool. A
    gathered prefill's K5 calls all take the grouped route, a decode
    step's none, an admission chunk's all or none."""
    sys.path.insert(0, ROOT)
    from fastvlm_tpu_torch.models import qwen2, vlm
    from fastvlm_tpu_torch.ops.cuda import experts as k5
    from fastvlm_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention)
    from fastvlm_tpu_torch.ops.cuda.prefill_attention import prefill_attention
    from port_bench import harness, loadgen, weights

    cfg = harness.load_json(MELLUM_CFG)
    mix = harness.load_json(os.path.join(ROOT, "port_bench", "traffic",
                                         "vqa-doc3k.json"))
    t0 = time.perf_counter()
    tree = weights.draw(cfg, 22, torch.device("cuda"), torch.bfloat16)
    server = harness.build_server(cfg, mix, tree, "bfloat16")
    del tree
    log("serve-mellum", f"weights and engine in {time.perf_counter() - t0:.1f} s, "
                        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    plain = {"attend": 0, "attend_pool": 0}
    orig = {"_attend": qwen2._attend, "_attend_pool": qwen2._attend_pool}

    def counted(name, key):
        def f(*a, **kw):
            plain[key] += 1
            return orig[name](*a, **kw)
        return f
    qwen2._attend = counted("_attend", "attend")
    qwen2._attend_pool = counted("_attend_pool", "attend_pool")
    calls = []
    saved = {n: getattr(vlm, n) for n in ("prefill", "prefill_continue",
                                           "decode_step")}

    def counts():
        return (prefill_attention.launches, prefill_attention.window_launches,
                paged_decode_attention.launches,
                paged_decode_attention.window_launches,
                k5.routed_experts.launches, k5.routed_experts.grouped)

    def watched(name):
        def f(*a, **kw):
            b = counts()
            out = saved[name](*a, **kw)
            calls.append((name, tuple(x - y for x, y in zip(counts(), b))))
            return out
        return f
    try:
        plan = loadgen.build(mix, cfg, 22, 30.0)
        n_img = 256
        longest = max(len(loadgen.prompt_ids(r.prompt, n_img)[0])
                      for r in plan.requests[:12])
        server.warm(longest, 8)
        for n in saved:
            setattr(vlm, n, watched(n))
        plain.update(attend=0, attend_pool=0)
        t1 = time.perf_counter()
        streams = []
        for i, req in enumerate(plan.requests[:12]):
            streams.append(server.stream(req, plan.images))
            if i == 7:
                time.sleep(0.5)
        finals = [list(s)[-1] for s in streams]
        secs = time.perf_counter() - t1
    finally:
        for n, f in saved.items():
            setattr(vlm, n, f)
        qwen2._attend, qwen2._attend_pool = orig["_attend"], orig["_attend_pool"]
    counters = server.counters()
    server.close()
    # a gathered prefill's 28 K5 calls take the grouped route, a decode
    # step's the Triton one; an admission chunk's all one route
    want = {"prefill": [(28, 21, 0, 0, 28, 28)],
            "prefill_continue": [(28, 21, 0, 0, 28, 0), (28, 21, 0, 0, 28, 28)],
            "decode_step": [(0, 0, 28, 21, 28, 0)]}
    bad = [c for c in calls if c[1] not in want[c[0]]]
    kinds = dict(collections.Counter(c[0] for c in calls))
    log("serve-mellum", f"12 requests in {secs:.2f} s; calls {kinds}; launch "
                        f"deltas of the first calls {calls[:3]}; plain "
                        f"attention calls {plain}; counters {counters}")
    if bad or plain["attend"] or plain["attend_pool"]:
        raise AssertionError(f"serve-mellum: calls off the kernels: {bad[:5]}, "
                             f"plain {plain}")
    if any("error" in f for f in finals):
        raise AssertionError(f"serve-mellum: a request failed: {finals}")
    del server
    gc.collect()
    torch.cuda.empty_cache()
    # launches summed over the calls: K4, K4 windowed, K3, K3 windowed, K5,
    # K5 on the grouped route
    launches = [int(sum(c[1][j] for c in calls)) for j in range(6)]
    by_kind = {k: sum(c[1][5] for c in calls if c[0] == k) for k in kinds}
    log("serve-mellum", f"K5 calls on the grouped route: {launches[5]} of "
                        f"{launches[4]}; by kind {by_kind}")
    return dict(calls=kinds, plain=plain, counters=dict(counters), seconds=secs,
                launches=launches)


AB_RUN = """
import importlib.util, json, sys, torch
sys.path.insert(0, {tree!r})
spec = importlib.util.spec_from_file_location("chip_smoke_ab", {script!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from fastvlm_tpu_torch.ops.cuda import _build, ffn
assert ffn.__file__.startswith({tree!r}), ffn.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
_build.load("ffn")
bf16 = cs.phase_k1(gen)[1]
print("AB " + json.dumps({{**cs.phase_k1_f32(gen), "bf16": bf16}}), flush=True)
"""


def k1_ab(parent):
    """This script's phase_k1 (bf16) and phase_k1_f32 run against the
    kernel of the checkout at ``parent`` and of this one, in turns (parent,
    change, change, parent), each in a fresh process that builds that
    checkout's csrc/ffn.cu: the same inputs (seed 0) and timings on one
    card. Prints each run's K1 lines and one JSON line a run, {"tree": ...,
    "max_abs": ..., "image": ..., "stages": ..., "bf16": {...}} (f32 keys
    but "bf16"); returns non-zero if a run fails."""
    trees = {"parent": os.path.abspath(parent), "change": ROOT}
    script = os.path.abspath(__file__)
    for tag in ("parent", "change", "change", "parent"):
        code = AB_RUN.format(tree=trees[tag], script=script)
        proc = subprocess.run([sys.executable, "-c", code], cwd=trees[tag],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("[K1]"):
                print(f"[{tag}] {line}", flush=True)
            elif line.startswith("AB "):
                print(json.dumps({"tree": tag, **json.loads(line[3:])}),
                      flush=True)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--tp-rank"]:  # one rank of phase tp's gloo world
        sys.path.insert(0, ROOT)
        return tp_rank_main(int(argv[1]), int(argv[2]), argv[3], argv[4])
    # fail before printing anything without a card or outside a checkout
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only "
                         "on a GPU")
    sys.path.insert(0, ROOT)
    import fastvlm_tpu_torch  # noqa: F401

    name, card = phase_device()
    if argv[:1] == ["--k1-ab"]:  # phase K1 on two checkouts' kernels in turns
        return k1_ab(argv[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    phase_build()
    if argv == ["--k1-only"]:  # phase K1 alone
        k1 = phase_k1(gen)[1]
        routes = k1_route_checks()
        k1_f32 = phase_k1_f32(gen)
        print(json.dumps({"k1": k1, "k1_f32": k1_f32,
                          "routes": {f"{c}x{ch}": r
                                     for (c, ch), r in routes.items()}}),
              flush=True)
        return 0
    if argv == ["--k4-only"]:  # phase K4, then the serving path it runs on
        k4 = phase_k4(gen)
        serve15 = phase_serve_15b(card)
        print(json.dumps({"k4": k4, "serve-1.5b": serve15}, default=str),
              flush=True)
        return 0
    if argv == ["--mellum-only"]:  # K4 and K3 with a window, K5
        res = {"k4_window": phase_k4_window(gen), "k3_window": phase_k3_window(gen),
               "k5": phase_k5(gen)}
        print(json.dumps(res, default=str), flush=True)
        return 0
    if argv == ["--serve-mellum-only"]:  # Mellum2 through the scheduler
        print(json.dumps({"serve-mellum": phase_serve_mellum(card)}, default=str),
              flush=True)
        return 0
    if argv == ["--tp-only"]:  # phase tp alone, after the engine it needs
        main_res = phase_main(card)
        tp_res = phase_tp(card, main_res["engine"], main_res["prompts"],
                          main_res["answers"], gen)
        print(json.dumps({"tp": tp_res}, default=str), flush=True)
        return 0
    if argv == ["--serve-view-only"]:  # phase serve-view alone, likewise
        view_res = phase_serve_view(card, phase_main(card)["engine"])
        print(json.dumps({"serve-view": view_res}, default=str), flush=True)
        return 0
    k1_err, k1 = phase_k1(gen)
    k1_route_checks()
    k1_f32 = phase_k1_f32(gen)
    k2_err, k2 = phase_k2(gen)
    k3_err, k3 = phase_k3(gen)
    k4 = phase_k4(gen)
    k4w = phase_k4_window(gen)
    k3w = phase_k3_window(gen)
    k5_res = phase_k5(gen)
    main_res = phase_main(card)
    engine = main_res.pop("engine")
    main_prompts, main_answers = main_res["prompts"], dict(main_res["answers"])
    serve_res = phase_serve(card, engine)
    view_res = phase_serve_view(card, engine)
    view_launches = {f"serve-view {m}": r["launches"]
                     for m, r in view_res["modes"].items()}
    view_launches["serve-view dense fallback"] = view_res["fallback_launches"]
    serve15_res = phase_serve_15b(card)
    video_res = phase_video(card, engine)
    spec_res = phase_spec(card, engine)
    ckpt_res = phase_checkpoint(card, engine, main_res.pop("params"),
                                main_res.pop("answers"))
    beam_res = phase_beam(card, ckpt_res.pop("engine"), engine)
    anyres_res = phase_anyres(card)
    # the anyres and serve-1.5b engines are out of scope: give their memory
    # back before the 7B
    gc.collect()
    torch.cuda.empty_cache()
    log("llava15", f"device memory before the 7B: "
                   f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
                   f"allocated (phase main's engine)")
    llava_res = phase_llava15(card)
    llava = llava_res.pop("engine")
    worker_res = phase_worker(card, engine, llava, llava_res.pop("images"))
    del llava
    gc.collect()
    torch.cuda.empty_cache()
    mellum = phase_serve_mellum(card)  # frees its 12B before it returns
    m_k4, m_k4w, m_k3, m_k3w, m_k5, m_k5g = mellum["launches"]
    quant_res = phase_quant(card, engine, main_res, gen)
    kv_res = phase_kv_int8(card, engine)
    export_res = phase_export(card, quant_res.pop("tower"),
                              quant_res.pop("cfg"))
    gc.collect()
    torch.cuda.empty_cache()
    train_res = phase_train(card, gen)
    par_res = phase_parallel(card, train_res)
    tp_res = phase_tp(card, engine, main_prompts, main_answers, gen)
    tp_k = tp_res["kernels"]
    phase_small()
    quant_paths = ("7b-int8", "7b-w8a8", "7b-int4", "decode-int8",
                   "decode-w8a8")
    kv_launches = np.sum(list(kv_res["launches"].values()), axis=0)
    k2_7b = quant_res["k2_7b_b8"]

    kernels = {"kernels": [
        {"name": "fused_ffn", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/ffn.cu",
         "replaces": "fastvlm_tpu/ops/pallas/ffn.py:76",
         "launches": main_res["k1_launches"],
         "launches_by_path": {"main": main_res["k1_launches"],
                              "serve": serve_res["k1_launches"],
                              **{p: n[0] for p, n in view_launches.items()},
                              "serve-1.5b": serve15_res["k1_launches"],
                              "video": video_res["k1_launches"],
                              "spec": spec_res["k1_launches"],
                              "video-spec": spec_res["video_k1"],
                              "spec-serve": spec_res["serve_k1"],
                              "checkpoint": ckpt_res["k1_launches"],
                              "beam": beam_res["k1_launches"],
                              "anyres": anyres_res["anyres_k1"],
                              "multi-image": anyres_res["multi_k1"],
                              "serve-fairness": anyres_res["fair"][0],
                              "serve-window": anyres_res["window"][0],
                              "llava-1.5-7b": int(llava_res["launches"][0]),
                              "worker": worker_res["worker"][0],
                              "worker-batch": worker_res["batch"][0],
                              "worker-llava": worker_res["llava"][0],
                              **{p: quant_res[p]["launches"][0]
                                 for p in quant_paths},
                              "kv-int8": int(kv_launches[0]),
                              "export": export_res["encoder"]["k1"],
                              **train_res["k1"], **par_res["k1"],
                              **_tp_launches(tp_res, 0)},
         "max_abs_err": max(k1_err, anyres_res["k1_err"],
                            train_res["k1_fwd_err"]),
         "ms": k1["ms"], "kernel_ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "operations",
         "library_ms": None, "library_chain_ms": k1["chain_ms"],
         "timed_as": "44 calls of one 1024 px image, bf16, ls folded; "
                     "bound_by: the sum is set by the 40 calls of stages "
                     "1-3; library_chain_ms: addmm-gelu-addmm-add in bf16 "
                     "cuBLAS, context only; max_abs_err also over the "
                     "5-tile stack's stage-2 call (N=20480, C=384) and the "
                     "training batch's five widths through "
                     "FusedFFNFunction (N = 4 images' rows); train and "
                     "parallel paths: 44 a step, one call a block over the "
                     "batch",
         "backward": "plain torch (autograd through ffn_reference), as "
                     "JAX trains through XLA's FFN",
         "backward_max_abs_err": train_res["k1_grad_err"],
         "f32_ms": k1_f32["image"]["ms"],
         "f32_kernel_ms": k1_f32["image"]["kernel_ms"],
         "f32_plain_ms": k1_f32["image"]["plain_ms"],
         "f32_bound_ms": k1_f32["image"]["bound_ms"],
         "f32_bound_by": "operations",
         "f32_cuda_core_ms": k1_f32["image"]["cuda_core_ms"],
         "f32_library_chain_ms": k1_f32["image"]["chain_ms"],
         "f32_max_abs_err": max(k1_f32["max_abs"],
                                train_res["f32"]["k1_max_abs"]),
         "f32_timed_as": "44 calls of one 1024 px image, float32, with ls "
                         "(as training calls it); bound: 3xTF32, three "
                         "TF32 products a product at 494.7 TFLOP/s, or the "
                         "bytes; cuda_core_ms: the f32 FLOPs at the CUDA "
                         "cores' 66.9 TFLOP/s (context); library_chain_ms: "
                         "addmm-gelu-addmm-add in f32 cuBLAS with TF32 off, "
                         "context only; max_abs_err also over the "
                         "training batch's five widths (N = 4 images' "
                         "rows, ls and ls=None); train-f32: 44 a step of a "
                         "full-width float32 SFT (tower frozen)",
         "f32_stages": k1_f32["stages"],
         "f32_train": {k: train_res["f32"][k] for k in (
             "median_ms", "profile_wall_ms", "profile_kernel_ms",
             "k1_kernel_ms", "k1_share", "peak_gib", "loss_rel_diff")}},
        {"name": "decode_attention", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/decode_attention.cu",
         "replaces": "fastvlm_tpu/ops/pallas/decode_attention.py:167",
         "launches": main_res["k2_launches"],
         "launches_by_path": {"main": main_res["k2_launches"],
                              **{p: n[1] for p, n in view_launches.items()},
                              "video": video_res["k2_launches"],
                              "checkpoint": ckpt_res["k2_launches"],
                              "beam": beam_res["k2_launches"],
                              "anyres": anyres_res["anyres_k2"],
                              "multi-image": anyres_res["multi_k2"],
                              "serve-fairness": anyres_res["fair"][1],
                              "llava-1.5-7b": int(llava_res["launches"][1]),
                              "worker": worker_res["worker"][1],
                              "worker-batch": worker_res["batch"][1],
                              "worker-llava": worker_res["llava"][1],
                              **{p: quant_res[p]["launches"][1]
                                 for p in quant_paths},
                              "kv-int8": int(kv_launches[1]),
                              **_tp_launches(tp_res, 1)},
         "max_abs_err": max(k2_err, beam_res["k2_max_abs_err"],
                            llava_res["k2_err"], k2_7b["err"],
                            tp_k["k2_err"]),
         "ms": k2["ms"], "kernel_ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": "bytes",
         "library_ms": k2["library_ms"],
         "library_kernel_ms": k2["library_kernel_ms"], "host_us": k2["host_us"],
         "timed_as": "one call, B=1, 14/2/64 bf16, S_max 416, length 400; "
                     "ms by events per call; max_abs_err also over the "
                     "beam's B=4 call and LLaVA-1.5-7B's 32/32/128 calls "
                     "at B=1 and B=4; library: "
                     "scaled_dot_product_attention with enable_gqa",
         "llava_32_32_128": {
             f"B={b}": {k: pt[k] for k in ("kernel_ms", "ms", "plain_ms",
                                           "bound_ms", "library_ms",
                                           "library_kernel_ms")}
             for b, pt in llava_res["k2"].items()},
         "qwen2_7b_28_4_128_b8": {
             k: k2_7b[k] for k in ("kernel_ms", "ms", "plain_ms", "bound_ms",
                                   "library_ms", "library_kernel_ms")},
         "tp_local_heads": tp_k["k2"]},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/paged_decode_attention.cu",
         "replaces": "fastvlm_tpu/ops/pallas/decode_attention.py:215",
         "launches": serve_res["k3_launches"],
         "launches_by_path": {"serve": serve_res["k3_launches"],
                              **{p: n[2] for p, n in view_launches.items()},
                              "serve-1.5b": serve15_res["k3_launches"],
                              "spec-serve": spec_res["serve_k3"],
                              "serve-fairness": anyres_res["fair"][2],
                              "serve-window": anyres_res["window"][2],
                              "llava-1.5-7b": int(llava_res["launches"][2]),
                              "worker": worker_res["worker"][2],
                              "worker-batch": worker_res["batch"][2],
                              "worker-llava": worker_res["llava"][2],
                              "kv-int8": int(kv_launches[2]),
                              **_tp_launches(tp_res, 2),
                              "serve-mellum": m_k3,
                              "serve-mellum windowed": m_k3w},
         "max_abs_err": max(k3_err, worker_res["k3_err"], tp_k["k3_err"],
                            *(r["max_abs_err"] for r in k3w.values()
                              if "max_abs_err" in r)),
         "ms": k3["ms"], "kernel_ms": k3["kernel_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": "bytes", "library_ms": None,
         "host_us": k3["host_us"], "dense_k2_kernel_ms": k3["dense_k2_kernel_ms"],
         "timed_as": "one call, B=8, 14/2/64 bf16, page 64, lengths "
                     "400-600, watermark table; ms by events per call; "
                     "launches from the serve phase; dense_k2_kernel_ms: K2 "
                     "on a dense cache of the same rows, context only; "
                     "max_abs_err also over the 7B worker's B=4 32/32/128 "
                     "call",
         "llava_32_32_128_b4": worker_res["k3"],
         "tp_local_heads": tp_k["k3"],
         "window": k3w},
        {"name": "prefill_attention", "route": "cuda",
         "source": "fastvlm_tpu_torch/csrc/prefill_attention.cu",
         "replaces": None,
         "launches_by_path": {"serve-1.5b": serve15_res["k4_launches"],
                              "serve-mellum": m_k4,
                              "serve-mellum windowed": m_k4w},
         "max_abs_err": max(r["max_abs_err"]
                            for r in (*k4.values(), *k4w.values())),
         "timed_as": "per case of phases K4 and K4w; bound: causal pairs "
                     "of the real rows (within the window) at 989 TFLOP/s "
                     "or their bytes once",
         "cases": k4, "window_cases": k4w},
        {"name": "routed_experts", "route": "cuda (grouped products) / triton",
         "source": "fastvlm_tpu_torch/csrc/experts.cu, "
                   "fastvlm_tpu_torch/ops/cuda/experts.py",
         "replaces": None,
         "launches_by_path": {"serve-mellum": m_k5,
                              "serve-mellum grouped": m_k5g},
         "max_abs_err": max(r["max_abs_err"] for r in k5_res.values()),
         "kernel_ms": k5_res["burst"]["kernel_ms"],
         "bound_ms": k5_res["burst"]["bound_ms"],
         "bound_by": k5_res["burst"]["bound_by"],
         "timed_as": "one sparse layer of Mellum2 (D 2304, 64 experts of "
                     "896, top 8, bf16) over the vqa-doc3k burst's 27,200 "
                     "tokens; max_abs_err over every case against "
                     "experts_reference on both routes, near-tie tokens "
                     "left out; launches: calls, four kernels each; "
                     "grouped: the calls whose products took csrc/experts.cu",
         "cases": k5_res},
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
