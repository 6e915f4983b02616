"""Serving soak: the port of ``scripts/soak_serving.py``.

One continuous-batching ``BatchScheduler`` under a staggered storm that
takes every admission path at once: text and image prompts, a shared
template prefix on half of them, per-row sampling mixed with greedy,
cancellation mid-flight, and mixed decode budgets. Then it checks the
scheduler's invariants:

- every stream ends with a clean finish reason (no error updates),
  a cancelled one (its client cancels 0.3 s after submitting, or
  ``--cancel-after``) with
  "cancelled" or no final update, or with "length" where the request's
  budget ran out at the first decode-chunk boundary after its cancel
  fired, where the scheduler honors a cancel (a fast engine finishes a
  16-token request within 0.3 s; the payload counts these as
  ``cancels_beaten``),
- cancelled requests release their pages within the run,
- the page pool returns to fully free after the storm,

and reports the non-cancelled walls and the committed tokens a second.

    python -m fastvlm_tpu_torch.tools.soak_serving [--n 48] [--arrival 0.15]
        [--size 0.5b | tiny] [--device cuda | cpu] [--cancel-after 0.3]

``--size tiny`` is the tiny random engine (``build_engine(random_tiny=
True)``, on the CPU with ``--device cpu``); ``0.5b`` is FastVLM-0.5B at
full width with random weights from a seed (FastViTHD, mlp2x_gelu 3072 ->
896, Qwen2-0.5B, bf16) on the card. Prints one JSON line: the checks, the
wall distribution, the reasons, the pool's low-water mark and the
scheduler's counters; exits 1 unless every check holds.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

TEMPLATE = ("You are a meticulous visual assistant. Answer precisely and "
            "cite what you can see. ")


def plan(engine, i: int, image, cancel_after: float = 0.3):
    """Request i of the storm, as the JAX script plans it (its client
    cancels ``cancel_after`` seconds after submitting; JAX's 0.3)."""
    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    shared = i % 2 == 0
    prompt = (TEMPLATE if shared else "") + f"describe scene {i}"
    return dict(
        prompt=engine.build_prompt(prompt),
        image=image if i % 4 == 0 else None,
        max_new=(16, 48, 96)[i % 3],
        sampling=(SamplingParams(temperature=0.8, top_p=0.9)
                  if i % 5 == 1 else None),
        cancel_after=cancel_after if i % 7 == 3 else None,
    )


def soak(engine, n: int = 48, arrival: float = 0.15,
         pool_tokens: int = 32768, image_size: int = 1024,
         label: str = "", cancel_after: float = 0.3) -> dict:
    """Run the storm through a fresh scheduler over ``engine``; returns the
    JSON payload (``ok`` and ``checks`` among its keys)."""
    from fastvlm_tpu_torch.ops.sampling import SamplingParams
    from fastvlm_tpu_torch.serve.batcher import BatchScheduler

    sched = BatchScheduler(engine, window_ms=30, paged=True, page_size=64,
                           pool_tokens=pool_tokens, continuous=True)
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (image_size, image_size, 3), np.uint8)
    plans = [plan(engine, i, image, cancel_after) for i in range(n)]
    plen = max(int(engine.prepare(pl["prompt"], pl["image"])["lens"][0])
               for pl in plans)
    t0 = time.perf_counter()
    sched.warmup(prompt_len=plen, max_new_tokens=96)
    warmup_s = time.perf_counter() - t0
    # a short warm pass before the storm
    for pl, sampling in ((plans[0], None),
                         (plans[1], SamplingParams(temperature=0.8,
                                                   top_p=0.9))):
        for _ in sched.submit(pl["prompt"], image=pl["image"],
                              max_new_tokens=16, sampling=sampling):
            pass

    walls, reasons, tokens = [None] * n, [None] * n, [0] * n
    # host clock: the cancel's firing; the chunk boundary before the final
    # update (the update before it, but for the first token's update,
    # which the prefill emits: then the submit)
    fired, boundary = [None] * n, [None] * n
    errors = []

    def fire(i, cancel):
        fired[i] = time.perf_counter()
        cancel.set()

    def run(i):
        pl = plans[i]
        cancel = threading.Event() if pl["cancel_after"] else None
        if cancel:
            threading.Timer(pl["cancel_after"], fire, (i, cancel)).start()
        start = time.perf_counter()
        last, seen, latest, count = None, start, start, 0
        try:
            for item in sched.submit(pl["prompt"], image=pl["image"],
                                     max_new_tokens=pl["max_new"],
                                     sampling=pl["sampling"], cancel=cancel):
                if "error" in item:
                    errors.append((i, item["error"]))
                    return
                count += 1
                seen = latest if count > 2 else start
                latest, last = time.perf_counter(), item
            boundary[i] = seen
        finally:
            walls[i] = time.perf_counter() - start
        if last is not None:
            stats = last.get("stats", {})
            reasons[i] = stats.get("finish_reason")
            tokens[i] = stats.get("decode_tokens", len(last.get("text", "")))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
        time.sleep(arrival)
    for t in threads:
        t.join(900)
    makespan = time.perf_counter() - t0

    pool = sched.pool
    counters = dict(sched.counters)
    sched.shutdown()
    cancels = [i for i in range(n) if plans[i]["cancel_after"] is not None]
    # a request whose budget ran out at the first chunk boundary after its
    # client's cancel fired (or before it fired)
    beaten = [i for i in cancels if reasons[i] == "length"
              and (fired[i] is None or fired[i] > boundary[i])]
    checks = {
        "all_terminated": all(w is not None for w in walls),
        "no_errors": not errors,
        "pool_fully_free": pool.free_pages == pool.num_pages,
        # a cancel mid-decode ends with "cancelled"; one that lands while
        # the request is queued or mid-prefill closes the stream with no
        # final update (None): both are the cancel working, and the counter
        # catches one that was ignored. A request whose budget ran out at
        # the boundary that would have honored its cancel had nothing left
        # to cancel.
        "cancels_honored": all(reasons[i] in ("cancelled", None)
                               for i in cancels if i not in beaten)
        and counters.get("cancelled", 0) >= len(cancels) - len(beaten),
        "rest_clean": all(reasons[i] in ("stop", "length", "truncated")
                          for i in range(n) if i not in cancels),
    }
    done = sorted(w for i, w in enumerate(walls)
                  if w is not None and i not in cancels)
    return {
        "metric": f"serving soak {label} ({n} reqs @ {1 / arrival:.0f}/s, "
                  f"mixed img/text/sampled/cancel)",
        "ok": all(checks.values()), "checks": checks,
        "p50_wall_s": done[len(done) // 2] if done else None,
        "p95_wall_s": done[int(0.95 * (len(done) - 1))] if done else None,
        "makespan_s": makespan,
        "agg_committed_tok_s": sum(tokens) / makespan,
        "warmup_s": warmup_s,
        "reasons": {str(r): reasons.count(r) for r in set(reasons)},
        "cancels_beaten": len(beaten),
        "pool_min_free_pages": pool.min_free,
        "counters": dict(sorted(counters.items())),
        "errors": errors[:5],
    }


def _engine(size: str, device: str):
    import torch

    from fastvlm_tpu_torch.engine import Engine, build_engine

    if size == "tiny":
        return build_engine(random_tiny=True, device=device)
    if size != "0.5b":
        raise SystemExit(f"--size must be tiny or 0.5b, got {size}")
    from fastvlm_tpu_torch import config as C
    from fastvlm_tpu_torch.data.preprocessing import ByteTokenizer
    from fastvlm_tpu_torch.models import qwen2, vlm

    decoder = C.qwen2_0_5b(param_dtype="bfloat16", compute_dtype="bfloat16")
    vision = C.FastViTConfig(image_size=1024, param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    cfg = C.FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=C.ProjectorConfig(mm_hidden_size=vision.out_channels,
                                    hidden_size=decoder.hidden_size))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = vlm.init(gen, cfg, device)
    params["decoder"] = qwen2.fuse_decoder_params(params["decoder"], decoder)
    return Engine(cfg, params, ByteTokenizer(), eos_ids=(-1,))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=48)
    p.add_argument("--arrival", type=float, default=0.15)
    p.add_argument("--size", default="0.5b")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--pool-tokens", type=int, default=32768)
    p.add_argument("--cancel-after", type=float, default=0.3,
                   help="seconds from submit to a client's cancel")
    args = p.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    engine = _engine(args.size, args.device)
    build_s = time.perf_counter() - t0
    out = soak(engine, args.n, args.arrival, args.pool_tokens,
               engine.cfg.vision.image_size, args.size, args.cancel_after)
    out["build_s"] = build_s
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
