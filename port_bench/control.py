#!/usr/bin/env python3
"""Readings that set a cell's check limits: for each seed, one run at the
cell's load with a short window, then the check's numbers (``harness.numbers``)
three times over the same sampled requests, all seeds in one process:

  program   the program's served tokens
  control   at each position of the same prompts and served tokens, the
            token the reference in fp8 puts first (the step below the
            configuration's bf16)
  altered   the program's tokens with one request's answer replaced by
            ids drawn from the seed (a token altered where it is produced,
            confined to one row of a batch)

    python3 port_bench/control.py --workload fastvlm-1.5b.vqa-shared \\
        --seconds 14 --seeds 11 12 13 14

Prints one JSON line a seed, then for each number the largest program
reading (the lower end of its limit) and the smallest control and altered
readings (the upper end). Not a run of the benchmark.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUMBERS = ("mean_logit_gap", "worst_request_gap", "max_logit_gap")


def readings(served, seed: int) -> dict:
    """The three readings of one served run."""
    import numpy as np
    import torch

    from port_bench import family, harness, weights
    from port_bench.reference import gaps

    cfg, dev = served.cfg, served.device
    images = served.plan.images
    tree = weights.draw(cfg, seed, dev, served.dtype)
    reference = family.of(cfg).Reference
    ref, ctl = reference(cfg, tree), reference(cfg, tree, quant="fp8")
    rng = np.random.default_rng([int(seed), 3])
    victim = int(rng.integers(len(served.sample)))
    program, control = [], []
    with torch.inference_mode():
        for i, rec in enumerate(served.sample):
            tokens = harness.Ctx.served(rec)
            want = harness.teacher_force(ref, cfg, rec, tokens, images, dev)
            program.append(gaps(want, tokens))
            rows = harness.teacher_force(ctl, cfg, rec, tokens, images, dev)
            control.append(gaps(want, rows.argmax(-1).tolist()))
            if i == victim:
                bad = rng.integers(0, cfg["vocab_size"], len(tokens)).tolist()
                altered = gaps(harness.teacher_force(ref, cfg, rec, bad,
                                                     images, dev), bad)
            del want, rows
    return {"program": harness.numbers(program),
            "control": harness.numbers(control),
            "altered": harness.numbers(program[:victim] + [altered]
                                       + program[victim + 1:]),
            "limits": cfg["check"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=14.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    rows = []
    for seed in a.seeds:
        served = harness.serve(
            bench, a.workload, seed, a.seconds, False,
            t_process=time.perf_counter(),
            log=lambda m: print(m, file=sys.stderr, flush=True))
        row = dict(seed=seed, attempted=served.out["attempted"],
                   failed=served.out["failed"],
                   metrics={k: v["value"]
                            for k, v in served.out["metrics"].items()},
                   **readings(served, seed))
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "workload": a.workload, "card": torch.cuda.get_device_name(),
        **{n: {"program_max": max(r["program"][n] for r in rows),
               "control_min": min(r["control"][n] for r in rows),
               "altered_min": min(r["altered"][n] for r in rows)}
           for n in NUMBERS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
