#!/usr/bin/env python3
"""Find the period of a burst mix once, on the chip: the time a burst of
the mix's largest size, every answer at the longest length, takes from
its due time to its last token, served alone (nothing else in flight).

    python3 port_bench/sweep.py --workload fastvlm-1.5b.vqa-unshared \\
        --workload fastvlm-1.5b.vqa-shared --seed 3 --bursts 12

The workloads share one program (the first one's configuration and
deployment settings); each prints its service times, and the period a
mix is given is 1.25 times the longest a workload's bursts take, so a
burst is due only after the last one ended (the cell then sits at about
four fifths of its knee). Not a run of the benchmark: it prints no result
line.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--bursts", type=int, default=12)
    a = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from port_bench import flops, harness, loadgen, stats

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell, cfg, mix = harness.load_cell(bench, a.workload[0])
    dtype = cfg["torch_dtype"]
    from port_bench import weights

    tree = weights.draw(cfg, a.seed, torch.device("cuda"),
                        getattr(torch, dtype))
    server = harness.build_server(cfg, mix, tree, dtype)
    del tree
    out = {}
    for name in a.workload:
        _, _, m = harness.load_cell(bench, name)
        plan = loadgen.build(m, cfg, a.seed, 600.0)
        n_img = flops.image_tokens(cfg)
        longest = max(len(loadgen.prompt_ids(r.prompt, n_img)[0])
                      for r in plan.requests)
        server.warm(longest, max(m["answers"]))
        loadgen.warm(server, plan)
        size, n_new = max(m["arrivals"]["sizes"]), max(m["answers"])
        service, ttft = [], []
        reqs = plan.requests
        for b in range(a.bursts):
            group = [dataclasses.replace(r, max_new=n_new)
                     for r in reqs[b * size:(b + 1) * size]]
            recs = [loadgen.Record(r, 0.0) for r in group]
            t0 = time.perf_counter()
            threads = [threading.Thread(
                target=loadgen.consume,
                args=(rec, server.stream(rec.req, plan.images)))
                for rec in recs]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=300)
            service.append(max(r.t_close for r in recs) - t0)
            ttft += [r.updates[0][0] - t0 for r in recs]
            time.sleep(0.2)
        worst = max(service)
        out[name] = {"service_s": service, "median_s": stats.percentile(
            service, 50), "max_s": worst, "ttft_p95_ms": 1000 * stats.percentile(
            ttft, 95), "period_s": 1.25 * worst}
        print(f"{name}: burst of {size}, {n_new} tokens each: service "
              f"{[round(s, 4) for s in service]} s; period "
              f"{1.25 * worst:.4f} s", file=sys.stderr, flush=True)
    server.close()
    print(json.dumps({"card": torch.cuda.get_device_name(), "sweep": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
