#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card of this
machine:

    python3 port_bench/run.py --workload fastvlm-1.5b.vqa-shared \\
        --seed 7 --seconds 30 --trace 0

(``python3 -m port_bench.run`` from the checkout's root is the same.) The
last line of standard output is the result, one JSON object; the last
lines of standard error give each number the check compared beside its
limit. ``--trace 1`` reports the cell's per-layer metrics instead of its
end-to-end ones. Exits non-zero, with no result, where the card the cell
asks for is missing.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "port_bench", ".cache")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # the host side launches kernels: no spinning intra-op thread pool may
    # take a core from it
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    import torch

    from port_bench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}.get(a.workload)
    if cell is None:
        _log(f"no workload {a.workload!r}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        _log(f"{a.workload} needs {cell['chips']} CUDA card(s); "
             f"available: {torch.cuda.is_available()}, "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    out = harness.run(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                      t_process=T_PROCESS, log=_log)
    found = harness.forbidden_modules()
    if found:  # the window has closed: whatever the run loaded, it shows
        _log(f"modules of JAX or the JAX package loaded: {found}")
        return 4
    for k, v in out["limits"].items():
        _log(f"{k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
