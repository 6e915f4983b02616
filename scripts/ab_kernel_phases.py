#!/usr/bin/env python3
"""Phases K2 and K3 of chip_smoke.py from two checkouts, in turns, on one card.

    python3 scripts/ab_kernel_phases.py PARENT_DIR [CHANGE_DIR]

Runs each checkout's own chip_smoke.py phases (device, build, K2, K3) in a
fresh process, in the order parent, change, change, parent, so that two
versions of the decode-attention kernels are compared on one card within
one call. CHANGE_DIR defaults to the checkout holding this script. Prints
each run's K2 main-path and K3 serving-call lines and one JSON line per
run, {"tree": "parent" | "change", "k2": {...}, "k3": {...}}, of the
numbers the two phases returned. Needs one CUDA card and nvcc; exits
non-zero if a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = """
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
cs.phase_device()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
gen = torch.Generator(device='cuda')
gen.manual_seed(0)
cs.phase_build()
print('AB ' + json.dumps({'k2': cs.phase_k2(gen)[1], 'k3': cs.phase_k3(gen)[1]}),
      flush=True)
"""


def main() -> int:
    if len(sys.argv) not in (2, 3):
        raise SystemExit(__doc__)
    trees = {"parent": os.path.abspath(sys.argv[1]),
             "change": os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else ROOT)}
    for tag in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, "-c", RUN], cwd=trees[tag],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("[K2] main-path") or line.startswith("[K3] serving"):
                print(f"[{tag}] {line}", flush=True)
            elif line.startswith("AB "):
                print(json.dumps({"tree": tag, **json.loads(line[3:])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
