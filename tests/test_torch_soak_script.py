"""fastvlm_tpu_torch/tools/soak_serving.py (the port of
scripts/soak_serving.py) on the tiny engine on the CPU: every invariant
green (clean termination, cancels honored, pool fully free, no error
updates), as tests/test_soak_script.py holds the JAX script."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_soak_tool_tiny_all_checks_green():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "fastvlm_tpu_torch.tools.soak_serving",
         "--size", "tiny", "--device", "cpu", "--n", "18", "--arrival",
         "0.05", "--pool-tokens", "4096", "--cancel-after", "0.02"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["ok"], payload
    assert payload["checks"] == {k: True for k in payload["checks"]}
    # the plan mixes all four admission flavors; the tiny engine finishes
    # request 3's 16 tokens within JAX's 0.3 s, so the run goes on to
    # request 17 (96 tokens) and its clients cancel sooner, to have a
    # cancel land mid-flight
    assert payload["reasons"].get("length", 0) >= 5, payload
    assert payload["counters"].get("cancelled", 0) >= 1, payload
