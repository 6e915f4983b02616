"""The port's multi-process launcher (fastvlm_tpu_torch/tools/
train_multihost.py, the counterpart of scripts/train_multihost.sh
--simulate + scripts/multihost_probe.py): two local gloo processes under
torch.distributed.run, each an all-reduce and a data-parallel AdamW step
that must equal the one-process step; each prints MULTIHOST_OK r/N."""

import inspect
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_simulation():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run(
        [sys.executable, "-m", "fastvlm_tpu_torch.tools.train_multihost",
         "--simulate", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    # torchrun replays each rank's output a line at a time, "[default<r>]:"
    # before it
    oks = [line for line in out.stdout.splitlines()
           if line.split("]:", 1)[-1].startswith("MULTIHOST_OK")]
    assert len(oks) == 2, out.stdout + out.stderr
    assert any(" 0/2 " in line for line in oks)
    assert any(" 1/2 " in line for line in oks)
    assert all("sum=1.0" in line for line in oks)
    assert "MULTIHOST_FAIL" not in out.stdout


def test_probe_defaults_to_the_card_and_simulate_to_gloo(monkeypatch):
    """--probe runs on the card unless --device says otherwise, as the JAX
    probe runs on the default backend; --simulate keeps its local gloo
    processes on the CPU and hands the probe its device explicitly.
    probe / simulate are stubbed: no world starts."""
    from fastvlm_tpu_torch.tools import train_multihost as tm

    calls = []
    monkeypatch.setattr(tm, "probe", lambda device: calls.append(
        ("probe", device)) or 0)
    monkeypatch.setattr(tm, "simulate", lambda n, device: calls.append(
        ("simulate", n, device)) or 0)
    assert tm.main(["--probe"]) == 0
    assert tm.main(["--probe", "--device", "cpu"]) == 0
    assert tm.main(["--simulate", "3"]) == 0
    assert tm.main(["--simulate", "2", "--device", "cuda"]) == 0
    assert calls == [("probe", "cuda"), ("probe", "cpu"),
                     ("simulate", 3, "cpu"), ("simulate", 2, "cuda")]
    monkeypatch.undo()
    assert inspect.signature(tm.probe).parameters["device"].default == "cuda"
    assert inspect.signature(tm.simulate).parameters["device"].default == "cpu"
