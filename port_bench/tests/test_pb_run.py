"""The benchmark's command: without the card a cell asks for it, it exits
non-zero and prints no result line."""

import subprocess
import sys

from port_bench import harness


def test_no_card_no_result(tmp_path):
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "fastvlm-1.5b.vqa-shared", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=harness.REPO,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_is_refused():
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1"], capture_output=True, text=True, timeout=300,
        cwd=harness.REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
