"""Nothing the benchmark runs imports JAX or the JAX package: the check
compares each loaded module's top-level name whole, since the port's
name, fastvlm_tpu_torch, begins with the JAX package's."""

import os
import subprocess
import sys

from port_bench import harness


def test_whole_top_level_names(monkeypatch):
    fake = {"fastvlm_tpu_torch": 1, "fastvlm_tpu_torch.engine": 1,
            "jaxtyping": 1, "flaxen": 1, "numpy": 1}
    monkeypatch.setattr(sys, "modules", dict(fake))
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"fastvlm_tpu.ops": 1}))
    assert harness.forbidden_modules() == ["fastvlm_tpu"]
    monkeypatch.setattr(sys, "modules", dict(fake, jax=1, **{"flax.core": 1}))
    assert harness.forbidden_modules() == ["flax", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, {root!r})\n"
        "import port_bench.run, port_bench.sweep\n"
        "from port_bench import harness, reference, loadgen, trace, readings\n"
        "import fastvlm_tpu_torch.engine, fastvlm_tpu_torch.serve.batcher\n"
        "import fastvlm_tpu_torch.models.vlm, fastvlm_tpu_torch.models.qwen2\n"
        "for m in {metrics!r}: harness.metric_reader(m)\n"
        "for c in {configs!r}: harness.family.of(harness.load_json(c))\n"
        "print(harness.forbidden_modules())\n").format(
            root=harness.REPO,
            metrics=[m["name"] for m in harness.load_json(
                harness.REPO + "/BENCHMARK.json")["per_layer"]],
            configs=[os.path.join(harness.REPO, c["file"]) for c in
                     harness.load_json(harness.REPO + "/BENCHMARK.json")[
                         "configs"]])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=harness.REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
