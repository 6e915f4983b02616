"""The benchmark of the PyTorch / CUDA port (``fastvlm_tpu_torch``): one
cell of ``BENCHMARK.json`` a run (``run.py``). See README.md."""
