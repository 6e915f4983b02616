"""The port's tensor-parallel engine in a 4-rank gloo world on the CPU:
the cases of tests/torch_engine_tp_cases.py at tp = 4, where the tiny
decoder's 2 kv heads do not divide tp (each rank keeps the one kv head its
q head reads) and its 258-id vocab stays whole."""

from torch_engine_tp_cases import *  # noqa: F401,F403
from torch_tiny import one_torch_thread  # noqa: F401 (autouse fixture)

TP = 4
