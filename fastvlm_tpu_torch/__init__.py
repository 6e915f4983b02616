"""fastvlm_tpu_torch — the PyTorch / CUDA port of fastvlm_tpu for NVIDIA Hopper.

Same module paths and function names as the JAX package (``fastvlm_tpu``),
which stays the reference the port is tested against. Plain tensor code is
PyTorch; the JAX package's Pallas kernels are hand-written CUDA C++ for
sm_90a under ``csrc/``:

    ops/cuda/ffn.py                     K1, the fused ConvFFN (encoder)
    ops/cuda/decode_attention.py        K2, dense-cache decode attention
    ops/cuda/paged_decode_attention.py  K3, decode attention over the paged
                                        KV pool (serving)

Each kernel runs for CUDA tensors; CPU tensors take its plain PyTorch
version. The package imports ``torch`` and never ``jax``.

Layout:
    models/    FastViTHD encoder, projector, Qwen2 decoder, FastVLM glue
    ops/       conv/norm helpers, KV caches (dense, paged), sampling,
               splice, CUDA kernels
    data/      conversation templates, constants, host preprocessing
    utils/     the weight bridge from the JAX package's parameter tree
    serve/     the continuous-batching scheduler over the paged pool
    engine.py  host API (prepare / stream / generate), predict.py its CLI
"""

__version__ = "0.1.0"

from fastvlm_tpu_torch.config import (  # noqa: F401
    FastViTConfig,
    FastVLMConfig,
    ProjectorConfig,
    Qwen2Config,
)
