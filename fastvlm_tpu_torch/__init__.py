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
    ops/       conv/norm helpers, KV caches (dense, int8, paged),
               sampling, prompt-lookup speculative decoding, beam search,
               splice, image resize, int8 / int4 / W8A8 quantization, CUDA
               kernels
    data/      conversation templates, constants, host preprocessing, the
               SFT data pipeline (target masking, dataset, collate)
    train/     SFT training: sampler, loss and AdamW step, LoRA / QLoRA,
               the trainer with native checkpoints, the train_sft CLI
    parallel/  torch.distributed bring-up, the (data, model) mesh, TP /
               FSDP / ZeRO-1 layouts, the GPipe pipeline, differentiable
               collectives
    tools/     the multi-process launcher and the serving soak
    utils/     HF checkpoint import (branch fusion, BN fold, key audit) and
               export, native bundles, weight deltas, the native JPEG
               loader, and the weight (and optimizer-state) bridge from the
               JAX package's tree
    serve/     the continuous-batching scheduler over the paged pool (or a
               dense per-batch cache), the HTTP tier
    eval/      the batch evaluation harness
    engine.py  host API (prepare / stream / generate / generate_spec /
               generate_beam; build_engine loads a checkpoint directory),
               predict.py its CLI
    export.py  torch.export of the encoder, quantized bundles
    video.py   video-frame QA with the prompt prefix's KV reused
"""

__version__ = "0.1.0"

from fastvlm_tpu_torch.config import (  # noqa: F401
    FastViTConfig,
    FastVLMConfig,
    ProjectorConfig,
    Qwen2Config,
)
