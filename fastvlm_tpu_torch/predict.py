"""Single-image inference CLI for the PyTorch port.

Same flags as ``fastvlm_tpu/predict.py``:

  python -m fastvlm_tpu_torch.predict --model-path ckpts/llava-fastvithd_0.5b_stage3 \
      --image-file img.jpg --prompt "Describe the image."

loads a HF checkpoint directory (``engine.build_engine``; the tokenizer is
``transformers.AutoTokenizer`` from the same directory) and runs on the CUDA
card, or with ``--device cpu`` on the CPU; without a card the default exits
with an error. ``--random-weights`` is the smoke mode (a tiny random model
with the byte tokenizer). ``--num_beams > 1`` decodes by beam search
(``Engine.generate_beam``); ``--spec-decode`` (with ``--temperature 0``)
decodes speculatively by prompt lookup (``Engine.generate_spec``,
``--draft-k`` tokens a draft). ``--verify-checkpoint`` audits
``--model-path`` instead of generating (``utils/checkpoint.
verify_checkpoint``: every key consumed, the encoder's features, and the
goldens of ``--goldens`` at 1e-3), prints the JSON report and PASS or FAIL.

``--tp N`` shards the decoder over N processes, one a rank
(``Engine(mesh=)``), started by torchrun:

  torchrun --nproc-per-node 2 -m fastvlm_tpu_torch.predict --tp 2 \
      --model-path ckpts/llava-fastvithd_7b_stage3 --image-file img.jpg

rank 0 prints; the others follow its device calls. ``--tp`` must equal
torchrun's ``WORLD_SIZE``, else the CLI exits with 2.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_prompt(user_prompt: str, conv_mode: str = "qwen_2",
                 use_im_start_end: bool = False) -> str:
    from fastvlm_tpu_torch.data.constants import (
        DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_TOKEN)
    from fastvlm_tpu_torch.data.conversation import conv_templates

    if use_im_start_end:
        qs = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
              + DEFAULT_IM_END_TOKEN + "\n" + user_prompt)
    else:
        qs = DEFAULT_IMAGE_TOKEN + "\n" + user_prompt
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default=None)
    parser.add_argument("--image-file", type=str, default=None)
    parser.add_argument("--prompt", type=str, default="Describe the image.")
    parser.add_argument("--conv-mode", type=str, default="qwen_2")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--spec-decode", action="store_true",
                        help="prompt-lookup speculative decoding (greedy "
                             "only: --temperature 0)")
    parser.add_argument("--draft-k", type=int, default=8,
                        help="speculative draft length (with --spec-decode)")
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (the JAX engine's platform=)")
    parser.add_argument("--random-weights", action="store_true",
                        help="smoke mode: tiny random model, byte tokenizer")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: the decoder sharded "
                             "over a (1, tp) mesh of tp processes (torchrun "
                             "--nproc-per-node tp)")
    parser.add_argument("--verify-checkpoint", action="store_true",
                        help="audit --model-path instead of generating: "
                             "every state-dict key consumed, the encoder's "
                             "features, and the 1e-3 golden comparison "
                             "when --goldens is given")
    parser.add_argument("--goldens", type=str, default=None,
                        help=".npz with 'input'/'features' arrays produced "
                             "by the reference encoder")
    args = parser.parse_args(argv)

    from fastvlm_tpu_torch.parallel.distributed import tp_world_error

    world_error = tp_world_error(args.tp, "fastvlm_tpu_torch.predict")
    if args.tp > 1 and world_error:
        print(world_error, file=sys.stderr)
        return 2
    if args.verify_checkpoint and args.tp > 1:
        parser.error("--verify-checkpoint audits a checkpoint in one "
                     "process: drop --tp")
    if args.verify_checkpoint and not args.model_path:
        parser.error("--verify-checkpoint requires --model-path")
    if not args.random_weights and not args.model_path:
        parser.error("--model-path required (or use --random-weights)")
    if args.spec_decode and args.temperature > 0:
        parser.error("--spec-decode is greedy-only; use --temperature 0")

    import torch

    from fastvlm_tpu_torch.engine import build_engine

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 1
    if args.verify_checkpoint:
        from fastvlm_tpu_torch.utils.checkpoint import verify_checkpoint

        report = verify_checkpoint(args.model_path, args.goldens,
                                   device=device)
        print(json.dumps(report, indent=2))
        ok = (not report["unused_keys"]
              and report["features_finite"]
              and report.get("golden_pass_1e-3", True))
        print(("PASS" if ok else "FAIL"), file=sys.stderr)
        return 0 if ok else 1
    mesh = None
    if args.tp > 1:
        from fastvlm_tpu_torch.parallel import distributed, make_mesh

        distributed.initialize(device=device)
        mesh = make_mesh(dp=1, tp=args.tp)
    try:
        if args.random_weights:
            engine = build_engine(random_tiny=True, device=device,
                                  conv_mode=args.conv_mode, mesh=mesh)
        else:
            engine = build_engine(args.model_path, dtype=args.dtype,
                                  device=device, conv_mode=args.conv_mode,
                                  mesh=mesh)
        if not engine.is_leader:
            engine.follow()
            return 0
        try:
            return _generate(args, engine, device)
        finally:
            engine.close()
    finally:
        if mesh is not None:
            distributed.shutdown()


def _generate(args, engine, device) -> int:
    import torch

    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    cfg = engine.cfg
    prompt = build_prompt(args.prompt, args.conv_mode)
    if args.image_file:
        from PIL import Image

        image = Image.open(args.image_file).convert("RGB")
    else:
        # blank image keeps the CLI usable for smoke runs without a file
        image = np.zeros((cfg.vision.image_size, cfg.vision.image_size, 3),
                         np.float32)
    sampling = SamplingParams(
        temperature=args.temperature if args.temperature > 0 else 0.0,
        top_p=args.top_p if args.top_p else 1.0,
    )
    t0 = time.perf_counter()
    if args.num_beams > 1:
        # beam decode is deterministic: sampling flags do not apply
        text, stats = engine.generate_beam(prompt, image,
                                           num_beams=args.num_beams,
                                           max_new_tokens=args.max_new_tokens)
    elif args.spec_decode:
        text, stats = engine.generate_spec(prompt, image,
                                           max_new_tokens=args.max_new_tokens,
                                           draft_k=args.draft_k)
    else:
        text, stats = engine.generate(prompt, image,
                                      max_new_tokens=args.max_new_tokens,
                                      sampling=sampling)
    elapsed = time.perf_counter() - t0
    print(text.strip())
    if args.timing:
        print(json.dumps({
            "device": (torch.cuda.get_device_name(0) if device == "cuda"
                       else "cpu"),
            "total_s": round(elapsed, 3),
            "ttft_ms": stats.get("ttft_ms"),
            "tokens": stats.get("decode_tokens"),
            "tok_per_s": stats.get("tok_per_s"),
        }), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
