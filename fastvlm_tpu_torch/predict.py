"""Single-image inference CLI for the PyTorch port.

Same flags as ``fastvlm_tpu/predict.py``. What runs today is the smoke mode:

  python -m fastvlm_tpu_torch.predict --random-weights --timing

(a tiny random model with the byte tokenizer) on the CUDA card, or with
``--device cpu`` on the CPU; without a card the default exits with an
error. ``--model-path``, ``--num_beams > 1``, ``--spec-decode``,
``--tp > 1`` and ``--verify-checkpoint`` exit with an error: they are not
yet ported (see ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

NOT_PORTED = "not yet ported, see ROADMAP.md"


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
    parser.add_argument("--spec-decode", action="store_true")
    parser.add_argument("--draft-k", type=int, default=8)
    parser.add_argument("--max-new-tokens", type=int, default=256)
    parser.add_argument("--dtype", type=str, default="bfloat16")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (the JAX engine's platform=)")
    parser.add_argument("--random-weights", action="store_true",
                        help="smoke mode: tiny random model, byte tokenizer")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--verify-checkpoint", action="store_true")
    parser.add_argument("--goldens", type=str, default=None)
    args = parser.parse_args(argv)

    unported = [name for name, used in (
        ("--verify-checkpoint", args.verify_checkpoint),
        ("--num_beams > 1", args.num_beams > 1),
        ("--spec-decode", args.spec_decode),
        ("--tp > 1", args.tp > 1),
        ("--model-path", args.model_path is not None),
    ) if used]
    if unported:
        print(f"{', '.join(unported)}: {NOT_PORTED}", file=sys.stderr)
        return 2
    if not args.random_weights:
        parser.error("--model-path is " + NOT_PORTED + "; use --random-weights")

    import torch

    from fastvlm_tpu_torch.engine import build_engine
    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    device = args.device
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 1
    engine = build_engine(random_tiny=True, device=device,
                          conv_mode=args.conv_mode)
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
