"""Interactive chat REPL with streaming output (the reference's
llava/serve/cli.py).

Counterpart of ``fastvlm_tpu/serve/cli.py``: the engine in process (no
HTTP), the conversation kept in the template across turns, tokens printed
as they decode, the request's stats with ``--timing``. Runs on the card
unless ``--device cpu`` is given.

    python -m fastvlm_tpu_torch.serve.cli --random-weights --device cpu
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--image-file", default=None)
    parser.add_argument("--conv-mode", default="qwen_2")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=1.0)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--random-weights", action="store_true")
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs")
    parser.add_argument("--timing", action="store_true")
    parser.add_argument("--spec", action="store_true",
                        help="prompt-lookup speculative streaming (greedy "
                             "only: requires --temperature 0; the same "
                             "tokens, fewer decoder passes)")
    parser.add_argument("--spec-draft-k", type=int, default=8)
    args = parser.parse_args(argv)
    if args.spec and args.temperature > 0:
        parser.error("--spec is greedy-only; pass --temperature 0")
    if not args.random_weights and not args.model_path:
        parser.error("--model-path required (or use --random-weights)")

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to run on the "
              "CPU", file=sys.stderr)
        return 1

    from fastvlm_tpu_torch.data.constants import DEFAULT_IMAGE_TOKEN
    from fastvlm_tpu_torch.data.conversation import conv_templates
    from fastvlm_tpu_torch.engine import build_engine
    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    if args.random_weights:
        engine = build_engine(random_tiny=True, device=args.device,
                              conv_mode=args.conv_mode)
    else:
        engine = build_engine(args.model_path, dtype=args.dtype,
                              device=args.device, conv_mode=args.conv_mode)

    image = None
    if args.image_file:
        from PIL import Image

        image = Image.open(args.image_file).convert("RGB")

    conv = conv_templates[args.conv_mode].copy()
    sampling = SamplingParams(
        temperature=args.temperature if args.temperature > 0 else 0.0,
        top_p=args.top_p)

    first_turn = True
    while True:
        try:
            inp = input("USER: ")
        except EOFError:
            break
        if not inp.strip():
            break

        if first_turn and image is not None:
            inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        print("ASSISTANT: ", end="", flush=True)
        shown = 0
        last = None
        # the rendered history keeps turn 1's <image>, so the image goes
        # with every turn (as in the reference CLI)
        for update in engine.stream(
            prompt, image,
            max_new_tokens=args.max_new_tokens, sampling=sampling,
            spec=args.spec, draft_k=args.spec_draft_k,
        ):
            text = update["text"]
            print(text[shown:], end="", flush=True)
            shown = len(text)
            last = update
        print()
        if args.timing and last:
            print(f"  [{last['stats']}]", file=sys.stderr)
        conv.messages[-1][1] = last["text"] if last else ""
        first_turn = False
    return 0


if __name__ == "__main__":
    sys.exit(main())
