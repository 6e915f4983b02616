"""Batch evaluation harness.

Counterpart of ``fastvlm_tpu/eval/run_eval.py``: a JSON eval set
[{image?, question, answer | answers}] goes through ``Engine.chat`` and is
scored by exact match, substring or VQA-style soft accuracy after
normalisation; per-item predictions and the aggregate accuracy are
written out.

  python -m fastvlm_tpu_torch.eval.run_eval --model-path CKPT \
      --questions eval.json --image-folder imgs/ --metric vqa \
      --output preds.json

The JAX flags, plus ``--device`` (the card by default; ``--device cpu``
asks for the CPU). ``--platform`` is the JAX backend switch and has no
meaning here.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import string
import time
from typing import List


def normalize(text: str) -> str:
    text = text.lower().strip()
    text = re.sub(rf"[{re.escape(string.punctuation)}]", "", text)
    articles = {"a", "an", "the"}
    return " ".join(w for w in text.split() if w not in articles)


def score(pred: str, answers: List[str], metric: str) -> float:
    p = normalize(pred)
    ans = [normalize(a) for a in answers]
    if metric == "exact":
        return float(p in ans)
    if metric == "substring":
        return float(any(a in p for a in ans if a))
    if metric == "vqa":
        # VQA-style soft accuracy: min(#matching annotator answers / 3, 1)
        matches = sum(1 for a in ans if a and (a == p or a in p))
        return min(matches / 3.0, 1.0) if len(ans) > 1 else float(
            any(a == p or (a and a in p) for a in ans))
    raise ValueError(metric)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--random-weights", action="store_true")
    parser.add_argument("--questions", required=True)
    parser.add_argument("--image-folder", default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--metric", default="vqa",
                        choices=["exact", "substring", "vqa"])
    parser.add_argument("--max-new-tokens", type=int, default=64)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from fastvlm_tpu_torch.ops.sampling import SamplingParams

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.exit(1, "run_eval: no CUDA device is available; pass "
                       "--device cpu to run on the CPU\n")
    from fastvlm_tpu_torch.engine import build_engine

    engine = build_engine(args.model_path, random_tiny=args.random_weights,
                          dtype=args.dtype, device=args.device)
    with open(args.questions) as f:
        items = json.load(f)
    if args.limit:
        items = items[: args.limit]

    sampling = SamplingParams(temperature=args.temperature)
    results = []
    total, correct = 0, 0.0
    t0 = time.time()
    for item in items:
        image = None
        if item.get("image"):
            from PIL import Image

            path = item["image"]
            if args.image_folder:
                path = os.path.join(args.image_folder, path)
            image = Image.open(path).convert("RGB")
        pred, stats = engine.chat(item["question"], image,
                                  max_new_tokens=args.max_new_tokens,
                                  sampling=sampling)
        answers = item.get("answers") or [item.get("answer", "")]
        s = score(pred, answers, args.metric)
        total += 1
        correct += s
        results.append({"id": item.get("id", total - 1), "prediction": pred,
                        "score": s, "stats": stats})

    summary = {
        "metric": args.metric,
        "accuracy": round(correct / max(total, 1), 4),
        "n": total,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(summary))
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"summary": summary, "results": results}, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
