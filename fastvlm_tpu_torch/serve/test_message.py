"""Smoke client: send one prompt through the controller (or straight to a
worker) and print the stream (the reference's
llava/serve/test_message.py).

    python -m fastvlm_tpu_torch.serve.test_message --model-name fastvlm-tiny
"""

from __future__ import annotations

import argparse

import requests

from fastvlm_tpu_torch.data.conversation import conv_templates
from fastvlm_tpu_torch.serve.protocol import iter_chunks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", default="http://localhost:10000")
    parser.add_argument("--worker-address", default=None)
    parser.add_argument("--model-name", required=True)
    parser.add_argument("--message", default="Tell me a story with more than 1000 words.")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    args = parser.parse_args(argv)

    if args.worker_address:
        worker_addr = args.worker_address
    else:
        requests.post(args.controller_address + "/refresh_all_workers",
                      timeout=60)
        r = requests.post(args.controller_address + "/list_models", timeout=60)
        print(f"Models: {r.json()['models']}")
        r = requests.post(args.controller_address + "/get_worker_address",
                          json={"model": args.model_name}, timeout=60)
        worker_addr = r.json()["address"]
        print(f"worker_addr: {worker_addr}")
    if worker_addr == "":
        print("No available workers")
        return 1

    conv = conv_templates["qwen_2"].copy()
    conv.append_message(conv.roles[0], args.message)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    response = requests.post(
        worker_addr + "/worker_generate_stream",
        json={"model": args.model_name, "prompt": prompt,
              "temperature": 0.0, "max_new_tokens": args.max_new_tokens,
              "stop": conv.sep},
        stream=True, timeout=600)
    print(prompt, end="")
    shown = 0
    for data in iter_chunks(response.iter_content(chunk_size=None)):
        if data["error_code"]:
            print(f"\n[error {data['error_code']}] {data['text']}")
            return 1
        text = data["text"]
        print(text[shown:], end="", flush=True)
        shown = len(text)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
