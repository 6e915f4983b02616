"""Register a worker with the controller by hand (the reference's
llava/serve/register_worker.py): reads the worker's status and posts it to
the controller.

    python -m fastvlm_tpu_torch.serve.register_worker \
        --controller-address http://localhost:10000 \
        --worker-name http://localhost:40000
"""

from __future__ import annotations

import argparse

import requests


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", required=True)
    parser.add_argument("--worker-name", required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args(argv)

    r = requests.post(args.worker_name + "/worker_get_status", timeout=60)
    requests.post(args.controller_address + "/register_worker", json={
        "worker_name": args.worker_name,
        "check_heart_beat": args.check_heart_beat,
        "worker_status": r.json(),
    }, timeout=60)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
