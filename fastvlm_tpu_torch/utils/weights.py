"""Weight distribution utilities: delta make / apply and consolidation.

Counterpart of ``fastvlm_tpu/utils/weights.py`` (the reference's
make_delta.py, apply_delta.py and consolidate.py), over the port's native
bundles (``utils/checkpoint.save_native``). A leaf whose shape or dtype
differs between base and target (an embedding grown by added tokens) is
stored whole in the delta, and taken whole back; every other leaf is
target - base, computed in float32 and cast to the leaf's dtype, as in JAX.

CLI (the JAX commands and flags, plus ``--device``, the card by default):
  python -m fastvlm_tpu_torch.utils.weights make-delta --base B --target T --delta D
  python -m fastvlm_tpu_torch.utils.weights apply-delta --base B --delta D --target T
  python -m fastvlm_tpu_torch.utils.weights consolidate --src DIR --dst DIR
"""

from __future__ import annotations

import argparse
from typing import Any

import torch

from fastvlm_tpu_torch.utils.checkpoint import (
    _map_tree, restore_native, save_native)


def _zip_tree(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_tree(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_tree(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype


def make_delta(base: Any, target: Any) -> Any:
    """delta = target - base per leaf; shape- or dtype-mismatched leaves are
    the target's, whole."""
    return _zip_tree(
        lambda b, t: (t.float() - b.float()).to(t.dtype) if _same(b, t) else t,
        base, target)


def apply_delta(base: Any, delta: Any) -> Any:
    """target = base + delta per leaf; a mismatched leaf is the delta's
    (stored whole)."""
    return _zip_tree(
        lambda b, d: (b.float() + d.float()).to(d.dtype) if _same(b, d) else d,
        base, delta)


def consolidate(params: Any) -> Any:
    """Every leaf gathered to host memory: a single-copy CPU tree (the
    reference consolidate.py)."""
    return _map_tree(lambda t: t.detach().cpu(), params)


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in ("make-delta", "apply-delta"):
        p = sub.add_parser(name)
        p.add_argument("--base", required=True)
        p.add_argument("--target", required=True)
        p.add_argument("--delta", required=True)
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    pc = sub.add_parser("consolidate")
    pc.add_argument("--src", required=True)
    pc.add_argument("--dst", required=True)
    pc.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.exit(1, "weights: no CUDA device is available; pass "
                       "--device cpu to run on the CPU\n")

    dev = args.device
    if args.cmd == "make-delta":
        base = restore_native(args.base, device=dev)
        target = restore_native(args.target, device=dev)
        save_native(args.delta, make_delta(base, target))
    elif args.cmd == "apply-delta":
        base = restore_native(args.base, device=dev)
        delta = restore_native(args.delta, device=dev)
        save_native(args.target, apply_delta(base, delta))
    else:
        src = restore_native(args.src, device=dev)
        save_native(args.dst, consolidate(src))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
