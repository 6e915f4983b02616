"""Model export: a traced vision encoder and quantized serving bundles.

Counterpart of ``fastvlm_tpu/export.py``, with its functions, files and
CLI:

  * ``export_vision_encoder``: the JAX package serializes the jitted
    FastViTHD encoder as StableHLO; the port traces it with
    ``torch.export.export`` and writes the program with
    ``torch.export.save`` (``fastvithd.pt2``), beside the same metadata
    sidecars (``write_metadata``) and the tower's weights as a native bundle
    (``vision_params``, ``utils/checkpoint.save_native``). The program is a
    function of (params, images), as the JAX one. JAX exports the XLA FFN
    (``ffn_backend="xla"``); the port exports the path it runs: kernel K1,
    one ``fastvlm::fused_ffn`` op per FFN (``ops/cuda/ffn.py``), which
    launches the kernel when the program runs on the card. Loading needs
    that op registered, i.e. ``fastvlm_tpu_torch.ops.cuda.ffn`` imported
    (``load_exported_encoder`` imports it).
  * ``quantize_checkpoint``: the decoder's linears to int8 / int4
    (``ops/quant.quantize_decoder``), the whole tree saved as a native
    bundle (``params``) with ``quantization.json``.

CLI (the JAX commands and flags, plus ``--device``, the card by default):
  python -m fastvlm_tpu_torch.export vision --model-path CKPT --output DIR
  python -m fastvlm_tpu_torch.export quantize --model-path CKPT --bits 8 --output DIR
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def write_metadata(output_dir: str, image_size: int, patch_size: int = 64):
    """The sidecar configs of the reference exporter, as the JAX package
    writes them."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "preprocessor_config.json"), "w") as f:
        json.dump({
            "crop_size": {"height": image_size, "width": image_size},
            "size": {"shortest_edge": image_size},
            "image_mean": [0.0, 0.0, 0.0],
            "image_std": [1.0, 1.0, 1.0],
            "do_normalize": True,
            "do_resize": True,
            "do_center_crop": True,
            "do_rescale": True,
            "rescale_factor": 1.0 / 255,
            "image_processor_type": "CLIPImageProcessor",
            "processor_class": "LlavaProcessor",
        }, f, indent=2)
    with open(os.path.join(output_dir, "processor_config.json"), "w") as f:
        json.dump({
            "image_token": "<image>",
            "num_additional_image_tokens": 0,
            "patch_size": patch_size,
            "processor_class": "LlavaProcessor",
        }, f, indent=2)


class _Encoder(torch.nn.Module):
    """(params, images) -> FastViTHD features, the function exported."""

    def __init__(self, vcfg):
        super().__init__()
        self.vcfg = vcfg

    def forward(self, params, images):
        from fastvlm_tpu_torch.models import fastvit

        return fastvit.apply(params, images, self.vcfg)


def export_vision_encoder(cfg, vision_params, output_dir: str,
                          batch: int = 1) -> str:
    """Trace the FastViTHD encoder at (batch, S, S, 3) images of the tower's
    compute dtype, on the device of ``vision_params``, and write the
    program, the sidecars and the weights. Returns the program's path."""
    from fastvlm_tpu_torch.config import resolve_dtype
    from fastvlm_tpu_torch.utils.checkpoint import save_native

    vcfg = cfg.vision
    leaf = vision_params["stem"][0]["w"]
    images = torch.zeros((batch, vcfg.image_size, vcfg.image_size, 3),
                         dtype=resolve_dtype(vcfg.compute_dtype),
                         device=leaf.device)
    with torch.no_grad():
        program = torch.export.export(_Encoder(vcfg), (vision_params, images))
    # the program keeps its example inputs, the weights among them; they
    # are saved apart (vision_params), so the program is the graph alone
    program.example_inputs = None
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, "fastvithd.pt2")
    torch.export.save(program, path)
    write_metadata(output_dir, vcfg.image_size, vcfg.total_stride)
    save_native(os.path.join(output_dir, "vision_params"), vision_params)
    return path


def load_exported_encoder(path: str):
    """Load a ``.pt2`` program and return a callable (params, images) ->
    features. Imports the module that registers ``fastvlm::fused_ffn``."""
    import fastvlm_tpu_torch.ops.cuda.ffn  # noqa: F401  (registers the op)

    return torch.export.load(path).module()


def quantize_checkpoint(cfg, params, bits: int, output_dir: str) -> None:
    """Quantize the decoder (weight-only, per output channel) and save the
    whole tree as a native serving bundle, with quantization.json."""
    from fastvlm_tpu_torch.ops.quant import quantize_decoder
    from fastvlm_tpu_torch.utils.checkpoint import save_native

    qparams = dict(params)
    qparams["decoder"] = quantize_decoder(params["decoder"], bits)
    os.makedirs(output_dir, exist_ok=True)
    save_native(os.path.join(output_dir, "params"), qparams)
    with open(os.path.join(output_dir, "quantization.json"), "w") as f:
        json.dump({"bits": bits, "scheme": "weight-only per-channel",
                   "quantized": ["decoder.layers.*", "decoder.lm_head"]}, f)


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    pv = sub.add_parser("vision")
    pv.add_argument("--model-path", required=True)
    pv.add_argument("--output", required=True)
    pv.add_argument("--batch", type=int, default=1)
    pv.add_argument("--dtype", default="float32")
    pv.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    pq = sub.add_parser("quantize")
    pq.add_argument("--model-path", required=True)
    pq.add_argument("--output", required=True)
    pq.add_argument("--bits", type=int, default=8, choices=[4, 8])
    pq.add_argument("--dtype", default="float32")
    pq.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        parser.exit(1, "export: no CUDA device is available; pass "
                       "--device cpu to run on the CPU\n")
    from fastvlm_tpu_torch.config import resolve_dtype
    from fastvlm_tpu_torch.engine import _with_dtype
    from fastvlm_tpu_torch.utils.checkpoint import load_vlm
    from fastvlm_tpu_torch.utils.convert import to_device

    cfg, params = load_vlm(args.model_path, dtype=resolve_dtype(args.dtype))
    cfg = _with_dtype(cfg, args.dtype)
    params = to_device(params, args.device)
    if args.cmd == "vision":
        path = export_vision_encoder(cfg, params["vision"], args.output,
                                     args.batch)
        print(f"exported {path}")
    else:
        quantize_checkpoint(cfg, params, args.bits, args.output)
        print(f"quantized ({args.bits}-bit) -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
