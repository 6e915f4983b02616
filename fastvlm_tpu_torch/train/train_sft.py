"""The SFT training CLI: the port of ``fastvlm_tpu/train/train_sft.py``.

Wires: checkpoint / config load (or a random tiny model for dry runs) ->
dataset -> freeze policy -> Trainer loop with native save / resume. Runs on
the card unless ``--device cpu`` asks for the CPU; without a card the
default exits 1.

Parallel training (``parallel/``): ``--multihost`` joins the process group
from torchrun's env, ``--coordinator host:port`` (or a ``file://`` URL)
with ``--num-processes`` / ``--process-id`` from the flags; NCCL on the
card, gloo with ``--device cpu``. ``--tp``, ``--sp``, ``--pp-micro``,
``--zero1`` and ``--fsdp`` then lay the (data, model) mesh over the world's
ranks (a one-rank world is made when none is up), with JAX's divisibility
errors.

Examples:
  python -m fastvlm_tpu_torch.train.train_sft --random-tiny --device cpu \\
      --data-path data/sft.json --image-folder data/images \\
      --output-dir ckpts/run1 --batch-size 4 --max-steps 8
  torchrun --standalone --nproc-per-node 2 -m \\
      fastvlm_tpu_torch.train.train_sft --multihost --device cpu \\
      --random-tiny --data-path data/sft.json --tp 2 --sp
"""

from __future__ import annotations

import argparse
import logging
import sys


def tiny_config(image_aspect_ratio: str = "pad"):
    """The --random-tiny model: 128 px FastViTHD, a 2-layer 64-wide decoder
    over the byte tokenizer's 258 ids; anyres runs get a 128 px tile grid."""
    from fastvlm_tpu_torch.config import (
        FastViTConfig, FastVLMConfig, ProjectorConfig, Qwen2Config)

    vision = FastViTConfig(layers=(1, 1, 1, 1, 1),
                           embed_dims=(8, 16, 32, 64, 128),
                           image_size=128, attn_head_dim=16)
    decoder = Qwen2Config(vocab_size=258, hidden_size=64, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=16,
                          intermediate_size=128)
    pins = (((128, 256), (256, 128), (256, 256))
            if image_aspect_ratio == "anyres" else None)
    return FastVLMConfig(
        vision=vision, decoder=decoder,
        projector=ProjectorConfig(mm_hidden_size=vision.out_channels,
                                  hidden_size=64),
        image_aspect_ratio=image_aspect_ratio,
        image_grid_pinpoints=pins)


def main(argv=None):
    parser = argparse.ArgumentParser()
    # model
    parser.add_argument("--model-path", default=None)
    parser.add_argument("--random-tiny", action="store_true",
                        help="random tiny model (pipeline dry runs)")
    parser.add_argument("--dtype", default="float32")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where training runs (the JAX CLI's --platform)")
    # data
    parser.add_argument("--data-path", required=True)
    parser.add_argument("--image-folder", default=None)
    parser.add_argument("--image-aspect-ratio", default="pad")
    parser.add_argument("--conv-version", default="qwen_2")
    parser.add_argument("--max-len", type=int, default=2048)
    # training
    parser.add_argument("--output-dir", default="./checkpoints/run")
    parser.add_argument("--num-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=4)
    parser.add_argument("--learning-rate", type=float, default=2e-5)
    parser.add_argument("--warmup-ratio", type=float, default=0.03)
    parser.add_argument("--save-steps", type=int, default=500)
    parser.add_argument("--log-steps", type=int, default=10)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--group-by-modality-length", action="store_true")
    parser.add_argument("--tune-mm-mlp-adapter", action="store_true")
    parser.add_argument("--freeze-mm-mlp-adapter", action="store_true")
    parser.add_argument("--unfreeze-mm-vision-tower", action="store_true")
    parser.add_argument("--mm-projector-lr", type=float, default=None)
    parser.add_argument("--mm-vision-tower-lr", type=float, default=None)
    parser.add_argument("--lora-enable", action="store_true")
    parser.add_argument("--lora-r", type=int, default=8)
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--bits", type=int, default=None, choices=[4, 8],
                        help="QLoRA: freeze an int4/int8-quantized decoder "
                             "base under the LoRA adapters")
    # parallelism
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", action="store_true",
                        help="sequence-parallel activations (T over the "
                             "model axis)")
    parser.add_argument("--pp-micro", type=int, default=None,
                        help="pipeline-parallel decoder: stage layers over "
                             "the model axis (--tp = stages) and stream N "
                             "microbatches (GPipe)")
    parser.add_argument("--zero1", action="store_true",
                        help="shard optimizer state over the data axis")
    parser.add_argument("--fsdp", action="store_true",
                        help="fully shard params over the data axis")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group (torchrun's env)")
    parser.add_argument("--coordinator", default=None,
                        help="rendezvous host:port (or a tcp:// / file:// "
                             "URL) for an explicit launch")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not args.random_tiny and not args.model_path:
        parser.error("--model-path required (or use --random-tiny)")

    import torch
    import torch.distributed as dist

    from fastvlm_tpu_torch.parallel import distributed

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to train on "
              "the CPU", file=sys.stderr)
        return 1
    owned = not dist.is_initialized()
    try:
        if args.multihost or args.coordinator:
            distributed.initialize(args.coordinator, args.num_processes,
                                   args.process_id, device=args.device)
        return _train(parser, args)
    finally:
        if owned:
            distributed.shutdown()


def _train(parser, args) -> int:
    import torch
    import torch.distributed as dist

    from fastvlm_tpu_torch.config import resolve_dtype
    from fastvlm_tpu_torch.data.preprocessing import (
        ByteTokenizer, ImageProcessor)
    from fastvlm_tpu_torch.data.sft import DataArguments, SupervisedDataset
    from fastvlm_tpu_torch.models import vlm
    from fastvlm_tpu_torch.parallel import distributed, make_mesh
    from fastvlm_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
    from fastvlm_tpu_torch.train.trainer import Trainer, TrainingArguments

    if args.random_tiny:
        cfg = tiny_config(args.image_aspect_ratio)
        gen = torch.Generator()
        gen.manual_seed(0)
        params = vlm.init(gen, cfg)
        tokenizer = ByteTokenizer()
    else:
        # transformers is imported here only: the card's machine lacks it
        from transformers import AutoTokenizer

        from fastvlm_tpu_torch.utils.checkpoint import load_vlm

        cfg, params = load_vlm(args.model_path,
                               dtype=resolve_dtype(args.dtype))
        tokenizer = AutoTokenizer.from_pretrained(args.model_path)

    if args.pp_micro and args.tp <= 1:
        parser.error("--pp-micro needs --tp > 1 (stages on the model axis)")
    mesh = None
    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.tp > 1 or world > 1 or args.sp or args.zero1 or args.fsdp:
        # the parallel paths run over a process group, of one rank if need be
        distributed.initialize(num_processes=1, device=args.device)
        mesh = make_mesh(tp=args.tp)
        if args.pp_micro:
            if cfg.decoder.num_layers % args.tp:
                parser.error(f"--pp-micro needs num_layers "
                             f"({cfg.decoder.num_layers}) divisible by "
                             f"--tp ({args.tp}) stages")
            dp = axis_size(mesh, DATA_AXIS)
            if args.batch_size % args.pp_micro or \
                    (args.batch_size // args.pp_micro) % dp:
                parser.error(
                    f"--pp-micro: batch {args.batch_size} must split into "
                    f"{args.pp_micro} microbatches divisible by dp={dp}")

    data_args = DataArguments(
        data_path=args.data_path,
        image_folder=args.image_folder,
        image_aspect_ratio=args.image_aspect_ratio,
        image_grid_pinpoints=cfg.image_grid_pinpoints,
        conv_version=args.conv_version,
        max_len=args.max_len,
    )
    dataset = SupervisedDataset(
        data_args, tokenizer, ImageProcessor(cfg.vision.image_size))

    train_args = TrainingArguments(
        output_dir=args.output_dir,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        warmup_ratio=args.warmup_ratio,
        save_steps=args.save_steps,
        log_steps=args.log_steps,
        max_steps=args.max_steps,
        group_by_modality_length=args.group_by_modality_length,
        tune_mm_mlp_adapter=args.tune_mm_mlp_adapter,
        freeze_mm_mlp_adapter=args.freeze_mm_mlp_adapter,
        unfreeze_mm_vision_tower=args.unfreeze_mm_vision_tower,
        mm_projector_lr=args.mm_projector_lr,
        mm_vision_tower_lr=args.mm_vision_tower_lr,
        lora_enable=args.lora_enable,
        lora_r=args.lora_r,
        lora_alpha=args.lora_alpha,
        bits=args.bits,
        zero1=args.zero1,
        fsdp=args.fsdp,
    )
    trainer = Trainer(cfg, params, dataset, train_args, mesh=mesh,
                      pp_micro=args.pp_micro, seq_parallel=args.sp,
                      device=args.device)
    result = trainer.train()
    print(result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
