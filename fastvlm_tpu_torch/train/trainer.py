"""Training loop: batching, steps, checkpoints, resume.

The port of ``fastvlm_tpu/train/trainer.py``, with the same behaviour:
length / modality-grouped sampling, per-module learning rates and freeze
routing (``train/step.py``), LoRA and QLoRA (``train/lora.py``), auto-resume
from the latest ``checkpoint-{step}`` directory, and adapter-only
checkpoints when only the projector trains. The checkpoint layout is JAX's
(``checkpoint-{step}/{params,opt_state,mm_projector,lora_adapters}``), each
written with ``utils/checkpoint.save_native`` instead of Orbax. Everything
runs on ``device`` ("cuda" unless the caller asks for the CPU).

Parallel training (``parallel/``): with a ``mesh`` (``make_mesh`` over an
initialized process group) every rank draws the same global batch from the
same seeded sampler and keeps its data rank's rows [r B/dp, (r+1) B/dp), so
a data-parallel run trains on JAX's batches. The params are split by a
layout (``parallel/sharding.py``): Megatron TP over "model" by default,
FSDP over "data" with ``fsdp``, the decoder's layers staged over "model"
with ``pp_micro`` (GPipe microbatches, ``train_step_pp``); ``seq_parallel``
adds sequence parallelism to TP and ``zero1`` slices the Adam moments over
"data". LoRA / QLoRA under a mesh train data-parallel, every leaf whole.
Checkpoints hold whole tensors in the one-process layout, written by the
primary rank only, so a run resumes under any layout.

The reference's gaps are kept as they are: a resumed run starts the
sampler at epoch 0 again (it re-reads batches it trained on), LoRA and
adapter-only checkpoints carry no optimizer state, and the LoRA optimizer
takes a constant learning rate (``warmup_ratio`` is ignored).

``history`` records each step's host data ms, real tokens, the loss where
it was read (every ``log_steps``) and a ``perf_counter`` stamp after it.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

import torch.distributed as dist

from fastvlm_tpu_torch.config import FastVLMConfig
from fastvlm_tpu_torch.data.sft import SupervisedDataset, collate
from fastvlm_tpu_torch.parallel import sharding
from fastvlm_tpu_torch.parallel.distributed import is_primary
from fastvlm_tpu_torch.parallel.mesh import (
    DATA_AXIS, axis_size, data_sharding, seq_sharding)
from fastvlm_tpu_torch.train import step as step_mod
from fastvlm_tpu_torch.train.sampler import LengthGroupedSampler
from fastvlm_tpu_torch.utils.checkpoint import restore_native, save_native
from fastvlm_tpu_torch.utils.convert import to_device

logger = logging.getLogger(__name__)


@dataclass
class TrainingArguments:
    output_dir: str = "./checkpoints/run"
    num_epochs: int = 1
    batch_size: int = 4
    learning_rate: float = 2e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    save_steps: int = 500
    log_steps: int = 10
    seed: int = 0
    lora_enable: bool = False
    lora_r: int = 8
    lora_alpha: float = 16.0
    bits: Optional[int] = None  # 4/8: a frozen quantized base under LoRA
    zero1: bool = False  # shard optimizer state over the data axis
    fsdp: bool = False  # shard params over the data axis (with a mesh)
    group_by_modality_length: bool = False
    tune_mm_mlp_adapter: bool = False   # adapter-only training + checkpoints
    freeze_mm_mlp_adapter: bool = False
    unfreeze_mm_vision_tower: bool = False
    mm_projector_lr: Optional[float] = None
    mm_vision_tower_lr: Optional[float] = None
    grad_clip: float = 1.0
    max_steps: Optional[int] = None


def batches(dataset: SupervisedDataset, sampler: LengthGroupedSampler,
            batch_size: int, num_image_tokens: int,
            cfg=None) -> Iterator[Dict[str, np.ndarray]]:
    if cfg is not None and getattr(dataset, "_anyres", False):
        yield from _anyres_batches(dataset, sampler, batch_size, cfg)
        return
    buf: List[Any] = []
    for idx in sampler:
        buf.append(dataset[idx])
        if len(buf) == batch_size:
            yield collate(buf, num_image_tokens)
            buf = []
    # the ragged tail is dropped, as in JAX


def _anyres_batches(dataset: SupervisedDataset, sampler, batch_size: int,
                    cfg) -> Iterator[Dict[str, np.ndarray]]:
    """Grid-uniform anyres batching: samples bucket by (grid_shape,
    crop_box), read from the image header, so each batch stacks its tiles
    into one (B, T, S, S, 3) array; ragged per-grid tails are dropped."""
    from fastvlm_tpu_torch.models.vlm import anyres_crop_box

    buckets: dict = {}
    for idx in sampler:
        grid_shape, original_size = dataset.anyres_meta(idx)
        key = (grid_shape, anyres_crop_box(cfg, grid_shape, original_size))
        buf = buckets.setdefault(key, [])
        buf.append(idx)
        if len(buf) == batch_size:
            yield collate([dataset[i] for i in buf], cfg.num_image_tokens,
                          cfg=cfg)
            buckets[key] = []


def _copy_into(dst, src) -> None:
    """Copy a restored tree into the live one leaf by leaf (the live leaves
    keep their identity, device and requires_grad)."""
    with torch.no_grad():
        for (_, d), (_, s) in zip(step_mod.named_leaves(dst),
                                  step_mod.named_leaves(src)):
            d.copy_(s)


class Trainer:
    def __init__(self, cfg: FastVLMConfig, params: Any,
                 dataset: SupervisedDataset, args: TrainingArguments,
                 mesh=None, pp_micro=None, seq_parallel=False,
                 device="cuda"):
        cfg.decoder.require_uniform("training")
        self.cfg = cfg
        self.args = args
        self.dataset = dataset
        self.device = torch.device(device)
        self.history: List[Dict[str, Any]] = []
        self.mesh = mesh
        # the parallel schedule: pipeline microbatches (the decoder staged
        # over the model axis) or sequence-parallel activations
        self.pp_micro = pp_micro
        self._seq_sharding = None
        if pp_micro and mesh is None:
            raise ValueError("pp_micro stages the decoder over a mesh's "
                             "model axis: pass mesh=")
        if mesh is not None:
            dp = axis_size(mesh, DATA_AXIS)
            if args.batch_size % dp:
                raise ValueError(f"batch {args.batch_size} not divisible "
                                 f"by dp={dp}")
            if seq_parallel:
                self._seq_sharding = seq_sharding(mesh)

        steps_per_epoch = len(dataset) // args.batch_size
        total = args.max_steps or max(steps_per_epoch * args.num_epochs, 1)
        self.total_steps = total

        if args.bits and not args.lora_enable:
            raise ValueError("--bits trains a frozen quantized base and "
                             "needs --lora-enable (QLoRA); a full fine-tune "
                             "of int weights is not meaningful")
        params = to_device(params, self.device)
        if args.lora_enable:
            from fastvlm_tpu_torch.train import lora

            params = dict(params)
            dec = params["decoder"]
            if args.bits:
                # QLoRA: int8/int4 frozen base (embeddings, norms and the
                # LM head stay float)
                from fastvlm_tpu_torch.ops.quant import quantize_decoder

                dec = quantize_decoder(dec, bits=args.bits, skip=("lm_head",))
            gen = torch.Generator(device=self.device)
            gen.manual_seed(args.seed)
            params["decoder"] = lora.add_lora(
                dec, gen, r=args.lora_r, alpha=args.lora_alpha,
                cfg=cfg.decoder)
            self.tx = lora.make_lora_optimizer(
                params, lr=args.learning_rate,
                weight_decay=args.weight_decay, grad_clip=args.grad_clip)
        else:
            self.tx = step_mod.make_optimizer(
                args.learning_rate,
                weight_decay=args.weight_decay,
                warmup_steps=int(args.warmup_ratio * total),
                total_steps=total,
                projector_lr=(None if args.freeze_mm_mlp_adapter
                              else args.mm_projector_lr),
                vision_lr=(None if args.freeze_mm_mlp_adapter
                           else args.mm_vision_tower_lr),
                freeze_vision=not args.unfreeze_mm_vision_tower,
                freeze_decoder=args.tune_mm_mlp_adapter,
                freeze_projector=args.freeze_mm_mlp_adapter,
                grad_clip=args.grad_clip,
            )
        layout = None
        if mesh is not None:
            layout = self._layout(params, mesh)
            params = layout.shard(params)
        self.state = step_mod.make_train_state(params, self.tx, layout)
        if args.zero1 and mesh is not None:
            self.state = self.state._replace(
                opt_state=sharding.shard_opt_state_zero1(
                    self.state.opt_state, mesh, layout))
        self.sampler = LengthGroupedSampler(
            dataset.modality_lengths if args.group_by_modality_length
            else dataset.lengths,
            args.batch_size,
            group_by_modality=args.group_by_modality_length,
            seed=args.seed,
        )

    def _layout(self, params, mesh) -> sharding.Layout:
        if self.pp_micro:
            from fastvlm_tpu_torch.parallel.pipeline import stage_layout

            return stage_layout(params, mesh)
        if self.args.fsdp:
            return sharding.fsdp_layout(params, mesh)
        if self.args.lora_enable:
            return sharding.replicated_layout(params, mesh)
        return sharding.tp_layout(params, self.cfg, mesh)

    # ---------------- checkpointing ----------------

    def _whole(self, tree, prefix=""):
        """The whole tree of a local one (collective under a mesh)."""
        layout = self.state.layout
        return tree if layout is None else layout.gather(tree, prefix)

    def _whole_opt_state(self, whole_params) -> Dict[str, Any]:
        """The optimizer state in the one-process layout (collective)."""
        opt, layout = self.state.opt_state, self.state.layout
        if layout is None:
            return opt
        params = dict(step_mod.named_leaves(self.state.params))
        out = {"count": opt["count"]}
        order = [p for p, _ in step_mod.named_leaves(whole_params)]
        for key in ("mu", "nu"):
            got = layout.gather_moments(opt[key], params)
            out[key] = {p: got[p] for p in order if p in got}
        return out

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(os.path.abspath(self.args.output_dir),
                            f"checkpoint-{step}")

    def latest_checkpoint(self) -> Optional[str]:
        out = os.path.abspath(self.args.output_dir)
        if not os.path.isdir(out):
            return None
        steps = []
        for d in os.listdir(out):
            if d.startswith("checkpoint-") and d[11:].isdigit():
                steps.append(int(d[11:]))
        return self._ckpt_dir(max(steps)) if steps else None

    def save(self, step: int) -> None:
        """Write ``checkpoint-{step}``: whole tensors in the one-process
        layout, by the primary rank (every rank joins the gathers)."""
        path = self._ckpt_dir(step)
        params = self.state.params
        if self.args.lora_enable:
            from fastvlm_tpu_torch.train import lora

            # LoRA split save (reference train_qwen.py:1232-1242)
            self._write(os.path.join(path, "lora_adapters"),
                        lora.split_lora_state(self._whole(params)["decoder"]))
            logger.info("saved LoRA adapters %s", path)
            return
        if self.args.tune_mm_mlp_adapter:
            # adapter-only checkpoint (reference llava_trainer.py:244-265)
            self._write(os.path.join(path, "mm_projector"),
                        self._whole(params["projector"], "projector"))
        else:
            whole = self._whole(params)
            self._write(os.path.join(path, "params"), whole)
            # full checkpoints also carry the optimizer state, so a resume
            # continues the schedule and the moments
            self._write(os.path.join(path, "opt_state"),
                        self._whole_opt_state(whole))
        logger.info("saved checkpoint %s", path)

    def _write(self, path: str, tree) -> None:
        if is_primary():
            save_native(path, tree)
        if self.state.layout is not None:
            dist.barrier()

    def _restore(self, path: str, live, prefix=""):
        """Copy the whole tree under ``path`` into the live (local) one."""
        layout = self.state.layout
        if layout is None:
            _copy_into(live, restore_native(path, live))
        else:
            _copy_into(live, layout.shard(restore_native(path), prefix))

    def resume(self) -> int:
        """Auto-resume from the latest checkpoint-* (reference
        train_qwen.py:1224-1227); returns its step, 0 without one. Any
        layout resumes any checkpoint: they hold whole tensors."""
        path = self.latest_checkpoint()
        if path is None:
            return 0
        step = int(os.path.basename(path).split("-")[1])
        params = self.state.params
        if self.args.lora_enable:
            from fastvlm_tpu_torch.train import lora

            like = lora.split_lora_state(params["decoder"])
            _copy_into(like, restore_native(
                os.path.join(path, "lora_adapters"), like))
        elif self.args.tune_mm_mlp_adapter:
            self._restore(os.path.join(path, "mm_projector"),
                          params["projector"], "projector")
        else:
            self._restore(os.path.join(path, "params"), params)
            opt_path = os.path.join(path, "opt_state")
            if os.path.isdir(opt_path):
                self._restore_opt_state(opt_path)
        self.state = self.state._replace(step=step)
        logger.info("resumed from %s (step %d)", path, step)
        return step

    def _restore_opt_state(self, path: str) -> None:
        live, layout = self.state.opt_state, self.state.layout
        if layout is None:
            _copy_into(live, restore_native(path, live))
            return
        whole = restore_native(path)
        _copy_into(live, {"count": whole["count"], **{
            k: layout.shard_moments(whole[k], live[k]) for k in ("mu", "nu")}})

    # ---------------- loop ----------------

    def _to_device(self, batch: Dict[str, np.ndarray]):
        """A global batch on the device; under a mesh, this data rank's rows
        [r B/dp, (r+1) B/dp) of it."""
        rows = (lambda x: x) if self.mesh is None else \
            data_sharding(self.mesh).local
        return {k: rows(torch.from_numpy(v)).to(self.device,
                                                non_blocking=True)
                for k, v in batch.items()}

    def train(self) -> Dict[str, float]:
        args = self.args
        start_step = self.resume()
        step = start_step
        last_loss = float("nan")
        loss = None
        t0 = time.time()
        # with max_steps set, keep cycling epochs until the step budget is
        # spent (the reference's HF Trainer max_steps semantics)
        epoch = 0
        while step < self.total_steps:
            if args.max_steps is None and epoch >= args.num_epochs:
                break
            epoch += 1
            it = batches(self.dataset, self.sampler, args.batch_size,
                         self.cfg.num_image_tokens, cfg=self.cfg)
            while step < self.total_steps:
                t_data = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    break
                # the anyres merge meta is not batch data
                anyres = batch.pop("_anyres", None)
                tokens = int(batch["attn_lens"].sum())
                data_ms = (time.perf_counter() - t_data) * 1e3
                batch = self._to_device(batch)
                if self.pp_micro:
                    if anyres is not None:
                        raise ValueError(
                            "anyres training composes with dp/tp/sp but not "
                            "--pp-micro (loss_fn_pp has no tile path); drop "
                            "--pp-micro or use image_aspect_ratio=pad")
                    self.state, loss = step_mod.train_step_pp(
                        self.state, self.cfg, self.tx, batch, self.mesh,
                        self.pp_micro)
                else:
                    self.state, loss = step_mod.train_step(
                        self.state, self.cfg, self.tx, batch,
                        seq_sharding=self._seq_sharding, anyres=anyres)
                step += 1
                read = None
                if step % args.log_steps == 0 or step == self.total_steps:
                    read = last_loss = float(loss)
                    logger.info("step %d/%d loss %.4f (%.2f s/step)",
                                step, self.total_steps, last_loss,
                                (time.time() - t0) / max(step - start_step, 1))
                self.history.append({"step": step, "loss": read,
                                     "data_ms": data_ms, "tokens": tokens,
                                     "t": time.perf_counter()})
                if args.save_steps and step % args.save_steps == 0:
                    self.save(step)
        if np.isnan(last_loss) and step > start_step:
            last_loss = float(loss)
        self.save(step)
        return {"final_loss": last_loss, "steps": step}
