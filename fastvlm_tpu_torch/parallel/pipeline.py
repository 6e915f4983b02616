"""Pipeline parallelism (GPipe schedule) over the decoder's layers: the port
of ``fastvlm_tpu/parallel/pipeline.py``.

The port's decoder keeps its layers in a list, so staging is slicing it:
rank s of the mesh's "model" axis holds layers [s L/S, (s+1) L/S) (S stages,
``stage_specs`` / ``shard_decoder_pipeline``); everything else is whole on
every rank. Microbatches stream through the stages as in JAX:

    step t:  stage s applies its layers to microbatch (t - s), then the
             activations move one stage forward (``collectives.shift``,
             point-to-point sends whose backward sends the gradient back).

Like JAX's SPMD program, every stage computes at every one of the M + S - 1
steps (off-schedule slots compute on zeros and are discarded through
``torch.where``), so each rank's autograd graph holds every send and its
backward issues every matching send in the same order. The last stage's
outputs reach every rank through a differentiable broadcast; the final norm
and the loss then run alike on every rank. The microbatches enter through
Megatron's f (``copy_to``): only stage 0 uses them, and the all-reduce of
their gradient brings stage 0's to every rank.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from fastvlm_tpu_torch.config import Qwen2Config
from fastvlm_tpu_torch.models import qwen2
from fastvlm_tpu_torch.parallel import collectives as coll
from fastvlm_tpu_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_size
from fastvlm_tpu_torch.parallel.sharding import Layout, _named

STAGED = (MODEL_AXIS,)


def stage_specs(params: Dict[str, Any]) -> Dict[str, Any]:
    """Specs of a decoder tree with its layers staged over "model": the
    layer list is split (``STAGED``), every other leaf whole (``()``)."""
    specs = {k: {p: () for p, _ in _named(v)} if isinstance(v, dict) else ()
             for k, v in params.items() if k != "layers"}
    specs["layers"] = STAGED
    return specs


def stage_layout(params: Dict[str, Any], mesh) -> Layout:
    """The layout of a whole VLM tree whose decoder layers are staged over
    the mesh's "model" axis (``Layout.staged``)."""
    n = len(params["decoder"]["layers"])
    stages = axis_size(mesh, MODEL_AXIS)
    if n % stages:
        raise ValueError(f"{n} layers not divisible by {stages} stages")
    return Layout(mesh, {p: () for p, _ in _named(params)}, staged=True,
                  num_layers=n)


def shard_decoder_pipeline(params: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's stage of a decoder tree: its block of layers, the other
    leaves whole."""
    return stage_layout({"decoder": params}, mesh).shard(
        {"decoder": params})["decoder"]


def forward_pipelined(
    params: Dict[str, Any],
    cfg: Qwen2Config,
    embeds: torch.Tensor,     # (M, b, T, D) microbatched inputs
    positions: torch.Tensor,  # (M, b, T)
    mask: torch.Tensor,       # (M, b, T, T) bool
    mesh,
    remat: bool = True,
) -> torch.Tensor:
    """GPipe forward over the mesh's "model" axis on this rank's stage of
    the decoder (``shard_decoder_pipeline``); returns the (M, b, T, D)
    final hidden states (after the final norm) on every rank. The rows b
    are this data rank's. ``remat`` recomputes each stage in the
    backward."""
    group = axis_group(mesh, MODEL_AXIS)
    n_stages, s = coll.size(group), coll.rank(group)
    m = embeds.shape[0]
    layers = params["layers"]

    def stage_apply(x, pos, msk):
        cos, sin, bias, msk4 = qwen2.pos_terms(cfg, pos, msk)
        for lp in layers:
            x = qwen2._layer(x, lp, cfg, cos, sin, None, None, msk4, None,
                             True, bias, window=cfg.attn_window,
                             positions=pos)
        return x

    emb = coll.copy_to(embeds, group)
    first = torch.tensor(s == 0, device=emb.device)
    last = torch.tensor(s == n_stages - 1, device=emb.device)
    zeros = torch.zeros_like(emb[0])
    state = zeros
    outs = [None] * m
    for step in range(m + n_stages - 1):
        inject = emb[step] if step < m else zeros
        x_in = torch.where(first, inject, state)
        # stage s holds microbatch (step - s); off-schedule slots compute on
        # zeros or a neighbour's garbage and are never collected
        mb = min(max(step - s, 0), m - 1)
        if remat and torch.is_grad_enabled():
            x_out = torch.utils.checkpoint.checkpoint(
                stage_apply, x_in, positions[mb], mask[mb],
                use_reentrant=False)
        else:
            x_out = stage_apply(x_in, positions[mb], mask[mb])
        done = step - (n_stages - 1)
        if 0 <= done < m:
            outs[done] = torch.where(last, x_out, zeros)
        if step < m + n_stages - 2:
            state = coll.shift(x_out, group)
    out = coll.broadcast(torch.stack(outs),
                         dist.get_global_rank(group, n_stages - 1), group)
    return qwen2._norm(out, params["final_norm"], cfg)
