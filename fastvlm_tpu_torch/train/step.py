"""SFT training step: multimodal forward + masked CE loss + AdamW update.

The port of ``fastvlm_tpu/train/step.py``. ``loss_fn`` is the same forward
(the image splice, the decoder without a cache, the LM head) and the same
token-mean cross entropy; ``train_step`` runs it, backpropagates, and
applies the optimizer in place (the JAX step donates its state).

The optimizer mirrors the JAX package's optax chain per parameter group:
``optax.multi_transform`` over ``chain(clip_by_global_norm(c),
adamw(schedule))`` for each trained group and ``set_to_zero`` for each
frozen one. Written out rather than ``torch.optim.AdamW`` because of where
the two differ:

  * the clip is per group (each group's own global norm), and optax scales
    by ``max_norm / norm`` only when ``norm >= max_norm``
    (``clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)`` always);
  * the learning rate is the schedule at the update count *before* the
    update, so a warmup's first step has lr 0;
  * the update is ``m_hat / (sqrt(v_hat) + eps)`` plus decoupled weight
    decay ``wd * p`` on every trained leaf (biases and norms too), scaled
    by ``-lr``, with the moments kept in each parameter's dtype.

Frozen groups take no gradient (``requires_grad`` False) and hold no
optimizer state; integer leaves (a QLoRA base) never take one. The state
is ``{"count": int32 0-d, "mu": {path: tensor}, "nu": {path: tensor}}``
keyed by the leaf paths of ``named_leaves`` ("decoder/layers/0/q/w").

Parallel training (``parallel/``): a state made with a ``Layout`` holds
each rank's pieces of the params and moments. ``loss_fn(layout=)`` runs the
tensor-parallel forward (``qwen2.forward``'s ``group``; with ``seq_sharding``
sequence-parallel, the bucket padded to a multiple of tp), gathers FSDP
leaves at use, and divides each data rank's NLL sum by the global count of
label tokens, so the gradients summed over "data" are JAX's token mean over
the global batch. ``AdamW.update`` then sums the gradients over "data",
clips each group by the norm of the whole gradient, and under ZeRO-1
updates the rank's slice of each param and all-gathers it.
``loss_fn_pp`` / ``train_step_pp`` stage the decoder's layers over "model"
(``parallel/pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from fastvlm_tpu_torch.config import FastVLMConfig
from fastvlm_tpu_torch.models import qwen2, vlm
from fastvlm_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, axis_group, axis_size, local_chunk)
from fastvlm_tpu_torch.parallel.sharding import replicated_layout

IGNORE_INDEX = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  data_group=None) -> torch.Tensor:
    """Token-mean CE over positions where label != IGNORE_INDEX; a batch
    with every label ignored has loss 0 (the count is at least 1).

    logits: (B, T, V) float; labels: (B, T) int (already shifted). With
    ``data_group`` the rows are one data rank's: the NLL sum is divided by
    the count summed over the group, so the ranks' losses add up to the
    global batch's mean."""
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, torch.zeros_like(labels)).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    count = mask.sum()
    if data_group is not None:
        dist.all_reduce(count, group=data_group)
    return nll.sum() / count.clamp(min=1)


def loss_fn(
    params: Any,
    cfg: FastVLMConfig,
    batch: Dict[str, torch.Tensor],
    remat: bool = True,
    seq_sharding=None,
    anyres=None,
    layout=None,
) -> torch.Tensor:
    """batch: images (B, H, W, 3) | absent, ids (B, T), labels (B, T),
    image_starts (B,), attn_lens (B,), tensors on the params' device.

    anyres: (grid_shape, crop_box) of a grid-uniform anyres batch, which
    carries ``tiles`` (B, T, S, S, 3): the tower runs once over the B*T
    tiles and each row's grids merge on their own. ``remat`` recomputes
    each decoder layer in the backward pass.

    layout: the ``parallel.sharding.Layout`` of a sharded ``params`` (this
    rank's pieces; the batch holds this data rank's rows). seq_sharding:
    ``parallel.mesh.seq_sharding(mesh)`` for sequence parallelism (with
    unsharded params when no layout is given)."""
    cfg.decoder.require_uniform("training")
    if layout is None and seq_sharding is not None:
        layout = replicated_layout(params, seq_sharding.mesh)
    mg = dg = None
    if layout is not None:
        mg = axis_group(layout.mesh, MODEL_AXIS)
        dg = axis_group(layout.mesh, DATA_AXIS)
    seq = seq_sharding is not None
    ids, labels = batch["ids"], batch["labels"]
    if seq and ids.shape[1] % axis_size(layout.mesh, MODEL_AXIS):
        # T splits over "model": pad the bucket; the padding is masked out
        # as keys (attn_lens) and carries no label
        pad = -ids.shape[1] % axis_size(layout.mesh, MODEL_AXIS)
        ids = torch.nn.functional.pad(ids, (0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad),
                                         value=IGNORE_INDEX)
    gather = None
    if layout is not None:
        # FSDP leaves are gathered where they are used: the tower and
        # projector here, each decoder layer inside its (rematerialized)
        # forward
        dec = params["decoder"]
        params = {k: layout.materialize(v, k) for k, v in params.items()
                  if k != "decoder"}
        params["decoder"] = {
            **layout.materialize({k: v for k, v in dec.items()
                                  if k != "layers"}, "decoder"),
            "layers": dec["layers"]}
        gather = lambda i, lp: layout.materialize(  # noqa: E731
            lp, f"decoder/layers/{i}")
    dec = params["decoder"]
    embeds = vlm._spliced_prompt_embeds(
        params, cfg, batch.get("images"), ids, batch["image_starts"],
        vision_embeds=_vision_embeds(params, cfg, batch, anyres),
        text=qwen2.embed(dec, ids, cfg.decoder, mg))
    b, t, _ = embeds.shape
    positions = torch.arange(t, device=ids.device)[None].expand(b, t)
    # causal mask restricted to real tokens (right padding)
    mask = qwen2.prefill_mask(batch["attn_lens"], t, t)
    hidden, _ = qwen2.forward(dec, cfg.decoder, embeds, positions, mask=mask,
                              remat=remat, group=mg, seq=seq, gather=gather)
    logits = qwen2.logits_from_hidden(dec, hidden, cfg.decoder, mg)
    # next-token prediction: logits[t] predicts labels[t+1]
    return cross_entropy(logits[:, :-1], labels[:, 1:], dg)


def _vision_embeds(params, cfg, batch, anyres):
    if anyres is None:
        return None
    grid_shape, crop_box = anyres
    tiles = batch["tiles"]
    b, t = tiles.shape[:2]
    grids = vlm.encode_tile_grids(
        params, cfg, tiles.reshape((b * t,) + tuple(tiles.shape[2:])))
    grids = grids.reshape((b, t) + tuple(grids.shape[1:]))
    return torch.stack([
        vlm.merge_tile_grids(params, cfg, g, grid_shape, crop_box)[0]
        for g in grids])


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) over nested dicts and lists, paths joined by "/"."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))


def map_leaves(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The tree rebuilt with ``fn(path, leaf)`` at every leaf."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, f"{prefix}/{i}" if prefix
                                     else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def warmup_cosine_schedule(peak: float, warmup_steps: int,
                           decay_steps: int) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)
    with end value 0: linear from 0 over ``warmup_steps``, then a cosine to
    0 over the remaining ``decay_steps - warmup_steps``."""
    cosine = cosine_schedule(peak, decay_steps - warmup_steps)

    def lr(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        return cosine(count - warmup_steps)

    return lr


def cosine_schedule(peak: float, decay_steps: int) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(peak, decay_steps) with alpha 0."""
    if decay_steps <= 0:
        raise ValueError(f"cosine schedule needs decay_steps > 0, got "
                         f"{decay_steps}")

    def lr(count: int) -> float:
        c = min(count, decay_steps)
        return peak * 0.5 * (1 + math.cos(math.pi * c / decay_steps))

    return lr


@dataclasses.dataclass(frozen=True)
class ParamGroup:
    """One trained group: ``lr(count)`` (the update count before this
    update), the global-norm clip and the decoupled weight decay."""
    lr: Callable[[int], float]
    clip: float
    weight_decay: float = 0.0


class AdamW:
    """optax.multi_transform of chain(clip_by_global_norm, adamw) groups.

    ``label(path)`` names each leaf's group; a group mapped to None, or a
    name missing from ``groups``, is frozen (optax.set_to_zero)."""

    def __init__(self, groups: Dict[str, Optional[ParamGroup]],
                 label: Callable[[str], str], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.groups, self.label = groups, label
        self.b1, self.b2, self.eps = b1, b2, eps

    def group_of(self, path: str, leaf) -> Optional[str]:
        """The trained group of a leaf, or None where it is frozen."""
        name = self.label(path)
        if self.groups.get(name) is None or not (
                torch.is_tensor(leaf) and leaf.is_floating_point()):
            return None
        return name

    def trained(self, params) -> Dict[str, torch.Tensor]:
        return {p: x for p, x in named_leaves(params)
                if self.group_of(p, x) is not None}

    def init(self, params) -> Dict[str, Any]:
        """Zero moments in each trained leaf's dtype (on its device)."""
        trained = self.trained(params)
        return {"count": torch.zeros((), dtype=torch.int32),
                "mu": {p: torch.zeros_like(x) for p, x in trained.items()},
                "nu": {p: torch.zeros_like(x) for p, x in trained.items()}}

    @torch.no_grad()
    def update(self, params, state: Dict[str, Any], layout=None) -> None:
        """One update from each trained leaf's ``.grad`` (a leaf the loss
        did not reach counts as a zero gradient, as in JAX), in place on the
        params and the state; the gradients are cleared.

        With a ``layout`` (``parallel.sharding.Layout``) the leaves are this
        rank's pieces: the gradients are summed over "data" first, each
        group's norm is the whole gradient's (``Layout.sq_norm``), and a
        moment that ZeRO-1 sliced (``shard_opt_state_zero1``) updates its
        slice of the param, which is then all-gathered over "data"."""
        count = int(state["count"])
        by_group: Dict[str, list] = {}
        for path, x in self.trained(params).items():
            by_group.setdefault(self.group_of(path, x), []).append((path, x))
        for name, leaves in by_group.items():
            group = self.groups[name]
            ps = [x for _, x in leaves]
            gs = [torch.zeros_like(x) if x.grad is None else x.grad
                  for x in ps]
            if layout is None:
                # optax's global norm: each leaf's sum of squares in its
                # own dtype, the leaves' sums added in f32
                norm = torch.stack([g.square().sum().float()
                                    for g in gs]).sum().sqrt()
            else:
                named = [(p, g) for (p, _), g in zip(leaves, gs)]
                layout.reduce_grads(named)
                norm = layout.sq_norm(named).sqrt()
            # optax: g when norm < max_norm, else (g / norm) * max_norm
            keep = norm < group.clip
            gs = torch._foreach_div(gs, torch.where(keep, 1.0, norm))
            torch._foreach_mul_(gs, torch.where(
                keep, 1.0, torch.tensor(group.clip, device=norm.device)))
            # mixed dtypes (QLoRA's bf16 and f32 adapters) take their
            # scalars rounded to their own dtype, as optax does
            by_dtype: Dict[torch.dtype, list] = {}
            sliced = []
            for (path, p), g in zip(leaves, gs):
                if state["mu"][path].shape != p.shape:  # a ZeRO-1 slice
                    p, g = (local_chunk(x, 0, layout.mesh, DATA_AXIS)
                            for x in (p, g))
                    sliced.append((path, p))
                by_dtype.setdefault(p.dtype, []).append((path, p, g))
            for dtype, rows in by_dtype.items():
                self._adamw(group, count, dtype, rows, state)
            for path, piece in sliced:
                whole = dict(leaves)[path]
                dist.all_gather(list(whole.chunk(
                    axis_size(layout.mesh, DATA_AXIS), 0)), piece.clone(),
                    group=axis_group(layout.mesh, DATA_AXIS))
            for p in ps:
                p.grad = None
        state["count"] = torch.tensor(count + 1, dtype=torch.int32)

    def _adamw(self, group: ParamGroup, count: int, dtype, rows, state):
        def rounded(v: float) -> float:
            return float(torch.tensor(v, dtype=dtype))

        b1, b2 = self.b1, self.b2
        ps = [p for _, p, _ in rows]
        gs = [g for _, _, g in rows]
        mu = [state["mu"][path] for path, _, _ in rows]
        nu = [state["nu"][path] for path, _, _ in rows]
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, rounded(b1))
        torch._foreach_add_(mu, torch._foreach_mul(gs, rounded(1 - b1)))
        torch._foreach_mul_(nu, rounded(b2))
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(gs, gs), rounded(1 - b2)))
        # bias corrections 1 - b ** count at the incremented count, in f32
        c = np.float32(count + 1)
        bc1, bc2 = (float(np.float32(1) - np.power(np.float32(b), c))
                    for b in (b1, b2))
        mu_hat = torch._foreach_div(mu, rounded(bc1))
        den = torch._foreach_div(nu, rounded(bc2))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, rounded(self.eps))
        upd = torch._foreach_div(mu_hat, den)
        if group.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(
                ps, rounded(group.weight_decay)))
        torch._foreach_mul_(upd, rounded(-group.lr(count)))
        torch._foreach_add_(ps, upd)


def make_optimizer(
    lr: float = 2e-5,
    *,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    warmup_steps: int = 0,
    total_steps: int = 10_000,
    projector_lr: Optional[float] = None,
    vision_lr: Optional[float] = None,
    freeze_vision: bool = True,
    freeze_decoder: bool = False,
    freeze_projector: bool = False,
    grad_clip: float = 1.0,
) -> AdamW:
    """Cosine-decay AdamW with per-module groups (decoder, projector,
    vision) and freeze routing, as the JAX ``make_optimizer``."""

    def sched(peak):
        if warmup_steps:
            return warmup_cosine_schedule(
                peak, warmup_steps, max(total_steps, warmup_steps + 1))
        return cosine_schedule(peak, max(total_steps, 1))

    def group(frozen, peak):
        return None if frozen else ParamGroup(sched(peak), grad_clip,
                                              weight_decay)

    # explicit None checks: an explicit 0.0 LR must not fall back to lr
    groups = {
        "decoder": group(freeze_decoder, lr),
        "projector": group(freeze_projector,
                           projector_lr if projector_lr is not None else lr),
        "vision": group(freeze_vision,
                        vision_lr if vision_lr is not None else lr),
    }

    def label(path: str) -> str:
        # extra top-level params (e.g. image_newline for unpad merges) train
        # with the decoder group
        top = path.split("/", 1)[0]
        return top if top in groups else "decoder"

    return AdamW(groups, label, b1=b1, b2=b2)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: int
    layout: Any = None  # parallel.sharding.Layout of sharded params


def make_train_state(params: Any, tx: AdamW, layout=None) -> TrainState:
    """The state over a copy of the trained leaves (the caller's tree is
    left as it is, as JAX leaves it), each requiring grad; every other leaf
    is shared and requires none. ``layout``: the layout of a sharded
    ``params`` (this rank's pieces), which the steps then follow."""

    def leaf(path, x):
        if not torch.is_tensor(x):
            return x
        if tx.group_of(path, x) is None:
            return x.detach()
        return x.detach().clone().requires_grad_(True)

    params = map_leaves(leaf, params)
    return TrainState(params=params, opt_state=tx.init(params), step=0,
                      layout=layout)


def _global_loss(loss: torch.Tensor, layout) -> torch.Tensor:
    """The loss over the global batch: each data rank's share summed."""
    loss = loss.detach()
    if layout is not None:
        loss = loss.clone()
        dist.all_reduce(loss, group=axis_group(layout.mesh, DATA_AXIS))
    return loss


def train_step(
    state: TrainState,
    cfg: FastVLMConfig,
    tx: AdamW,
    batch: Dict[str, torch.Tensor],
    seq_sharding=None,
    anyres=None,
) -> Tuple[TrainState, torch.Tensor]:
    """loss, backward, one optimizer update (in place); returns the new
    state and the loss (a 0-d tensor on the device, not read here). A
    sharded state (``state.layout``) takes this data rank's rows and
    returns the global batch's loss."""
    loss = loss_fn(state.params, cfg, batch, seq_sharding=seq_sharding,
                   anyres=anyres, layout=state.layout)
    loss.backward()
    tx.update(state.params, state.opt_state, state.layout)
    return (state._replace(step=state.step + 1),
            _global_loss(loss, state.layout))


def loss_fn_pp(params: Any, cfg: FastVLMConfig,
               batch: Dict[str, torch.Tensor], mesh,
               n_micro: int) -> torch.Tensor:
    """Pipeline-parallel loss: the decoder's layers staged over the mesh's
    "model" axis (``parallel/pipeline.forward_pipelined``, this rank's
    stage in ``params``); the tower, projector, embedding and head whole on
    every rank; the batch is this data rank's rows, split into ``n_micro``
    microbatches. The same function as ``loss_fn``."""
    cfg.decoder.require_uniform("training")
    from fastvlm_tpu_torch.parallel import pipeline as pp

    embeds = vlm._spliced_prompt_embeds(
        params, cfg, batch.get("images"), batch["ids"], batch["image_starts"])
    b, t, d = embeds.shape
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} "
                         f"microbatches")
    positions = torch.arange(t, device=embeds.device)[None].expand(b, t)
    mask = qwen2.prefill_mask(batch["attn_lens"], t, t)
    hidden = pp.forward_pipelined(
        params["decoder"], cfg.decoder, embeds.reshape(n_micro, -1, t, d),
        positions.reshape(n_micro, -1, t), mask.reshape(n_micro, -1, t, t),
        mesh)
    logits = qwen2.logits_from_hidden(params["decoder"],
                                      hidden.reshape(b, t, d), cfg.decoder)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                         axis_group(mesh, DATA_AXIS))


def train_step_pp(
    state: TrainState,
    cfg: FastVLMConfig,
    tx: AdamW,
    batch: Dict[str, torch.Tensor],
    mesh,
    n_micro: int = 2,
) -> Tuple[TrainState, torch.Tensor]:
    """One step with the decoder pipelined over the mesh's "model" axis.
    The state holds this rank's stage (``parallel/pipeline.stage_layout``
    as its layout); layer params, gradients and moments stay stage-local.
    Returns the global batch's loss."""
    loss = loss_fn_pp(state.params, cfg, batch, mesh, n_micro)
    loss.backward()
    tx.update(state.params, state.opt_state, state.layout)
    return (state._replace(step=state.step + 1),
            _global_loss(loss, state.layout))
