"""Parameter layouts over the (data, model) mesh: the port of
``fastvlm_tpu/parallel/sharding.py``.

Tensor-parallel layout of the Qwen2 decoder (Megatron's, over "model"), as
in JAX:
  q/k/v projections  the head (output) dim;
  o projection       the input dim (row-parallel: its product is summed);
  gate/up            the intermediate (output) dim;
  down               the intermediate (input) dim;
  embed / lm_head    the vocab dim;
  norms              replicated.
The vision tower and projector are replicated. The port's layers are a
list, so a layer's specs carry no stacked leading axis.

JAX places whole arrays and GSPMD computes on them; the port keeps each
rank's local piece (``Layout.shard``) and the forward calls the collectives
(``models/qwen2.forward``'s ``group``, ``train/step.py``). A spec is a tuple
naming the mesh axis of each dim (None: whole). ``fit_spec`` drops an axis
a dim cannot split, as JAX's; the port also keeps attention heads whole
(q/o split only when the heads divide tp, k/v when the kv heads do), where
GSPMD may split a head: the product is the same.

``Layout`` is what a sharded train state carries (``train/step.TrainState``):
the mesh, every leaf's fitted spec by its path in the whole tree, and
whether the decoder's layers are staged over "model" (a pipeline). It
slices a whole tree into local pieces, gathers local pieces back (a
checkpoint is written whole), gathers FSDP leaves at use, reduces
gradients over "data" and sums a global norm over exactly the axes each
leaf is split on.

Serving (``engine.Engine(mesh=)``) cuts the tree with ``serving_layout``
and sizes every KV cache by ``kv_heads``: JAX splits its cache over the
kv heads where they divide tp and keeps it whole otherwise; here a rank
keeps the kv heads its own q heads read, so that the decode kernels see a
whole number of q heads per kv head.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from fastvlm_tpu_torch.parallel import collectives as coll
from fastvlm_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, NamedSharding, axis_group, axis_rank, axis_size,
    local_chunk)

Spec = Tuple[Optional[str], ...]


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _named(v, f"{prefix}/{k}" if prefix else str(k))


def _rebuild(fn, tree, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(fn, v, f"{prefix}/{i}" if prefix
                                   else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def decoder_specs(cfg) -> Dict[str, Any]:
    """Specs of one decoder tree; ``layers`` holds one layer's specs,
    applied to every layer."""
    m = MODEL_AXIS
    col = {"w": (None, m), "b": (m,)}
    row = {"w": (m, None)}
    specs: Dict[str, Any] = {
        "embed": (m, None),
        "final_norm": (None,),
        "layers": {"ln1": (None,), "q": col, "k": col, "v": col, "o": row,
                   "ln2": (None,), "gate": {"w": (None, m)},
                   "up": {"w": (None, m)}, "down": row},
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = {"w": (None, m)}
    return specs


def _lookup(specs, path: str) -> Spec:
    node = specs
    for key in path.split("/"):
        if not isinstance(node, dict) or key not in node:
            return ()
        node = node[key]
    return node if isinstance(node, tuple) else ()


def vlm_specs(cfg, params) -> Dict[str, Spec]:
    """Every leaf's spec by its path: the decoder TP'd, everything else
    (vision, projector, image_newline, adapters) replicated."""
    dec = decoder_specs(cfg.decoder)
    layer = dec.pop("layers")
    out = {}
    for path, _ in _named(params):
        parts = path.split("/")
        if parts[0] != "decoder":
            out[path] = ()
        elif parts[1] == "layers":
            out[path] = _lookup(layer, "/".join(parts[3:]))
        else:
            out[path] = _lookup(dec, "/".join(parts[1:]))
    return out


def fit_spec(x: torch.Tensor, spec: Spec, mesh) -> Spec:
    """Drop the mesh axes a leaf's dims cannot split (dim % axis size):
    real checkpoints shard fully, tiny test configs replicate the leaf."""
    return tuple(ax if ax is not None and x.shape[i] % axis_size(mesh, ax)
                 == 0 else None for i, ax in enumerate(spec))


def _whole_heads(specs: Dict[str, Spec], cfg, tp: int) -> Dict[str, Spec]:
    """Keep attention heads whole: q/o (and k/v with them) replicate when
    the heads do not divide tp; k/v alone when the kv heads do not."""
    out = dict(specs)
    for path in specs:
        parts = path.split("/")
        name = parts[-2] if len(parts) >= 2 else ""
        if name in ("q", "o", "k", "v") and cfg.num_heads % tp:
            out[path] = ()
        elif name in ("k", "v") and cfg.num_kv_heads % tp:
            out[path] = ()
    return out


@dataclass
class Layout:
    """A sharded tree's layout: see the module docstring. ``specs`` are by
    whole-tree path; with ``staged`` the decoder's layers are split over
    "model" in contiguous blocks (rank s holds [s L/S, (s+1) L/S))."""
    mesh: Any
    specs: Dict[str, Spec]
    staged: bool = False
    num_layers: int = 0

    # ----- paths -----

    def _stage_layers(self) -> int:
        return self.num_layers // axis_size(self.mesh, MODEL_AXIS)

    def global_path(self, path: str, stage: Optional[int] = None) -> str:
        """The whole-tree path of a local leaf (a staged layer's index moves
        by its stage's offset: this rank's, or ``stage``'s)."""
        if not self.staged or not path.startswith("decoder/layers/"):
            return path
        _, _, i, rest = path.split("/", 3)
        s = axis_rank(self.mesh, MODEL_AXIS) if stage is None else stage
        return f"decoder/layers/{s * self._stage_layers() + int(i)}/{rest}"

    def _stages(self, x: torch.Tensor) -> torch.Tensor:
        """Every stage's copy of a staged local leaf, stacked in stage
        order; collective."""
        return coll._all_gather(x[None], 0, self.group(MODEL_AXIS))

    def spec(self, path: str) -> Spec:
        return self.specs.get(self.global_path(path), ())

    def axis(self, path: str) -> Optional[str]:
        """The mesh axis a local leaf is split over, if any (a staged
        layer's leaves count as split over "model")."""
        if self.staged and path.startswith("decoder/layers/"):
            return MODEL_AXIS
        return next((a for a in self.spec(path) if a is not None), None)

    def group(self, axis: str):
        return axis_group(self.mesh, axis)

    # ----- whole <-> local -----

    def shard(self, tree, prefix: str = ""):
        """Each rank's local copy of a whole tree (compact tensors); a
        subtree names its place with ``prefix``."""
        if self.staged and not prefix:
            dec = dict(tree["decoder"])
            n = self._stage_layers()
            s = axis_rank(self.mesh, MODEL_AXIS)
            dec["layers"] = dec["layers"][s * n:(s + 1) * n]
            tree = {**tree, "decoder": dec}

        def leaf(path, x):
            if not torch.is_tensor(x):
                return x
            return self.piece(x, self.global_path(path)).clone()

        return _rebuild(leaf, tree, prefix)

    def piece(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """This rank's piece (a view) of the whole leaf at ``path``."""
        return NamedSharding(self.mesh, self.specs.get(path, ())).local(x)

    def gather_leaf(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """The whole tensor of a (non-staged) local leaf; collective."""
        for d, ax in enumerate(self.spec(path)):
            if ax is not None:
                x = coll._all_gather(x, d, self.group(ax))
        return x

    def gather(self, tree, prefix: str = ""):
        """The whole tree of a local one (every rank gets it; collective:
        every rank calls it); a subtree names its place with ``prefix``."""
        out = _rebuild(lambda p, x: self.gather_leaf(x, p)
                       if torch.is_tensor(x) else x, tree, prefix)
        if not self.staged or prefix:
            return out
        # staged layers: stage s's i-th layer is layer s * n + i
        n_st = axis_size(self.mesh, MODEL_AXIS)
        local = out["decoder"]["layers"]
        n = len(local)
        layers = [None] * (n * n_st)
        for i, lp in enumerate(local):
            stacked = _rebuild(lambda p, x: self._stages(x), lp)
            for s in range(n_st):
                layers[s * n + i] = _rebuild(lambda p, x, s=s: x[s].clone(),
                                             stacked)
        return {**out, "decoder": {**out["decoder"], "layers": layers}}

    def gather_moments(self, moments: Dict[str, torch.Tensor],
                       params: Dict[str, torch.Tensor]):
        """{whole-tree path: whole tensor} of this rank's optimizer moments
        (``params``: the local leaves by path); ZeRO-1 slices (shapes that
        differ from the param's) are all-gathered over "data" first.
        Collective."""
        out = {}
        for path, x in moments.items():
            if x.shape != params[path].shape:
                x = coll._all_gather(x, 0, self.group(DATA_AXIS))
            if self.staged and path.startswith("decoder/layers/"):
                for s, part in enumerate(self._stages(x)):
                    out[self.global_path(path, s)] = part.clone()
            else:
                out[path] = self.gather_leaf(x, path)
        return out

    def shard_moments(self, whole: Dict[str, torch.Tensor],
                      live: Dict[str, torch.Tensor]):
        """This rank's pieces, shaped as ``live``'s, of whole moments."""
        out = {}
        for path, x in live.items():
            gp = self.global_path(path)
            piece = self.piece(whole[gp], gp)
            if piece.shape != x.shape:  # a ZeRO-1 slice
                piece = local_chunk(piece, 0, self.mesh, DATA_AXIS)
            out[path] = piece
        return out

    # ----- training -----

    def materialize(self, tree, prefix: str):
        """``tree`` (at ``prefix`` in the whole tree) with each
        data-sharded (FSDP) leaf all-gathered, differentiably: its gradient
        is reduce-scattered back to the local piece."""
        def leaf(path, x):
            for d, ax in enumerate(self.spec(path)):
                if ax == DATA_AXIS:
                    return coll.all_gather(x, d, self.group(DATA_AXIS))
            return x

        return _rebuild(leaf, tree, prefix)

    @torch.no_grad()
    def reduce_grads(self, named: Iterable[Tuple[str, torch.Tensor]]) -> None:
        """Sum over "data" the gradients of every leaf not split over it
        (an FSDP leaf's was reduce-scattered in the backward)."""
        group = self.group(DATA_AXIS)
        for path, g in named:
            if self.axis(path) != DATA_AXIS:
                dist.all_reduce(g, group=group)

    def sq_norm(self, named: Iterable[Tuple[str, torch.Tensor]]):
        """Global sum of squares: each leaf's own (in its dtype, as f32),
        summed over the axis the leaf is split on (a replicated leaf counts
        once), then the leaves' sums added in f32 in leaf order, as the
        one-process norm adds them (so one rank gives its bits). Every rank
        makes the same two all-reduces."""
        named = list(named)
        sums = torch.stack([g.square().sum().float() for _, g in named])
        axes = [self.axis(p) for p, _ in named]
        for ax in (MODEL_AXIS, DATA_AXIS):
            sel = torch.tensor([a == ax for a in axes], device=sums.device)
            part = torch.where(sel, sums, 0.0)
            dist.all_reduce(part, group=self.group(ax))
            sums = torch.where(sel, part, sums)
        return sums.sum()


def tp_layout(params, cfg, mesh) -> Layout:
    """Megatron TP over "model" (``vlm_specs`` fitted to the mesh)."""
    tp = axis_size(mesh, MODEL_AXIS)
    leaves = dict(_named(params))
    specs = {p: fit_spec(leaves[p], s, mesh)
             for p, s in _whole_heads(vlm_specs(cfg, params), cfg.decoder,
                                      tp).items()}
    return Layout(mesh, specs)


def replicated_layout(params, mesh) -> Layout:
    """Every leaf whole on every rank: data parallelism alone."""
    return Layout(mesh, {p: () for p, _ in _named(params)})


def fsdp_spec(x: torch.Tensor, dp: int, min_size: int = 2 ** 14,
              stack: int = 1) -> Spec:
    """JAX's FSDP rule: a leaf of at least ``min_size`` elements splits
    over "data" on its largest dim that dp divides; others stay whole.
    ``stack``: the number of layers a decoder layer's leaf is one of (JAX
    stacks them into one leaf, whose size the rule reads; its layer axis,
    never the largest divisible dim at a real width, is not a choice
    here)."""
    if x.numel() * stack < min_size:
        return ()
    for d in sorted(range(x.dim()), key=lambda d: -x.shape[d]):
        if x.shape[d] % dp == 0:
            return tuple(DATA_AXIS if i == d else None
                         for i in range(x.dim()))
    return ()


def fsdp_layout(params, mesh, min_size: int = 2 ** 14) -> Layout:
    dp = axis_size(mesh, DATA_AXIS)
    n = len(params.get("decoder", {}).get("layers", ()))
    return Layout(mesh, {p: fsdp_spec(
        x, dp, min_size, n if p.startswith("decoder/layers/") else 1)
        for p, x in _named(params)})


def kv_heads(cfg, tp: int, rank: int) -> List[int]:
    """The kv heads (indices into the config's) that rank ``rank`` of a
    ``tp``-wide "model" axis attends with and keeps in its KV cache, in the
    order its local q heads use them: local q head j reads local kv head
    j // (Hq_local // len(heads)).

    Heads that do not divide tp leave attention whole: every kv head. kv
    heads that divide tp: the rank's slice of them (the split k / v
    projections give exactly these). Otherwise (k / v stay whole, as in
    ``_whole_heads``): the kv heads the rank's q heads read, once each
    where they form equal groups, as the decode kernels need (Hq_local %
    Hkv_local == 0); else one a q head."""
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    if tp == 1 or hq % tp:
        return list(range(hkv))
    lq, g = hq // tp, hq // hkv
    per_q = [(rank * lq + j) // g for j in range(lq)]
    heads = sorted(set(per_q))
    group = lq // len(heads)
    if lq % len(heads) == 0 and all(per_q[j] == heads[j // group]
                                    for j in range(lq)):
        return heads
    return per_q


def serving_layout(params, cfg, mesh) -> Layout:
    """The layout of a tensor-parallel Engine: ``tp_layout``. A decoder
    with quantized leaves (``ops/quant.py``: ``w_q`` / ``scale``) has no
    spec and raises ValueError, as JAX's ``shard_vlm`` fails on such a
    tree (its specs name ``w`` / ``b`` leaves)."""
    quant = [p for p, _ in _named(params.get("decoder", {}), "decoder")
             if p.endswith("/w_q")]
    if quant:
        raise ValueError(
            f"tensor-parallel serving takes a float decoder: {quant[0]} "
            f"and {len(quant) - 1} more are quantized leaves, which the "
            f"layout has no spec for (the JAX package's shard_vlm fails "
            f"on them too)")
    return tp_layout(params, cfg, mesh)


def shard_vlm(params, cfg, mesh):
    """This rank's pieces of the whole tree under the TP layout."""
    return tp_layout(params, cfg, mesh).shard(params)


def shard_vlm_fsdp(params, mesh, min_size: int = 2 ** 14):
    """FSDP: every leaf of at least ``min_size`` elements split over "data"
    on its largest divisible dim (``fsdp_spec``); the training forward
    all-gathers it at use and its gradient is reduce-scattered."""
    return fsdp_layout(params, mesh, min_size).shard(params)


def shard_opt_state_zero1(opt_state: Dict[str, Any], mesh,
                          layout: Optional[Layout] = None) -> Dict[str, Any]:
    """ZeRO-1: each rank keeps its dim-0 slice of every moment leaf whose
    leading dim "data" divides, but for a leaf the ``layout`` already
    splits over "data" (FSDP's moments are the param's pieces); the count
    and the other
    leaves stay whole. ``train/step.AdamW.update`` then updates the
    rank's slice of each such param and all-gathers it."""
    dp = axis_size(mesh, DATA_AXIS)

    def piece(path, x):
        if layout is not None and layout.axis(path) == DATA_AXIS:
            return x
        if x.dim() and x.shape[0] >= dp and x.shape[0] % dp == 0:
            return local_chunk(x, 0, mesh, DATA_AXIS).clone()
        return x

    return {"count": opt_state["count"],
            **{k: {p: piece(p, x) for p, x in opt_state[k].items()}
               for k in ("mu", "nu")}}
