"""Multimodal projector: ``mlp2x_gelu`` (Linear -> GELU -> Linear),
``linear`` or ``identity``. Counterpart of ``fastvlm_tpu/models/projector.py``;
weights are (in, out) matrices."""

from __future__ import annotations

from typing import Any, Dict

import torch

from fastvlm_tpu_torch.config import ProjectorConfig
from fastvlm_tpu_torch.ops.conv import gelu

Params = Dict[str, Any]


def init(gen: torch.Generator, cfg: ProjectorConfig, device="cpu") -> Params:
    """Random f32 params drawn from ``gen`` (a generator on ``device``)."""
    if cfg.projector_type == "identity":
        return {"layers": []}
    dims = [cfg.mm_hidden_size] + [cfg.hidden_size] * max(cfg.mlp_depth, 1)
    layers = []
    for cin, cout in zip(dims[:-1], dims[1:]):
        layers.append({
            "w": torch.randn((cin, cout), generator=gen, device=device) * 0.02,
            "b": torch.zeros((cout,), device=device),
        })
    return {"layers": layers}


def apply(params: Params, x: torch.Tensor, cfg: ProjectorConfig) -> torch.Tensor:
    """x: (..., mm_hidden) -> (..., hidden). GELU between layers, none after
    the last; each product accumulates in f32 with the bias added in f32."""
    for i, lp in enumerate(params["layers"]):
        if i > 0:
            x = gelu(x)
        y = torch.matmul(x, lp["w"].to(x.dtype)).float() + lp["b"].float()
        x = y.to(x.dtype)
    return x
