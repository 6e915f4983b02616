"""The (data, model) device mesh: the port of ``fastvlm_tpu/parallel/mesh.py``.

A ``torch.distributed.DeviceMesh`` of shape (dp, tp) over the world's ranks,
its dims named ``"data"`` and ``"model"``: DP splits the batch over
"data"; TP splits the decoder's heads and MLP columns over "model"
(``parallel/sharding.py``), or a pipeline stages its layers there
(``parallel/pipeline.py``). Where GSPMD inserts the collectives from
shardings, the port calls them itself (``parallel/collectives.py``) over
the mesh's per-axis process groups.

``NamedSharding`` mirrors JAX's placement of an input: ``spec`` names the
mesh axis each dim is split over (None: whole), and ``local(x)`` is this
rank's piece.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(dp: Optional[int] = None, tp: int = 1,
              devices: Optional[Sequence[int]] = None):
    """A (data, model) mesh over ``devices`` (global ranks; default: every
    rank of the initialized world), laid out rank-major. dp defaults to
    n // tp. Raises ValueError on the shapes JAX's ``make_mesh`` rejects,
    before any process group is touched."""
    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh: no process group; call "
                               "parallel.distributed.initialize() first")
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} devices not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp * tp} != device count {n}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "parallel.distributed.initialize() first")
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(devices).reshape(dp, tp),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh) -> dict:
    """{"data": dp, "model": tp}, as JAX's ``Mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def axis_rank(mesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


@dataclass(frozen=True)
class NamedSharding:
    """A placement: dim i of a tensor is split over the mesh axis
    ``spec[i]`` (None or missing: whole)."""
    mesh: Any
    spec: Tuple[Optional[str], ...]

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's piece of the whole tensor ``x`` (a view)."""
        for d, axis in enumerate(self.spec):
            if axis is not None:
                x = local_chunk(x, d, self.mesh, axis)
        return x


def local_chunk(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Rank r's r-th of ``n`` equal chunks of ``x`` along ``dim`` (n = the
    axis' size, which must divide the dim)."""
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {axis}={n}")
    return x.chunk(n, dim)[axis_rank(mesh, axis)]


def data_sharding(mesh) -> NamedSharding:
    """Batch-dim sharding for inputs."""
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def seq_sharding(mesh) -> NamedSharding:
    """(B, T, D) activations of sequence-parallel training: batch over
    "data", tokens over "model". Passed to ``train_step`` / ``loss_fn`` as
    ``seq_sharding``: between decoder blocks each rank holds T/tp tokens."""
    return NamedSharding(mesh, (DATA_AXIS, MODEL_AXIS, None))
