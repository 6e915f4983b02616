"""Process-group bring-up: the port of ``fastvlm_tpu/parallel/distributed.py``.

One call per process before any collective:

    from fastvlm_tpu_torch.parallel.distributed import initialize
    initialize()                               # torchrun's env (RANK, ...)
    initialize("host:port", n, pid)            # explicit: a tcp:// rendezvous
    initialize("file:///tmp/store", n, pid, device="cpu")   # gloo on the CPU

``torch.distributed`` takes the place of ``jax.distributed``: the backend is
NCCL when the caller trains on the card (the default) and gloo when it asks
for the CPU. Then ``parallel.mesh.make_mesh`` lays the (data, model) mesh
over the world's ranks, rank-major, as JAX lays it over host-major devices.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device: str = "cuda",
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Idempotent ``init_process_group``: ``nccl`` for ``device="cuda"``,
    ``gloo`` for ``device="cpu"``. With no coordinator the rendezvous is
    torchrun's env (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), or an in-memory store for ``num_processes=1``; a
    ``host:port`` becomes ``tcp://host:port`` and a ``tcp://`` or
    ``file://`` URL is used as it is, with ``num_processes`` and
    ``process_id`` (default: the env's ``WORLD_SIZE`` and ``RANK``). A
    collective that waits longer than ``timeout`` fails instead of
    hanging."""
    if dist.is_initialized():
        return
    if device not in ("cuda", "cpu"):
        raise ValueError(f"initialize: device must be 'cuda' or 'cpu', got "
                         f"{device!r}")
    backend = "nccl" if device == "cuda" else "gloo"
    kw = {}
    if coordinator_address is None and num_processes == 1:
        # a world of one needs no rendezvous
        init_method = None
        kw = {"store": dist.HashStore(), "world_size": 1, "rank": 0}
    elif coordinator_address is None:
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        kw["world_size"] = (num_processes if num_processes is not None
                            else int(os.environ["WORLD_SIZE"]))
        kw["rank"] = (process_id if process_id is not None
                      else int(os.environ["RANK"]))
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device for the NCCL "
                               "backend; pass device='cpu' for gloo")
        rank = kw.get("rank", int(os.environ.get("RANK", 0)))
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method,
                            timeout=timeout, **kw)
    logger.info("torch.distributed up (%s): rank %d / %d", backend,
                dist.get_rank(), dist.get_world_size())


def tp_world_error(tp: int, module: str) -> Optional[str]:
    """A CLI's message for a ``--tp`` other than the world's size (the
    env's ``WORLD_SIZE``, 1 without one), or None when they agree: the
    ranks of a tensor-parallel engine are processes that torchrun
    starts."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if tp == world:
        return None
    return (f"--tp {tp} needs a world of {tp} processes, one a rank "
            f"(WORLD_SIZE is {world}): run torchrun --nproc-per-node {tp} "
            f"-m {module} --tp {tp} ...")


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (rank 0, or the
    only process when no group is up)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Destroy the default process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
