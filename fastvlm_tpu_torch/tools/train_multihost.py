"""Multi-process training launcher: the port of ``scripts/train_multihost.sh``
and ``scripts/multihost_probe.py``.

    python -m fastvlm_tpu_torch.tools.train_multihost [train_sft args...]

runs ``train_sft --multihost`` in this process, which joins the process
group from torchrun's env; start it on every process with ``torchrun``
(``torch.distributed.run``), one process per card. With ``COORDINATOR``
(host:port), ``NUM_PROCESSES`` and ``PROCESS_ID`` in the env, the
rendezvous is that address instead.

    python -m fastvlm_tpu_torch.tools.train_multihost --simulate N

is the plumbing check without a cluster: N local gloo processes on the
CPU through ``torch.distributed.run --standalone``, each running the probe
(``--probe --device cpu``): one all-reduce of the ranks, and one
data-parallel AdamW step of a small linear layer whose result every rank
must hold, equal to the one-process step over the whole batch. Each prints
``MULTIHOST_OK <rank>/<N>``, or ``MULTIHOST_FAIL``, on a line torchrun
prefixes with ``[default<rank>]:``; the run fails if any process does.

    python -m fastvlm_tpu_torch.tools.train_multihost --probe

runs the probe in this process, on the card (NCCL) unless ``--device cpu``
asks for the CPU, as the JAX probe runs on the default backend; start it
on every process with torchrun.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile


def probe(device: str = "cuda") -> int:
    import torch
    import torch.distributed as dist

    from fastvlm_tpu_torch.parallel import distributed, make_mesh, sharding
    from fastvlm_tpu_torch.parallel.mesh import DATA_AXIS, axis_rank
    from fastvlm_tpu_torch.train import step as step_mod

    distributed.initialize(device=device)
    try:
        rank, n = dist.get_rank(), dist.get_world_size()
        dev = torch.device("cuda" if device == "cuda" else "cpu")
        total = torch.tensor([float(rank)], device=dev)
        dist.all_reduce(total)
        ok = float(total) == n * (n - 1) / 2

        # one DP step: rank r holds row r of an (n, 4) batch
        gen = torch.Generator().manual_seed(0)
        whole = {"decoder": {"w": torch.randn(4, 4, generator=gen)}}
        batch = torch.randn(n, 4, generator=gen)
        mesh = make_mesh()
        tx = step_mod.make_optimizer(1e-2)
        layout = sharding.replicated_layout(whole, mesh)
        state = step_mod.make_train_state(
            step_mod.map_leaves(lambda _, x: x.to(dev), whole), tx, layout)
        r = axis_rank(mesh, DATA_AXIS)
        rows = batch[r:r + 1].to(dev)
        ((rows @ state.params["decoder"]["w"]) ** 2).sum().div(n).backward()
        tx.update(state.params, state.opt_state, layout)
        got = state.params["decoder"]["w"].detach()

        ref = step_mod.make_train_state(whole, tx)
        ((batch @ ref.params["decoder"]["w"]) ** 2).sum().div(n).backward()
        tx.update(ref.params, ref.opt_state)
        ok = ok and torch.allclose(got.cpu(), ref.params["decoder"]["w"],
                                   atol=1e-6)
        parts = [torch.empty_like(got) for _ in range(n)]
        dist.all_gather(parts, got)
        ok = ok and all(torch.equal(p, got) for p in parts)
        print(f"MULTIHOST_OK {rank}/{n} sum={float(total)} "
              f"primary={distributed.is_primary()}" if ok
              else f"MULTIHOST_FAIL {rank}/{n}", flush=True)
        return 0 if ok else 1
    finally:
        distributed.shutdown()


def simulate(n: int, device: str = "cpu", timeout: float = 600) -> int:
    """N local processes of the probe under torchrun; returns the exit
    code (non-zero if any process failed). Each process's output goes to
    its own file under a temporary log directory and torchrun replays it a
    line at a time, prefixed ``[default<rank>]:``: concurrent writers to one
    pipe could otherwise split or merge lines."""
    print(f"simulating {n} processes", flush=True)
    with tempfile.TemporaryDirectory() as logs:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc-per-node={n}", "--log-dir", logs, "--redirects",
               "3", "--tee", "3", "-m",
               "fastvlm_tpu_torch.tools.train_multihost", "--probe",
               "--device", device]
        return subprocess.run(cmd, timeout=timeout).returncode


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in argv:
        device = argv[argv.index("--device") + 1]
    if argv[:1] == ["--simulate"]:  # gloo on the CPU unless asked
        return simulate(int(argv[1]) if len(argv) > 1 else 2, device or "cpu")
    if argv[:1] == ["--probe"]:  # the card unless asked
        return probe(device or "cuda")
    from fastvlm_tpu_torch.train import train_sft

    extra = ["--multihost"]
    if os.environ.get("COORDINATOR"):
        extra += ["--coordinator", os.environ["COORDINATOR"],
                  "--num-processes", os.environ["NUM_PROCESSES"],
                  "--process-id", os.environ["PROCESS_ID"]]
    return train_sft.main(extra + argv)


if __name__ == "__main__":
    sys.exit(main())
