"""Bursts at a fixed period: ``sizes`` requests due together every
``period_s`` seconds, whether or not earlier ones finished (an open
loop). A block of ``len(sizes)`` bursts holds every size once, in an
order the seed draws, so a window of whole blocks does the same work on
every seed."""

from port_bench.loadgen import offer_due as offer  # noqa: F401


def due(params: dict, rng, seconds: float):
    """(due time in seconds after the window opens, requests) of every
    burst due before ``seconds``."""
    sizes, period = params["sizes"], params["period_s"]
    out, block = [], []
    j = 0
    while j * period < seconds - 1e-9:
        if not block:
            block = [sizes[i] for i in rng.permutation(len(sizes))]
        out.append((j * period, block.pop()))
        j += 1
    return out
