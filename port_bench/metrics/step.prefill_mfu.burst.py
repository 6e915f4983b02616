"""Model FLOPs of the bursts' batched prefills (tower, projector, decoder past the cached prefix) over the prefill calls' wall time at the bf16 peak, %."""

from port_bench import readings


def read(ctx):
    return readings.prefill_mfu(ctx)
