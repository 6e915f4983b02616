"""Kernel K1 (fused ConvFFN) at the bursts' batched encodes: its bound time over its kernel time, %."""

from port_bench import readings


def read(ctx):
    return readings.k1_roofline(ctx)
