"""The tower's and projector's operations for the real images of the window's prefills over the device time of their encodes at the bf16 peak, %."""

from port_bench import program_timeline


def read(ctx):
    return program_timeline.encode_mfu(ctx)
