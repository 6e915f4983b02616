"""Kernels a gathered batch's prefill runs on the device (the tower, the projector, the decoder through the logits, the first token's sampling), mean over the window's batches."""

from port_bench import program_timeline


def read(ctx):
    return program_timeline.prefill_launches(ctx)
