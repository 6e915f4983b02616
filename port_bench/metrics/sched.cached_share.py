"""Prompt tokens served from the scheduler's prefix cache, as a share of all prompt tokens of the window's requests, %."""

from port_bench import readings


def read(ctx):
    return readings.cached_share(ctx)
