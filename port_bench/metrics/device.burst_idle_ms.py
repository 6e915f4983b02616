"""Time in which the device ran nothing between a burst's due time and its last request's first token, mean over the window's bursts, ms."""

from port_bench import readings


def read(ctx):
    return readings.burst_idle_ms(ctx)
