"""Time in which the device ran nothing inside the device interval of each burst's gathered prefill (waiting on launches or a host read), mean over the window's bursts, ms."""

from port_bench import program_timeline


def read(ctx):
    return program_timeline.burst_idle_launch_ms(ctx)
