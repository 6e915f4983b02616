"""Mean host time of the scheduler's prepare of each gathered batch (every engine.prepare, the ids read back, pages, prefix reuse, padding, the image stack), ms."""

from port_bench import program_timeline


def read(ctx):
    return program_timeline.prep_ms(ctx)
